"""Training (twin of ``outgridvit_tpu/training``): the train step of
``steps.py`` and what it runs (losses, metrics, mixing, optimizer, state)."""
