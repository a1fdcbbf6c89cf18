"""Tensor ops: activations, grid partition, outlook aggregation, input
normalization, and the two hand-written CUDA kernels with their plain
PyTorch versions."""
