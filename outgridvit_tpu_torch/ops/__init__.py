"""Tensor ops: activations, grid partition, outlook aggregation, input
normalization, augmentation, drop-path, and the hand-written CUDA kernels
(grid MHSA, MLP branch, attention branch, fused outlook value path) with
their plain PyTorch versions."""
