"""Kernels for Hopper with their plain PyTorch versions."""
