"""Kernels' wrappers and their plain PyTorch versions."""
