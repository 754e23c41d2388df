"""Tensor operations of the codec path (PyTorch)."""
