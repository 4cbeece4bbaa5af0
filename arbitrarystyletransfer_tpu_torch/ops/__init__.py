"""Tensor ops of the port: plain PyTorch routes and the kernel wrappers."""
