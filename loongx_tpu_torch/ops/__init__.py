"""Tensor ops and the kernel wrappers."""
