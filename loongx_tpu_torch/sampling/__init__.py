"""Sampling: the neural edit."""
