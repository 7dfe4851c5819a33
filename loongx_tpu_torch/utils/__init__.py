"""Utilities: the weight bridge from the JAX package, checkpoints
(pipeline directories, LoRA files) and the Hugging Face weight
conversion."""
