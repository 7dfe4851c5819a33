"""FLUX DiT and VAE."""
