"""Models: FLUX DiT and VAE, CS3 encoders, DGF fusion."""
