"""Text encoders: T5 v1.1 (prompt embeds) and the CLIP text tower (pooled)."""
