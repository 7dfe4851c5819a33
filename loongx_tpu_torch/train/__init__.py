"""QLoRA training: LoRA leaves, optimizers, the flow-matching train step."""
