"""Command-line entry points: ``python -m loongx_tpu_torch.cli.convert``
(the published weights -> a pipeline directory), ``python -m
loongx_tpu_torch.cli.infer`` (the neural edit served from one) and
``python -m loongx_tpu_torch.cli.train`` (LoRA training from a YAML
config)."""
