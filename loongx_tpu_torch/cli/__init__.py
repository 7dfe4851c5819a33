"""Command-line entry points: ``python -m loongx_tpu_torch.cli.convert``
(the published weights -> a pipeline directory) and ``python -m
loongx_tpu_torch.cli.infer`` (the neural edit served from one)."""
