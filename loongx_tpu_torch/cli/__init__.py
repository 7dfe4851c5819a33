"""Command-line entry points: ``python -m loongx_tpu_torch.cli.convert``
(the published weights -> a pipeline directory), ``python -m
loongx_tpu_torch.cli.infer`` (the neural edit served from one), ``python -m
loongx_tpu_torch.cli.train`` (LoRA training from a YAML config), ``python
-m loongx_tpu_torch.cli.evaluate`` and ``cli.parity`` (CLIP-I / CLIP-T /
DINO scores), ``python -m loongx_tpu_torch.cli.speech_demo`` (audio ->
Whisper -> Marian -> the edit), ``python -m loongx_tpu_torch.cli.web_demo``
(the stdlib HTTP demo) and ``python -m loongx_tpu_torch.cli.gradio_app``
(the gradio demo, or the HTTP one without gradio).  Each serves on the GPU
unless ``--device cpu``."""
