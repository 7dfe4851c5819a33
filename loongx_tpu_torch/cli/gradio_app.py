"""Gradio web demo: subject-driven generation (counterpart of
``loongx_tpu/cli/gradio_app.py``): centre crop to a square, resize, a
subject condition, a few-step `generate()`.

    python -m loongx_tpu_torch.cli.gradio_app --checkpoint <dir>

Uses ``gradio`` where it is installed, else serves the same editing core
through the stdlib server of `cli.web_demo`.  Serves on the GPU unless
``--device cpu``; the serving knobs are `cli.infer.serving_knobs`'s
environment variables.
"""

from __future__ import annotations

import argparse


def process_image_and_text(pipeline, image, text: str, num_steps: int = 8,
                           size: int = 512, **generate_kwargs):
    """The demo's whole editing path, UI-free: centre crop to a square,
    resize, subject condition on the pipeline's device, few-step generate
    (``generate_kwargs`` go to `generate`: the serving knobs, draws).
    Returns a PIL image."""
    from PIL import Image

    from loongx_tpu_torch.sampling.condition import Condition
    from loongx_tpu_torch.sampling.generate import generate

    w, h = image.size
    s = min(w, h)
    image = image.crop(
        ((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2)
    ).resize((size, size))
    cond = Condition("subject", raw_img=image, device=pipeline.device)
    out = generate(pipeline, prompt=text.strip(), conditions=[cond],
                   height=size, width=size, num_inference_steps=num_steps,
                   output_type="uint8", **generate_kwargs)
    return Image.fromarray(out[0])


def build_app(pipeline, num_steps: int = 8, **generate_kwargs):
    import gradio as gr

    return gr.Interface(
        fn=lambda image, text: process_image_and_text(
            pipeline, image, text, num_steps, **generate_kwargs),
        inputs=[gr.Image(type="pil"), gr.Textbox(lines=2)],
        outputs=gr.Image(type="pil"),
        title="LoongX subject-driven generation",
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from loongx_tpu_torch.precision import set_precision

    set_precision()

    try:
        import gradio  # noqa: F401
    except ImportError:
        # the same demo on the stdlib server (cli/web_demo.py)
        print("gradio not installed: serving the built-in web UI instead")
        from loongx_tpu_torch.cli.web_demo import main as web_main

        web_main(["--checkpoint", args.checkpoint, "--steps", str(args.steps),
                  "--port", str(args.port), "--device", args.device])
        return

    from loongx_tpu_torch.cli.infer import require_device, serving_knobs
    from loongx_tpu_torch.models.pipeline import LoongXPipeline

    require_device(parser, args.device)
    pipeline = LoongXPipeline.from_pretrained(args.checkpoint,
                                              device=args.device)
    build_app(pipeline, args.steps, **serving_knobs()).launch(
        server_port=args.port)


if __name__ == "__main__":
    main()
