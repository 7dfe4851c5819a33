"""Speech-driven editing demo (counterpart of
``loongx_tpu/cli/speech_demo.py``): record or load audio, transcribe it
(Whisper), optionally translate zh->en (MarianMT), and serve the edit with
the transcript as the instruction.

    python -m loongx_tpu_torch.cli.speech_demo --checkpoint <dir> \\
        --image in.png --audio said.wav --whisper_path <whisper dir> \\
        --translate_path <opus-mt dir> --output edited.png

A local Hugging Face checkout (config.json + safetensors + tokenizer) runs
the port's Whisper / Marian (`models.text.whisper`, `models.text.marian`) on
``--device``; any other path goes to the ``whisper`` package or
transformers' ``MarianMTModel``, as in the JAX package.  The edit is
`cli.infer.edit_one` on the GPU unless ``--device cpu``; with EEG and fNIRS
in the brain data it serves ``neural_edit``, where the transcript does not
reach the image.  Serving knobs are the environment variables
`cli.infer.serving_knobs` reads (LOONGX_W8A8=1, ...), read once in `main`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional


def _is_local_hf_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "config.json"))


def _read_audio(audio_path: str, target_rate: int = 16000):
    """Audio file -> mono float waveform at 16 kHz (numpy)."""
    import numpy as np

    try:
        import soundfile as sf  # type: ignore

        audio, rate = sf.read(audio_path, dtype="float32")
    except (ImportError, OSError):
        # OSError: soundfile installed but libsndfile missing
        import wave

        with wave.open(audio_path, "rb") as w:
            rate = w.getframerate()
            width = w.getsampwidth()
            frames = w.readframes(w.getnframes())
            if width == 2:
                audio = np.frombuffer(frames, np.int16) / 32768.0
            elif width == 1:  # unsigned 8-bit PCM
                audio = (np.frombuffer(frames, np.uint8).astype(np.float32)
                         - 128.0) / 128.0
            elif width == 4:
                audio = np.frombuffer(frames, np.int32) / 2147483648.0
            elif width == 3:  # 24-bit PCM: widen to int32
                raw = np.frombuffer(frames, np.uint8).reshape(-1, 3)
                as32 = (raw[:, 0].astype(np.uint32)
                        | (raw[:, 1].astype(np.uint32) << 8)
                        | (raw[:, 2].astype(np.uint32) << 16))
                audio = (as32.astype(np.int32) << 8 >> 8) / 8388608.0
            else:
                raise ValueError(f"unsupported wav sample width {width}")
            audio = audio.astype(np.float32)
            if w.getnchannels() > 1:
                audio = audio.reshape(-1, w.getnchannels())
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if rate != target_rate:  # crude host-side resample, off the hot path
        n = int(len(audio) * target_rate / rate)
        audio = np.interp(
            np.linspace(0.0, len(audio) - 1.0, n),
            np.arange(len(audio)), audio,
        ).astype(np.float32)
    return audio


def transcribe(audio_path: str, whisper_path: str = "openai/whisper-large",
               translate_path: Optional[str] = "Helsinki-NLP/opus-mt-zh-en",
               language: str = "zh", device="cuda") -> str:
    """Audio file -> (optionally translated) instruction text.

    A local Hugging Face checkout runs the port's Whisper / Marian on
    ``device``; otherwise the ``whisper`` package (Whisper) or
    transformers' ``MarianMTModel`` (translation) serves it."""
    if _is_local_hf_dir(whisper_path):
        from loongx_tpu_torch.models.text.whisper import WhisperASR

        text = WhisperASR.from_pretrained(
            whisper_path, device=device).transcribe(
                _read_audio(audio_path), language=language)
    else:
        import whisper  # type: ignore

        # openai-whisper's load_model takes short names ("large") or a .pt
        # path: map Hugging Face ids like "openai/whisper-large" onto them
        name = whisper_path
        if "/" in name and not os.path.exists(name):
            name = name.rsplit("/", 1)[-1].removeprefix("whisper-")
        model = whisper.load_model(name)
        result = model.transcribe(audio_path, language=language)
        text = result["text"].strip()
    if translate_path and language != "en":
        if _is_local_hf_dir(translate_path):
            from loongx_tpu_torch.models.text.marian import MarianTranslator

            text = MarianTranslator.from_pretrained(
                translate_path, device=device).translate(text)
        else:
            from transformers import MarianMTModel, MarianTokenizer

            tok = MarianTokenizer.from_pretrained(translate_path)
            mt = MarianMTModel.from_pretrained(translate_path)
            batch = tok([text], return_tensors="pt", padding=True)
            text = tok.decode(mt.generate(**batch)[0],
                              skip_special_tokens=True)
    return text


def record_audio(seconds: float = 5.0, sample_rate: int = 16000) -> str:
    """Record from the default microphone to a temporary wav."""
    import tempfile

    import sounddevice as sd  # type: ignore
    import soundfile as sf  # type: ignore

    audio = sd.rec(int(seconds * sample_rate), samplerate=sample_rate,
                   channels=1)
    sd.wait()
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        path = f.name
    sf.write(path, audio, sample_rate)
    return path


def speech_edit(pipeline, image_path: str, audio_path: Optional[str],
                output_path: str, *, transcriber=None,
                fallback_prompt: Optional[str] = None,
                brain: Optional[dict] = None, record_seconds: float = 5.0,
                target_size: int = 512, num_steps: int = 28,
                knobs: Optional[Dict[str, bool]] = None):
    """Audio -> instruction -> edit, with an injectable transcriber
    (audio_path -> text) so the demo runs without Whisper / MarianMT
    weights or a microphone.  ``knobs`` are `cli.infer.serving_knobs`.
    Returns the instruction."""
    from loongx_tpu_torch.cli.infer import edit_one, write_image

    transcriber = transcriber or transcribe
    try:
        # recording failures (no sounddevice on a headless host) also fall
        # back to --prompt, not only transcription failures
        audio = audio_path or record_audio(record_seconds)
        prompt = transcriber(audio)
        print(f"[speech] instruction: {prompt!r}")
    except Exception as exc:
        if not fallback_prompt:
            raise
        print(f"[speech] transcription unavailable ({exc}); using --prompt")
        prompt = fallback_prompt

    img = edit_one(pipeline, image_path, prompt, brain=brain or {},
                   target_size=target_size, num_steps=num_steps, knobs=knobs)
    write_image(output_path, img)
    print(f"[speech] saved {output_path}")
    return prompt


def main(argv=None, *, pipeline=None, transcriber=None):
    parser = argparse.ArgumentParser(description="Speech-driven editing demo")
    parser.add_argument("--checkpoint", type=str, required=pipeline is None,
                        help="pipeline directory written by "
                        "loongx_tpu_torch.cli.convert")
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--audio", type=str, default=None,
                        help="audio file; records from mic if omitted")
    parser.add_argument("--record_seconds", type=float, default=5.0)
    parser.add_argument("--whisper_path", type=str,
                        default="openai/whisper-large")
    parser.add_argument("--translate_path", type=str,
                        default="Helsinki-NLP/opus-mt-zh-en")
    parser.add_argument("--language", type=str, default="zh")
    parser.add_argument("--brain_data_path", type=str, default=None)
    parser.add_argument("--output", type=str, default="edited.png")
    parser.add_argument("--prompt", type=str, default=None,
                        help="fallback when no audio available")
    parser.add_argument("--target_size", type=int, default=512)
    parser.add_argument("--steps", type=int, default=28)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from loongx_tpu_torch.precision import set_precision

    set_precision()

    from loongx_tpu_torch.cli.infer import (
        load_brain_data, require_device, serving_knobs,
    )

    require_device(parser, args.device)
    knobs = serving_knobs()
    if pipeline is None:
        from loongx_tpu_torch.models.pipeline import LoongXPipeline

        pipeline = LoongXPipeline.from_pretrained(args.checkpoint,
                                                  device=args.device)
    if transcriber is None:
        def transcriber(audio):
            return transcribe(audio, args.whisper_path, args.translate_path,
                              args.language, device=args.device)
    brain_data = load_brain_data(args.brain_data_path)
    return speech_edit(
        pipeline, args.image, args.audio, args.output,
        transcriber=transcriber, fallback_prompt=args.prompt,
        brain=brain_data.get(os.path.basename(args.image), {}),
        record_seconds=args.record_seconds, target_size=args.target_size,
        num_steps=args.steps, knobs=knobs)


if __name__ == "__main__":
    main()
