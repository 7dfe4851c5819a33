"""Faults planted in the measured program's timed path, to show that a
run's check reads them: each a context manager that patches one function of
``loongx_tpu_torch`` while the block runs.  The harness's own tests
(``perfbench/tests``) and ``perfbench.calibrate`` use them; a run never
does."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(module, name, make):
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def _rows(x, b):
    if hasattr(x, "shape") and x.shape[:1] == (b,):
        return x[: b // 2]
    if isinstance(x, dict):
        return {k: _rows(v, b) for k, v in x.items()}
    if isinstance(x, list):
        return [_rows(v, b) for v in x]
    return x


# -- serving --------------------------------------------------------------


def edit_image_altered():
    """Every decoded image halved where the decode produces it."""
    from loongx_tpu_torch.sampling import generate

    return _patched(generate, "vae_decode",
                    lambda fn: lambda *a, **k: fn(*a, **k) * 0.5)


def edit_half_batch():
    """Half of each request's images served, the other half copies."""
    from loongx_tpu_torch.sampling import generate

    def make(fn):
        def served(pipe, image, **k):
            b = image.shape[0]
            out = fn(pipe, image[: b // 2], **_rows(k, b))
            return np.concatenate([out, out])
        return served
    return _patched(generate, "neural_edit", make)


def edit_state_unchanged():
    """Every denoise step returns its latents unchanged."""
    from loongx_tpu_torch.sampling import generate

    return _patched(generate, "euler_step",
                    lambda fn: lambda latents, *a, **k: latents)


# -- training ---------------------------------------------------------------


def train_state_unchanged():
    """The optimizer step leaves every parameter as it was."""
    from loongx_tpu_torch.train import optim

    return _patched(optim.Prodigy, "step", lambda fn: lambda self, *a: None)


def train_half_batch():
    """The loss over the first half of the batch's rows only."""
    from loongx_tpu_torch.train import step

    def make(fn):
        def loss(params, cfg, batch, draws, *a, **k):
            b = batch["x0"].shape[0]
            return fn(params, cfg, _rows(batch, b), _rows(draws, b), *a, **k)
        return loss
    return _patched(step, "flow_match_loss", make)


def train_answer_altered():
    """The first row's prediction zeroed where the DiT produces it."""
    from loongx_tpu_torch.train import step

    def make(fn):
        def forward(*a, **k):
            pred = fn(*a, **k)
            keep = torch.ones(pred.shape[0], 1, 1, dtype=pred.dtype,
                              device=pred.device)
            keep[0] = 0
            return pred * keep
        return forward
    return _patched(step, "flux_forward", make)


SERVE = {"image_altered": edit_image_altered, "half_batch": edit_half_batch,
         "state_unchanged": edit_state_unchanged}
TRAIN = {"state_unchanged": train_state_unchanged,
         "half_batch": train_half_batch,
         "answer_altered": train_answer_altered}
