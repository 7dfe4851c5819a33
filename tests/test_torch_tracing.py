"""The port's spans (``loongx_tpu_torch/utils/profiling.py``) on the CPU:
nothing is recorded, no CUDA event made and no ``record_function`` entered
while recording is off; ``spans_on()`` and a running profiler both record;
parents, roots, self time and the launch count; the spans a tiny
``neural_edit`` and a tiny remat train step emit; the spans in an exported
Chrome trace; ``cli.infer``'s stage report.  On the card (marked ``chip``):
a span's host interval holds its kernels' launches and its device interval
their device intervals, on the profiler's clock, and remat's re-runs on the
autograd engine's thread are children of ``train.backward``.  This file
imports no JAX, so the card tests run where JAX is not installed:

    python -m pytest --noconftest -m chip tests/test_torch_tracing.py
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from loongx_tpu_torch.cli import infer
from loongx_tpu_torch.models.flux import model as fmodel
from loongx_tpu_torch.models.flux.model import FluxConfig
from loongx_tpu_torch.models.flux.vae import VAEConfig
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.sampling.generate import neural_edit
from loongx_tpu_torch.train import step as tstep
from loongx_tpu_torch.train.optim import build_optimizer
from loongx_tpu_torch.utils import profiling
from loongx_tpu_torch.utils.profiling import span, spans, spans_on

CFG = dataclasses.replace(FluxConfig.tiny(), joint_dim=4096, pooled_dim=768)
SIZE, STEPS = 16, 2
SIGNALS = dict(eeg=(1, 4, 512), ppg=(1, 4, 256), fnirs=(1, 6, 512),
               motion=(1, 6, 128))
EDIT_STAGES = ("edit.brain_encode", "edit.vae_encode", "edit.denoise",
               "edit.vae_decode")
TRAIN_PHASES = ("train.forward", "train.backward", "train.grad_sync",
                "train.clip", "train.optimizer")


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _names(records):
    return [r.name for r in records]


def _one(records, name):
    found = [r for r in records if r.name == name]
    assert len(found) == 1, (name, _names(records))
    return found[0]


# -- the recorder -------------------------------------------------------------


class _Refused:
    """Stands in for what tracing off must never touch."""

    calls = 0

    def __init__(self, *a, **k):
        type(self).calls += 1
        raise AssertionError("made while tracing was off")


def _refuse_device_work(monkeypatch):
    _Refused.calls = 0
    monkeypatch.setattr(torch.cuda, "Event", _Refused)
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)


def test_off_records_nothing_and_touches_no_event(monkeypatch):
    _refuse_device_work(monkeypatch)
    # as if the card were in use: a recording span would make its events
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not profiling.recording()
    ctx = span("a")
    assert span("b") is ctx  # one shared do-nothing manager
    with span("a"):
        with span("b"):
            torch.ones(4).sum()
    assert spans() == [] and _Refused.calls == 0


def test_off_program_makes_no_event_nor_record_function(monkeypatch, edit,
                                                        train):
    _refuse_device_work(monkeypatch)
    edit()
    train()
    assert spans() == [] and _Refused.calls == 0


@pytest.mark.parametrize("how", ["spans_on", "profiler"])
def test_spans_on_and_a_running_profiler_both_record(how):
    if how == "spans_on":
        with spans_on():
            assert profiling.recording()
            with span("a"):
                pass
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.recording()
            with span("a"):
                pass
    assert not profiling.recording()
    with span("after"):
        pass
    assert _names(spans()) == ["a"]


def test_spans_on_nests():
    with spans_on():
        with spans_on():
            pass
        assert profiling.recording()
        with span("a"):
            pass
    assert not profiling.recording() and _names(spans()) == ["a"]


def test_parents_roots_and_self_time():
    with spans_on():
        with span("root") as root:
            time.sleep(0.002)
            with span("child.1") as c1:
                time.sleep(0.003)
                with span("grandchild") as g:
                    time.sleep(0.001)
            with span("child.2") as c2:
                time.sleep(0.002)
        with span("second.root") as root2:
            pass
    recs = spans()
    assert _names(recs) == ["grandchild", "child.1", "child.2", "root",
                            "second.root"]
    assert (root.parent, root.root) == (None, root.id)
    assert (c1.parent, c1.root) == (root.id, root.id)
    assert (c2.parent, c2.root) == (root.id, root.id)
    assert (g.parent, g.root) == (c1.id, root.id)
    assert (root2.parent, root2.root) == (None, root2.id)
    assert len({r.id for r in recs}) == 5
    for r in recs:  # on the CPU the device interval is the host interval
        assert (r.device_start_ns, r.device_end_ns) == (r.host_start_ns,
                                                        r.host_end_ns)
        assert r.host_start_ns <= r.host_end_ns
    # children inside their parents, in order
    assert root.host_start_ns <= c1.host_start_ns <= g.host_start_ns
    assert g.host_end_ns <= c1.host_end_ns <= c2.host_start_ns
    assert c2.host_end_ns <= root.host_end_ns
    dur = {r.name: r.device_end_ns - r.device_start_ns for r in recs}
    assert g.self_ns == dur["grandchild"]
    assert c1.self_ns == dur["child.1"] - dur["grandchild"]
    assert root.self_ns == dur["root"] - dur["child.1"] - dur["child.2"]
    assert root.self_ns >= 1.5e6 and c1.self_ns >= 2.5e6


def test_self_time_counts_overlapping_children_once():
    recs = [SimpleNamespace(name=n, id=i, parent=p, device_start_ns=s,
                            device_end_ns=e, self_ns=None)
            for n, i, p, s, e in (("p", 1, None, 0, 100), ("a", 2, 1, 10, 40),
                                  ("b", 3, 1, 30, 60), ("c", 4, 1, 90, 120))]
    profiling._self_times(recs)
    assert [r.self_ns for r in recs] == [100 - 50 - 10, 30, 30, 30]


def test_a_span_on_another_thread_takes_the_waiting_span_as_parent():
    done = threading.Event()
    inner = {}

    def engine():
        with span("train.recompute") as r:
            inner["r"] = r
        done.set()

    with spans_on():
        with span("train.step") as step:
            with span("train.backward") as bwd:
                t = threading.Thread(target=engine)
                t.start()
                done.wait(10)
                t.join()
    r = inner["r"]
    assert (r.parent, r.root) == (bwd.id, step.id)
    assert r.thread != bwd.thread
    assert _names(spans()) == ["train.recompute", "train.backward",
                               "train.step"]


def test_launch_delta_counts_name_keys_only():
    with spans_on():
        with span("outer") as outer:
            cuda_build.LAUNCHES["qmm_flat"] += 1
            cuda_build.LAUNCHES["qmm_flat:wgmma"] += 1
            with span("inner") as inner:
                for _ in range(3):
                    cuda_build.LAUNCHES["flash_attention"] += 1
                    cuda_build.LAUNCHES["flash_attention:wgmma"] += 1
                cuda_build.LAUNCHES["flash_rope"] += 1  # no route key
    assert inner.launches == 4 and outer.launches == 5


def test_the_record_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_records",
                        profiling.collections.deque(maxlen=3))
    with spans_on():
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert _names(spans()) == ["s2", "s3", "s4"]
    profiling.clear_spans()
    assert spans() == []


def test_spans_show_in_the_exported_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with span("edit.request"):
            with span("edit.denoise.step"):
                torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3  # ts are after it
    named = {e["name"]: e for e in events if e.get("name") in
             ("edit.request", "edit.denoise.step")}
    assert set(named) == {"edit.request", "edit.denoise.step"}
    req, step = named["edit.request"], named["edit.denoise.step"]
    # the step inside the request on the trace's own timeline (us)
    assert req["ts"] <= step["ts"]
    assert step["ts"] + step["dur"] <= req["ts"] + req["dur"]
    # and the recorder's host intervals on the same clock as the trace's
    rec = {r.name: r for r in spans()}
    for name, e in named.items():
        r = rec[name]
        assert r.host_start_ns / 1e3 <= base_us + e["ts"] + 1
        assert base_us + e["ts"] + e["dur"] <= r.host_end_ns / 1e3 + 1


# -- the program's spans ------------------------------------------------------


@pytest.fixture(scope="module")
def edit():
    pipe = LoongXPipeline.init_serving(CFG, VAEConfig.tiny(), device="cpu")
    rng = np.random.default_rng(0)
    sig = {k: rng.standard_normal(v, np.float32) for k, v in SIGNALS.items()}
    img = rng.uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32)
    return lambda: neural_edit(pipe, img, height=SIZE, width=SIZE,
                               num_inference_steps=STEPS, **sig)


@pytest.fixture(scope="module")
def train():
    pipe = LoongXPipeline.init_training(CFG, device="cpu")
    params = pipe.params
    trainable, frozen = tstep.partition(params, tstep.trainable_mask(params))
    init_fn, step_fn = tstep.make_train_step(
        CFG, build_optimizer({"type": "SGD", "params": {"lr": 1e-3}}),
        remat=True, grad_clip=0.5, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    h = w = 4
    s_img, s_txt = h * w, 8
    ids = torch.stack(torch.broadcast_tensors(
        torch.zeros(h, w), torch.arange(h, dtype=torch.float32)[:, None],
        torch.arange(w, dtype=torch.float32)[None, :]), -1).reshape(-1, 3)
    # the LoRA factors act on the condition tokens
    batch = {"x0": torch.randn(1, s_img, CFG.in_channels, generator=gen),
             "cond_tokens": torch.randn(1, s_img, CFG.in_channels,
                                        generator=gen),
             "prompt_embeds": torch.randn(1, s_txt, CFG.joint_dim,
                                          generator=gen),
             "pooled": torch.randn(1, CFG.pooled_dim, generator=gen),
             "img_ids": ids, "cond_ids": ids,
             "txt_ids": torch.zeros(s_txt, 3)}
    state = [init_fn(trainable)]

    def run():
        state[0], metrics = step_fn(state[0], frozen, batch, gen)
        return metrics

    return run


def test_a_neural_edit_emits_its_stages_and_one_span_a_step(edit):
    with spans_on():
        edit()
    recs = spans()
    req = _one(recs, "edit.request")
    assert (req.parent, req.root) == (None, req.id)
    for name in EDIT_STAGES:
        stage = _one(recs, name)
        assert (stage.parent, stage.root) == (req.id, req.id)
    steps = [r for r in recs if r.name == "edit.denoise.step"]
    assert len(steps) == STEPS
    denoise = _one(recs, "edit.denoise")
    assert all((s.parent, s.root) == (denoise.id, req.id) for s in steps)
    assert len(recs) == 1 + len(EDIT_STAGES) + STEPS
    # stages in program order, inside the request
    order = [_one(recs, n) for n in EDIT_STAGES]
    for a, b in zip(order, order[1:]):
        assert a.host_end_ns <= b.host_start_ns
    assert req.host_start_ns <= order[0].host_start_ns
    assert order[-1].host_end_ns <= req.host_end_ns
    assert req.launches == 0  # plain versions on the CPU: no kernel


def test_a_remat_train_step_emits_its_phases_under_one_step(train):
    with spans_on():
        metrics = train()
    assert np.isfinite(float(metrics["loss"]))
    recs = spans()
    step = _one(recs, "train.step")
    assert (step.parent, step.root) == (None, step.id)
    for name in TRAIN_PHASES:
        phase = _one(recs, name)
        assert (phase.parent, phase.root) == (step.id, step.id)
    bwd = _one(recs, "train.backward")
    rec = [r for r in recs if r.name == "train.recompute"]
    # remat re-runs every block once in the backward, never in the forward
    assert len(rec) == CFG.num_double_blocks + CFG.num_single_blocks
    assert all((r.parent, r.root) == (bwd.id, step.id) for r in rec)
    assert all(bwd.host_start_ns <= r.host_start_ns <= r.host_end_ns
               <= bwd.host_end_ns for r in rec)
    assert len(recs) == 1 + len(TRAIN_PHASES) + len(rec)
    phases = [_one(recs, n) for n in TRAIN_PHASES]
    assert sum(p.device_end_ns - p.device_start_ns for p in phases) <= (
        step.device_end_ns - step.device_start_ns)


def test_the_program_records_under_a_profiler_alone(edit):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        edit()
    names = _names(spans())
    assert names.count("edit.denoise.step") == STEPS
    assert names.count("edit.request") == 1
    traced = {e.name for e in prof.events()}
    assert {"edit.request", "edit.denoise.step", *EDIT_STAGES} <= traced


# -- cli.infer --timing -------------------------------------------------------


def _rec(name, ms, queue_ms=0.0):
    return SimpleNamespace(name=name, device_ms=ms, host_start_ns=0,
                           device_start_ns=int(queue_ms * 1e6))


def test_stage_report_reads_the_groups_spans():
    recs = [_rec("edit.brain_encode", 12.0), _rec("edit.vae_encode", 3.5),
            _rec("edit.denoise.step", 400.0, 30.0),
            _rec("edit.denoise.step", 410.0, 50.0),
            _rec("edit.denoise.step", 420.0, 40.0),
            _rec("edit.denoise", 1230.0), _rec("edit.vae_decode", 80.25),
            _rec("edit.request", 1400.0)]
    assert infer.stage_report(recs) == (
        "device ms: brain encode 12.0, VAE encode 3.5, denoise 410.0/step "
        "x 3, VAE decode 80.2; queue wait 40.0 ms (median of 3 steps)")
    # a stage that did not run is left out
    assert infer.stage_report(recs[1:2]) == "device ms: VAE encode 3.5"


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# the mapping of CUDA events onto the host clock, against the profiler's
SLACK_NS = 50_000


@pytest.mark.chip
def test_spans_hold_their_kernels_on_the_profilers_clock():
    """Three spans of matmuls under a CUDA-activity profile (no
    ``spans_on``: the profiler alone turns recording on).  Each span's host
    interval holds the launch calls of its kernels, and its device interval
    their device intervals within `SLACK_NS`."""
    _card()
    x = torch.randn(2048, 2048, device="cuda")
    for _ in range(3):
        x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with span(f"probe.{i}"):
                for _ in range(20):
                    x @ x
        torch.cuda.synchronize()
    recs = {r.name: r for r in spans()}
    assert set(recs) == {"probe.0", "probe.1", "probe.2"}
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {e.correlation_id(): e for e in events
               if e.device_type() == cuda and "gemm" in e.name().lower()}
    launches = [e for e in events if e.device_type() != cuda
                and e.correlation_id() in kernels]
    assert len(launches) >= 60
    # no device copy of a span's annotation counts as device work
    assert not [e for e in events if e.device_type() == cuda
                and e.name().startswith("probe.")]
    for r in recs.values():
        mine = [e for e in launches
                if r.host_start_ns <= e.start_ns() <= r.host_end_ns]
        assert len(mine) >= 20, (r.name, len(mine))
        for e in mine:
            assert e.start_ns() + e.duration_ns() <= r.host_end_ns
            k = kernels[e.correlation_id()]
            assert k.start_ns() >= r.device_start_ns - SLACK_NS, r.name
            assert (k.start_ns() + k.duration_ns()
                    <= r.device_end_ns + SLACK_NS), r.name
    assert sum(len([e for e in launches if r.host_start_ns <= e.start_ns()
                    <= r.host_end_ns]) for r in recs.values()) == len(launches)


@pytest.mark.chip
def test_remat_reruns_on_the_engines_thread_are_backward_children():
    """Under a CUDA-activity profile alone, a checkpointed block's re-run in
    the backward (on the autograd engine's thread) is a ``train.recompute``
    child of ``train.backward``, and the forward's first run is none."""
    _card()
    x = torch.randn(512, 512, device="cuda", requires_grad=True)

    def block(h):
        return torch.tanh(h @ h)

    with profile(activities=[ProfilerActivity.CUDA]):
        with span("train.step") as step:
            with span("train.forward"):
                y = checkpoint(fmodel._rerun_spanned, block, x,
                               use_reentrant=False).sum()
            with span("train.backward") as bwd:
                torch.autograd.grad(y, [x])
    recs = spans()
    rec = _one(recs, "train.recompute")
    assert (rec.parent, rec.root) == (bwd.id, step.id)
    assert rec.thread != bwd.thread
    assert bwd.device_start_ns <= rec.device_start_ns <= rec.device_end_ns \
        <= bwd.device_end_ns
