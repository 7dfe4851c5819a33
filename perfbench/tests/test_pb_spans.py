"""The per-layer metrics that read the program's spans
(``loongx_tpu_torch.utils.profiling.spans``): each on a recorder filled by
hand gives the worked value, and nothing where the recorder holds no span
of its kind or the program has no recorder; a tiny traced run of a served
and of a train cell on the host reports them."""

from __future__ import annotations

import contextlib
import json
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from loongx_tpu_torch.utils import profiling

from perfbench import run
from perfbench.core import registry, trace
from perfbench.tests.test_pb_harness import CELL, HostCards
from perfbench.tests.test_pb_reference import (
    MIX, TINY, TRAIN_MIX, train_cfg,
)

SERVE = ("span_denoise_step_ms.serve", "span_encode_decode_ms.serve",
         "queue_wait_ms.serve", "port_kernels_per_step.serve")
TRAIN = ("span_forward_ms.train", "span_backward_ms.train",
         "span_recompute_ms.train", "span_optimizer_ms.train",
         "port_kernels_per_step.train")
MS = 1_000_000  # ns


def _span(name, host, device, launches=0):
    """A finished record: host and device (start, end) in ms."""
    return SimpleNamespace(
        name=name, host_start_ns=host[0] * MS, host_end_ns=host[1] * MS,
        device_start_ns=device[0] * MS, device_end_ns=device[1] * MS,
        launches=launches)


# two requests of two denoise steps each
EDIT = [
    _span("edit.brain_encode", (0, 1), (0, 5)),
    _span("edit.vae_encode", (1, 2), (5, 7)),
    _span("edit.denoise.step", (2, 3), (7, 107), 100),
    _span("edit.denoise.step", (3, 4), (107, 207), 100),
    _span("edit.denoise", (2, 4), (7, 207)),
    _span("edit.vae_decode", (4, 5), (207, 219)),
    _span("edit.request", (0, 220), (0, 220), 200),
    _span("edit.brain_encode", (300, 301), (300, 305)),
    _span("edit.vae_encode", (301, 302), (305, 306)),
    _span("edit.denoise.step", (302, 303), (330, 430), 100),
    _span("edit.denoise.step", (303, 304), (430, 531), 102),
    _span("edit.denoise", (302, 304), (330, 531)),
    _span("edit.vae_decode", (304, 305), (531, 541)),
    _span("edit.request", (300, 550), (300, 550), 202),
]
# two train steps, two re-run blocks each
STEPS = [
    _span("train.forward", (0, 5), (0, 800), 900),
    _span("train.recompute", (6, 7), (820, 1020), 400),
    _span("train.recompute", (7, 8), (1020, 1220), 400),
    _span("train.backward", (5, 9), (800, 2800), 2000),
    _span("train.grad_sync", (9, 9), (2800, 2800)),
    _span("train.clip", (9, 10), (2800, 2810), 0),
    _span("train.optimizer", (10, 11), (2810, 2900), 0),
    _span("train.step", (0, 3000), (0, 3000), 2900),
    _span("train.forward", (3000, 3005), (3000, 3820), 900),
    _span("train.recompute", (3006, 3007), (3830, 4030), 400),
    _span("train.recompute", (3007, 3008), (4030, 4230), 400),
    _span("train.backward", (3005, 3009), (3820, 5800), 2000),
    _span("train.grad_sync", (3009, 3009), (5800, 5800)),
    _span("train.clip", (3009, 3010), (5800, 5812), 0),
    _span("train.optimizer", (3010, 3011), (5812, 5900), 0),
    _span("train.step", (3000, 6000), (3000, 6000), 2900),
]

WORKED = {
    "span_denoise_step_ms.serve": (100 + 100 + 100 + 101) / 4,
    "span_encode_decode_ms.serve": ((5 + 2 + 12) + (5 + 1 + 10)) / 2,
    # waits 5, 104, 28, 127 ms: the median of four
    "queue_wait_ms.serve": (28 + 104) / 2,
    "port_kernels_per_step.serve": (100 + 100 + 100 + 102) / 4,
    "span_forward_ms.train": (800 + 820) / 2,
    "span_backward_ms.train": (2000 + 1980) / 2,
    "span_recompute_ms.train": (400 + 400) / 2,
    "span_optimizer_ms.train": ((10 + 90) + (12 + 88)) / 2,
    "port_kernels_per_step.train": 2900,
}


def _read(name, monkeypatch, records):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return registry.metric(name).read({})


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_worked_value(name, monkeypatch):
    records = EDIT if name.endswith(".serve") else STEPS
    assert _read(name, monkeypatch, records) == pytest.approx(WORKED[name])


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_to_read(name, monkeypatch):
    assert _read(name, monkeypatch, []) is None
    # the other path's spans are not this metric's
    other = STEPS if name.endswith(".serve") else EDIT
    assert _read(name, monkeypatch, other) is None
    # a program without the recorder, as before it was written
    monkeypatch.delattr(profiling, "spans")
    assert registry.metric(name).read({}) is None


def test_every_span_metric_is_in_the_benchmark():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SERVE + TRAIN:
        cell = "edit_b4_512" if name.endswith(".serve") else "qlora_b4_512"
        assert entries[name]["workloads"] == [cell]
        assert name in {m["name"] for m in registry.per_layer(bench, cell)}


# -- a traced run on the host ---------------------------------------------------


@contextlib.contextmanager
def _host_record():
    """`trace.record` on the host: a CPU profile (which turns the program's
    spans on) and a trace with no device operation."""
    out = {}
    with profile(activities=[ProfilerActivity.CPU]):
        yield out
    out.update(trace.summarize([]))


def _bench(e2e, names):
    return {
        "configs": [{"name": "tiny", "file": "unused"}],
        "workloads": [{"name": CELL, "config": "tiny",
                       "traffic": "tiny_mix", "chips": 1}],
        "end_to_end": [{"name": e2e, "unit": "x"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": n, "unit": "x", "moves": e2e,
                       "workloads": [CELL]} for n in names],
    }


@pytest.mark.parametrize("path", ["serve", "train"])
def test_a_traced_host_run_reports_the_span_metrics(path, monkeypatch,
                                                    capsys):
    if path == "serve":
        cfg = dict(TINY, driver="serve_edit",
                   checks={"image_rel_l2": 8e-2})
        mix, bench = MIX, _bench("images_per_s", SERVE)
    else:
        cfg = train_cfg()
        cfg["checks"] = {"loss_gap": 2e-2, "grad_norm_gap": 0.2,
                         "change_norm_gap": 0.2}
        mix, bench = TRAIN_MIX, _bench("train_samples_per_s", TRAIN)
    monkeypatch.setattr(registry, "benchmark", lambda root=None: bench)
    monkeypatch.setattr(registry, "config", lambda entry, root=None: cfg)
    monkeypatch.setattr(registry, "traffic", lambda name: mix)
    monkeypatch.setattr(trace, "record", _host_record)
    profiling.clear_spans()
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 33 + 7),
                   "--seconds", "0", "--trace", "1"], cards=HostCards)
    out, _ = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    names = SERVE if path == "serve" else TRAIN
    assert set(line["metrics"]) == set(names)
    for name in names:
        value = line["metrics"][name]["value"]
        assert value >= 0 and value == value
    # the profiled units alone: two of them
    records = profiling.spans()
    root = "edit.request" if path == "serve" else "train.step"
    assert sum(r.name == root for r in records) == run.PROFILED_UNITS
    if path == "serve":
        # plain versions on the host: no kernel of the port's own
        assert line["metrics"]["port_kernels_per_step.serve"]["value"] == 0
        assert line["metrics"]["span_denoise_step_ms.serve"]["value"] > 0
    else:
        assert line["metrics"]["span_recompute_ms.train"]["value"] > 0
        assert (line["metrics"]["span_recompute_ms.train"]["value"]
                < line["metrics"]["span_backward_ms.train"]["value"])
    profiling.clear_spans()
