"""The yardstick on the CPU: operation and byte counts against counts worked
by hand, the window's rate arithmetic, the trace reduction, finding the
parts by name, and the import graph of a cell."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run
from perfbench.core import flops, readers, registry, trace

ROOT = Path(__file__).resolve().parents[2]
FLUX_DEV = {"num_attention_heads": 24, "attention_head_dim": 128,
            "in_channels": 64, "joint_attention_dim": 4096,
            "pooled_projection_dim": 768, "guidance_embeds": True,
            "num_layers": 19, "num_single_layers": 38}
TINY = dict(FLUX_DEV, num_attention_heads=2, attention_head_dim=32,
            in_channels=16, num_layers=2, num_single_layers=2)


def test_linear_and_attention_by_hand():
    op = flops.linear("x", m=16, k=16, n=64, precision="int8")
    assert op.ops == 2 * 16 * 16 * 64
    # x bf16 + W int8 + scale f32 + bias bf16 + y bf16
    assert op.bytes == 16 * 16 * 2 + 16 * 64 + 64 * 4 + 64 * 2 + 16 * 64 * 2
    assert op.bound_s == max(op.ops / 1979e12, op.bytes / 3.35e12)
    att = flops.attention("a", b=1, h=24, s=2560, d=128)
    assert att.ops == 80_530_636_800
    assert att.bound_s == att.ops / 989e12  # compute-bound at S 2560
    assert flops.attention("a", 1, 24, 2560, 128, backward=True).ops == \
        2 * att.ops


def _serve_int8_ops_by_hand(b, s_txt, s_img, s_cond, h, mlp, c_in, joint,
                            pooled, nd, ns):
    lat, full = b * (s_img + s_cond), b * (s_txt + s_img + s_cond)
    top = (2 * b * (s_img + s_cond) * c_in * h + 2 * b * s_txt * joint * h
           + 2 * (2 * b) * (256 * h + h * h) * 2           # time, guidance
           + 2 * (2 * b) * (pooled * h + h * h)            # pooled
           + 2 * b * h * 2 * h + 2 * b * s_img * h * c_in)  # norm_out, out
    double = (2 * (2 * b) * h * 6 * h + 2 * b * h * 6 * h
              + 2 * lat * h * 3 * h + 2 * b * s_txt * h * 3 * h
              + 2 * lat * h * h + 2 * b * s_txt * h * h
              + 2 * 2 * lat * h * mlp + 2 * 2 * b * s_txt * h * mlp)
    single = (2 * (2 * b) * h * 3 * h + 2 * full * h * 3 * h
              + 2 * full * h * mlp + 2 * full * (h + mlp) * h)
    return top + nd * double + ns * single


@pytest.mark.parametrize("t", [TINY, FLUX_DEV], ids=["tiny", "flux1-dev"])
@pytest.mark.parametrize("b", [1, 4])
def test_serve_forward_counts(t, b):
    s_txt, s_img = 512, 1024
    ops = flops.serve_forward(t, b, s_txt, s_img, s_img)
    h = t["num_attention_heads"] * t["attention_head_dim"]
    want = _serve_int8_ops_by_hand(b, s_txt, s_img, s_img, h, 4 * h,
                                   t["in_channels"], 4096, 768,
                                   t["num_layers"], t["num_single_layers"])
    assert sum(o.ops for o in ops if o.kind == "linear") == want
    s = s_txt + 2 * s_img
    assert sum(o.ops for o in ops if o.kind == "attention") == (
        (t["num_layers"] + t["num_single_layers"]) * 4 * b
        * t["num_attention_heads"] * s * s * t["attention_head_dim"])


def test_flux_dev_serve_forward_at_peak():
    """33.07e12 int8 ops and 4.59e12 bf16 attention ops a forward at 512
    px: 21.35 ms at the data-sheet peaks."""
    ops = flops.serve_forward(FLUX_DEV, 1, 512, 1024, 1024)
    assert sum(o.ops for o in ops if o.kind == "linear") == 33_074_791_317_504
    assert abs(flops.peak_seconds(ops) - 0.0213542) < 1e-6


def test_train_step_counts_by_hand():
    t, b, r = FLUX_DEV, 4, 4
    ops = flops.train_step(t, b, 512, 1024, 1024, r)
    fwd = sum(o.ops for o in ops if o.kind == "linear")
    assert fwd == _serve_int8_ops_by_hand(b, 512, 1024, 1024, 3072, 12288, 64,
                                          4096, 768, 19, 38)
    h, lat, full, txt = 3072, b * 2048, b * 2560, b * 512
    # every block linear's input gradient but the modulations' and the first
    # double block's text q/k/v, plus the final proj_out
    per_double = (2 * lat * h * 3 * h + 2 * txt * h * 3 * h + 2 * lat * h * h
                  + 2 * txt * h * h + 4 * lat * h * 4 * h + 4 * txt * h * 4 * h)
    per_single = (2 * full * h * 3 * h + 2 * full * h * 4 * h
                  + 2 * full * 5 * h * h)
    dx = (19 * per_double - 2 * txt * h * 3 * h + 38 * per_single
          + 2 * b * 1024 * h * 64)
    assert sum(o.ops for o in ops if o.kind == "linear_dx") == dx
    # LoRA on proj_mlp of one single block: forward x A, (x A) B; backward
    # dB, d(xA), dA and dx through A
    lora = {o.name: o.ops for o in ops if o.kind == "lora"}
    m, k, n = full, h, 4 * h
    assert lora["single_blocks.0.proj_mlp.lora"] == (
        2 * m * r * (k + n) + 2 * m * r * (2 * n + k) + 2 * m * r * k)
    att = [o for o in ops if o.kind == "attention"]
    assert len(att) == 2 * 57
    assert abs(flops.peak_seconds(ops) - 0.32366) < 1e-4


# -- the window ---------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


class _Units:
    """Units of fixed length on a fake clock, ``work`` items each."""

    unit, first_unit = "request", 0

    def __init__(self, clock, seconds, work):
        self.clock, self.seconds, self.work, self.ran = clock, seconds, work, []

    def run_unit(self, i):
        self.clock.now += self.seconds
        self.ran.append(i)
        return self.work


class _NoCard:
    def sync(self):
        pass


def test_window_ends_at_the_first_unit_past_seconds(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)
    drv = _Units(clock, 4.0, work=4)
    w = run.window(drv, _NoCard(), 10.0, traced=False)
    # 4 + 4 + 4 s: the third request ends 12 s in, past 10 s
    assert drv.ran == [0, 1, 2]
    assert w["seconds"] == pytest.approx(12.0)
    rate = registry.metric("images_per_s").read(
        {"window": {"work": sum(u["work"] for u in w["units"]),
                    "seconds": w["seconds"]}})
    assert rate == pytest.approx(12 / 12.0)


def test_mfu_takes_every_unit_of_the_window(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)
    w = run.window(_Units(clock, 4.0, work=1), _NoCard(), 10.0, False)
    ops = [flops.Op("w", "linear", 1979e12, 0.0, "int8")]   # 1 s at peak
    units = w["units"]
    ctx = {"window": {"units": len(units), "work": 3, "seconds": 20.0,
                      "unit_seconds": sum(u["end"] - u["start"]
                                          for u in units)}, "ops": ops}
    # 3 units of 1 at-peak second each over their own 12 s; the 8 s of the
    # window between units (a trace being read) are not the units' time
    assert registry.metric("mfu.serve").read(ctx) == pytest.approx(25.0)


def test_window_of_one_long_unit(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(run.time, "perf_counter", clock)
    w = run.window(_Units(clock, 13.0, work=1), _NoCard(), 10.0, False)
    assert len(w["units"]) == 1 and w["seconds"] == pytest.approx(13.0)


# -- the trace ----------------------------------------------------------------


def test_summarize_union_gaps_and_labels():
    s = trace.WINDOW_SPAN
    events = [
        (s, False, 0, 1000),
        ("qmm_wgmma_kernel<0>", True, 100, 300),
        ("flash_fwd_wgmma_kernel", True, 200, 400),   # overlaps: union
        ("elementwise", True, 700, 800),
        ("cudaLaunchKernel", False, 450, 650),        # spans the gap 400-700
        ("aten::copy_", False, 850, 990),             # spans the tail gap
        ("outside", True, 1200, 1300),                # after the window
    ]
    out = trace.summarize(events)
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"] == pytest.approx(400e-9)     # 100-400 and 700-800
    assert out["device_events"] == 3
    labels = dict(out["idle_gaps"])
    assert labels["cudaLaunchKernel"] == pytest.approx(300e-9)
    assert labels["aten::copy_"] == pytest.approx(200e-9)
    assert labels[trace.HOST_ONLY] == pytest.approx(100e-9)  # 0-100
    ctx = {"trace": out, "profiled": {"units": 1, "steps": 2}}
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    assert readers.device_events_per_step(ctx) == pytest.approx(1.5)
    assert trace.family_seconds(out, readers.GEMM) == pytest.approx(200e-9)
    b = trace.breakdown(out)
    assert b["device_ops"][0][0] in ("qmm_wgmma_kernel<0>",
                                     "flash_fwd_wgmma_kernel")
    assert len(b["device_ops"]) == 3


def test_summarize_takes_the_window_from_the_marks():
    events = [("fill", True, 1000, 1010), ("k", True, 1100, 1200),
              ("cudaLaunchKernel", False, 1020, 1090),
              ("fill", True, 1990, 2000)]
    out = trace.summarize(events)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["busy_s"] == pytest.approx(120e-9)
    assert dict(out["idle_gaps"])["cudaLaunchKernel"] == pytest.approx(90e-9)


def test_readers_find_nothing_without_a_trace():
    ctx = {"trace": None, "profiled": {"units": 0, "steps": 0},
           "rest": {"units": 0, "seconds": 0.0, "steps": 0, "spans": {}},
           "window": {"units": 0, "work": 0, "seconds": 0.0,
                      "unit_seconds": 0.0}, "ops": []}
    for m in ("gemm_roofline.serve", "attn_roofline.train", "mfu.serve",
              "idle_share.train", "kernels_per_step.serve",
              "other_ms_per_step.train", "denoise_ms_per_step.serve"):
        assert registry.metric(m).read(ctx) is None


# -- the parts, by name -------------------------------------------------------


def test_every_part_of_the_benchmark_is_found_by_name():
    bench = registry.benchmark(ROOT)
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in names:
        assert callable(registry.metric(name).read)
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"])
        cfg = registry.config(cell["config_entry"], ROOT)
        assert (ROOT / "perfbench" / "drivers" / f"{cfg['driver']}.py").exists()
        mix = registry.traffic(w["traffic"])
        assert mix["draws"]
        reported = {m["name"] for m in registry.end_to_end(bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.per_layer(bench, w["name"])
    for c in bench["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    with pytest.raises(KeyError):
        registry.cell(bench, "no_such_cell")


# -- imports ------------------------------------------------------------------


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; "
                          "print(json.dumps(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cells_import_graph_holds_no_jax():
    mods = _loaded("import perfbench.run, perfbench.core.trace\n"
                   "import perfbench.drivers.serve_edit as s, "
                   "perfbench.drivers.train_qlora as t\n"
                   "import loongx_tpu_torch.sampling.generate, "
                   "loongx_tpu_torch.train.step, loongx_tpu_torch.train.optim, "
                   "loongx_tpu_torch.models.pipeline, loongx_tpu_torch.ops.quant")
    assert "loongx_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = _loaded("import perfbench.reference.edit, "
                   "perfbench.reference.train, perfbench.core.weights")
    assert not mods & {"loongx_tpu_torch", *run.FORBIDDEN}
