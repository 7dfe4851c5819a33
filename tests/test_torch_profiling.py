"""The port's profiling utilities (``loongx_tpu_torch/utils/profiling.py``,
``utils/device_bench.py``) on the CPU: the barrier, the trace file, and
the device-time readers on a CPU function when the caller asks for the CPU
(the card's kernels are read by ``chip_smoke.py`` on the machine with the
card).  The spans are `test_torch_tracing.py`'s."""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from loongx_tpu_torch.utils import device_bench, profiling


def _work():
    a = torch.ones(64, 64)
    return torch.mm(a, a).relu()


def test_device_times_of_a_cpu_function():
    ops = device_bench.device_op_times(_work, n=3, device="cpu")
    # top-level operators only, each once: not their children (aten::empty
    # and aten::fill_ inside aten::ones, aten::clamp_min inside aten::relu)
    assert set(ops) == {"aten::ones", "aten::mm", "aten::relu"}
    assert all(v >= 0 for v in ops.values()) and ops["aten::mm"] > 0
    mm = device_bench.device_time_ms(_work, "aten::mm", n=3, device="cpu")
    assert mm > 0
    assert device_bench.device_time_ms(_work, "no such kernel", n=3,
                                       device="cpu") == 0.0
    total = device_bench.device_time_ms(_work, "", n=3, device="cpu")
    assert np.isfinite(total) and total > 0


def test_device_readers_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_bench.device_op_times(_work)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_bench.device_profile(_work)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_bench.device_ms(_work)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        _work()
    assert prof is not None
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    profiling.force({"a": [torch.ones(2)], "b": None})


def test_card_line_is_nvidia_smis_first_line(monkeypatch):
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\nsecond card\n", "")

    monkeypatch.setattr(subprocess, "run", run)
    assert profiling.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [profiling.SMI_QUERY]
    assert os.path.basename(calls[0][0]) == "nvidia-smi"
