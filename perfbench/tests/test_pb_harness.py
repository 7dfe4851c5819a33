"""The harness on the CPU at a tiny size: a whole run of a served cell with
the look for a card replaced by a host stand-in, its last line's keys, the
metrics found by name, and ``correct`` false under faults planted in the
timed path."""

from __future__ import annotations

import json

import pytest

from perfbench import faults, run
from perfbench.core import registry
from perfbench.tests.test_pb_reference import MIX, TINY, TRAIN_MIX, train_cfg

CELL = "tiny_edit"
BENCH = {
    "configs": [{"name": "tiny", "file": "unused"}],
    "workloads": [{"name": CELL, "config": "tiny", "traffic": "tiny_mix",
                   "chips": 1}],
    "end_to_end": [
        {"name": "images_per_s", "unit": "images/s", "workloads": [CELL]},
        {"name": "peak_mem_gib", "unit": "GiB"},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [
        {"name": "mfu.serve", "unit": "%", "moves": "images_per_s",
         "workloads": [CELL]}],
}


class HostCards(run.Cards):
    """The host in the card's place (a test of the harness, not a run)."""

    device = "cpu"

    def __init__(self, count):
        self.count = count

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 1

    def kind(self):
        return "host"


@pytest.fixture
def tiny(monkeypatch):
    cfg = dict(TINY, driver="serve_edit",
               checks={"image_rel_l2": 8e-2})
    monkeypatch.setattr(registry, "benchmark", lambda root=None: BENCH)
    monkeypatch.setattr(registry, "config", lambda entry, root=None: cfg)
    monkeypatch.setattr(registry, "traffic", lambda name: MIX)


def _run(capsys, trace=0):
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 33 + 5),
                   "--seconds", "0", "--trace", str(trace)], cards=HostCards)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]) if rc == 0 else None, err


def test_run_prints_the_contract_line(tiny, capsys):
    rc, line, err = _run(capsys)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 1
    assert set(line["metrics"]) == {"images_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert line["metrics"]["images_per_s"]["unit"] == "images/s"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    name, check = next(iter(line["checks"].items()))
    assert name == "image_rel_l2" and check["value"] <= check["limit"]
    assert err.strip().splitlines()[-1].startswith("check image_rel_l2 ")


def test_no_card_no_result(monkeypatch, capsys, tiny):
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "0"])
    out, err = capsys.readouterr()
    if rc == 0:
        pytest.skip("this machine has a CUDA card")
    assert rc == 3 and out == "" and "CUDA card" in err


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serve_faults_make_correct_false(tiny, capsys, fault):
    with faults.SERVE[fault]():
        rc, line, _ = _run(capsys)
    assert rc == 0 and line["correct"] is False


@pytest.fixture
def tiny_train(monkeypatch):
    cfg = train_cfg()
    cfg["checks"] = {"loss_gap": 2e-2, "grad_norm_gap": 0.2,
                     "change_norm_gap": 0.2}
    bench = dict(BENCH, workloads=[{"name": CELL, "config": "tiny",
                                    "traffic": "tiny_mix", "chips": 1}],
                 end_to_end=[{"name": "train_samples_per_s",
                              "unit": "samples/s"},
                             {"name": "setup_s", "unit": "s"}])
    monkeypatch.setattr(registry, "benchmark", lambda root=None: bench)
    monkeypatch.setattr(registry, "config", lambda entry, root=None: cfg)
    monkeypatch.setattr(registry, "traffic", lambda name: TRAIN_MIX)


def test_train_run_is_correct(tiny_train, capsys):
    rc, line, _ = _run(capsys)
    assert rc == 0 and line["correct"] is True
    assert line["attempted"] == 1
    assert set(line["checks"]) == {"loss_gap", "grad_norm_gap",
                                   "change_norm_gap"}
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults_make_correct_false(tiny_train, capsys, fault):
    with faults.TRAIN[fault]():
        rc, line, _ = _run(capsys)
    assert rc == 0 and line["correct"] is False


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "loongx_tpu_torch_extra",
                        types.ModuleType("loongx_tpu_torch_extra"))
    assert "loongx_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "loongx_tpu.sampling",
                        types.ModuleType("loongx_tpu.sampling"))
    assert run.forbidden_modules() == ["loongx_tpu"]


def test_serve_config_choices_reach_the_program(monkeypatch):
    """The configuration's S4D core and attention scores are what the
    driver hands `neural_edit`; a choice it cannot serve is refused."""
    from loongx_tpu_torch.sampling import generate

    from perfbench.drivers import serve_edit

    seen = {}
    edit = generate.neural_edit

    def spy(*a, **k):
        seen.update(s4_mode=k["s4_mode"], int8_attn=k["int8_attn"])
        return edit(*a, **k)

    monkeypatch.setattr(generate, "neural_edit", spy)
    cfg = dict(TINY, s4_mode="scan", attention_scores="int8")
    drv = serve_edit.Driver(cfg, MIX, seed=4, device="cpu")
    drv.run_unit(0)
    assert seen == {"s4_mode": "scan", "int8_attn": True}
    with pytest.raises(ValueError, match="attention_scores"):
        serve_edit.Driver(dict(TINY, attention_scores="fp8"), MIX, seed=4,
                          device="cpu")
