"""The HiDream cell on the CPU at a tiny size: a whole run with the host in
the card's place comes out ``correct``; each expert-layer fault, the 4-bit
control and the serving faults turn it false; the cell's operation counts
against counts worked by hand; the configuration's W8A8 groups against the
program's rules.  (On the card: ``test_pb_hidream_chip.py``.)"""

from __future__ import annotations

import copy
import json

import pytest
import torch

from perfbench import faults, faults_hidream, run
from perfbench.core import flops, flops_hidream, registry
from perfbench.drivers import serve_edit_hidream
from perfbench.tests.test_pb_harness import HostCards
from perfbench.tests.test_pb_reference import MIX, TINY

CELL = "tiny_hidream"
TINY_HD = {
    "transformer": {"patch_size": 2, "in_channels": 4, "out_channels": 4,
                    "num_layers": 2, "num_single_layers": 2,
                    "attention_head_dim": 32, "num_attention_heads": 2,
                    "caption_channels": [4096, 4096], "text_emb_dim": 784,
                    "num_routed_experts": 4, "num_activated_experts": 2,
                    "axes_dims_rope": [8, 12, 12], "ffn_multiple_of": 64},
    "vae": TINY["vae"],
    "quantization": {"activations": "int8"},
    "dtype": "bfloat16", "attention_scores": "bfloat16", "s4_mode": "conv",
    "driver": "serve_edit_hidream",
    "checks": {"image_rel_l2": 0.05},  # sound 0.025-0.035, faults >= 0.063
}
HD_MIX = copy.deepcopy(MIX)
HD_MIX["params"].update(guidance=None, llama_streams=4, llama_tokens=3,
                        pooled_extra=16)
HD_MIX["draws"].update(
    llama={"dist": "normal", "shape": ["batch", "llama_streams",
                                       "llama_tokens", 4096]},
    pooled_extra={"dist": "normal", "shape": ["batch", "pooled_extra"]})
BENCH = {
    "configs": [{"name": "tiny", "file": "unused"}],
    "workloads": [{"name": CELL, "config": "tiny", "traffic": "tiny_mix",
                   "chips": 1}],
    "end_to_end": [
        {"name": "images_per_s", "unit": "images/s", "workloads": [CELL]},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "mfu.serve", "unit": "%", "moves": "images_per_s",
                   "workloads": [CELL]}],
}


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(registry, "benchmark", lambda root=None: BENCH)
    monkeypatch.setattr(registry, "config",
                        lambda entry, root=None: copy.deepcopy(TINY_HD))
    monkeypatch.setattr(registry, "traffic", lambda name: HD_MIX)


def _run(capsys):
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 33 + 7),
                   "--seconds", "0", "--trace", "0"], cards=HostCards)
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def test_the_cell_runs_and_is_correct(tiny, capsys):
    line = _run(capsys)
    assert line["correct"] is True and line["attempted"] == 1
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}


FAULTS = {**faults.SERVE, **faults_hidream.MOE}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_make_correct_false(tiny, capsys, fault):
    with FAULTS[fault]():
        line = _run(capsys)
    assert line["correct"] is False, line["checks"]


def test_the_control_reads_over_the_limit():
    drv = serve_edit_hidream.Driver(copy.deepcopy(TINY_HD), HD_MIX, seed=3,
                                    device="cpu")
    drv.run_unit(0)
    value, limit = drv.check([0], control=True)["image_rel_l2"]
    assert value < limit < drv.control["image_rel_l2"]


def test_operation_counts_by_hand():
    """Batch 1, 4 image + 4 condition + 3 text + 2 Llama tokens a block."""
    t = TINY_HD["transformer"]
    ops = {o.name: o for o in flops_hidream.serve_forward(t, 1, 3, 2, 4, 4)}
    d, f, fs = 64, 192, 128
    routed = ops["single_blocks.0.moe.routed.w13"]
    assert routed.kind == "expert" and routed.precision == "int8"
    # every token of the single stream, 2 rows each: 2 x 13 rows
    assert routed.ops == 2.0 * 26 * d * 2 * f
    assert routed.bytes == 26 * d * 2 + 4 * (d * 2 * f + 2 * f * 4) \
        + 26 * f * 2
    assert ops["double_blocks.1.moe.shared.w2"].ops == 2.0 * 8 * fs * d
    assert ops["double_blocks.0.ff_t.w13"].ops == 2.0 * 5 * d * 2 * f
    assert ops["double_blocks.0.to_qkv_t"].ops == 2.0 * 5 * d * 3 * d
    assert ops["single_blocks.1.attention"].ops == 4.0 * 2 * 13 ** 2 * 32
    assert ops["final_layer.linear"].ops == 2.0 * 4 * d * 16
    kinds = {o.kind for o in ops.values()}
    assert kinds == {"linear", "expert", "attention"}
    caption = flops_hidream.caption_ops(t, 1, 5, 2)
    assert len(caption) == 5 and caption[0].ops == 2.0 * 5 * 4096 * d
    # routed rows do not depend on the routing: top-k rows a token
    assert flops.bound_seconds(list(ops.values()), ("expert",)) > 0


def test_the_configuration_states_the_programs_groups():
    """Every K the served HiDream products take, with the group the
    program's rules give it (dense: the stacked kernels'; experts:
    `ops.moe.expert_group`) and the reference's."""
    from loongx_tpu_torch.ops import moe
    from loongx_tpu_torch.ops.quant_matmul import stacked_w8a8_group

    from perfbench.reference import hidream as ref

    cell = registry.cell(registry.benchmark(), "hidream_edit_b4_512")
    cfg = registry.config(cell["config_entry"])
    groups = {int(k): v for k, v in cfg["quantization"]["groups"].items()}
    dense = {64: 2560, 256: 2560, 2048: 2560, 2560: 7680, 4096: 2560}
    for k, n in dense.items():
        assert stacked_w8a8_group(k, n) == (groups[k], k)
        assert ref.dense_group(k) == groups[k]
    for k in (2560, 6912, 3584):
        assert moe.expert_group(k) == groups[k] == ref.expert_group(k)
    assert cfg["reduced"] == []


def test_the_published_layout_counts_17_b_parameters():
    from perfbench.reference import hidream as ref

    cell = registry.cell(registry.benchmark(), "hidream_edit_b4_512")
    t = registry.config(cell["config_entry"])["transformer"]
    from perfbench.core.weights import _leaves

    n = sum(torch.Size(leaf.shape).numel()
            for _, leaf in _leaves(ref.layout(t)))
    assert 16.9e9 < n < 17.3e9
