"""The controls fail where the program passes: the reference computed one
precision below the configuration's, in the program's place (4-bit
activations for the served W8A8 DiT; the DiT linears' inputs and outputs in
fp8 e4m3 for the bf16 QLoRA step), reads far above the program's own
readings.  On the CPU at a
tiny size; on the card (marked ``chip``) at the configurations' widths with
the runs cut short."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import calibrate
from perfbench.core import registry
from perfbench.drivers import serve_edit, train_qlora
from perfbench.tests.test_pb_reference import MIX, TINY, TRAIN_MIX, train_cfg


def test_serve_control_reads_far_above_the_program():
    cfg = copy.deepcopy(TINY)
    drv = serve_edit.Driver(cfg, MIX, seed=3, device="cpu")
    drv.run_unit(0)
    value, _ = drv.check([0], control=True)["image_rel_l2"]
    assert drv.control["image_rel_l2"] > 3 * value


def test_train_control_reads_far_above_the_program():
    drv = train_qlora.Driver(train_cfg(), TRAIN_MIX, seed=9, device="cpu")
    drv.warm()
    prog = drv.readings
    drv.free()
    ref = drv.reference()
    got = train_qlora.compare(prog, ref)
    control = train_qlora.compare(drv.reference("fp8"), ref)
    assert any(control[k] > 3 * got[k] for k in got), (control, got)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
def test_serve_control_fails_on_the_card():
    """Full width, one image, 4 denoise steps: the control over the cell's
    limit, the program under it."""
    _card()
    cell = registry.cell(registry.benchmark(), "edit_b4_512")
    cfg = registry.config(cell["config_entry"])
    mix = copy.deepcopy(registry.traffic(cell["traffic"]))
    mix["params"]["batch"], mix["params"]["steps"] = 1, 4
    row = calibrate.serve_seed(serve_edit, cfg, mix, 17, 1, [])
    limit = cfg["checks"]["image_rel_l2"]
    assert row["sound"]["image_rel_l2"] < limit < \
        row["control"]["image_rel_l2"]


@pytest.mark.chip
def test_train_control_and_faults_fail_on_the_card():
    """Full width, batch 2, two steps: the program within every limit, the
    fp8 control and each planted fault over one of them."""
    _card()
    cell = registry.cell(registry.benchmark(), "qlora_b4_512")
    cfg = registry.config(cell["config_entry"])
    mix = copy.deepcopy(registry.traffic(cell["traffic"]))
    mix["params"]["batch"] = 2
    mix["check"]["steps"] = 2
    row = calibrate.train_seed(train_qlora, cfg, mix, 19,
                               ["state_unchanged", "half_batch",
                                "answer_altered"])
    limits = cfg["checks"]
    assert all(row["sound"][k] < limits[k] for k in limits)
    for name in ("control", "state_unchanged", "half_batch",
                 "answer_altered"):
        assert any(row[name][k] > limits[k] for k in limits), (name, row)
