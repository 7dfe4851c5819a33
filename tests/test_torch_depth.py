"""The port's Depth-Anything estimator against the JAX package on the CPU.

A tiny random transformers ``DepthAnythingForDepthEstimation`` (the
geometry of tests/test_depth.py: DINOv2 hidden 32, 4 layers, a 56 px grid;
the DPT neck 8/16/24/32) gives a state dict that both packages' converters
read; the trees must be equal leaf for leaf, and the bridge must carry
JAX's tree.  Then, fed the same inputs: `resize2d` in every mode (1e-5,
the JAX test's bound against ``F.interpolate``), `dinov2_features` stage by
stage and `depth_anything_forward` on square and non-square inputs (ATOL
2e-4, tests/test_depth.py's, and 1e-4 of the output's largest value: the
random model's depth is about 1e-7), `dpt_resize_hw`, the estimator from a
checkout with its ``preprocessor_config.json`` end to end (float depth as
the forward; the min-max uint8 image by the share of values that differ,
at most U8_SHARE), the depth / depth_pred condition synthesis and
``ImageConditionDataset`` rows against JAX's, the errors when no model
is found, and the Hugging Face layout ``chip_smoke.py`` writes for its
random Depth-Anything-Small, read back by transformers and by the port.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.data import datasets as jdatasets
from loongx_tpu.models import depth as jdepth
from loongx_tpu.sampling import condition as jcond
from loongx_tpu.utils.convert import convert_depth_anything_state as jconvert
from loongx_tpu_torch.data import datasets as tdatasets
from loongx_tpu_torch.models import depth as tdepth
from loongx_tpu_torch.sampling import condition as tcond
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree
from loongx_tpu_torch.utils.convert import convert_depth_anything_state as tconvert

ATOL = 2e-4
REL = 1e-4
# share of the min-max uint8 depth image's values that may differ
U8_SHARE = 0.01

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _no_network():
    """Every file these tests read is local: a name lookup or a connection
    to anywhere fails the test instead of leaving the machine."""
    import socket

    def refuse(*a, **k):
        raise AssertionError(f"network access attempted: {a!r}")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(socket, "getaddrinfo", refuse)
        mp.setattr(socket.socket, "connect", refuse)
        yield


def _hf_model(seed=0):
    """tests/test_depth.py's tiny torch model."""
    from transformers import (
        DepthAnythingConfig as HFDepthAnythingConfig,
        DepthAnythingForDepthEstimation,
        Dinov2Config,
    )

    torch.manual_seed(seed)
    bb = Dinov2Config(hidden_size=32, num_hidden_layers=4,
                      num_attention_heads=2, mlp_ratio=4, image_size=56,
                      patch_size=14, out_indices=[1, 2, 3, 4],
                      apply_layernorm=True, reshape_hidden_states=False)
    cfg = HFDepthAnythingConfig(
        backbone_config=bb, reassemble_hidden_size=32, patch_size=14,
        neck_hidden_sizes=[8, 16, 24, 32], reassemble_factors=[4, 2, 1, 0.5],
        fusion_hidden_size=16, head_hidden_size=8, head_in_index=-1,
        depth_estimation_type="relative", max_depth=1)
    model = DepthAnythingForDepthEstimation(cfg).eval()
    with torch.no_grad():  # layer scales other than 1 so each one counts
        for name, p in model.named_parameters():
            if "lambda1" in name:
                p.mul_(0.7)
    return model


def _tcfg():
    return tdepth.DepthAnythingConfig(
        hidden_size=32, num_layers=4, num_heads=2, mlp_ratio=4, patch_size=14,
        image_size=56, out_indices=(1, 2, 3, 4),
        neck_hidden_sizes=(8, 16, 24, 32),
        reassemble_factors=(4.0, 2.0, 1.0, 0.5), fusion_hidden_size=16,
        head_hidden_size=8)


def _jcfg(tcfg):
    return jdepth.DepthAnythingConfig(**dataclasses.asdict(tcfg))


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= atol and err <= REL * float(np.abs(want).max()) + 1e-12, err


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """(JAX params, port params, config, checkout dir with a DPT processor
    config at 56 x 56)."""
    from transformers import DPTImageProcessor

    model = _hf_model()
    path = tmp_path_factory.mktemp("depth") / "depth-anything-tiny"
    model.save_pretrained(path)
    DPTImageProcessor(
        do_resize=True, size={"height": 56, "width": 56},
        keep_aspect_ratio=True, ensure_multiple_of=14, do_rescale=True,
        do_normalize=True, image_mean=[0.485, 0.456, 0.406],
        image_std=[0.229, 0.224, 0.225]).save_pretrained(path)
    sd = {k: v.detach().numpy().astype(np.float32)
          for k, v in model.state_dict().items()}
    cfg = _tcfg()
    jp = jconvert(sd, _jcfg(cfg), dtype=jnp.float32)
    tp = tconvert({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                  device="cpu")
    return jp, tp, cfg, str(path)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=path)


def test_config_matches_jax_and_reads_hf(golden):
    assert (dataclasses.asdict(tdepth.DepthAnythingConfig())
            == dataclasses.asdict(jdepth.DepthAnythingConfig()))
    with open(Path(golden[3]) / "config.json") as f:
        hf = json.load(f)
    assert (dataclasses.asdict(tdepth.DepthAnythingConfig.from_hf_config(hf))
            == dataclasses.asdict(jdepth.DepthAnythingConfig.from_hf_config(hf))
            == dataclasses.asdict(golden[2]))


def test_converter_and_bridge_match_jax(golden):
    jp, tp, _, _ = golden
    want = jax.tree.map(np.asarray, jp)
    _assert_trees_equal(tp, want)
    _assert_trees_equal(from_numpy_tree(want, "cpu"), want)
    _assert_trees_equal(from_numpy_tree(to_numpy_tree(tp), "cpu"), want)


def test_init_matches_jax_layout():
    cfg = _tcfg()
    want = jax.eval_shape(lambda: jdepth.init_depth_anything_params(
        jax.random.key(0), _jcfg(cfg)))
    got = tdepth.init_depth_anything_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree.map(lambda s: tuple(s.shape), want)
            == jax.tree.map(lambda t: tuple(t.shape), to_numpy_tree(got)))
    out = tdepth.depth_anything_forward(got, cfg, torch.zeros(1, 56, 56, 3))
    assert out.shape == (1, 56, 56) and torch.isfinite(out).all()


@pytest.mark.parametrize("size,mode,align", [
    ((10, 14), "linear", True), ((10, 14), "linear", False),
    ((3, 4), "linear", True), ((3, 4), "linear", False),
    ((11, 9), "cubic", False), ((4, 3), "cubic", False),
    ((1, 1), "linear", True), ((1, 4), "linear", True),
    ((1, 1), "linear", False), ((5, 7), "cubic", False),
])
def test_resize2d_matches_jax(size, mode, align):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(jdepth.resize2d(jnp.asarray(x), size, mode, align))
    got = tdepth.resize2d(torch.from_numpy(x), size, mode, align).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    with pytest.raises(ValueError, match="unknown resize mode"):
        tdepth.resize2d(torch.from_numpy(x), (3, 3), "area")


@pytest.mark.parametrize("shape", [(2, 56, 56, 3), (1, 56, 84, 3)])
def test_dinov2_features_per_stage_match_jax(golden, shape):
    """Every collected stage; the non-square input takes the bicubic
    position-table resize (`_interpolated_pos`)."""
    jp, tp, cfg, _ = golden
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jdepth.dinov2_features(jp, _jcfg(cfg), jnp.asarray(x))
    got = tdepth.dinov2_features(tp, cfg, torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)
    pos_w = jdepth._interpolated_pos(jp, _jcfg(cfg), 4, 6, False)
    _close(tdepth._interpolated_pos(tp, cfg, 4, 6, False), pos_w)


@pytest.mark.parametrize("shape", [(1, 56, 56, 3), (2, 56, 84, 3),
                                   (1, 70, 42, 3)])
def test_depth_forward_matches_jax_and_hf(golden, shape):
    from transformers import DepthAnythingForDepthEstimation

    jp, tp, cfg, path = golden
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jdepth.depth_anything_forward(jp, _jcfg(cfg),
                                                    jnp.asarray(x)))
    got = tdepth.depth_anything_forward(tp, cfg, torch.from_numpy(x))
    assert got.shape == shape[:3]
    _close(got, want)
    with torch.no_grad():
        hf = DepthAnythingForDepthEstimation.from_pretrained(path).eval()(
            torch.from_numpy(x).permute(0, 3, 1, 2)).predicted_depth
    _close(got, hf.numpy())


def test_metric_head_matches_jax(golden):
    jp, tp, cfg, _ = golden
    cfg = dataclasses.replace(cfg, depth_estimation_type="metric",
                              max_depth=20.0)
    x = np.random.default_rng(3).standard_normal((1, 56, 56, 3)).astype(
        np.float32)
    _close(tdepth.depth_anything_forward(tp, cfg, torch.from_numpy(x)),
           jdepth.depth_anything_forward(jp, _jcfg(cfg), jnp.asarray(x)))


def test_dpt_resize_hw_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(20, 900, 2))
        for target, keep in ((518, True), ((392, 518), True), (56, False)):
            assert (tdepth.dpt_resize_hw(h, w, target, 14, keep)
                    == jdepth.dpt_resize_hw(h, w, target, 14, keep))


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray((np.random.default_rng(seed).random((h, w, 3))
                            * 255).astype(np.uint8))


def _u8_share(a, b):
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    return float((a != b).mean())


@pytest.mark.parametrize("hw", [(70, 56), (64, 64)])
def test_estimator_matches_jax_end_to_end(golden, hw):
    """from_pretrained reads the processor config as JAX's does; the depth
    at the source resolution and the pipeline's uint8 image."""
    path = golden[3]
    jest = jdepth.DepthAnythingEstimator.from_pretrained(path)
    test = tdepth.DepthAnythingEstimator.from_pretrained(path, device="cpu")
    for key in ("size", "ensure_multiple_of", "keep_aspect_ratio", "resample",
                "do_resize", "do_rescale", "rescale_factor", "do_normalize"):
        assert getattr(test, key) == getattr(jest, key), key
    np.testing.assert_array_equal(test.image_mean, jest.image_mean)
    img = _image(6, *hw)
    want, got = jest(img), test(img)
    assert got["predicted_depth"].shape == hw
    _close(got["predicted_depth"], want["predicted_depth"])
    assert got["depth"].size == (hw[1], hw[0])
    assert _u8_share(got["depth"], want["depth"]) <= U8_SHARE


def test_estimator_honours_processor_config(golden, tmp_path):
    """Bilinear resample, no normalisation, a non-square size without
    keeping the aspect: as JAX's estimator."""
    from transformers import DepthAnythingForDepthEstimation, DPTImageProcessor

    path = tmp_path / "odd"
    DepthAnythingForDepthEstimation.from_pretrained(golden[3]).save_pretrained(
        path)
    DPTImageProcessor(do_resize=True, size={"height": 42, "width": 56},
                      keep_aspect_ratio=False, ensure_multiple_of=14,
                      resample=2, do_rescale=True, do_normalize=False
                      ).save_pretrained(path)
    jest = jdepth.DepthAnythingEstimator.from_pretrained(str(path))
    test = tdepth.DepthAnythingEstimator.from_pretrained(str(path),
                                                          device="cpu")
    assert test.size == (42, 56) and test.resample == 2
    assert test.do_normalize is False
    img = _image(7, 64, 48)
    _close(test.predict_depth(img), jest.predict_depth(img))


@pytest.fixture()
def depth_env(golden, monkeypatch):
    """$LOONGX_DEPTH_MODEL at the tiny checkout, both packages' estimator
    caches empty before and after."""
    monkeypatch.setenv("LOONGX_DEPTH_MODEL", golden[3])
    jdepth._ESTIMATOR_CACHE.clear()
    tdepth._ESTIMATOR_CACHE.clear()
    yield golden[3]
    jdepth._ESTIMATOR_CACHE.clear()
    tdepth._ESTIMATOR_CACHE.clear()


@pytest.mark.parametrize("ct", ["depth", "depth_pred"])
def test_synthesize_condition_image_matches_jax(depth_env, ct):
    img = _image(8, 64, 64)
    want = jcond.synthesize_condition_image(ct, img)
    got = tcond.synthesize_condition_image(ct, img, device="cpu")
    assert got.mode == want.mode == "RGB" and got.size == want.size
    assert _u8_share(got, want) <= U8_SHARE
    est = tdepth._ESTIMATOR_CACHE[(depth_env, "cpu")]
    assert type(est) is tdepth.DepthAnythingEstimator
    assert est.params["patch"]["kernel"].device.type == "cpu"
    # the estimator is built once per (path, device)
    assert tdepth.depth_estimator(device="cpu") is est
    cond = tcond.Condition(ct, raw_img=img, device="cpu")
    assert _u8_share(cond.condition, want) <= U8_SHARE
    assert len(tdepth._ESTIMATOR_CACHE) == 1


@pytest.mark.parametrize("ct", ["depth", "depth_pred"])
def test_image_condition_dataset_depth_rows_match_jax(depth_env, ct):
    from PIL import Image

    class Base:
        def __init__(self):
            rng = np.random.RandomState(3)
            self.items = [{"jpg": Image.fromarray(rng.randint(
                0, 255, (40, 48, 3), np.uint8)), "json": {"prompt": f"p{i}"}}
                for i in range(3)]

        def __len__(self):
            return len(self.items)

        def __getitem__(self, i):
            return self.items[i]

    kw = dict(condition_size=28, target_size=42, condition_type=ct,
              drop_text_prob=0.3, drop_image_prob=0.3, seed=5)
    want = jdatasets.ImageConditionDataset(Base(), **kw)
    got = tdatasets.ImageConditionDataset(Base(), device="cpu", **kw)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray) and w[k].dtype.kind == "f":
                assert g[k].shape == w[k].shape, k
                # uint8 images as floats in [-1, 1]: a flipped value moves
                # by 2/255
                diff = np.abs(g[k] - w[k])
                assert diff.max() <= 2 / 255 + 1e-6, k
                assert (diff > 1e-6).mean() <= U8_SHARE, k
            elif isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    assert type(tdepth._ESTIMATOR_CACHE[(depth_env, "cpu")]) is (
        tdepth.DepthAnythingEstimator)


def test_depth_errors_without_a_model(monkeypatch, tmp_path):
    """No local checkout: the hub fallback (the HF pipeline, replaced here by
    one that fails as it does offline) raises, and the synthesis says what
    to set, in JAX's words."""
    seen = []

    def offline(model, device):
        seen.append((model, device))
        raise OSError("no network")

    monkeypatch.setattr(tdepth, "_hf_depth_pipeline", offline)
    tdepth._ESTIMATOR_CACHE.clear()
    img = _image(9, 16, 16)
    monkeypatch.delenv("LOONGX_DEPTH_MODEL", raising=False)
    with pytest.raises(RuntimeError, match="point \\$LOONGX_DEPTH_MODEL"):
        tcond.synthesize_condition_image("depth", img, device="cpu")
    assert seen == [("LiheYoung/depth-anything-small-hf", "cpu")]
    monkeypatch.setenv("LOONGX_DEPTH_MODEL", str(tmp_path))  # no config.json
    with pytest.raises(RuntimeError, match="failed to load") as exc:
        tcond.synthesize_condition_image("depth_pred", img, device="cpu")
    assert isinstance(exc.value.__cause__, OSError)
    ds = tdatasets.ImageConditionDataset(
        [{"jpg": img, "json": {"prompt": "p"}}], condition_type="depth",
        condition_size=16, target_size=16, device="cpu")
    with pytest.raises(OSError, match="no network"):
        ds[0]
    assert not tdepth._ESTIMATOR_CACHE


def test_chip_smoke_depth_layout(tmp_path):
    """``chip_smoke``'s random Depth-Anything checkout (tiny here): read by
    transformers with the port's depth, by the port's converter back to the
    tree written, and its processor config as the published one's."""
    from transformers import DepthAnythingForDepthEstimation

    cfg = _tcfg()
    path = str(tmp_path / "depth")
    params, written = chip_smoke.write_hf_depth(
        torch, path, cfg, torch.Generator().manual_seed(0), "cpu")
    assert written == (tmp_path / "depth" / "model.safetensors").stat().st_size
    with open(Path(path) / "config.json") as f:
        assert tdepth.DepthAnythingConfig.from_hf_config(json.load(f)) == cfg
    est = tdepth.DepthAnythingEstimator.from_pretrained(path, device="cpu")
    _assert_trees_equal(est.params, to_numpy_tree(params))
    assert est.size == (56, 56) and est.resample == 3
    np.testing.assert_allclose(est.image_mean, [0.485, 0.456, 0.406])
    x = np.random.default_rng(10).standard_normal((1, 56, 70, 3)).astype(
        np.float32)
    got = tdepth.depth_anything_forward(params, cfg, torch.from_numpy(x))
    with torch.no_grad():
        hf = DepthAnythingForDepthEstimation.from_pretrained(path).eval()(
            torch.from_numpy(x).permute(0, 3, 1, 2)).predicted_depth
    _close(got, hf.numpy())
