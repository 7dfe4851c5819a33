"""The port's evaluation stack against the JAX package on the CPU.

The CLIP vision tower and the DINO ViT at ``tiny()`` in float32 (JAX's
random trees bridged; ATOL 1e-4, tests/test_clip_vision.py's), both
preprocessors (the resize branch included: ``jax.image.resize``'s
antialiased bilinear against ``F.interpolate(antialias=True)``, within
RESIZE_ATOL), the converters on tiny Hugging Face checkpoints that
transformers builds here (trees equal to JAX's converters' leaf for leaf,
features against transformers' within ATOL), the ``eval_clip.pkl`` bundle
written by either package's converter and read by either package's evaluate
CLI, `evaluate_directory` and ``cli.evaluate`` against JAX's on the same
directory, the Hugging Face backends on the caller's device, ``cli.parity``
on the port's tiny pipeline (as tests/test_eval_cli.py drives JAX's), and
the Hugging Face layouts ``chip_smoke.py`` writes for its random CLIP
ViT-B/32 and DINO ViT-S/16, read back by transformers and by the port.
"""

import dataclasses
import importlib.util
import json
import os
import pickle
import string
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.cli import convert as jconvert_cli
from loongx_tpu.cli import evaluate as jevaluate_cli
from loongx_tpu.evaluation import metrics as jmetrics
from loongx_tpu.models import vision as jv
from loongx_tpu.models.text import clip_vision as jcv
from loongx_tpu.utils import convert as jconvert
from loongx_tpu_torch.cli import convert as tconvert_cli
from loongx_tpu_torch.cli import evaluate as tevaluate_cli
from loongx_tpu_torch.cli import parity as tparity_cli
from loongx_tpu_torch.evaluation import metrics as tmetrics
from loongx_tpu_torch.evaluation.torch_backend import make_dino_backend
from loongx_tpu_torch.models import vision as tv
from loongx_tpu_torch.models.text import clip as tclip
from loongx_tpu_torch.models.text import clip_vision as tcv
from loongx_tpu_torch.utils import convert as tconvert
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

ATOL = 1e-4
# jax.image.resize(bilinear) vs F.interpolate(bilinear, antialias=True),
# in normalised units; measured at most 6.1e-5 (a 100x300 image to 224)
RESIZE_ATOL = 1e-4

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


def _bridge(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _assert_trees_equal(got, want, path=""):
    """Port tree ``got`` equal, leaf for leaf, to the numpy tree ``want``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(g, np.asarray(want), err_msg=path)


def _images(seed, n=2, size=16):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(
        np.float32)


def test_configs_match_jax():
    for j, t, names in ((jcv.CLIPVisionConfig, tcv.CLIPVisionConfig,
                         ("b32", "tiny")),
                        (jv.ViTConfig, tv.ViTConfig, ("dino_s16", "tiny"))):
        for name in names:
            assert (dataclasses.asdict(getattr(j, name)())
                    == dataclasses.asdict(getattr(t, name)()))


def test_patches_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcv._patches(torch.from_numpy(x), 8).numpy(),
        np.asarray(jcv._patches(jnp.asarray(x), 8)))


@pytest.mark.parametrize("batch", [1, 3])
def test_clip_vision_encode_matches_jax(batch):
    cfg = jcv.CLIPVisionConfig.tiny()
    params = jcv.init_clip_vision_params(jax.random.key(0), cfg)
    x = _images(batch, batch)
    want = np.asarray(jcv.clip_vision_encode(params, cfg, jnp.asarray(x)))
    got = tcv.clip_vision_encode(_bridge(params), tcv.CLIPVisionConfig.tiny(),
                                 torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_vit_encode_matches_jax(batch):
    cfg = jv.ViTConfig.tiny()
    params = jv.init_vit_params(jax.random.key(1), cfg)
    x = _images(10 + batch, batch)
    want = np.asarray(jv.vit_encode(params, cfg, jnp.asarray(x)))
    got = tv.vit_encode(_bridge(params), tv.ViTConfig.tiny(),
                        torch.from_numpy(x))
    assert got.shape == want.shape == (batch, cfg.hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("shape,size", [
    ((2, 16, 16, 3), 16),    # no resize
    ((2, 8, 8, 3), 16),      # upsampling
    ((2, 37, 23, 3), 16),    # downsampling, antialiased
    ((1, 512, 512, 3), 224),  # the CLI's 512 px edits to CLIP's 224
    ((1, 100, 300, 3), 224),  # up in one axis, down in the other
])
def test_preprocessors_match_jax(shape, size):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    for jfn, tfn in ((jcv.clip_preprocess, tcv.clip_preprocess),
                     (jv.vit_preprocess, tv.vit_preprocess)):
        want = np.asarray(jfn(jnp.asarray(x), size))
        got = tfn(torch.from_numpy(x), size).numpy()
        assert got.shape == want.shape == (shape[0], size, size, 3)
        np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)


def test_random_inits_match_jax_layout():
    """The port's random trees have the JAX trees' names and shapes."""
    gen = torch.Generator().manual_seed(0)
    for jinit, tinit, jcfg, tcfg in (
            (jcv.init_clip_vision_params, tcv.init_clip_vision_params,
             jcv.CLIPVisionConfig.tiny(), tcv.CLIPVisionConfig.tiny()),
            (jv.init_vit_params, tv.init_vit_params, jv.ViTConfig.tiny(),
             tv.ViTConfig.tiny())):
        want = jax.eval_shape(lambda: jinit(jax.random.key(0), jcfg))
        got = tinit(tcfg, generator=gen, device="cpu")
        assert (jax.tree.map(lambda s: tuple(s.shape), want)
                == jax.tree.map(lambda t: tuple(t.shape), to_numpy_tree(got)))


# ---------------------------------------------------------------------------
# Hugging Face checkpoints built here
# ---------------------------------------------------------------------------


def _write_char_vocab(d):
    """A character-level CLIP BPE vocabulary (no merges), as
    tests/test_eval_cli.py writes it."""
    from transformers import CLIPTokenizer

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in string.ascii_lowercase + string.digits + " ":
        for tok in (ch, ch + "</w>"):
            if tok not in vocab:
                vocab[tok] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    CLIPTokenizer(os.path.join(d, "vocab.json"),
                  os.path.join(d, "merges.txt")).save_pretrained(d)
    return len(vocab)


@pytest.fixture(scope="module")
def hf_clip_dir(tmp_path_factory):
    """A tiny HF CLIP checkpoint (model, tokenizer, processor), as
    tests/test_eval_cli.py builds it."""
    from transformers import CLIPConfig, CLIPModel

    d = str(tmp_path_factory.mktemp("hf_clip"))
    n_vocab = _write_char_vocab(d)
    cfg = CLIPConfig(
        text_config={
            "vocab_size": n_vocab, "hidden_size": 32,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 64, "max_position_embeddings": 16,
            "eos_token_id": 1, "bos_token_id": 0, "pad_token_id": 1,
            "hidden_act": "quick_gelu",
        },
        vision_config={
            "image_size": 16, "patch_size": 8, "hidden_size": 32,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "intermediate_size": 64, "hidden_act": "quick_gelu",
        },
        projection_dim=16,
    )
    torch.manual_seed(0)
    CLIPModel(cfg).eval().save_pretrained(d, safe_serialization=True)
    with open(os.path.join(d, "preprocessor_config.json"), "w") as f:
        json.dump({
            "image_processor_type": "CLIPImageProcessor",
            "do_resize": True, "size": {"shortest_edge": 16},
            "do_center_crop": True, "crop_size": {"height": 16, "width": 16},
            "do_rescale": True, "do_normalize": True,
            "image_mean": list(tcv.CLIP_MEAN), "image_std": list(tcv.CLIP_STD),
            "do_convert_rgb": True,
        }, f)
    return d


@pytest.fixture(scope="module")
def hf_vit_dir(tmp_path_factory):
    """A narrow HF ViTModel (DINO layout: exact GELU, eps 1e-6, qkv bias;
    the 224 px grid of 16 px patches, which --jax_dino_path assumes, and
    one head of 64), saved as safetensors: what --jax_dino_path /
    --dino_path read."""
    from transformers import ViTConfig, ViTModel

    d = str(tmp_path_factory.mktemp("hf_vit"))
    cfg = ViTConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                    intermediate_size=96, image_size=224, patch_size=16,
                    hidden_act="gelu", layer_norm_eps=1e-6, qkv_bias=True)
    torch.manual_seed(1)
    ViTModel(cfg, add_pooling_layer=False).eval().save_pretrained(
        d, safe_serialization=True)
    with open(os.path.join(d, "preprocessor_config.json"), "w") as f:
        json.dump({
            "image_processor_type": "ViTImageProcessor", "do_resize": True,
            "size": {"height": 224, "width": 224}, "do_rescale": True,
            "do_normalize": True, "image_mean": list(tv.IMAGENET_MEAN),
            "image_std": list(tv.IMAGENET_STD)}, f)
    return d


def _numpy_state(d):
    return {k: v.numpy() for k, v in tconvert.load_safetensors_dir(d).items()}


def test_convert_clip_vision_state_matches_jax_and_hf(hf_clip_dir):
    from transformers import CLIPModel

    cfg = tcv.CLIPVisionConfig(image_size=16, patch_size=8, hidden=32,
                               num_layers=2, num_heads=4, d_ff=64,
                               projection_dim=16)
    state = tconvert.load_safetensors_dir(hf_clip_dir)
    got = tconvert.convert_clip_vision_state(state, cfg, device="cpu")
    want = jconvert.convert_clip_vision_state(
        _numpy_state(hf_clip_dir), jcv.CLIPVisionConfig(
            **dataclasses.asdict(cfg)))
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    _assert_trees_equal(_bridge(want), jax.tree.map(np.asarray, want))

    x = _images(3)
    model = CLIPModel.from_pretrained(hf_clip_dir).eval()
    pix = tcv.clip_preprocess(torch.from_numpy(x), 16)
    with torch.no_grad():
        ref = model.get_image_features(pixel_values=pix.permute(0, 3, 1, 2))
    np.testing.assert_allclose(tcv.clip_vision_encode(got, cfg, pix).numpy(),
                               ref.numpy(), atol=ATOL)


def test_convert_vit_state_matches_jax_and_hf(hf_vit_dir):
    from transformers import ViTModel

    cfg = tv.ViTConfig(hidden=64, num_layers=2, num_heads=1, d_ff=96)
    state = tconvert.load_safetensors_dir(hf_vit_dir)
    got = tconvert.convert_vit_state(state, cfg, device="cpu")
    want = jconvert.convert_vit_state(_numpy_state(hf_vit_dir),
                                      jv.ViTConfig(**dataclasses.asdict(cfg)))
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    # the "vit."-prefixed layout of ViTForImageClassification checkpoints
    prefixed = tconvert.convert_vit_state(
        {f"vit.{k}": v for k, v in state.items()}, cfg, device="cpu")
    _assert_trees_equal(prefixed, jax.tree.map(np.asarray, want))
    _assert_trees_equal(_bridge(want), jax.tree.map(np.asarray, want))

    x = _images(4)
    pix = tv.vit_preprocess(torch.from_numpy(x), 224)
    with torch.no_grad():
        ref = ViTModel.from_pretrained(hf_vit_dir).eval()(
            pixel_values=pix.permute(0, 3, 1, 2)).last_hidden_state[:, 0]
    np.testing.assert_allclose(tv.vit_encode(got, cfg, pix).numpy(),
                               ref.numpy(), atol=ATOL)


def test_bridge_takes_eval_trees_and_refuses_unknown_leaves():
    for tree in (jcv.init_clip_vision_params(jax.random.key(2),
                                             jcv.CLIPVisionConfig.tiny()),
                 jv.init_vit_params(jax.random.key(3), jv.ViTConfig.tiny())):
        numpy_tree = jax.tree.map(np.asarray, tree)
        _assert_trees_equal(from_numpy_tree(numpy_tree, "cpu"), numpy_tree)
        # tensors already in a tree are moved, not refused
        _assert_trees_equal(from_numpy_tree(from_numpy_tree(numpy_tree, "cpu"),
                                            "cpu"), numpy_tree)
    with pytest.raises(KeyError, match="visual_bias"):
        from_numpy_tree({"projection": {"visual_bias": np.zeros(2)}}, "cpu")


# ---------------------------------------------------------------------------
# eval_clip.pkl, evaluate_directory and the evaluate CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundles(hf_clip_dir, tmp_path_factory):
    """(JAX converter's bundle dir, the port converter's)."""
    root = tmp_path_factory.mktemp("bundles")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jconvert_cli.main(["--eval_clip", hf_clip_dir, "--out", jdir])
    tconvert_cli.main(["--eval_clip", hf_clip_dir, "--out", tdir])
    return jdir, tdir


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """gen/gt pairs of random 16x16 and 20x20 images (so the CLIs' Pillow
    resize is taken too) and a captions jsonl."""
    from PIL import Image

    root = tmp_path_factory.mktemp("eval")
    gen, gt = root / "gen", root / "gt"
    gen.mkdir(), gt.mkdir()
    rng = np.random.default_rng(7)
    for i, size in enumerate((16, 20, 16)):
        for d, tag in ((gen, 0), (gt, 1)):
            Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)
                            ).save(d / f"p{i}_{tag}.png")
    cap = root / "caps.jsonl"
    with open(cap, "w") as f:
        for i in range(3):
            f.write(json.dumps({"source_image": f"imgs/p{i}_0.png",
                                "instruction": f"make {i} red"}) + "\n")
    return str(gen), str(gt), str(cap)


def test_eval_clip_bundles_equal(bundles):
    with open(os.path.join(bundles[0], "eval_clip.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(bundles[1], "eval_clip.pkl"), "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want)
    for key in ("text_cfg", "vision_cfg"):
        assert got[key] == want[key]
    for key in ("text_params", "vision_params"):
        _assert_trees_equal(got[key], jax.tree.map(np.asarray, want[key]))
        assert all(isinstance(x, np.ndarray)
                   for x in jax.tree.leaves(got[key]))
    assert sorted(os.listdir(bundles[1])) == sorted(os.listdir(bundles[0]))


def _close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_eval_clip_bundles_read_both_ways(bundles, eval_dirs):
    """Each package's evaluate CLI reads the other's bundle and scores as it
    scores its own."""
    gen, gt, cap = eval_dirs
    common = ["--gen_dir", gen, "--gt_dir", gt, "--caption_path", cap,
              "--image_size", "16"]
    jdir, tdir = bundles
    want = jevaluate_cli.main(common + ["--jax_clip_path", jdir])
    assert {"clip_i", "clip_t_gen", "clip_t_gt"} <= set(want)
    for bundle in (jdir, tdir):
        _close(tevaluate_cli.main(common + ["--jax_clip_path", bundle,
                                            "--device", "cpu"]), want, ATOL)
    _close(jevaluate_cli.main(common + ["--jax_clip_path", tdir]), want, 1e-6)


def test_evaluate_cli_matches_jax(bundles, hf_vit_dir, eval_dirs, tmp_path):
    """Every metric and both result files, CLIP and DINO together."""
    gen, gt, cap = eval_dirs
    common = ["--gen_dir", gen, "--gt_dir", gt, "--caption_path", cap,
              "--jax_clip_path", bundles[0], "--jax_dino_path", hf_vit_dir,
              "--image_size", "16"]
    want = jevaluate_cli.main(common + ["--out_dir", str(tmp_path / "j")])
    got = tevaluate_cli.main(common + ["--out_dir", str(tmp_path / "t"),
                                       "--device", "cpu"])
    assert {"l1", "l2", "num_pairs", "clip_i", "clip_t_gen", "clip_t_gt",
            "dino_i"} == set(want)
    _close(got, want, ATOL)
    for name in ("evaluation_metrics.txt", "per_image_metrics.csv"):
        with open(tmp_path / "j" / name) as f:
            jl = f.read().splitlines()
        with open(tmp_path / "t" / name) as f:
            tl = f.read().splitlines()
        assert [line.split(",")[0].split(":")[0] for line in tl] == [
            line.split(",")[0].split(":")[0] for line in jl]


def test_evaluate_cli_refuses_cuda_without_a_card(eval_dirs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit):
        tevaluate_cli.main(["--gen_dir", eval_dirs[0], "--gt_dir",
                            eval_dirs[1]])


def test_evaluate_directory_and_helpers_match_jax(eval_dirs, tmp_path):
    """Pairing, pixel distances, cosines, files: the same numbers with the
    same injected embedders (a fixed projection of the pixels)."""
    from PIL import Image

    gen, gt, _ = eval_dirs
    assert (tmetrics.pair_generated_gt(gen, gt)
            == jmetrics.pair_generated_gt(gen, gt))
    pairs = jmetrics.pair_generated_gt(gen, gt)
    for metric in ("l1", "l2"):
        assert (tmetrics.eval_distance(pairs, metric, 16)
                == jmetrics.eval_distance(pairs, metric, 16))
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.eval_distance(pairs, "l3")
    a, b = np.random.default_rng(0).standard_normal((2, 5, 7))
    np.testing.assert_array_equal(tmetrics.cosine_matrix_mean(a, b),
                                  jmetrics.cosine_matrix_mean(a, b))

    proj = np.random.default_rng(1).standard_normal((16 * 16 * 3, 8))

    def img_fn(paths):
        return np.stack([np.asarray(Image.open(p).convert("RGB").resize(
            (16, 16)), np.float32).reshape(-1) @ proj for p in paths])

    def txt_fn(texts):
        return np.stack([np.full(8, len(t), np.float64) for t in texts])

    instructions = {"p0": "a", "p1": "bb", "p2": "ccc"}
    kw = dict(gt_dir=gt, instructions=instructions, clip_image_embed=img_fn,
              clip_text_embed=txt_fn, dino_image_embed=img_fn, image_size=16)
    want = jmetrics.evaluate_directory(gen, out_dir=str(tmp_path / "j"), **kw)
    got = tmetrics.evaluate_directory(gen, out_dir=str(tmp_path / "t"), **kw)
    assert got == want
    for name in ("evaluation_metrics.txt", "per_image_metrics.csv"):
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())
    with pytest.raises(ValueError, match="no generated/gt pairs"):
        tmetrics.evaluate_directory(str(tmp_path))


def test_hf_backends_on_the_callers_device(hf_clip_dir, hf_vit_dir,
                                           eval_dirs):
    paths = [p for p, _ in jmetrics.pair_generated_gt(*eval_dirs[:2])]
    j_img, j_txt = jmetrics._default_clip_backend(hf_clip_dir)
    t_img, t_txt = tmetrics._default_clip_backend(hf_clip_dir, "cpu")
    np.testing.assert_allclose(t_img(paths), j_img(paths), atol=1e-6)
    np.testing.assert_allclose(t_txt(["make it red", "b"]),
                               j_txt(["make it red", "b"]), atol=1e-6)
    np.testing.assert_allclose(
        tmetrics._default_dino_backend(hf_vit_dir, "cpu")(paths),
        jmetrics._default_dino_backend(hf_vit_dir)(paths), atol=1e-6)


def test_dino_backend_batches_and_identity(tmp_path):
    """Batches of ``batch_size`` give the one-batch features; identical
    pairs score DINO-I 1 (tests/test_vit_dino.py's check)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(3):
        base = rng.integers(0, 255, (16, 16, 3), np.uint8)
        Image.fromarray(base).save(tmp_path / f"d{i}_0.png")
        Image.fromarray(base).save(tmp_path / f"d{i}_1.png")
    cfg = tv.ViTConfig.tiny()
    params = tv.init_vit_params(cfg, generator=torch.Generator().manual_seed(0),
                                device="cpu")
    paths = sorted(str(p) for p in tmp_path.iterdir())
    one = make_dino_backend(params, cfg, device="cpu")(paths)
    two = make_dino_backend(params, cfg, batch_size=2, device="cpu")(paths)
    np.testing.assert_allclose(two, one, atol=1e-6)
    results = tmetrics.evaluate_directory(
        str(tmp_path), dino_image_embed=make_dino_backend(params, cfg,
                                                          device="cpu"),
        image_size=16, device="cpu")
    np.testing.assert_allclose(results["dino_i"], 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# the parity runbook on the port's tiny pipeline
# ---------------------------------------------------------------------------


class FakeTokenizer:
    """tests/test_eval_cli.py's character tokenizer."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, prompts, padding=None, max_length=None,
                 truncation=None, return_tensors=None):
        ids = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            for j, ch in enumerate(p[:max_length]):
                ids[i, j] = (ord(ch) + j) % self.vocab_size

        class R:
            input_ids = ids

        return R()


def test_parity_runbook_tiny(bundles, hf_vit_dir, tmp_path, monkeypatch):
    """Stage the L-Mind split -> the port's batch infer -> evaluate with the
    port's CLIP and DINO towers -> compare, on the CPU; then the FAIL branch
    (exit 1 with parity.json written) on the existing outputs."""
    from PIL import Image

    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.utils.checkpoint import save_pipeline

    ckpt = str(tmp_path / "ckpt")
    save_pipeline(LoongXPipeline.tiny(torch.Generator().manual_seed(0),
                                      device="cpu"), ckpt)
    real_fp = LoongXPipeline.from_pretrained

    def fp(path, **kw):
        p = real_fp(path, **kw)
        p.t5_tokenizer = FakeTokenizer(p.t5_cfg.vocab_size)
        p.clip_tokenizer = FakeTokenizer(p.clip_cfg.vocab_size)
        p.max_sequence_length = 8
        return p

    monkeypatch.setattr(LoongXPipeline, "from_pretrained", staticmethod(fp))
    data = tmp_path / "data"
    (data / "imgs").mkdir(parents=True)
    rng = np.random.RandomState(0)
    rows = []
    for i in range(2):
        for tag in (0, 1):
            Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(
                data / "imgs" / f"s{i}_{tag}.png")
        rows.append({"source_image": f"imgs/s{i}_0.png",
                     "target_image": f"imgs/s{i}_1.png",
                     "instruction": f"edit number {i}"})
    with open(data / "missing.jsonl", "w") as f:
        f.write(json.dumps({"source_image": "imgs/x_0.png",
                            "target_image": "imgs/x_1.png"}) + "\n")
    with pytest.raises(SystemExit, match="no usable pairs"):
        tparity_cli.stage_test_split(str(data / "missing.jsonl"), str(data),
                                     str(tmp_path / "none"))
    jsonl = str(data / "test.jsonl")
    with open(jsonl, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")

    out = str(tmp_path / "parity")
    common = ["--checkpoint", ckpt, "--test_jsonl", jsonl,
              "--image_dir", str(data), "--jax_clip_path", bundles[1],
              "--jax_dino_path", hf_vit_dir, "--out", out,
              "--mode", "neural_speech", "--steps", "1", "--target_size",
              "16", "--device", "cpu"]
    # random weights cannot reach the targets: a wide tolerance checks the
    # plumbing; real runs keep the 0.005 default
    verdict = tparity_cli.main(common + ["--tolerance", "2.0"])
    assert verdict["parity"] is True
    assert verdict["clip_i"]["pass"] and verdict["clip_t_gen"]["pass"]
    assert sorted(os.listdir(os.path.join(out, "outputs"))) == [
        "s0_0.png", "s1_0.png"]
    with open(os.path.join(out, "parity.json")) as f:
        written = json.load(f)
    assert written["verdict"] == json.loads(json.dumps(verdict))
    assert np.isfinite(written["results"]["dino_i"])
    assert os.path.exists(os.path.join(out, "eval", "evaluation_metrics.txt"))

    with pytest.raises(SystemExit) as exc:
        tparity_cli.main(common + ["--skip_generate", "--tolerance",
                                   "0.000001", "--target_clip_i", "9.9"])
    assert exc.value.code == 1
    with open(os.path.join(out, "parity.json")) as f:
        assert json.load(f)["verdict"]["parity"] is False
    with pytest.raises(SystemExit):  # no CLIP scoring backend
        tparity_cli.main(["--checkpoint", ckpt, "--test_jsonl", jsonl,
                          "--image_dir", str(data)])


# ---------------------------------------------------------------------------
# the Hugging Face layouts chip_smoke.py writes
# ---------------------------------------------------------------------------


def test_chip_smoke_hf_clip_and_vit_layouts(tmp_path):
    """``chip_smoke``'s random CLIP and DINO checkpoints (tiny here): read by
    transformers with the port's features, by the port's converter back to
    the trees written, and the tokenizer by CLIPTokenizer."""
    from transformers import CLIPModel, CLIPTokenizer, ViTModel

    gen = torch.Generator().manual_seed(0)
    tcfg = tclip.CLIPTextConfig(vocab_size=600, hidden=32, num_layers=2,
                                num_heads=4, d_ff=64, max_positions=16)
    vcfg = tcv.CLIPVisionConfig.tiny()
    clip_dir = str(tmp_path / "clip")
    text, vision = chip_smoke.write_hf_clip(torch, clip_dir, tcfg, vcfg, gen,
                                            "cpu")
    tok = CLIPTokenizer.from_pretrained(clip_dir)
    ids = tok(["make it red", "b"], padding="max_length", max_length=16,
              truncation=True, return_tensors="np").input_ids
    assert ids[0, 0] == tok.bos_token_id
    with open(os.path.join(clip_dir, "config.json")) as f:
        assert json.load(f)["text_config"]["eos_token_id"] == tok.eos_token_id

    model = CLIPModel.from_pretrained(clip_dir).eval()
    x = _images(5)
    pix = tcv.clip_preprocess(torch.from_numpy(x), 16)
    eos_cfg = dataclasses.replace(tcfg, eos_token_id=tok.eos_token_id)
    with torch.no_grad():
        np.testing.assert_allclose(
            tcv.clip_vision_encode(vision, vcfg, pix).numpy(),
            model.get_image_features(pixel_values=pix.permute(0, 3, 1, 2)
                                     ).numpy(), atol=ATOL)
        np.testing.assert_allclose(
            tclip.clip_text_features(text, eos_cfg,
                                     torch.from_numpy(ids)).numpy(),
            model.get_text_features(input_ids=torch.from_numpy(ids).long()
                                    ).numpy(), atol=ATOL)
    bundle = str(tmp_path / "bundle")
    tconvert_cli.main(["--eval_clip", clip_dir, "--out", bundle])
    with open(os.path.join(bundle, "eval_clip.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert saved["vision_cfg"] == dataclasses.asdict(vcfg)
    assert saved["text_cfg"] == dataclasses.asdict(eos_cfg)
    _assert_trees_equal(text, saved["text_params"])
    _assert_trees_equal(vision, saved["vision_params"])

    dcfg = tv.ViTConfig.tiny()
    vit_dir = str(tmp_path / "vit")
    vit = chip_smoke.write_hf_vit(torch, vit_dir, dcfg, gen, "cpu")
    pix = tv.vit_preprocess(torch.from_numpy(x), 16)
    with torch.no_grad():
        ref = ViTModel.from_pretrained(vit_dir).eval()(
            pixel_values=pix.permute(0, 3, 1, 2)).last_hidden_state[:, 0]
    np.testing.assert_allclose(tv.vit_encode(vit, dcfg, pix).numpy(),
                               ref.numpy(), atol=ATOL)
    read = tconvert.convert_vit_state(tconvert.load_safetensors_dir(vit_dir),
                                      dcfg, device="cpu")
    _assert_trees_equal(read, to_numpy_tree(vit))
