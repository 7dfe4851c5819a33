"""The port's config spine, host ops, datasets and loader against the JAX
package's, on the CPU.

Every file under ``configs/`` loads to an equal ``dataclasses.asdict``; the
host ops (``loongx_tpu_torch/csrc/host_ops.cc``, built by the port) give
JAX's bytes; every dataset type's samples, built on in-memory base lists as
tests/test_data_ckpt.py builds them, equal JAX's bit for bit (image arrays
compared as bytes, the host-op resize included); the loader's batch order,
``skip_batches`` and ``host_id`` slices are JAX's; ``background_iter``
still stops its producer when the consumer closes early.
"""

import dataclasses
import glob
import json
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from loongx_tpu import config as jconfig
from loongx_tpu import native as jnative
from loongx_tpu.data import datasets as jdatasets
from loongx_tpu.data import loader as jloader
from loongx_tpu_torch import config as tconfig
from loongx_tpu_torch import native as tnative
from loongx_tpu_torch.data import datasets as tdatasets
from loongx_tpu_torch.data import loader as tloader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    REPO, "configs", "*.yaml"))), ids=os.path.basename)
def test_config_files_load_equal(path):
    got = dataclasses.asdict(tconfig.load_config(path))
    assert got == dataclasses.asdict(jconfig.load_config(path))
    assert got != dataclasses.asdict(tconfig.Config())


def test_config_env_and_unknown_key(tmp_path, monkeypatch):
    path = os.path.join(REPO, "configs", "seed_512.yaml")
    monkeypatch.setenv("XFL_CONFIG", path)
    assert tconfig.load_config() == tconfig.load_config(path)
    monkeypatch.delenv("XFL_CONFIG")
    assert tconfig.load_config() == tconfig.Config()
    bad = tmp_path / "bad.yaml"
    bad.write_text("train:\n  batch_sise: 2\n")
    msgs = []
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="batch_sise") as exc:
            mod.load_config(str(bad))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Host ops
# ---------------------------------------------------------------------------


def _bytes_equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), what)


@pytest.mark.parametrize("shape,size", [((37, 53, 3), (16, 24)),
                                        ((20, 20, 3), (64, 48)),
                                        ((9, 7, 1), (9, 7))])
def test_host_ops_equal_jax(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    _bytes_equal(tnative.resize_bilinear(img, *size),
                 jnative.resize_bilinear(img, *size))
    _bytes_equal(tnative.resize_bilinear(img, *size, 1 / 127.5, -1.0),
                 jnative.resize_bilinear(img, *size, 1 / 127.5, -1.0))
    _bytes_equal(tnative.u8_to_f32(img), jnative.u8_to_f32(img))
    if shape[-1] == 3:
        _bytes_equal(tnative.rgb_to_gray3(img), jnative.rgb_to_gray3(img))


def test_host_ops_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: where the library cannot be built, the ops raise."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "host_ops.cc")
    (tmp_path / "host_ops.cc").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.u8_to_f32(np.zeros((2, 2, 3), np.uint8))
    assert not list((tmp_path / "build").glob("*.so"))


def test_host_ops_concurrent_builds(monkeypatch, tmp_path):
    """Threads racing to build one library: each renames a whole file into
    place, and every one loads a working library."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    errors = []

    def build():
        try:
            tnative.build()
        except Exception as exc:  # collected and re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        tnative.lib_path().name]


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def _assert_samples_equal(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            _bytes_equal(g, w, key)
        else:
            assert type(g) is type(w) and g == w, key


@pytest.fixture(scope="module")
def seed_corpus(tmp_path_factory):
    """tests/test_data_ckpt.py's L-Mind corpus (32x32 PNGs, speech
    transcripts on two rows, no motion signal) plus a row without
    biosignals."""
    from PIL import Image

    root = tmp_path_factory.mktemp("seed")
    (root / "imgs").mkdir()
    rng = np.random.RandomState(0)
    rows, bio = [], {}
    for i in range(4):
        for tag in (0, 1):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
                root / "imgs" / f"sample{i}_{tag}.png")
        row = {"source_image": f"imgs/sample{i}_0.png",
               "target_image": f"imgs/sample{i}_1.png",
               "instruction": f"edit {i}"}
        if i % 2:
            row["speech2text"] = f"spoken edit {i}"
        rows.append(row)
        bio[f"sample{i}_0.png"] = {
            "EEG": rng.randn(4, 1000).astype(np.float32),
            "FNIRS": rng.randn(6, 300).astype(np.float32),
            "PPG": rng.randn(4, 200).astype(np.float32),
        }
    rows.append({"source_image": "imgs/missing.png",
                 "target_image": "imgs/missing.png", "instruction": "x"})
    (root / "train.jsonl").write_text("".join(json.dumps(r) + "\n"
                                              for r in rows))
    with open(root / "data_final.pkl", "wb") as f:
        pickle.dump(bio, f)
    return str(root / "train.jsonl"), str(root)


@pytest.mark.parametrize("image_size", [32, 24, 48])
def test_seed_dataset_equals_jax(seed_corpus, image_size):
    jsonl, root = seed_corpus
    kw = dict(image_dir=root, image_size=image_size, condition_size=image_size)
    got, want = (m.SeedDataset(jsonl, **kw) for m in (tdatasets, jdatasets))
    assert len(got) == len(want) == 4
    assert got.descriptions() == want.descriptions()
    for i in range(len(want)):
        _assert_samples_equal(got[i], want[i])


class _PairBase:
    """Side-by-side pair images (16 + 2 padding each side), as the Subjects
    corpus holds them."""

    def __init__(self, n=3):
        from PIL import Image

        rng = np.random.RandomState(1)
        self.items = [{
            "image": Image.fromarray(rng.randint(0, 255, (20, 40, 3),
                                                 np.uint8)),
            "description": {"description_0": f"left {i}",
                            "description_1": f"right {i}"}}
            for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_subject_pair_dataset_equals_jax(drop):
    kw = dict(condition_size=12, target_size=16, image_size=16, padding=2,
              drop_text_prob=drop, drop_image_prob=drop, seed=3)
    got, want = (m.SubjectPairDataset(_PairBase(), **kw)
                 for m in (tdatasets, jdatasets))
    for i in range(len(want)):
        _assert_samples_equal(got[i], want[i])


class _ImgBase:
    def __init__(self, n=4):
        from PIL import Image

        rng = np.random.RandomState(2)
        self.items = [{"jpg": Image.fromarray(rng.randint(0, 255, (30, 26, 3),
                                                          np.uint8)),
                       "json": {"prompt": f"prompt {i}"}} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _fake_depth(img):
    """A stand-in depth estimator (the real one is not ported): gray."""
    return img.convert("L")


@pytest.mark.parametrize("ct", ["canny", "coloring", "deblurring", "fill",
                                "sr", "depth", "depth_pred"])
def test_image_condition_dataset_equals_jax(ct):
    kw = dict(condition_size=24, target_size=32, condition_type=ct,
              drop_text_prob=0.3, drop_image_prob=0.3, position_scale=1.5,
              seed=5, depth_fn=_fake_depth)
    got, want = (m.ImageConditionDataset(_ImgBase(), **kw)
                 for m in (tdatasets, jdatasets))
    for i in range(len(want)):
        _assert_samples_equal(got[i], want[i])


def test_depth_condition_without_estimator_names_the_roadmap(monkeypatch):
    """No depth_fn and no local Depth-Anything checkout: the estimator's
    load fails (the Hugging Face pipeline fallback, replaced by one that
    fails as it does offline) and the row raises its error, as JAX's does.
    The estimator itself is tests/test_torch_depth.py's."""
    import socket

    from loongx_tpu_torch.models import depth as tdepth

    def offline(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(tdepth, "_hf_depth_pipeline", offline)
    # nothing here may leave the machine
    monkeypatch.setattr(socket, "getaddrinfo", offline)
    monkeypatch.setattr(socket.socket, "connect", offline)
    monkeypatch.delenv("LOONGX_DEPTH_MODEL", raising=False)
    tdepth._ESTIMATOR_CACHE.clear()
    ds = tdatasets.ImageConditionDataset(_ImgBase(), condition_type="depth",
                                         device="cpu")
    with pytest.raises(OSError, match="no network"):
        ds[0]
    with pytest.raises(ValueError, match="not implemented"):
        tdatasets.ImageConditionDataset(_ImgBase(), condition_type="warp")[0]


class _CartoonBase:
    def __init__(self):
        from PIL import Image

        rng = np.random.RandomState(4)
        tags = ["lion", "owl", "girl"]

        def img():
            return Image.fromarray(rng.randint(0, 255, (20, 20, 3), np.uint8))

        self.items = [{"tags": [t], "condition": img(), "target": img(),
                       "target_description": {"facing_direction": "left",
                                              "pose": "standing"}}
                      for t in tags]
        self.items[1]["description"] = "given description"

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_cartoon_dataset_equals_jax():
    kw = dict(condition_size=16, target_size=24, drop_text_prob=0.4,
              drop_image_prob=0.4, seed=1)
    got, want = (m.CartoonDataset(_CartoonBase(), **kw)
                 for m in (tdatasets, jdatasets))
    for i in range(len(want)):
        _assert_samples_equal(got[i], want[i])


def test_build_dataset_seed_equals_jax(seed_corpus):
    jsonl, root = seed_corpus
    raw = {"condition_type": "subject", "dataset": {
        "type": "seed", "jsonl_path": jsonl, "image_dir": root,
        "image_size": 24, "condition_size": 24}}
    got = tdatasets.build_dataset(tconfig._build(tconfig.TrainConfig, raw))
    want = jdatasets.build_dataset(jconfig._build(jconfig.TrainConfig, raw))
    assert type(got).__name__ == type(want).__name__ == "SeedDataset"
    _assert_samples_equal(got[1], want[1])
    raw["dataset"]["type"] = "nope"
    with pytest.raises(ValueError, match="nope"):
        tdatasets.build_dataset(tconfig._build(tconfig.TrainConfig, raw))


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


def _descs(module, ds, **kw):
    return [b["description"] for b in module.iterate_batches(
        ds, num_workers=2, epochs=kw.pop("epochs", 2), **kw)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=1, seed=5),
    dict(batch_size=3, seed=0, drop_last=False),
    dict(batch_size=1, seed=5, skip_batches=3),
    dict(batch_size=1, seed=3, host_id=1, num_hosts=2),
    dict(batch_size=2, shuffle=False),
], ids=["order", "ragged", "skip", "host1of2", "unshuffled"])
def test_iterate_batches_equals_jax(seed_corpus, kw):
    jsonl, root = seed_corpus
    ds = tdatasets.SeedDataset(jsonl, image_dir=root, image_size=16)
    got = _descs(tloader, ds, **dict(kw))
    assert got == _descs(jloader, ds, **dict(kw))
    assert got


def test_iterate_batches_collate_equals_jax(seed_corpus):
    jsonl, root = seed_corpus
    ds = tdatasets.SeedDataset(jsonl, image_dir=root, image_size=16)
    got = next(tloader.iterate_batches(ds, 2, seed=1, num_workers=2))
    want = next(jloader.iterate_batches(ds, 2, seed=1, num_workers=2))
    _assert_samples_equal(got, want)


def test_tiny_dataset_raises_as_jax(seed_corpus):
    jsonl, root = seed_corpus
    ds = tdatasets.SeedDataset(jsonl, image_dir=root, image_size=16)
    msgs = []
    for mod in (tloader, jloader):
        with pytest.raises(ValueError, match="drop_last") as exc:
            next(mod.iterate_batches(ds, batch_size=len(ds) + 1,
                                     num_workers=1))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_background_iter_early_close_stops_producer():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = tloader.background_iter(gen(), depth=1)
    for i, _ in enumerate(it):
        if i >= 2:
            break
    it.close()
    n_after_close = len(produced)
    deadline = time.time() + 2.0
    while time.time() < deadline:
        time.sleep(0.2)
        if len(produced) == n_after_close:
            break
        n_after_close = len(produced)
    assert len(produced) < 100


def test_background_iter_reraises_producer_error():
    def gen():
        yield 1
        raise KeyError("boom")

    it = tloader.background_iter(gen())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_prefetch_to_device_cpu(seed_corpus):
    jsonl, root = seed_corpus
    ds = tdatasets.SeedDataset(jsonl, image_dir=root, image_size=16)
    host = list(tloader.iterate_batches(ds, 2, epochs=1, num_workers=1))
    dev = list(tloader.prefetch_to_device(
        tloader.iterate_batches(ds, 2, epochs=1, num_workers=1), device="cpu"))
    assert len(dev) == len(host) == 2
    for h, d in zip(host, dev):
        assert d["description"] == h["description"]
        assert isinstance(d["image"], torch.Tensor)
        np.testing.assert_array_equal(d["image"].numpy(), h["image"])
