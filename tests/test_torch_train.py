"""The PyTorch port's QLoRA training slice against the JAX package, on CPU.

  * LoRA: `add_lora`'s refusals, `lora_mask`, `lora_state_dict`, and the
    bridge carrying a JAX ``quantize_tree`` + ``add_lora`` tree across;
  * optimizers: Prodigy, AdamW and SGD for three steps on a fixed tree
    against optax (float32 math on both sides; only the order of float32
    sums differs, so rtol 1e-5);
  * the training pieces: encoder dropout fed JAX's own keep masks,
    ``fuse_text_train``, ``flow_match_xt``;
  * the whole step at ``tests/test_train.py``'s narrow seed geometry
    (TestTrainEncoders._seed_setup: full-size CS3 encoders and DGF, a 1 + 1
    block DiT at the real embedding widths), float32, once with bf16 DiT
    weights and once ``quantize_tree``'d: JAX's ``flow_match_loss`` /
    ``make_train_step`` and the port get the same t, noise and dropout
    masks, drawn here with ``jax.random`` exactly as ``step.py:96-111`` and
    ``encoders.py:94-97`` draw them.  The loss, every LoRA gradient and the
    LoRA leaves after two Prodigy steps are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from loongx_tpu.models import encoders as jenc
from loongx_tpu.models import fusion as jfusion
from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.ops import quant as jquant
from loongx_tpu.ops.latents import latent_image_ids as jlatent_ids
from loongx_tpu.ops.schedule import flow_match_xt as jflow_match_xt
from loongx_tpu.train import lora as jlora
from loongx_tpu.train import step as jstep
from loongx_tpu.train.optim import prodigy as jprodigy
from loongx_tpu_torch.models import encoders as tenc
from loongx_tpu_torch.models import fusion as tfusion
from loongx_tpu_torch.models.flux import model as tmodel
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.ops.schedule import flow_match_xt
from loongx_tpu_torch.train import lora as tlora
from loongx_tpu_torch.train import step as tstep
from loongx_tpu_torch.train.optim import Prodigy, build_optimizer
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

TINY = jmodel.FluxConfig.tiny()


def _to_torch(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _tcfg(cfg):
    return tmodel.FluxConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def _torch_init(init, *args, seed=0):
    """Float32 params from one of the port's init functions (a torch seed;
    seconds, where the JAX package's eager inits take tens), as the JAX
    package's arrays: both sides get the same values."""
    g = torch.Generator().manual_seed(seed)
    tree = init(*args, generator=g, dtype=torch.float32, device="cpu")
    return jax.tree.map(jnp.asarray, to_numpy_tree(tree))


@pytest.fixture(scope="module")
def tiny_flux():
    return _torch_init(tmodel.init_flux_params, _tcfg(TINY))


@pytest.fixture(scope="module")
def tiny_qlora(tiny_flux):
    """JAX quantize_tree + add_lora (r 2, alpha 4, float32 factors)."""
    return jlora.add_lora(jax.random.key(1), jquant.quantize_tree(tiny_flux),
                          r=2, alpha=4, dtype=jnp.float32)


@pytest.mark.parametrize("form,match", [
    ("fused_qkv", "fused qkv"), ("split_proj_out", "proj_out K-split"),
    ("dead_target", "never applies"), ("no_match", "no linears matched"),
])
def test_add_lora_refusals_match_jax(tiny_flux, form, match):
    jtree, targets = jquant.quantize_tree(tiny_flux), jlora.DEFAULT_TARGETS
    if form == "fused_qkv":
        jtree = jquant.fuse_qkv_projections(jtree)
    elif form == "split_proj_out":
        jtree = jquant.split_single_proj_out(jtree, TINY.hidden)
    elif form == "dead_target":
        targets = (r"^context_embedder$",)
    else:
        targets = (r"^no_such_layer$",)
    with pytest.raises(ValueError):
        jlora.add_lora(jax.random.key(1), jtree, targets=targets)
    with pytest.raises(ValueError, match=match):
        tlora.add_lora(_to_torch(jtree), targets=targets)
    if form == "dead_target":  # a non-flux caller may opt out of the guard
        out = tlora.add_lora(_to_torch(jtree), targets=targets, appliable=None)
        assert "lora_a" in out["context_embedder"]


def test_add_lora_mask_and_state_dict_match_jax(tiny_flux, tiny_qlora):
    jtree = tiny_qlora
    ttree = tlora.add_lora(_to_torch(jquant.quantize_tree(tiny_flux)), r=2,
                           alpha=4, dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0))
    # same leaves, shapes, dtypes; B = 0 and scale alpha / r as in JAX
    jflat = {k: np.asarray(v) for k, v in jlora.lora_state_dict(jtree).items()}
    tflat = tlora.lora_state_dict(ttree)
    assert set(jflat) == set(tflat)
    for key, want in jflat.items():
        got = to_numpy_tree(tflat[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key.endswith(("lora_b", "lora_scale")):
            np.testing.assert_array_equal(got.astype(np.float32),
                                          want.astype(np.float32), key)
    # the trainable mask is the same tree of booleans
    jmask = jax.tree.map(bool, jlora.lora_mask(jtree))
    assert tlora.lora_mask(ttree) == jmask
    # the original tree is left as it was
    assert "lora_a" not in _to_torch(jquant.quantize_tree(tiny_flux))["x_embedder"]


def test_bridge_carries_quantized_lora_tree(tiny_qlora):
    jtree = jax.tree_util.tree_map_with_path(
        lambda path, x: x.astype(jnp.bfloat16)
        if path[-1].key in ("lora_a", "lora_b") else x, tiny_qlora)
    back = to_numpy_tree(_to_torch(jtree))
    jnp_tree = jax.tree.map(np.asarray, jtree)
    assert jax.tree.structure(back) == jax.tree.structure(jnp_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


def test_init_training_builds_the_jax_training_layout(tiny_qlora):
    pipe = LoongXPipeline.init_training(_tcfg(TINY), seed=0, device="cpu")
    want = tiny_qlora
    got = pipe.params["flux"]
    assert jax.tree.structure(jax.tree.map(lambda _: 0, to_numpy_tree(got))) \
        == jax.tree.structure(jax.tree.map(lambda _: 0, want))
    assert got["double_blocks"]["attn"]["to_q"]["kernel_q"].dtype == torch.int8
    assert "to_qkv" not in got["double_blocks"]["attn"]
    assert "proj_out_mlp" not in got["single_blocks"]
    assert set(pipe.params) == {"flux", "encoders", "dgf"}
    assert pipe.device.type == "cpu"


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _opt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}


def _run_pair(jopt, topt_factory, steps=3):
    tree = _opt_tree()
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape)
                          .astype(np.float32), tree) for _ in range(steps)]
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = [torch.from_numpy(x.copy()) for x in jax.tree.leaves(tree)]
    topt = topt_factory(tparams)
    for g in grads:
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, gl in zip(tparams, jax.tree.leaves(g)):
            p.grad = torch.from_numpy(gl)
        topt.step()
        for p, w in zip(tparams, jax.tree.leaves(jparams)):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7)
    return jstate, topt


@pytest.mark.parametrize("kw", [
    dict(lr=0.1, weight_decay=0.01, use_bias_correction=True,
         safeguard_warmup=True),
    dict(lr=1.0),
])
def test_prodigy_matches_jax(kw):
    jkw = dict(kw)
    jkw["learning_rate"] = jkw.pop("lr")
    jstate, topt = _run_pair(jprodigy(**jkw), lambda ps: Prodigy(ps, **kw))
    np.testing.assert_allclose(float(topt.d), float(jstate.d), rtol=1e-5)
    for st in topt.state.values():
        assert all(st[n].dtype == torch.float32 for n in ("mu", "nu", "s"))


def test_prodigy_moves_d_and_keeps_bf16_params():
    """A bf16 leaf stays bf16 (the update is cast before the add) and d
    grows once the iterates move."""
    p = torch.full((64,), 0.5, dtype=torch.bfloat16)
    opt = Prodigy([p], lr=1.0, d0=1e-3)
    for i in range(6):
        p.grad = torch.full((64,), 1.0, dtype=torch.bfloat16)
        opt.step()
    assert p.dtype == torch.bfloat16 and float(p[0]) < 0.5
    assert float(opt.d) > 1e-3


@pytest.mark.parametrize("typ,params,jopt", [
    ("AdamW", dict(lr=1e-2), optax.adamw(1e-2, weight_decay=0.0)),
    ("AdamW", dict(lr=1e-2, weight_decay=0.1), optax.adamw(1e-2, weight_decay=0.1)),
    ("SGD", dict(lr=0.1), optax.sgd(0.1)),
])
def test_build_optimizer_matches_optax(typ, params, jopt):
    factory = build_optimizer({"type": typ, "params": params})
    _run_pair(jopt, factory)


# ---------------------------------------------------------------------------
# Training pieces: dropout, fusion, interpolant
# ---------------------------------------------------------------------------


def _dropout_masks(key, b, widths):
    """The keep masks `_apply_mlp_ln_relu` draws from ``key`` (one split per
    layer, bernoulli(0.7))."""
    masks = []
    for width in widths:
        key, sub = jax.random.split(key)
        masks.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 0.7, (b, width)))))
    return masks


ENC_WIDTHS = {"eeg": (2048, 4096), "ppg": (1024, 4096), "fnirs": (1024, 768),
              "motion": (512, 768)}
ENC_SHAPES = {"eeg": (1, 4, 4096), "ppg": (1, 4, 256), "fnirs": (1, 6, 512),
              "motion": (1, 6, 128)}


@pytest.mark.parametrize("name", ["fnirs", "motion"])
def test_encoder_dropout_matches_jax(name):
    """The whole-step test below covers EEG and PPG with JAX's masks too."""
    jparams = _torch_init(getattr(tenc, f"init_{name}_encoder"), seed=3)
    x = np.random.default_rng(4).standard_normal(ENC_SHAPES[name]).astype(np.float32)
    key = jax.random.key(5)
    want = getattr(jenc, f"{name}_encode")(jparams, jnp.asarray(x), rng=key)
    tparams = _to_torch(jparams)
    got = getattr(tenc, f"{name}_encode")(
        tparams, torch.from_numpy(x),
        dropout=_dropout_masks(key, 1, ENC_WIDTHS[name]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    # a generator draws its own masks: about 30 % of the live units dropped
    proj = tparams["proj"]
    h = torch.randn(64, proj["linear_0"]["kernel"].shape[0],
                    generator=torch.Generator().manual_seed(1))
    alive = tenc._apply_mlp_ln_relu(proj, h, 1) > 0
    drawn = tenc._apply_mlp_ln_relu(proj, h, 1, torch.Generator().manual_seed(0))
    assert 0.25 < float((drawn[alive] == 0).float().mean()) < 0.35


@pytest.mark.parametrize("with_pooled", [True, False])
def test_fuse_text_train_matches_jax(with_pooled):
    dgf = _torch_init(tfusion.init_dgf, seed=6)
    rng = np.random.default_rng(7)
    prompt, pooled, brain = (rng.standard_normal(s).astype(np.float32) * 0.1
                             for s in ((1, 512, 4096), (1, 768), (1, 512, 4096)))
    bpool = rng.standard_normal((1, 768)).astype(np.float32) if with_pooled else None
    want = jfusion.fuse_text_train(dgf, *(jnp.asarray(a) for a in (prompt, pooled, brain)),
                                   None if bpool is None else jnp.asarray(bpool))
    got = tfusion.fuse_text_train(
        _to_torch(dgf), *(torch.from_numpy(a) for a in (prompt, pooled, brain)),
        None if bpool is None else torch.from_numpy(bpool))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)
    if not with_pooled:
        np.testing.assert_array_equal(got[1].numpy(), pooled)


def test_flow_match_xt_matches_jax():
    rng = np.random.default_rng(8)
    x0, x1 = (rng.standard_normal((2, 6, 4)).astype(np.float32) for _ in range(2))
    t = rng.uniform(size=2).astype(np.float32)
    want = jflow_match_xt(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(t))
    got = flow_match_xt(*(torch.from_numpy(a) for a in (x0, x1, t)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------

SEED_CFG = jmodel.FluxConfig(
    in_channels=16, num_heads=2, head_dim=32, num_double_blocks=1,
    num_single_blocks=1, joint_dim=4096, pooled_dim=768, axes_dims=(8, 12, 12))
FLAGS = {"latent_lora": False, "union_cond_attn": True}
PRODIGY = dict(lr=0.1, weight_decay=0.01, use_bias_correction=True,
               safeguard_warmup=True)


@pytest.fixture(scope="module")
def seed_base():
    """TestTrainEncoders._seed_setup's geometry plus a condition stream."""
    def init(generator, dtype, device):
        kw = dict(generator=generator, dtype=dtype, device=device)
        return {
            "flux": tmodel.init_flux_params(_tcfg(SEED_CFG), **kw),
            "encoders": {name: getattr(tenc, f"init_{name}_encoder")(**kw)
                         for name in ("eeg", "ppg", "fnirs", "motion")},
            "dgf": tfusion.init_dgf(**kw),
        }
    rng = np.random.RandomState(0)
    batch = {
        "x0": rng.randn(1, 16, 16).astype(np.float32),
        "cond_tokens": rng.randn(1, 16, 16).astype(np.float32),
        "img_ids": np.array(jlatent_ids(8, 8)),
        "cond_ids": np.array(jlatent_ids(8, 8)),
        "txt_ids": np.zeros((512, 3), np.float32),
        "prompt_embeds": (rng.randn(1, 512, 4096) * 0.1).astype(np.float32),
        "pooled": (rng.randn(1, 768) * 0.1).astype(np.float32),
        "eeg": rng.randn(1, 4, 4096).astype(np.float32),
        "ppg": rng.randn(1, 4, 256).astype(np.float32),
        "fnirs": rng.randn(1, 6, 512).astype(np.float32),
        "motion": rng.randn(1, 6, 128).astype(np.float32),
    }
    return _torch_init(init), batch


def _seed_params(base, quantized: bool):
    """The JAX training tree: the flux tree in bf16, or ``quantize_tree``'d
    for the int8 variant, plus JAX ``add_lora`` (r 2, float32) with lora_b
    moved off zero so both factors have gradients from the first step."""
    flux = base["flux"]
    if quantized:
        flux = jquant.quantize_tree(flux)
    else:
        flux = jax.tree.map(lambda x: x.astype(jnp.bfloat16), flux)
    flux = jlora.add_lora(jax.random.key(1), flux, r=2, dtype=jnp.float32)

    def nudge(path, x):
        if path[-1].key == "lora_b":
            r = np.random.default_rng(x.size)
            return x + jnp.asarray(0.05 * r.standard_normal(x.shape), x.dtype)
        return x

    return dict(base, flux=jax.tree_util.tree_map_with_path(nudge, flux))


def _jax_draws(key, x0_shape):
    """The port's explicit draws for one JAX step key (step.py:96-111)."""
    k_t, k_noise, k_drop = jax.random.split(key, 3)
    t = jax.nn.sigmoid(jax.random.normal(k_t, (x0_shape[0],), jnp.float32))
    x1 = jax.random.normal(k_noise, x0_shape, jnp.float32)
    dropout = {name: _dropout_masks(k, x0_shape[0], ENC_WIDTHS[name])
               for name, k in zip(("eeg", "ppg", "fnirs", "motion"),
                                  jax.random.split(k_drop, 4))}
    return {"t": torch.from_numpy(np.array(t)),
            "noise": torch.from_numpy(np.array(x1)), "dropout": dropout}


def _grad_recorder():
    """An optax transformation that passes the updates through and keeps
    the last ones (the raw gradients, first in a chain) as its state."""
    return optax.GradientTransformation(
        lambda params: params, lambda updates, state, params=None: (updates, updates))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_train_step_matches_jax(seed_base, quantized):
    base, batch = seed_base
    params = _seed_params(base, quantized)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = [jax.random.key(10), jax.random.key(11)]
    trainable, frozen = jstep.partition(params, jstep.trainable_mask(params))

    jkw = dict(PRODIGY)
    jkw["learning_rate"] = jkw.pop("lr")
    # make_train_step's own chain (clip 0.5, then Prodigy) behind a
    # pass-through that keeps the raw gradients in its state: one compile
    init_fn, step_fn = jstep.make_train_step(
        SEED_CFG, optax.chain(_grad_recorder(), optax.clip_by_global_norm(0.5),
                              jprodigy(**jkw)),
        flags=FLAGS, use_brain_condition=True, fuse_flag=True,
        attn_backend="xla", remat=False, grad_clip=None, dtype=jnp.float32)
    jstate = init_fn(trainable)
    jit_step = jax.jit(step_fn)
    jmetrics, jgrads = [], None
    for key in keys:
        jstate, m = jit_step(jstate, frozen, jbatch, key)
        jmetrics.append(m)
        if jgrads is None:
            jgrads = jstate.opt_state[0]
    jloss = jmetrics[0]["loss"]

    # the port: the same tree, batch and draws (remat on for the int8 tree)
    tparams = _to_torch(params)
    ttr, tfr = tstep.partition(tparams, tstep.trainable_mask(tparams))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = [_jax_draws(k, batch["x0"].shape) for k in keys]
    tcfg = _tcfg(SEED_CFG)
    loss, _ = tstep.flow_match_loss(
        tstep.combine(ttr, tfr), tcfg, tbatch, draws[0], FLAGS, True, True,
        remat=quantized, dtype=torch.float32)
    tlora_leaves = tlora.lora_state_dict(ttr["flux"])
    tgrads = torch.autograd.grad(loss, list(tlora_leaves.values()))
    # float32 end to end; the two frameworks sum in other orders
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jg = jlora.lora_state_dict(jgrads["flux"])
    assert set(jg) == set(tlora_leaves)
    for key, g in zip(tlora_leaves, tgrads):
        want = np.asarray(jg[key])
        if not np.abs(want).max() > 0:
            # a structural zero: the last single block's q/k LoRA acts only
            # on condition rows, which the velocity never reads
            np.testing.assert_array_equal(g.numpy(), want, key)
            continue
        assert _rel_l2(g.numpy(), want) < 1e-4, (key, _rel_l2(g.numpy(), want))

    init_t, step_t = tstep.make_train_step(
        tcfg, build_optimizer({"type": "Prodigy", "params": PRODIGY}),
        flags=FLAGS, use_brain_condition=True, fuse_flag=True,
        remat=quantized, dtype=torch.float32)
    before = {k: v.detach().clone() for k, v in tlora_leaves.items()}
    state = init_t(ttr)
    for i, d in enumerate(draws):
        state, m = step_t(state, tfr, tbatch, d)
        for name in ("loss", "grad_norm", "t_mean"):
            np.testing.assert_allclose(float(m[name]), float(jmetrics[i][name]),
                                       rtol=1e-4, err_msg=name)
    assert state.step == 2
    jafter = jlora.lora_state_dict(jstate.trainable["flux"])
    jbefore = jlora.lora_state_dict(trainable["flux"])
    for key, leaf in tlora.lora_state_dict(state.trainable["flux"]).items():
        moved = leaf.detach().numpy() - before[key].numpy()
        want = np.asarray(jafter[key]) - np.asarray(jbefore[key])
        if not np.abs(want).max() > 0:
            np.testing.assert_array_equal(moved, want, key)
            continue
        # Prodigy's first steps are near sign(g) * dlr: a coordinate whose
        # gradient the two frameworks round to opposite signs moves the
        # other way, so the updates are compared as a whole
        assert _rel_l2(moved, want) < 1e-3, (key, _rel_l2(moved, want))
