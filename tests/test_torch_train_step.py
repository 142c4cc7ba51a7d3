"""The port's training steps (duplex and full) against
repro.train.train_step.

One bridged ``init_state`` and one numpy batch go through both steps.  In
duplex mode the port's runs with ``use_flash=True`` (the plain flash
version on the CPU), JAX's with ``use_flash=False``, since JAX's
transformer cannot run its flash path on a CPU (see
test_torch_transformer.py).  Full mode runs without flash on both sides,
as the reference does: grad through the kernel raises."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duplex as jdx
from repro.models import layers as JL, registry as jreg
from repro.optim import AdamWConfig as JAdamW, SGDConfig as JSGD
from repro.optim import optimizers as jopt, schedule as jsched
from repro.train import losses as jlosses
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.core import duplex as tdx
from repro_torch.models import layers as TL, registry as treg
from repro_torch.optim import AdamWConfig as TAdamW, SGDConfig as TSGD
from repro_torch.optim import optimizers as topt, schedule as tsched
from repro_torch.train import train_step as tts
from repro_torch.utils import tree_flatten, tree_unflatten

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)
ARCHS = ["granite-3-8b", "qwen2-72b", "granite-moe-1b-a400m",
         "llama4-maverick-400b-a17b", "gemma2-9b", "starcoder2-7b",
         "mamba2-780m", "recurrentgemma-9b"]
# the archs of the slices after MoE: gemma2 (local + global layers,
# softcaps, post-norms), starcoder2 (layernorm, ungated gelu MLP), the
# attention-free mamba2 (ssd layers) and the hybrid recurrentgemma (lru
# layers and windowed local ones)
LATER_ARCHS = ["gemma2-9b", "starcoder2-7b", "mamba2-780m",
               "recurrentgemma-9b"]


def _configs(opt="sgd", bfp=None, microbatch=1, arch="granite-3-8b",
             lr=1e-2, mode="duplex", schedule=None, **opt_kw):
    dkw = dict(n_blocks=2, d_branch=32 if bfp else 16, pool_factor=4,
               branch_heads=2)
    jd = jdx.DuplexConfig(**dkw, bfp=JL.BFPPolicy(enabled=bfp is not None,
                                                   group=bfp or (3, 3)))
    td = tdx.DuplexConfig(**dkw, bfp=TL.BFPPolicy(enabled=bfp is not None,
                                                   group=bfp or (3, 3)))
    jo, to = (JSGD(**opt_kw), TSGD(**opt_kw)) if opt == "sgd" else \
        (JAdamW(**opt_kw), TAdamW(**opt_kw))
    jt = jts.TrainConfig(mode=mode, duplex=jd, opt=jo, lr=lr,
                         microbatch=microbatch, backbone_dtype=jnp.float32,
                         lr_schedule=schedule and schedule(jsched))
    tt = tts.TrainConfig(mode=mode, duplex=td, opt=to, lr=lr,
                         microbatch=microbatch, backbone_dtype=torch.float32,
                         lr_schedule=schedule and schedule(tsched))
    jentry, tentry = jreg.get(arch), treg.get(arch)
    tcfg = dc.replace(tentry.smoke, use_flash=mode == "duplex")
    return (jentry, jentry.smoke, jt), (tentry, tcfg, tt)


def _batch(vocab, b=4, s=16, seed=0):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _jax_state(jside, seed=0):
    jentry, jcfg, jt = jside
    st = jax.jit(lambda key: jts.init_state(key, jentry, jcfg, jt, JP32))(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, st)


def _jax_step(jside, state_np, batch, n=1):
    jentry, jcfg, jt = jside
    step = jax.jit(jts.make_train_step(jentry, jcfg, jt, JP32))
    st = jax.tree_util.tree_map(jnp.asarray, state_np)
    for _ in range(n):
        st, m = step(st, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree_util.tree_map(np.asarray, st), \
        {k: float(v) for k, v in m.items()}


def _torch_step(tside, state, batch, n=1):
    tentry, tcfg, tt = tside
    step = tts.make_train_step(tentry, tcfg, tt, TP32)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    ms = []
    for _ in range(n):
        state, m = step(state, tb)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def _assert_state_close(got, want_np, rtol, atol,
                        keys=("branch", "opt", "step")):
    got_np = bridge.to_numpy({k: got[k] for k in keys})
    want = {k: want_np[k] for k in keys}
    gflat, wflat = tree_flatten(got_np), tree_flatten(want)
    assert [p for p, _ in gflat] == [p for p, _ in wflat]
    for (path, g), (_, w) in zip(gflat, wflat):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_bridged_state_has_the_ports_structure(opt):
    jside, tside = _configs(opt)
    bridged = bridge.state_from_jax(_jax_state(jside), "cpu")
    tentry, tcfg, tt = tside
    own = tts.init_state(torch.Generator().manual_seed(0), tentry, tcfg, tt,
                         TP32)
    sig = lambda s: [(p, tuple(x.shape), x.dtype) for p, x in tree_flatten(s)]
    assert sig(bridged) == sig(own)
    assert "step" not in own["opt"]          # AdamW's step comes with update 1


@pytest.mark.parametrize("opt,opt_kw", [
    ("sgd", {}),                                     # momentum 0.9, wd, clip
    ("sgd", dict(nesterov=True, clip_norm=None)),
    ("adamw", {}),
])
def test_one_step_matches_jax(opt, opt_kw):
    jside, tside = _configs(opt, **opt_kw)
    st_np = _jax_state(jside)
    batch = _batch(jside[1].vocab)
    want_state, want_m = _jax_step(jside, st_np, batch)
    got_state, (got_m,) = _torch_step(
        tside, bridge.state_from_jax(st_np, "cpu"), batch)
    for key in ("loss", "accuracy", "grad_norm", "lr"):
        np.testing.assert_allclose(got_m[key], want_m[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    _assert_state_close(got_state, want_state, rtol=1e-5, atol=1e-6)


# BFP (32,32) on the branch: the same 1e-5/1e-6 holds because no mantissa
# or group exponent rounds differently at these inputs (a flip would move an
# operand by a whole group step, 2^(e-4), and fail the comparison).
def test_one_step_with_bfp_matches_jax():
    jside, tside = _configs("sgd", bfp=(32, 32))
    st_np = _jax_state(jside, seed=3)
    batch = _batch(jside[1].vocab, seed=3)
    want_state, want_m = _jax_step(jside, st_np, batch)
    got_state, (got_m,) = _torch_step(
        tside, bridge.state_from_jax(st_np, "cpu"), batch)
    for key in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(got_m[key], want_m[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    _assert_state_close(got_state, want_state, rtol=1e-5, atol=1e-6)


def test_trains_and_freezes_backbone():
    jside, tside = _configs("adamw", arch="qwen2-72b", lr=3e-3,
                            weight_decay=0.0)
    state = bridge.state_from_jax(_jax_state(jside), "cpu")
    before = [t.clone() for _, t in tree_flatten(state["backbone"])]
    state, ms = _torch_step(tside, state, _batch(jside[1].vocab), n=8)
    after = [t for _, t in tree_flatten(state["backbone"])]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    losses = [m["loss"] for m in ms]
    assert losses[-1] < losses[0], losses    # memorizes a fixed batch
    assert int(state["step"]) == 8


@pytest.mark.parametrize("arch,seed", [("granite-moe-1b-a400m", 7),
                                       ("gemma2-9b", 8), ("starcoder2-7b", 8),
                                       ("mamba2-780m", 8),
                                       ("recurrentgemma-9b", 8)])
def test_duplex_sgd_steps_match_jax(arch, seed):
    """3 duplex SGD steps: each step's loss, then the branch and optimizer
    leaves; the frozen backbone (MoE, ssd and lru layers and all) stays as
    it came over.  The port's global layers run the flash path (the plain
    version on the CPU), its local layers the windowed attention; JAX runs
    both without flash."""
    jside, tside = _configs("sgd", arch=arch)
    st_np = _jax_state(jside, seed=seed)
    batch = _batch(jside[1].vocab, seed=seed)
    _, want_state, want_losses = _jax_full_steps(jside, st_np, batch, 3)
    got_state, ms = _torch_step(tside, bridge.state_from_jax(st_np, "cpu"),
                                batch, n=3)
    np.testing.assert_allclose([m["loss"] for m in ms], want_losses,
                               rtol=1e-5, atol=1e-6)
    _assert_state_close(got_state, want_state, rtol=1e-5, atol=1e-6)
    for (p, a), (_, b) in zip(tree_flatten(got_state["backbone"]),
                              tree_flatten(st_np["backbone"])):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=p)


def test_duplex_adamw_on_ssm_backbone_matches_jax():
    """Counterpart of tests/test_train_step.py::test_duplex_on_ssm_backbone:
    the technique applies to attention-free backbones too.  6 AdamW duplex
    steps on mamba2 SMOKE from one bridged init, each loss equal to JAX's,
    and the last below the first."""
    jside, tside = _configs("adamw", arch="mamba2-780m", lr=3e-3,
                            weight_decay=0.0)
    st_np = _jax_state(jside, seed=3)
    batch = _batch(jside[1].vocab, seed=3)
    _, _, want_losses = _jax_full_steps(jside, st_np, batch, 6)
    _, ms = _torch_step(tside, bridge.state_from_jax(st_np, "cpu"), batch,
                        n=6)
    losses = [m["loss"] for m in ms]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", LATER_ARCHS)
def test_forward_and_grad_match_jax(arch):
    """Counterpart of tests/test_arch_smoke.py::test_forward_and_grad: the
    next-token NLL (+ 0.01·aux) of the whole model on one batch, and its
    gradient with respect to every backbone leaf, against JAX's."""
    jcfg, tcfg = jreg.get(arch).smoke, treg.get(arch).smoke
    params = jax.tree_util.tree_map(np.asarray, jreg.get(arch).module
                                    .init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16))

    def jloss(p):
        o = jreg.get(arch).module.forward(p, jcfg, jnp.asarray(tokens),
                                          policy=JP32)
        lg = jreg.get(arch).module.lm_logits(p, jcfg, o["hidden"], JP32)
        lp = jax.nn.log_softmax(lg, axis=-1)
        tgt = jnp.roll(jnp.asarray(tokens), -1, axis=1)
        nll = -jnp.take_along_axis(lp, tgt[..., None], -1).mean()
        return nll + 0.01 * o["aux"]

    want, want_g = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params))
    paths, leaves = zip(*tree_flatten(bridge.to_torch(params, "cpu")))
    leaves = [t.requires_grad_() for t in leaves]
    p = tree_unflatten(list(zip(paths, leaves)))
    tok = torch.from_numpy(tokens).long()
    module = treg.get(arch).module
    o = module.forward(p, tcfg, tok, policy=TP32)
    lp = torch.log_softmax(module.lm_logits(p, tcfg, o["hidden"], TP32), -1)
    tgt = torch.roll(tok, -1, dims=1)
    loss = -torch.gather(lp, -1, tgt[..., None]).mean() + 0.01 * o["aux"]
    got_g = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5,
                               atol=1e-6)
    gmax = 0.0
    for path, w in tree_flatten(jax.tree_util.tree_map(np.asarray, want_g)):
        np.testing.assert_allclose(got_g[path].numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=path)
        gmax = max(gmax, float(np.abs(w).max()))
    assert np.isfinite(gmax) and gmax > 0


def test_microbatch_equals_fullbatch():
    base = dict(lr=1e-2, momentum=0.0, weight_decay=0.0, clip_norm=None)
    _, t1 = _configs("sgd", microbatch=1, **base)
    jside, t4 = _configs("sgd", microbatch=4, **base)
    st_np = _jax_state(jside, seed=2)
    batch = _batch(jside[1].vocab, b=8)
    s1, _ = _torch_step(t1, bridge.state_from_jax(st_np, "cpu"), batch)
    s4, _ = _torch_step(t4, bridge.state_from_jax(st_np, "cpu"), batch)
    for (p, a), (_, b) in zip(tree_flatten(s1["branch"]),
                              tree_flatten(s4["branch"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=p)


# ---------------------------------------------------------------- full mode

FULL_KEYS = ("backbone", "opt", "step")


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_full_state_bridges_leaf_for_leaf(opt):
    jside, (tentry, tcfg, tt) = _configs(opt, mode="full")
    st_np = _jax_state(jside)
    assert set(st_np) == {"step", "backbone", "opt"}
    bridged = bridge.state_from_jax(st_np, "cpu")
    own = tts.init_state(torch.Generator().manual_seed(0), tentry, tcfg, tt,
                         TP32)
    sig = lambda s: [(p, tuple(x.shape), x.dtype) for p, x in tree_flatten(s)]
    assert sig(bridged) == sig(own)
    assert all(x.dtype == torch.float32 and not x.requires_grad
               for _, x in tree_flatten(own["backbone"]))
    for (p, got), (_, want) in zip(tree_flatten(bridged),
                                   tree_flatten(st_np)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=p)


@pytest.mark.parametrize("mode", ["duplex", "full"])
def test_mamba2_state_bridges_leaf_for_leaf(mode):
    """The bridge needs no change for ssd layers: a JAX mamba2 state (duplex
    with a bf16 backbone, as the launcher stores it, ``dt_bias``, ``A_log``
    and ``D`` included; full in f32) crosses over value for value, with the
    structure and dtypes of the port's own init."""
    (je, jc, jt), (te, tc, tt) = _configs("sgd", arch="mamba2-780m",
                                          mode=mode)
    if mode == "duplex":
        jt = dc.replace(jt, backbone_dtype=jnp.bfloat16)
        tt = dc.replace(tt, backbone_dtype=torch.bfloat16)
    st_np = _jax_state((je, jc, jt))
    bridged = bridge.state_from_jax(st_np, "cpu")
    own = tts.init_state(torch.Generator().manual_seed(0), te, tc, tt, TP32)
    sig = lambda s: [(p, tuple(x.shape), x.dtype) for p, x in tree_flatten(s)]
    assert sig(bridged) == sig(own)
    ssd = own["backbone"]["stack"]["sub0"]["ssd"]
    assert ssd["dt_bias"].dtype == tt.backbone_dtype
    for (p, got), (_, want) in zip(tree_flatten(bridge.to_numpy(bridged)),
                                   tree_flatten(st_np)):
        np.testing.assert_array_equal(got, np.asarray(want, got.dtype),
                                      err_msg=p)


def _jax_full_steps(jside, st_np, batch, n):
    """n JAX full steps: the states before each step and the losses."""
    jentry, jcfg, jt = jside
    jstep = jax.jit(jts.make_train_step(jentry, jcfg, jt, JP32))
    st, states, losses = jax.tree_util.tree_map(jnp.asarray, st_np), [], []
    for _ in range(n):
        states.append(jax.tree_util.tree_map(np.asarray, st))
        st, m = jstep(st, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return states, jax.tree_util.tree_map(np.asarray, st), losses


@pytest.mark.parametrize("arch", ARCHS)
def test_full_steps_match_jax(arch):
    """3 full-finetune SGD steps from one bridged init: each step's loss and,
    after them, every backbone and optimizer leaf."""
    jside, tside = _configs("sgd", arch=arch, mode="full", lr=1e-2)
    st_np = _jax_state(jside, seed=4)
    batch = _batch(jside[1].vocab, seed=4)
    _, want_state, want_losses = _jax_full_steps(jside, st_np, batch, 3)
    got_state, ms = _torch_step(tside, bridge.state_from_jax(st_np, "cpu"),
                                batch, n=3)
    np.testing.assert_allclose([m["loss"] for m in ms], want_losses,
                               rtol=1e-5, atol=1e-6)
    assert want_losses[-1] < want_losses[0]
    _assert_state_close(got_state, want_state, rtol=1e-5, atol=1e-6,
                        keys=FULL_KEYS)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_adamw_steps_match_jax(arch):
    """3 full-finetune AdamW steps from one bridged init: each step's loss
    end to end; and at each step's JAX state, the port's gradient of the
    whole backbone and its AdamW update on JAX's gradient, leaf by leaf
    (rtol 1e-5, atol 1e-6 throughout).

    AdamW's first steps normalise each gradient element by about
    |g| + eps, so an element whose gradient is f32 rounding noise (|g| ~
    1e-9 here, from sums that cancel) moves by an lr-sized step in a
    direction set by that noise; the two frameworks round such sums
    differently, so leaves run end to end differ there by up to 4e-4 after
    one step while the losses agree to 1e-6.  The gradient and the update
    are therefore held apart, each on the same inputs."""
    jside, tside = _configs("adamw", arch=arch, mode="full", lr=1e-2)
    jentry, jcfg, jt = jside
    tentry, tcfg, tt = tside
    st_np = _jax_state(jside, seed=4)
    batch = _batch(jside[1].vocab, seed=4)
    states, _, want_losses = _jax_full_steps(jside, st_np, batch, 3)
    _, ms = _torch_step(tside, bridge.state_from_jax(st_np, "cpu"), batch,
                        n=3)
    np.testing.assert_allclose([m["loss"] for m in ms], want_losses,
                               rtol=1e-5, atol=1e-6)

    def jloss(backbone, b):
        out = jentry.module.forward(backbone, jcfg, b["tokens"], policy=JP32)
        logits = jentry.module.lm_logits(backbone, jcfg, out["hidden"], JP32)
        loss, _ = jlosses.lm_cross_entropy(logits, b["labels"],
                                           z_loss=jt.z_loss)
        return loss + jt.aux_weight * out["aux"]

    jgrad = jax.jit(jax.grad(jloss))
    tloss = tts.make_loss_fn(tentry, tcfg, tt, TP32)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for st in states:
        want_g = jax.tree_util.tree_map(np.asarray, jgrad(
            jax.tree_util.tree_map(jnp.asarray, st["backbone"]), jb))
        paths, leaves = zip(*tree_flatten(
            bridge.to_torch(st["backbone"], "cpu")))
        leaves = [t.requires_grad_() for t in leaves]
        loss, _ = tloss(tree_unflatten(list(zip(paths, leaves))), None, tb)
        got_g = dict(zip(paths, torch.autograd.grad(loss, leaves)))
        for p, w in tree_flatten(want_g):
            np.testing.assert_allclose(got_g[p].numpy(), w, rtol=1e-5,
                                       atol=1e-6, err_msg=p)
        lr = float(jt.lr)
        want = jopt.opt_update(jt.opt, jax.tree_util.tree_map(jnp.asarray,
                                                              want_g),
                               jax.tree_util.tree_map(jnp.asarray, st["opt"]),
                               jax.tree_util.tree_map(jnp.asarray,
                                                      st["backbone"]), lr)
        got = topt.opt_update(tt.opt, bridge.to_torch(want_g, "cpu"),
                              bridge.to_torch(st["opt"], "cpu"),
                              bridge.to_torch(st["backbone"], "cpu"),
                              torch.tensor(lr))
        want_np = jax.tree_util.tree_map(np.asarray, want[:2])
        for (p, g), (_, w) in zip(tree_flatten(bridge.to_numpy(
                {"p": got[0], "o": got[1]})), tree_flatten(
                {"p": want_np[0], "o": want_np[1]})):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=p)


def test_full_adamw_trains_moe_backbone():
    """Counterpart of tests/test_train_step.py::test_full_step_trains_backbone:
    AdamW full mode on granite-moe SMOKE, with the aux loss in the
    objective, memorises a fixed batch over 6 steps."""
    jside, tside = _configs("adamw", arch="granite-moe-1b-a400m",
                            mode="full", lr=3e-3, weight_decay=0.0)
    state = bridge.state_from_jax(_jax_state(jside, seed=1), "cpu")
    _, ms = _torch_step(tside, state, _batch(jside[1].vocab), n=6)
    losses = [m["loss"] for m in ms]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_full_microbatch_matches_fullbatch_and_jax():
    _, t1 = _configs("sgd", mode="full")
    jside, t2 = _configs("sgd", mode="full", microbatch=2)
    st_np = _jax_state(jside, seed=5)
    batch = _batch(jside[1].vocab, b=8, seed=5)
    s1, m1 = _torch_step(t1, bridge.state_from_jax(st_np, "cpu"), batch)
    s2, m2 = _torch_step(t2, bridge.state_from_jax(st_np, "cpu"), batch)
    np.testing.assert_allclose(m2[0]["loss"], m1[0]["loss"], rtol=1e-5,
                               atol=1e-6)
    for (p, a), (_, b) in zip(tree_flatten(s1["backbone"]),
                              tree_flatten(s2["backbone"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=p)
    want_state, want_m = _jax_step(jside, st_np, batch)
    np.testing.assert_allclose(m2[0]["loss"], want_m["loss"], rtol=1e-5,
                               atol=1e-6)
    _assert_state_close(s2, want_state, rtol=1e-5, atol=1e-6, keys=FULL_KEYS)


def test_full_step_with_cosine_schedule_matches_jax():
    sched = lambda m: m.cosine_warmup(1e-2, warmup=2, total=10)
    jside, tside = _configs("sgd", mode="full", schedule=sched)
    st_np = _jax_state(jside, seed=6)
    batch = _batch(jside[1].vocab, seed=6)
    want_state, want_m = _jax_step(jside, st_np, batch, n=3)
    got_state, ms = _torch_step(tside, bridge.state_from_jax(st_np, "cpu"),
                                batch, n=3)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(ms[-1][key], want_m[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    _assert_state_close(got_state, want_state, rtol=1e-5, atol=1e-6,
                        keys=FULL_KEYS)


def test_full_mode_with_flash_raises():
    """Full mode differentiates the backbone; the flash kernel is forward
    only, so the step raises, as ``jax.grad`` through it does."""
    jside, (tentry, tcfg, tt) = _configs(mode="full")
    state = bridge.state_from_jax(_jax_state(jside), "cpu")
    step = tts.make_train_step(tentry, dc.replace(tcfg, use_flash=True), tt,
                               TP32)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(jside[1].vocab).items()}
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        step(state, batch)


def test_tap_indices_of_granite():
    np.testing.assert_array_equal(tts.tap_indices(40, 8),
                                  jts.tap_indices(40, 8))
    assert tts.tap_indices(40, 8).tolist() == [0, 6, 11, 17, 22, 28, 33, 39]
