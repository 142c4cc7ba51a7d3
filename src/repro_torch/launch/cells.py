"""Cell construction shared by the launchers (counterpart of
``repro/launch/cells.py``).

A cell is one (arch, shape) pair of ``registry.cells()`` in one variant:
``baseline`` (the registry config), ``tuned`` (``tuned_cfg`` level 1 and
the ``fsdp_pure`` layout for training) or ``tuned2`` (level 2, and an fp8
backbone for training).  ``build_cell`` allocates nothing: its arguments
are tensors on the ``meta`` device, the counterpart of the reference's
``jax.ShapeDtypeStruct``s, and its shardings ``NamedSharding``s on the
mesh it is given, an ``AbstractMesh`` or a ``DeviceMesh``.  A caller that
runs a cell draws its arguments on a device of its own from the returned
``cfg`` through the port's inits.
"""
from __future__ import annotations

import dataclasses as dc
import functools

import torch

from repro_torch.configs.common import ShapeSpec
from repro_torch.core import duplex as dx
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models import layers as L, registry
from repro_torch.optim import SGDConfig
from repro_torch.train import serve_step as ss, train_step as ts
from repro_torch.utils import tree_map

POLICY = L.Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def duplex_tcfg(cfg, backbone_dtype=torch.bfloat16) -> ts.TrainConfig:
    """Production duplex config: branch width scales with the backbone.
    ``backbone_dtype=torch.float8_e4m3fn`` stores the frozen backbone in 8
    bits; compute still upcasts it at use."""
    d_branch = max(256, cfg.d_model // 8)
    n_blocks = max(2, min(8, cfg.n_rep))
    return ts.TrainConfig(
        mode="duplex",
        duplex=dx.DuplexConfig(
            n_blocks=n_blocks, d_branch=d_branch, pool_factor=16,
            branch_heads=max(4, d_branch // 128),
            bfp=L.BFPPolicy(enabled=True, group=(32, 32))),
        opt=SGDConfig(), lr=1e-3, backbone_dtype=backbone_dtype)


def activation_rules(cfg, mesh, fsdp_pure: bool = False) -> dict:
    """Per-arch activation specs, ``{name: spec}``, for
    ``distributed.ctx.activation_sharding``.

    Heads divide TP → shard the flat query-head axis; otherwise fall back to
    sequence parallelism (q sharded on seq, kv replicated and all-gathered).
    ``fsdp_pure``: the batch dim spreads over ALL mesh axes and nothing else
    is sharded.
    """
    tp = sh.mesh_shape(mesh)["model"]
    if fsdp_pure:
        dpm = sh.dp_axes(mesh, include_model=True)
        return {"resid": P(dpm, None, None),
                "act_q": P(dpm, None, None, None),
                "act_kv": P(dpm, None, None, None),
                "act_lru": P(dpm, None, None)}
    dp = sh.dp_axes(mesh)
    rules = {"resid": P(dp, None, None),
             "act_lru": P(dp, None, "model"),
             # decode scores follow the seq-sharded KV cache
             "dec_scores": P(dp, None, None, "model")}
    if cfg.n_heads and cfg.n_heads % tp == 0:
        rules["act_q"] = P(dp, None, "model", None)
        rules["act_kv"] = P(dp, None,
                            "model" if cfg.n_kv % tp == 0 else None, None)
    elif cfg.n_heads:
        rules["act_q"] = P(dp, "model", None, None)      # sequence parallel
        rules["act_kv"] = P(dp, None, None, None)
    return rules


def input_specs(arch: str, shape: ShapeSpec, mesh, fsdp_pure: bool = False):
    """``(batch, shardings)`` of one cell: ``meta`` tensors (int32 tokens
    and labels, the stub frontend in bf16) and their ``NamedSharding``s.
    Decode takes one new token, ``tokens`` [B, 1], against a cache of
    ``seq_len``."""
    entry = registry.get(arch)
    cfg = entry.full
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    def batch_sharding(tree):
        return sh.to_named(tree_map(
            lambda x: sh.batch_pspec(tuple(x.shape), mesh,
                                     include_model=fsdp_pure), tree), mesh)

    fe_shapes = entry.frontend_shape(cfg, b)
    frontend = None if fe_shapes is None else {
        k: sds(v, torch.bfloat16) for k, v in fe_shapes.items()}

    if shape.mode == "decode":
        tokens = {"tokens": sds((b, 1))}
        return tokens, batch_sharding(tokens)
    batch = {"tokens": sds((b, s))}
    if shape.mode == "train":
        batch["labels"] = sds((b, s))
    if frontend is not None:
        batch["frontend"] = frontend
    return batch, batch_sharding(batch)


def tuned_cfg(cfg, level: int = 1):
    """The 'tuned' model-config overrides (baseline = registry config)."""
    over = dict(causal_skip=True,
                lru_scan_chunk=4096 if cfg.lru_width else None)
    if level >= 2:
        # fewer, fatter attention chunks: kv re-reads scale with n_q_chunks
        over.update(q_chunk=1024, kv_chunk=2048)
    return dc.replace(cfg, **over)


def build_cell(arch: str, shape: ShapeSpec, mesh, variant: str = "baseline"):
    """Returns ``(fn, example_args, in_shardings, out_shardings, donate,
    cfg, fsdp_pure)``: the step, its arguments on ``meta``, their
    ``NamedSharding``s, ``None`` (the outputs' layout is left to the
    runtime), the argument positions the step may overwrite, the cell's
    model config and whether its layout is ``fsdp_pure``.

    train: ``fn(state, batch)``, the duplex step (an fp8 backbone at
    ``tuned2``); prefill: ``fn(params, batch)`` with a cache of ``seq_len +
    64`` and the logits of every position (baseline) or the last
    (tuned); decode: ``fn(params, cache, tokens)``, one greedy token
    against a bf16 cache of ``seq_len``."""
    entry = registry.get(arch)
    level = {"baseline": 0, "tuned": 1, "tuned2": 2}[variant]
    cfg = entry.full if level == 0 else tuned_cfg(entry.full, level)
    b, s = shape.global_batch, shape.seq_len
    tuned = level >= 1
    # fsdp_pure: frozen-backbone training of non-MoE archs (EP needs TP)
    fsdp_pure = tuned and shape.mode == "train" and cfg.n_experts == 0
    pspec = functools.partial(sh.param_pspec, fsdp_pure=fsdp_pure,
                              lru_gates_colparallel=tuned)
    gen = torch.Generator()          # nothing is drawn on meta

    if shape.mode == "train":
        tcfg = duplex_tcfg(cfg, backbone_dtype=(
            torch.float8_e4m3fn if level >= 2 else torch.bfloat16))
        state_shapes = ts.init_state(gen, entry, cfg, tcfg, POLICY,
                                     device="meta")
        state_specs = sh.to_named(
            sh.state_pspecs(state_shapes, mesh, pspec=pspec), mesh)
        batch, batch_specs = input_specs(arch, shape, mesh, fsdp_pure)
        fn = ts.make_train_step(entry, cfg, tcfg, POLICY)
        return (fn, (state_shapes, batch), (state_specs, batch_specs),
                None, (0,), cfg, fsdp_pure)

    params_shapes = entry.module.init_params(gen, cfg, device="meta")
    param_specs = sh.to_named(sh.tree_pspecs(params_shapes, mesh, pspec),
                              mesh)

    if shape.mode == "prefill":
        batch, batch_specs = input_specs(arch, shape, mesh)
        step = ss.make_prefill_step(entry, cfg, max_len=s + 64, policy=POLICY,
                                    logits_mode="last" if tuned else "all")

        def fn(params, batch):
            return step(params, batch["tokens"], batch.get("frontend"))

        return (fn, (params_shapes, batch), (param_specs, batch_specs),
                None, (), cfg, False)

    cache_shapes = entry.module.init_cache(cfg, batch=b, max_len=s,
                                           dtype=torch.bfloat16,
                                           device="meta")
    cache_specs = sh.to_named(
        sh.tree_pspecs(cache_shapes, mesh, sh.cache_pspec), mesh)
    tokens, tok_specs = input_specs(arch, shape, mesh)
    step = ss.make_decode_step(entry, cfg, policy=POLICY)

    def fn(params, cache, tokens):
        return step(params, cache, tokens["tokens"])

    return (fn, (params_shapes, cache_shapes, tokens),
            (param_specs, cache_specs, tok_specs), None, (1,), cfg, False)
