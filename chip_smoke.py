"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of their own:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and a few small ones, with times (kernel, plain version,
     one library call as a yardstick) and the bound the card sets
     (``flash_check`` lines; ``bfp_check`` lines at the JAX tests' shapes,
     and for the two stages of each BFP product, the operand passes
     bit-exact and the GEMM, on ragged shapes and transposed views);
  4. the BFP path, ``kernels/ops.py``: ``bfp_dense`` forward and backward
     on granite-3-8b's MLP up-projection at full width (x [2,4096,4096],
     w [4096,12800], group 32), quantize + packed product on the same
     operands, and the duplex branch's up-projection; counts zeroed just
     before and read just after, every result held against the plain
     versions, the operand passes at full width bit for bit, then each BFP
     kernel timed, each product also by stage (``prepass_ms`` for the two
     operand passes, ``gemm_ms``) beside the bf16 ceiling 2MKN / 989e12,
     and ``bfp_dense`` forward + backward timed as a whole
     (``bfp_path``/``bfp_time`` lines);
     all of it freed before the next phase;
  5. the duplex path: ``repro_torch.launch.train`` trains granite-3-8b at full
     width (random weights from a seed, bf16 backbone, flash kernel on) for
     3 duplex steps at batch 2 x 4096 tokens; the launch counts are zeroed
     just before and read just after; the loss must be finite, the branch
     must move and the backbone's checksum must not; the flash path's loss
     is then held against the plain attention path's on the same state;
     the step launches no BFP kernel (its branch quantizes by fake-quant,
     as the reference's does); each path frees its state before the next,
     so that each peak stands alone;
  6. ``f1_check`` (run before the BFP path): the kernel wrappers refuse
     autograd on the card as on the CPU -- flash on bf16 CUDA tensors that
     require grad and ``ops.matmul`` raise under grad mode, and both launch
     under ``torch.no_grad()``; then ``ssd_check``: mamba2-780m's SSD in
     f32 at its head shape (H=48, P=64, N=128, chunk 256), B=1, S=1024:
     the chunked scan against the recurrent oracle (y and the final
     state), and one full-width ``ssd_block`` on the card against the same
     block on the CPU, both at rtol = atol = 1e-4, with their times; then
     ``lru_check``: recurrentgemma-9b's RG-LRU block (``models/hybrid.py``,
     d 4096, lru width 4096) in f32, B=2, S=4096: the odd-even scan against
     the step-by-step oracle, with and without a carried state, and the
     chunked scan (chunks 4096 and 256) against the full one, at 1e-4; the
     scan's gradients (x, ``wr``, ``wi``, Λ; B=1, S=1024) against the
     oracle's at 1e-4 of each leaf's scale; one block on the card against
     the CPU (B=1, S=1024); a 1024-token prefill and 32 decode steps against
     the stateless block at 2e-4; the scan's, the block's (f32, bf16, bf16
     forward + backward with its peak) and a decode step's times beside
     their bounds; no kernel launched;
  7. ``full_path``: the full finetune (the paper's FR baseline) on
     granite-3-8b at full width, depth cut to 8 of 40 layers (f32 params,
     gradients and SGD momentum of 40 layers need 98 GB), bf16 compute,
     flash off, B=4 x S=1024, 3 steps through ``train.loop``; loss and time
     per step (``full_step`` lines), peak memory beside the duplex path's,
     the backbone checksum before and after (must differ), no kernel
     launched; then one more step under the profiler (``full_profile``
     lines);
  8. ``moe_path``: the duplex step of phase 5 on granite-moe-1b-a400m at
     full width and depth (24 layers, 32 experts top-8, group 4096,
     capacity 1280), flash on, B=2 x S=4096, 3 steps through the launcher:
     72 flash launches and no BFP launch, each step's backbone aux loss
     (``moe_step`` lines), the first MoE layer's dropped share and the time
     of its routing and of the whole layer (``moe_route``), the flash loss
     against plain attention, one step profiled (``moe_profile`` lines);
     then ``moe_full_path``: the FR step of phase 7 on the same model, not
     cut (``moe_full_step``, ``moe_full_profile`` lines), which must move
     the first layer's router and experts and carry ``aux_weight·aux`` in
     its objective (``moe_full_aux``); then ``moe_top1_path``:
     llama4-maverick-400b-a17b at full width, depth cut to 1 of 48 layers
     (128 experts top-1 + a shared expert, 34.7 GB of bf16 backbone), the
     duplex step with flash on, B=2 x S=4096, 2 steps: finite losses, one
     flash launch a step, the frozen backbone unchanged, and the share of
     (token, pass) assignments its MoE layer dropped (``moe_top1_*``);
  9. ``gemma2_path`` and ``starcoder2_path``: the duplex step of phase 5 on
     gemma2-9b (42 layers alternating sliding-window ``local`` and global
     ``attn``, head dim 256, softcaps 50 and 30, post-norms) and
     starcoder2-7b (32 layers, GQA 36/4, layernorm, ungated gelu MLP, qkv
     bias) at full width and depth, B=2 x S=4096, 3 steps: 21 and 32 flash
     launches a step (the ``attn`` layers; ``local`` layers keep their
     window on the blockwise path), the flash loss against plain
     attention, one step profiled, and gemma2's time per layer kind
     (``gemma2_attention``); between them ``gemma2_full_path``: the FR step
     of phase 7 on gemma2-9b at full width, depth cut to 4 of 42 layers
     (two of each kind), B=1 x S=2048, so that both kinds run the
     blockwise path backward, and the softcapped unembedding too;
  10. ``mamba2_path``: the duplex step of phase 5 on mamba2-780m (48
     attention-free ``ssd`` layers, d 1536, 48 heads of 64, state 128,
     chunk 256) at full width and depth, B=2 x S=4096, 3 steps: no kernel
     launch (no ``attn`` layer, so the plain-attention check is skipped
     with a line that says so), one step profiled, and the time of one
     ``ssd_block`` and of its chunked scan with their shares of the step
     (``mamba2_mixers``); then ``mamba2_full_path``: the FR step of phase 7
     on mamba2-780m at full width, B=4 x S=1024, depth cut to the deepest
     count whose peak, reckoned from the measured peaks of 2- and 4-layer
     cuts, stays under 75 GB (``mamba2_full_reckon``); of that draw it keeps
     the layers below the first, if any, whose largest exponent in the
     scan's masked exp passes log(f32 max) at init, where the backward of
     the reference's ``where`` after the exp is NaN
     (``mamba2_full_exponents``); the path must move
     layer 0's ``x_proj``, ``A_log``, ``dt_bias`` and ``conv_x``
     (``mamba2_full_moved``);
  11. ``whisper_path``: the duplex step of phase 5 on whisper-base at full
     width and depth (6 encoder and 12 decoder layers, d 512, 8 heads of
     64; the decoder alternates causal ``attn`` layers with ``cross``
     layers over the encoder's output) with the launcher's stub frames
     [2, 1500, 512] in bf16, B=2 x S=4096, 3 steps: 6 flash launches a step
     (the decoder's ``attn`` layers; the encoder keeps flash off and the
     cross layers never take it: both run the blockwise f32 path), the
     flash loss against plain attention with the same frames, one step
     profiled, and one encoder layer's, one cross layer's and one decoder
     ``attn`` layer's attention time and share of the step
     (``whisper_attention``); then ``whisper_full_path``: the FR step of
     phase 7 on whisper-base whole, B=4 x S=1024, with frames, which must
     move layer 0's encoder ``attn/wq`` and decoder cross layer's
     ``attn/wk`` and ``mlp/wi`` (``whisper_full_moved``); then
     ``vision_path``: llama-3.2-vision-90b at full width, depth cut to one
     superblock, 5 of 100 layers (4 ``attn`` + 1 ``cross``, 5.33 G params,
     10.66 GB in bf16), the duplex step with flash on and the launcher's
     stub ``cross_kv`` [2, 1600, 8192] in bf16, B=2 x S=4096, 2 steps: 4
     flash launches a step, the flash loss against plain attention, and a
     line saying why its FR step is not run (f32 params, gradients and
     momentum of one superblock alone are 63.9 GB); then
     ``vision_causality``: on that final state, token 4000 of the first
     batch changed, the largest change of the hidden state at positions
     0-3999 with the stub frontend (must be 0) and without one (printed:
     the reference's cross layer then attends to its own input,
     non-causally); then ``recurrentgemma_path``: the duplex step of phase
     5 on recurrentgemma-9b at full width and depth (38 layers, 12 x
     (``lru``, ``lru``, ``local``) + (``lru``, ``lru``), d 4096, MQA at
     head dim 256, window 2048, shorter than S, so the window masks keys),
     B=2 x S=4096, 3 steps: no kernel launch (no ``attn`` layer), one step
     profiled, the time of one ``lru_block`` and of its odd-even scan with
     their shares of the step over all 26 ``lru`` layers
     (``recurrentgemma_mixers``), and the ``local`` layers' attention time
     and share (``recurrentgemma_attention``); then
     ``recurrentgemma_window``: the first ``local`` sublayer of that final
     backbone in f32, B=1, S=4096, position 0 of its input changed: the
     largest change of its output at positions 2048-4095 must be exactly 0
     and at some position in 1-2047 not 0; then
     ``recurrentgemma_full_path``: the FR step of phase 7 on
     recurrentgemma-9b at full width, B=1 x S=4096, depth reckoned from the
     measured peaks of 5- and 8-layer cuts and rounded down to the pattern
     (``recurrentgemma_full_reckon``; no ``ssd`` layer, so
     ``recurrentgemma_full_exponents`` keeps the whole draw), which must
     move layer 0's ``lru/wx``, ``lru/lambda``, ``lru/conv_w`` and the
     first ``local`` layer's ``attn/wq`` (``recurrentgemma_full_moved``);
  12. serving, ROADMAP §1 items 3(a) to 3(d): ``decode_check``,
     one layer's decode step at full width, f32, on the card against the
     CPU (output and v at 1e-4, the written k slot at 1e-3 beside rope's
     angle difference there, every other k slot equal, ``len`` and ``pos``
     exact): ``attn``, granite-3-8b's layer, B=4, ``attention_decode``
     over a 2088-slot cache holding 2047 tokens; ``ring``, gemma2-9b's
     ``local`` layer (window 4096, softcap 50, head dim 256), B=2,
     ``_ring_decode`` over a 4096-slot ring holding positions 512-4607;
     ``ssd``, mamba2-780m's ``ssd_block`` (d 1536, 48 heads of 64, state
     128), B=4, one step from a seeded state (output and every state leaf
     at 1e-4); ``cross``, llama-3.2-vision-90b's cross layer (64 heads, kv
     8, head dim 128), B=2, ``_cross_decode`` over a seeded 1600-slot cross
     cache (output at 1e-4, the cache bit for bit unchanged); ``lru``,
     recurrentgemma-9b's ``lru`` sublayer (d 4096, its MLP too), B=2, a
     256-token prefill from the zero state and 8 decode steps (every
     output, and ``h`` and ``conv`` after the last, at 1e-4);
     ``serve_check`` (granite-3-8b, B=4, 2048 tokens),
     ``gemma2_serve_check`` (gemma2-9b, B=2, 4608 tokens, so every local
     ring has wrapped), ``mamba2_serve_check`` (mamba2-780m, B=4, 2048
     tokens, its position in the cache's ``step``), ``whisper_serve_check``
     (whisper-base, B=8, 384 tokens over the launcher's stub frames [8,
     1500, 512]), ``vision_serve_check`` (llama-3.2-vision-90b cut to
     one superblock, B=2, 2048 tokens over a stub ``cross_kv`` [2, 1600,
     8192]) and ``recurrentgemma_serve_check`` (recurrentgemma-9b, B=2,
     4608 tokens, so every local ring has wrapped, beside 26 RG-LRU
     states), each model at full width and, but for vision, depth, the
     frontend fed to prefill and to the forward alike: ``prefill`` of
     all tokens but the last and one ``decode_step``, their logits against
     ``forward`` + ``lm_logits`` at the last two positions, in f32
     (relative Frobenius 1e-4) and in bf16 (at most 1.1 times the bf16
     forward's own error against the f32 forward; granite also 2e-2
     against the bf16 forward; argmax agreement printed), then a greedy
     step under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
     raises); ``serve_path``, ``gemma2_serve_path``,
     ``mamba2_serve_path``, ``whisper_serve_path``, ``vision_serve_path``
     and ``recurrentgemma_serve_path``, the serving launcher
     ``repro_torch.launch.serve`` on the same cases with 32 generated
     tokens (``serve.main``; vision, cut, through ``serve.serve``): prefill
     seconds, each decode step by CUDA events, tok/s, the peaks beside the
     params' and the cache's bytes, a step's byte bound (their sum over
     3.35 TB/s; whisper's counts its decoder's params, not its encoder's,
     and the self and cross caches), no kernel launched, every cache
     ``len`` (mamba2's ``step``) at prompt + 31, each ring holding the last
     positions of its window, the params unchanged, and one decode step
     profiled (``serve_profile``, ``gemma2_serve_profile``,
     ``mamba2_serve_profile``, ``whisper_serve_profile``,
     ``vision_serve_profile`` and ``recurrentgemma_serve_profile``
     lines);
  13. ``resume_path``: duplex at full width, depth cut to 4 layers, flash
     on, B=2 x S=4096: 4 steps straight; then 2 steps saving a checkpoint
     every 2 into a directory that is removed afterwards, whose restored
     state must equal the saved one bit for bit; then a run to 4 steps that
     must resume from step 2 and match the straight run's steps 2-3 and
     final branch (rtol 1e-5, atol 1e-6); save and restore times in s and
     GB/s;
  14. ``arms``: ``repro_torch.bench.table2_accuracy`` on the card with the
     reference's step counts: each arm's validation loss and accuracy, the
     ordering row, the wall time;
  15. ``ablations``: ``repro_torch.bench.fig21_ablations`` (Fig. 21: pool 8
     against 4, a norm-free branch against a normed one) and
     ``repro_torch.bench.bfp_fidelity`` (§III-E: rmse and bits of three
     formats, transpose invariance, the 128x128 ``bfp_matmul`` kernel row,
     BFP against f32 training) on the card at the reference's step counts;
     ``fig21_row`` and ``bfp_fidelity_row`` lines and one JSON line for
     each run with its wall time and launches; fig21 launches nothing,
     bfp_fidelity exactly 4 products; the kernel row's product held against
     the plain version, the rmse values against the same draw on the CPU
     (rtol 1e-6), the bits exactly, the transpose difference exactly 0;
  16. one JSON line with every kernel's numbers, the card line again, and
     the last line {"ok": true, "device": {...}}.
Each of the paths 4-15 (in 12, the six ``*serve_path`` runs; in 15, each
benchmark) zeroes every kernel's launch count just before it and reads the
counts just after.
Any failure raises and the exit code is not 0.  Without a CUDA device it
exits with code 2 before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses as dc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 SIMT pipes
# (the kernel's f32 arithmetic), HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
MAIN_STEPS = 3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches
    in ``.launches``."""
    from repro_torch.kernels import bfp_common as bc, bfp_matmul as bm, \
        bfp_quant as bq, flash_attention as fa
    fns = (fa.flash_attention, bm.bfp_matmul, bq.bfp_quantize,
           bq.bfp_matmul_packed, bm.quantize_operand, bq.dequantize_operand,
           bc.gemm_tn)
    return {f.__name__: f for f in fns}


def zero_counts() -> None:
    for f in kernel_counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in kernel_counters().items()}


def tree_nbytes(tree) -> int:
    from repro_torch.utils import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def frontend_shapes(fe) -> str:
    """A stub frontend's shapes as JSON (null for none)."""
    return json.dumps(fe and {k: list(v.shape) for k, v in fe.items()})


def attention_flops(b, h, sq, skv, d, causal):
    """The (query, key) pairs these inputs need (the causal triangle,
    top-left aligned) at 4·d FLOPs each."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return 4.0 * b * h * d * pairs


def attention_bound_ms(b, h, kv, sq, skv, d, causal, dtype):
    """Least time for the attention forward: its FLOPs over the peak for
    the dtype, against q/k/v read once and o written once over the memory
    rate."""
    flops = attention_flops(b, h, sq, skv, d, causal)
    nbytes = (2 * b * h * sq * d + 2 * b * kv * skv * d) * \
        torch.tensor([], dtype=dtype).element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# (label, b, h, kv, sq, skv, d, causal, softcap, dtype, iters).  Beside the
# main shape: MQA; rectangular causal; softcap; d=64 with Sq/Skv off the
# 128-row tiles; granite-moe-1b's attention (d=64, a multi-wave grid);
# llama4-maverick's (GQA ratio 5, a multi-wave grid); gemma2-9b's global
# layers (d=256 with softcap 50, the d=256 kernel, 1,024 CTAs in several
# waves), and the same without the cap, which reads what the cap costs the
# kernel; d=256 with Sq/Skv off the tiles; starcoder2-7b's attention (GQA
# ratio 9, odd, multi-wave); non-causal with Skv < Sq; f32 (the SIMT
# kernel), at d=256 with softcap too; the V-layout probes: q = 0, so
# every output row is the mean of V's rows, which a wrong MN-major V
# descriptor cannot give; whisper-base's decoder self-attention (MHA,
# GQA ratio 1, d=64) and llama-3.2-vision-90b's (64 heads, GQA ratio 8,
# the most heads of any path).  The rows in VIEW_ROWS take their inputs as
# attention_layer passes them on the main path: [B,S,H,d] tensors seen as
# [B,H,S,d], so q's sequence stride is H*d and k/v's KV*d.
FLASH_CASES = [
    ("main", 2, 32, 8, 4096, 4096, 128, True, None, torch.bfloat16, 10),
    ("mqa", 1, 8, 1, 1024, 1024, 128, True, None, torch.bfloat16, 20),
    ("rect_causal_bf16", 1, 8, 2, 384, 640, 128, True, None, torch.bfloat16,
     20),
    ("softcap_bf16", 2, 8, 2, 1024, 1024, 128, True, 20.0, torch.bfloat16,
     20),
    ("ragged_d64_bf16", 2, 8, 2, 200, 328, 64, True, None, torch.bfloat16,
     20),
    ("granite_moe_d64", 2, 16, 8, 4096, 4096, 64, True, None, torch.bfloat16,
     10),
    ("llama4_h40", 2, 40, 8, 4096, 4096, 128, True, None, torch.bfloat16, 10),
    ("gemma2_d256", 2, 16, 8, 4096, 4096, 256, True, 50.0, torch.bfloat16,
     10),
    ("gemma2_d256_nocap", 2, 16, 8, 4096, 4096, 256, True, None,
     torch.bfloat16, 10),
    ("ragged_d256_bf16", 2, 8, 4, 200, 328, 256, True, None, torch.bfloat16,
     20),
    ("starcoder2_h36", 2, 36, 4, 4096, 4096, 128, True, None, torch.bfloat16,
     10),
    ("whisper_mha_d64", 2, 8, 8, 4096, 4096, 64, True, None, torch.bfloat16,
     10),
    ("vision_h64", 2, 64, 8, 4096, 4096, 128, True, None, torch.bfloat16,
     10),
    ("short_kv_noncausal_bf16", 1, 8, 2, 512, 320, 128, False, None,
     torch.bfloat16, 20),
    ("v_probe_bf16", 1, 4, 4, 128, 128, 128, False, None, torch.bfloat16,
     20),
    ("v_probe_d256_bf16", 1, 4, 4, 128, 128, 256, False, None,
     torch.bfloat16, 20),
    ("rect_causal_f32", 1, 8, 2, 384, 640, 64, True, None, torch.float32, 20),
    ("softcap_f32", 2, 4, 2, 512, 512, 128, True, 20.0, torch.float32, 20),
    ("softcap_d256_f32", 1, 8, 2, 200, 328, 256, True, 50.0, torch.float32,
     10),
]
VIEW_ROWS = ("gemma2_d256", "gemma2_d256_nocap", "starcoder2_h36",
             "whisper_mha_d64", "vision_h64")
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# relative Frobenius error ||kernel - plain|| / ||plain||, over all rows and
# over the query rows past Sq/2.  The elementwise criterion is loose where
# |o| is small: a late causal row averages many keys, so |o| ~ 1/sqrt(row).
REL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}


def rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


def library_attention(q, k, v, causal: bool, cap):
    """One PyTorch call that computes the kernel's function on these
    inputs, a yardstick only: SDPA where there is no softcap; with one,
    flex_attention (compiled) with ``cap·tanh(s/cap)`` as its score_mod,
    which flex applies after the 1/√d scale as the kernel does, and the
    top-left causal mask as a block mask.  Also returns SDPA, the function
    without the cap."""
    import torch.nn.functional as F
    from torch.nn.attention import flex_attention as fx

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    if cap is None:
        return sdpa, sdpa
    global _FLEX
    if _FLEX is None:
        _FLEX = torch.compile(fx.flex_attention, dynamic=False)
    mask = fx.create_block_mask(lambda b, h, qi, ki: qi >= ki, None, None,
                                q.shape[2], k.shape[2], device=q.device) \
        if causal else None
    flex = _FLEX

    def capped(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)
    return (lambda: flex(q, k, v, score_mod=capped, block_mask=mask,
                         enable_gqa=True)), sdpa


_FLEX = None


def check_flash(gen) -> dict:
    """Kernel vs plain version per shape; returns each shape's numbers by
    label."""
    from repro_torch.kernels import flash_attention as fa
    rows = {}
    for (label, b, h, kv, sq, skv, d, causal, cap, dtype,
         iters) in FLASH_CASES:
        def draw(heads, s):
            if label in VIEW_ROWS:
                return torch.randn((b, s, heads, d), generator=gen,
                                   device="cuda", dtype=dtype).transpose(1, 2)
            return torch.randn((b, heads, s, d), generator=gen,
                               device="cuda", dtype=dtype)
        q, k, v = draw(h, sq), draw(kv, skv), draw(kv, skv)
        if label.startswith("v_probe"):
            q.zero_()
        # chunks are the reference's tiling contract only (each length
        # tiles by itself); the kernel uses its own tiles
        kw = dict(causal=causal, softcap=cap, q_chunk=sq, kv_chunk=skv)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal, softcap=cap)
        # the criterion of tests/test_kernels_flash.py (assert_allclose with
        # rtol = atol = tol): |kernel - plain| <= tol + tol * |plain|
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - TOL[dtype] * (1 + want.float().abs())).max())
        if not excess <= 0:
            raise AssertionError(f"flash {label}: |kernel - plain| exceeds "
                                 f"{TOL[dtype]} (1 + |plain|) by {excess}; "
                                 f"max |diff| {err}")
        rel_all = rel_fro(got, want)
        rel_tail = rel_fro(got[:, :, sq // 2:], want[:, :, sq // 2:])
        if not max(rel_all, rel_tail) <= REL_TOL[dtype]:
            raise AssertionError(f"flash {label}: relative Frobenius error "
                                 f"{rel_all} (all rows), {rel_tail} (rows "
                                 f"past Sq/2) exceeds {REL_TOL[dtype]}")
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters)
        plain_ms = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                             softcap=cap),
            max(2, iters // 5), warmup=1)
        # the library call on the same function; on a softcap row SDPA,
        # which has no cap, is timed too and kept apart.  The library's
        # output is held to the bf16 gate, so that its time is the time of
        # this function.
        library, sdpa = library_attention(q, k, v, causal, cap)
        lib_diff = (library().float() - want.float()).abs()
        library_err = float(lib_diff.max())
        if not float((lib_diff - TOL[torch.bfloat16]
                      * (1 + want.float().abs())).max()) <= 0:
            raise AssertionError(f"flash {label}: the library call differs "
                                 f"from the plain version by {library_err}")
        del lib_diff
        library_ms = time_ms(library, iters)
        sdpa_ms = library_ms if cap is None else time_ms(sdpa, iters)
        bound_ms, bound_by = attention_bound_ms(b, h, kv, sq, skv, d, causal,
                                                dtype)
        tflops = attention_flops(b, h, sq, skv, d, causal) / kernel_ms / 1e9
        row = {"shape": label, "q": [b, h, sq, d], "kv": [b, kv, skv, d],
               "causal": causal, "softcap": cap, "dtype": str(dtype),
               "max_abs_err": err, "tol": TOL[dtype], "rel_fro_err": rel_all,
               "rel_fro_err_tail": rel_tail, "rel_tol": REL_TOL[dtype],
               "kernel_ms": kernel_ms, "tflops": tflops,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "sdpa" if cap is None else "flex",
               "library_max_abs_err": library_err,
               "library_ms_without_softcap": None if cap is None
               else sdpa_ms,
               "kernel_over_library": kernel_ms / library_ms,
               "main_path_views": label in VIEW_ROWS,
               "bound_ms": bound_ms, "bound_by": bound_by}
        print("flash_check " + json.dumps(row), flush=True)
        rows[label] = row
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# BFP kernels (csrc/bfp.cu): checks against the plain versions, then the
# slice's path, kernels/ops.py, at the widths of the granite-3-8b cell.
# ---------------------------------------------------------------------------

# The elementwise criterion of tests/test_kernels_bfp.py:36-37
# (|kernel - plain| <= atol + rtol |plain|), and a relative Frobenius gate:
# the operands are the same bf16-exact values on both sides, so only the
# order of the f32 sums differs.  Read on the H100: exactly 0 wherever the
# sums are exact in f32, 8.4e-8 where they round (PERF.md, Findings);
# the gate sits 12x above that.
BFP_RTOL, BFP_ATOL = 1e-5, 1e-4
BFP_REL_TOL = 1e-6
# H100 SXM dense peaks for the bounds: int8 tensor cores (BFP mantissas fit
# int8; the least time for a BFP product), f32 SIMT pipes (quantization).
PEAK_INT8_OPS = 1979e12
PEAK_F32_OPS = 67e12

# the Pallas kernel bodies each CUDA kernel replaces
BFP_REPLACES = {
    "bfp_matmul": "src/repro/kernels/bfp_matmul.py:27",
    "bfp_quantize": "src/repro/kernels/bfp_quant.py:23",
    "bfp_matmul_packed": "src/repro/kernels/bfp_quant.py:70",
}
# (label, m, k, n, group, block, dtype, rows of A zeroed, skip_zero_groups)
BFP_MATMUL_CASES = [
    *[(f"{m}x{k}x{n}_{dt}", m, k, n, 32, 64, dt, 0, False)
      for m, k, n in [(32, 32, 32), (64, 96, 32), (100, 70, 36),
                      (128, 128, 128), (256, 128, 512)]
      for dt in (torch.float32, torch.bfloat16)],
    *[(f"group{g}", 64, 64, 64, g, 64, torch.float32, 0, False)
      for g in (8, 16, 32)],
    ("group3_f32", 100, 70, 36, 3, 48, torch.float32, 0, False),
    ("group3_bf16", 100, 70, 36, 3, 48, torch.bfloat16, 0, False),
    ("zero_gated", 64, 64, 64, 32, 32, torch.float32, 32, True),
    ("zero_gated_tile", 192, 192, 192, 32, 64, torch.float32, 96, True),
    ("wide_range", 256, 512, 256, 32, 64, torch.float32, 0, False),
]
# (label, m, n, group, block, dtype)
BFP_QUANT_CASES = [
    *[(f"{m}x{n}_{dt}", m, n, 32, 64, dt)
      for m, n in [(32, 32), (96, 64), (70, 40), (100, 70)]
      for dt in (torch.float32, torch.bfloat16)],
    ("group3", 100, 70, 3, 48, torch.float32),
]


def bfp_gate(label: str, got: torch.Tensor, want: torch.Tensor,
             bound: torch.Tensor | None = None):
    """Both gates; returns (max |diff|, relative Frobenius error).  With
    ``bound``, the elementwise gate is |kernel - plain| <= bound instead."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if bound is None:
        bound = BFP_ATOL + BFP_RTOL * want.float().abs()
    excess = float((diff - bound).max())
    rel = rel_fro(got, want)
    if not excess <= 0:
        raise AssertionError(f"bfp {label}: |kernel - plain| exceeds its "
                             f"bound by {excess}; max |diff| {err}")
    if not rel <= BFP_REL_TOL:
        raise AssertionError(f"bfp {label}: relative Frobenius error {rel} "
                             f"exceeds {BFP_REL_TOL}")
    return err, rel


def check_bfp(gen) -> None:
    """Each BFP kernel against its plain version at the JAX tests' shapes."""
    from repro_torch.kernels import bfp_matmul as bm, bfp_quant as bq
    from repro_torch.kernels.bfp_common import qdq_block
    for (label, m, k, n, g, blk, dtype, zrows,
         skip) in BFP_MATMUL_CASES:
        a = (torch.randn((m, k), generator=gen, device="cuda") * 2).to(dtype)
        b = (torch.randn((k, n), generator=gen, device="cuda") * 2).to(dtype)
        a[:zrows] = 0
        bound = None
        if label == "wide_range":
            # group exponents over the whole 4-bit range along K, so that
            # the f32 sums round and cancel; the elementwise gate is then
            # the f32 dot-product error bound 2 K u (|Q(a)| |Q(b)|), u = 2^-24
            span = torch.exp2(torch.linspace(-12, 12, k, device="cuda"))
            a, b = a * span, b * span[:, None]
            qa, qb = (qdq_block(t, g, 5, 4).abs() for t in (a, b))
            bound = 2 * k * 2.0 ** -24 * torch.matmul(qa, qb)
        got = bm.bfp_matmul(a, b, group=g, block_m=blk, block_n=blk,
                            block_k=blk, skip_zero_groups=skip)
        torch.cuda.synchronize()
        err, rel = bfp_gate(label, got, bm.bfp_matmul_plain(a, b, group=g),
                            bound)
        print("bfp_check " + json.dumps({
            "kernel": "bfp_matmul", "case": label, "mkn": [m, k, n],
            "group": g, "dtype": str(dtype), "skip_zero_groups": skip,
            "elementwise_gate": "2Ku|Q(a)||Q(b)|" if bound is not None
            else f"rtol {BFP_RTOL} atol {BFP_ATOL}",
            "max_abs_err": err, "rel_fro_err": rel}), flush=True)
    for label, m, n, g, blk, dtype in BFP_QUANT_CASES:
        x = (torch.randn((m, n), generator=gen, device="cuda") * 3).to(dtype)
        mant, exp = bq.bfp_quantize(x, group=g, block_m=blk, block_n=blk)
        pm, pe = bq.bfp_quantize_plain(x, group=g, block_m=blk, block_n=blk)
        if not (torch.equal(mant, pm) and torch.equal(exp, pe)):
            raise AssertionError(f"bfp_quantize {label}: not bit-exact")
        print("bfp_check " + json.dumps({
            "kernel": "bfp_quantize", "case": label, "mn": [m, n],
            "padded": list(mant.shape), "group": g, "dtype": str(dtype),
            "bit_exact": True}), flush=True)
    for g, blk in ((32, 32), (3, 48)):
        a = torch.randn((64, 96), generator=gen, device="cuda") * 3
        b = torch.randn((96, 64), generator=gen, device="cuda") * 3
        ops_ = (*bq.bfp_quantize_plain(a, group=g, block_m=blk, block_n=blk),
                *bq.bfp_quantize_plain(b, group=g, block_m=blk, block_n=blk))
        got = bq.bfp_matmul_packed(*ops_, group=g, block_m=blk, block_n=blk,
                                   block_k=blk)
        torch.cuda.synchronize()
        err, rel = bfp_gate(f"packed group {g}", got,
                            bq.bfp_matmul_packed_plain(*ops_, group=g))
        print("bfp_check " + json.dumps({
            "kernel": "bfp_matmul_packed", "case": f"group{g}",
            "mkn": [64, 96, 64], "group": g, "max_abs_err": err,
            "rel_fro_err": rel}), flush=True)


# The two stages of each product.  (label, rows, k, group, dtype,
# transposed, zero gate): ragged shapes, a transposed view, group 3, the
# gate on and off.
BFP_OPERAND_CASES = [
    ("100x70_g32_f32", 100, 70, 32, torch.float32, False, False),
    ("100x70_g32_bf16_gate", 100, 70, 32, torch.bfloat16, False, True),
    ("250x190_g3_f32_T_gate", 250, 190, 3, torch.float32, True, True),
    ("200x300_g3_bf16_T", 200, 300, 3, torch.bfloat16, True, False),
    ("300x200_g8_f32_gate", 300, 200, 8, torch.float32, False, True),
    ("64x520_g16_f32_T", 64, 520, 16, torch.float32, True, False),
]


def check_bfp_stages(gen) -> None:
    """Each operand pass against its plain version (bit-exact, padding and
    gate flags included) and the GEMM against its plain version (the
    product gates of ``bfp_gate``)."""
    from repro_torch.kernels import bfp_common as bc, bfp_matmul as bm, \
        bfp_quant as bq
    for label, rows, k, g, dtype, trans, gate in BFP_OPERAND_CASES:
        x = (torch.randn((k, rows) if trans else (rows, k), generator=gen,
                         device="cuda") * 3).to(dtype)
        x = x.T if trans else x
        x[: rows // 3] = 0       # whole tiles of zeros for the gate
        for tile in (bc.GEMM_TILE_M, bc.GEMM_TILE_N):
            got = bm.quantize_operand(x, tile, group=g, gate=gate)
            want = bm.quantize_operand_plain(x, tile, group=g, gate=gate)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and (not gate or torch.equal(
                    got[1], want[1]))):
                raise AssertionError(f"quantize_operand {label} tile {tile}:"
                                     f" not bit-exact")
        print("bfp_check " + json.dumps({
            "kernel": "quantize_operand", "case": label,
            "shape": [rows, k], "padded": list(got[0].shape), "group": g,
            "dtype": str(dtype), "transposed": trans, "gate": gate,
            "bit_exact": True}), flush=True)
        mant, exp = bq.bfp_quantize_plain(x, group=g, block_m=g, block_n=g)
        if trans:
            mant, exp = mant.T.contiguous().T, exp.T.contiguous().T
        for tile in (bc.GEMM_TILE_M, bc.GEMM_TILE_N):
            got = bq.dequantize_operand(mant, exp, tile, group=g)
            want = bq.dequantize_operand_plain(mant, exp, tile, group=g)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"dequantize_operand {label} tile "
                                     f"{tile}: not bit-exact")
        print("bfp_check " + json.dumps({
            "kernel": "dequantize_operand", "case": label,
            "shape": list(mant.shape), "padded": list(got.shape), "group": g,
            "transposed": trans, "bit_exact": True}), flush=True)
    # the GEMM on bf16 buffers with whole zero tiles, ragged (m, n)
    for m, n, k in ((100, 36, 70), (300, 520, 200), (257, 129, 1000)):
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((n, k), generator=gen, device="cuda")
        a[: m // 2] = 0
        for gate in (False, True):
            aq, fa = bm.quantize_operand(a, bc.GEMM_TILE_M, gate=gate)
            bq_, fb = bm.quantize_operand(b, bc.GEMM_TILE_N, gate=gate)
            got = bc.gemm_tn(aq, bq_, m, n, fa, fb)
            torch.cuda.synchronize()
            err, rel = bfp_gate(f"gemm_tn {m}x{n}x{k}", got,
                                bc.gemm_tn_plain(aq, bq_, m, n))
            print("bfp_check " + json.dumps({
                "kernel": "gemm_tn", "case": f"{m}x{k}x{n}", "gate": gate,
                "max_abs_err": err, "rel_fro_err": rel}), flush=True)


def matmul_bound_ms(m, k, n, in_bytes):
    """2MKN operations at the int8 tensor-core rate against the operands
    read once and the f32 output written once."""
    t_ops = 2.0 * m * k * n / PEAK_INT8_OPS
    t_bytes = ((m * k + k * n) * in_bytes + m * n * 4) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def quantize_bound_ms(m, n, mp, np_, g, in_bytes):
    """Four f32 operations a value (max, scale, round, clip) against the
    input read once and the mantissas and exponents written once."""
    t_ops = 4.0 * m * n / PEAK_F32_OPS
    t_bytes = (m * n * in_bytes + mp * np_ + (mp // g) * (np_ // g)) \
        / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def run_bfp_path() -> dict:
    """The slice's path at full width: ops.bfp_dense forward and backward on
    the granite-3-8b cell's MLP up-projection (B*S = 8192 tokens, d 4096,
    d_ff 12800, group 32), the storage path (quantize both operands, then
    the packed product) on the same operands, and the duplex branch's MLP
    up-projection (launch/cells.py::duplex_tcfg: d_branch 512, 256 pooled
    positions).  Counts are zeroed just before and read just after."""
    from repro_torch.kernels import bfp_common as bc, bfp_matmul as bm, \
        bfp_quant as bq, ops
    from repro_torch.kernels.bfp_common import qdq_block
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg = ops.BFPKernelConfig(group=32)
    b_, s_, d, ff = 2, 4096, 4096, 12800
    # post-norm activations at unit scale; weights and the upstream gradient
    # at granite's initializer range (0.02), inside the 4-bit exponent range
    x = torch.randn((b_, s_, d), generator=gen, device="cuda")
    w = torch.randn((d, ff), generator=gen, device="cuda") * 0.02
    g = torch.randn((b_, s_, ff), generator=gen, device="cuda") * 0.02
    xb = torch.randn((2, 256, 512), generator=gen, device="cuda")
    wb = torch.randn((512, 2048), generator=gen, device="cuda") * 0.02
    gb = torch.randn((2, 256, 2048), generator=gen, device="cuda") * 0.02
    x2, g2 = x.reshape(-1, d), g.reshape(-1, ff)

    zero_counts()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ops.bfp_dense(xr, wr, cfg)
    y.backward(g)
    torch.cuda.synchronize()
    dense_launches = bm.bfp_matmul.launches
    xm, xe = ops.quantize(x2, cfg)
    wm, we = ops.quantize(w, cfg)
    yp = ops.matmul_packed(xm, xe, wm, we, cfg)
    xbr, wbr = xb.clone().requires_grad_(), wb.clone().requires_grad_()
    yb = ops.bfp_dense(xbr, wbr, cfg)
    yb.backward(gb)
    torch.cuda.synchronize()
    launches = read_counts()
    flash_launches = launches.pop("flash_attention")
    print(f"bfp_path: launches {json.dumps(launches)} bfp_dense_full_width "
          f"{dense_launches}", flush=True)
    # each product is two operand passes and one GEMM
    if dense_launches != 3 or flash_launches or launches != {
            "bfp_matmul": 6, "bfp_quantize": 2, "bfp_matmul_packed": 1,
            "quantize_operand": 12, "dequantize_operand": 2, "gemm_tn": 7}:
        raise AssertionError(f"bfp path launched {launches}, bfp_dense "
                             f"{dense_launches}; expected 3 per bfp_dense, "
                             f"2 quantize, 1 packed, 2 operand passes and "
                             f"1 GEMM per product")

    # the results against the plain versions (launches no longer counted)
    y2 = y.detach().reshape(-1, ff)
    checks = {
        "y": (y2, bm.bfp_matmul_plain(x2, w)),
        "dx": (xr.grad.reshape(-1, d), bm.bfp_matmul_plain(g2, w.T)),
        "dw": (wr.grad, bm.bfp_matmul_plain(x2.T, g2)),
        "packed_vs_plain": (yp, bq.bfp_matmul_packed_plain(xm, xe, wm, we)),
        "packed_vs_matmul": (yp, y2),
        "branch_y": (yb.detach().reshape(-1, 2048),
                     bm.bfp_matmul_plain(xb.reshape(-1, 512), wb)),
        "branch_dx": (xbr.grad.reshape(-1, 512),
                      bm.bfp_matmul_plain(gb.reshape(-1, 2048), wb.T)),
        "branch_dw": (wbr.grad, bm.bfp_matmul_plain(xb.reshape(-1, 512).T,
                                                    gb.reshape(-1, 2048))),
    }
    errs = {}
    for name, (got, want) in checks.items():
        if not torch.isfinite(got).all():
            raise AssertionError(f"bfp_path {name}: non-finite values")
        errs[name] = bfp_gate(name, got, want)
        print(f"bfp_path {name}: shape {list(got.shape)} max_abs_err "
              f"{errs[name][0]!r} rel_fro_err {errs[name][1]!r}", flush=True)
        del got, want
    del checks
    pm, pe = bq.bfp_quantize_plain(x2)
    # the largest difference over mantissas and exponents, in integer steps
    quant_err = max((xm.int() - pm.int()).abs().max().item(),
                    (xe.int() - pe.int()).abs().max().item())
    if not (torch.equal(xm, pm) and torch.equal(xe, pe)):
        raise AssertionError(f"bfp_path: quantize(x2) not bit-exact, max "
                             f"difference {quant_err}")
    del pm, pe
    print(f"bfp_path quantize(x2): bit_exact True max_abs_err {quant_err}",
          flush=True)

    # each stage at full width: the operand passes against their plain
    # versions, bit for bit, padding included
    tm, tn = bc.GEMM_TILE_M, bc.GEMM_TILE_N
    stage_in = {
        "quantize_operand(x2)": (
            lambda: bm.quantize_operand(x2, tm)[0],
            lambda: bm.quantize_operand_plain(x2, tm)[0]),
        "quantize_operand(w.T)": (
            lambda: bm.quantize_operand(w.T, tn)[0],
            lambda: bm.quantize_operand_plain(w.T, tn)[0]),
        "dequantize_operand(x2)": (
            lambda: bq.dequantize_operand(xm, xe, tm),
            lambda: bq.dequantize_operand_plain(xm, xe, tm)),
        "dequantize_operand(w.T)": (
            lambda: bq.dequantize_operand(wm.T, we.T, tn),
            lambda: bq.dequantize_operand_plain(wm.T, we.T, tn)),
    }
    for name, (kernel, plain) in stage_in.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"bfp_path {name}: not bit-exact")
        print(f"bfp_path {name}: shape {list(got.shape)} bit_exact True",
              flush=True)
        del got, want

    # times at the full-width shape
    m_, k_, n_ = x2.shape[0], d, ff
    qx, qw = qdq_block(x2, 32, 5, 4).bfloat16(), qdq_block(w, 32, 5, 4) \
        .bfloat16()
    library_ms = time_ms(lambda: torch.matmul(qx, qw), 10)  # yardstick only
    qx, _ = bm.quantize_operand(x2, tm)
    qw, _ = bm.quantize_operand(w.T, tn)
    dx_, dw_ = bq.dequantize_operand(xm, xe, tm), \
        bq.dequantize_operand(wm.T, we.T, tn)
    ceiling_bf16_ms = 2.0 * m_ * k_ * n_ / PEAK_FLOPS[torch.bfloat16] * 1e3
    rows = {
        "bfp_matmul": {
            "ms": time_ms(lambda: bm.bfp_matmul(x2, w), 5),
            "prepass_ms": time_ms(lambda: (bm.quantize_operand(x2, tm),
                                           bm.quantize_operand(w.T, tn)), 5),
            "gemm_ms": time_ms(lambda: bc.gemm_tn(qx, qw, m_, n_), 5),
            "ceiling_bf16_ms": ceiling_bf16_ms,
            "plain_ms": time_ms(lambda: bm.bfp_matmul_plain(x2, w), 3, 1),
            "library_ms": library_ms, "max_abs_err": errs["y"][0],
            "rel_fro_err": errs["y"][1],
            **dict(zip(("bound_ms", "bound_by"),
                       matmul_bound_ms(m_, k_, n_, 4)))},
        "bfp_quantize": {
            "ms": time_ms(lambda: bq.bfp_quantize(x2), 20),
            "plain_ms": time_ms(lambda: bq.bfp_quantize_plain(x2), 5, 1),
            "library_ms": None, "max_abs_err": float(quant_err),
            **dict(zip(("bound_ms", "bound_by"), quantize_bound_ms(
                m_, k_, xm.shape[0], xm.shape[1], 32, 4)))},
        "bfp_matmul_packed": {
            "ms": time_ms(lambda: bq.bfp_matmul_packed(xm, xe, wm, we), 5),
            "prepass_ms": time_ms(
                lambda: (bq.dequantize_operand(xm, xe, tm),
                         bq.dequantize_operand(wm.T, we.T, tn)), 5),
            "gemm_ms": time_ms(lambda: bc.gemm_tn(dx_, dw_, m_, n_), 5),
            "ceiling_bf16_ms": ceiling_bf16_ms,
            "plain_ms": time_ms(
                lambda: bq.bfp_matmul_packed_plain(xm, xe, wm, we), 3, 1),
            "library_ms": library_ms,
            "max_abs_err": errs["packed_vs_plain"][0],
            "rel_fro_err": errs["packed_vs_plain"][1],
            **dict(zip(("bound_ms", "bound_by"),
                       matmul_bound_ms(m_, k_, n_, 1)))},
    }
    for name, row in rows.items():
        row["launches"] = launches[name]
        print(f"bfp_time {name}: " + json.dumps(row), flush=True)

    # the path end to end: bfp_dense forward and backward, three products
    def dense_step():
        xr.grad = wr.grad = None
        ops.bfp_dense(xr, wr, cfg).backward(g)
    dense = {"ms": time_ms(dense_step, 5),
             "ceiling_bf16_ms": 3 * ceiling_bf16_ms}
    print("bfp_time bfp_dense_fwd_bwd: " + json.dumps(dense), flush=True)
    del x, w, g, x2, g2, xr, wr, y, y2, yp, xm, xe, wm, we
    del xb, wb, gb, xbr, wbr, yb, qx, qw, dx_, dw_
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def watching(module, name: str, see):
    """Inside the block, every call of ``module.<name>`` first passes its
    arguments to ``see``.  The callers reach these functions through the
    module's namespace, so wrapping the name sees their inputs."""
    plain = getattr(module, name)

    def wrapper(*args, **kw):
        see(*args, **kw)
        return plain(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, plain)


def first_call(module, name: str, store: list):
    """Record the positional arguments of the first call of
    ``module.<name>`` inside the block: ``(params, x, MoEConfig)`` of
    ``moe.moe_apply``, ``(x, dt, A, B, C, chunk)`` of ``ssm._ssd_chunked``."""
    return watching(module, name,
                    lambda *args, **kw: store or store.append(args))


def routing(params, x, mcfg, policy):
    """The port's routing of one MoE layer's input: (kept mask, capacity,
    group size)."""
    from repro_torch.models import moe
    xg, gates = moe.router_gates(params, x, mcfg, policy=policy)
    cap = moe.capacity(mcfg, xg.shape[1])
    return moe.route(gates, mcfg.top_k, cap)[2], cap, xg.shape[1]


def kind_layers(cfg, kind: str) -> int:
    """The layers of ``kind`` in ``cfg``'s stack: the pattern's times
    ``n_rep`` and the remainder's."""
    return cfg.n_rep * sum(sp.kind == kind for sp in cfg.pattern) + \
        sum(sp.kind == kind for sp in cfg.remainder)


def flash_layers(cfg) -> int:
    """The layers that run the flash kernel: the ``attn`` ones of ``cfg``'s
    own stack (``local`` layers keep their window on the blockwise path and
    ``cross`` layers are never flash, as the reference's; an encoder,
    ``cfg.encoder``, keeps ``use_flash`` off)."""
    return kind_layers(cfg, "attn")


def run_main_path(arch: str = "granite-3-8b", label: str = "main"):
    """The duplex step through the launcher at full width and depth, B=2,
    S=4096, 3 steps: granite-3-8b (``main``), granite-moe-1b-a400m
    (``moe``), gemma2-9b (``gemma2``), starcoder2-7b (``starcoder2``),
    mamba2-780m (``mamba2``), whisper-base (``whisper``: 6 encoder and 12
    decoder layers, the launcher's stub frames [2, 1500, 512] in bf16) or
    recurrentgemma-9b (``recurrentgemma``: 38 layers, 26 ``lru`` and 12
    ``local`` with a 2048 window, shorter than S).
    Returns the path's numbers and its run (entry, configs, final state,
    batches), which the caller reads further and then drops, so that the
    next path's peak stands alone."""
    from repro_torch.launch import train

    argv = ["--arch", arch, "--preset", "full", "--mode", "duplex",
            "--steps", str(MAIN_STEPS), "--seq", "4096", "--batch", "2",
            "--log-every", "1", "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = train.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts.pop("flash_attention")
    bfp_launches = sum(counts.values())
    peak = torch.cuda.max_memory_allocated()

    report = out["report"]
    entry, cfg, tcfg, policy = train.build(arch, "full")
    for m in report.metrics_history:
        print(f"{label}_step {m['step']}: loss {m['loss']!r} step_time_s "
              f"{m['step_time_s']!r} grad_norm {m['grad_norm']!r}")
    n_attn = flash_layers(cfg)
    fe = out["frontend"]
    print(f"{label}_path: arch {arch} layers {cfg.n_layers} of "
          f"{entry.full.n_layers} encoder_layers "
          f"{cfg.encoder.n_layers if cfg.encoder else 0} frontend "
          f"{frontend_shapes(fe)} "
          f"(flash layers {n_attn}) batch 2 seq 4096 "
          f"steps {report.steps_run} wall_s {wall!r} "
          f"max_memory_allocated_bytes {peak} flash_launches {launches} "
          f"expected {n_attn * MAIN_STEPS} backbone_checksum "
          f"{out['backbone_checksum']} branch_max_abs_change "
          f"{out['branch_max_abs_change']!r} bfp_launches {bfp_launches}",
          flush=True)
    losses = [m["loss"] for m in report.metrics_history]
    if len(losses) != MAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label} path losses not finite: {losses}")
    if bfp_launches:   # the branch quantizes by fake-quant, as the reference
        raise AssertionError(f"the duplex step launched {bfp_launches} BFP "
                             f"kernels; the reference's step reaches none")
    if launches != n_attn * MAIN_STEPS:
        raise AssertionError(f"flash launched {launches} times, expected "
                             f"{n_attn * MAIN_STEPS}")
    before, after = out["backbone_checksum"]
    if before != after:
        raise AssertionError(f"backbone changed: checksum {before} -> {after}")
    if not out["branch_max_abs_change"] > 0:
        raise AssertionError("branch params did not move")

    batches = [cuda_batch(cfg, 4096, 2, m["step"], fe)
               for m in report.metrics_history]
    if n_attn:
        check_plain_attention(entry, cfg, tcfg, policy, report.state,
                              batches[0], label)
    else:
        print(f"{label}_path_reference: skipped: {arch} has no attn layer, "
              f"so flash is not on its path", flush=True)
    profile_step(entry, cfg, tcfg, policy, report.state, batches[0],
                 label="profile" if label == "main" else f"{label}_profile")
    times = [m["step_time_s"] for m in report.metrics_history]
    run = {"entry": entry, "cfg": cfg, "policy": policy,
           "state": report.state, "batches": batches, "step_times": times,
           "steps": [m["step"] for m in report.metrics_history],
           "n_layers": cfg.n_layers}
    return {"label": label, "launches": launches, "peak_bytes": peak,
            "step_times": times}, run


def cuda_batch(cfg, seq: int, batch: int, step: int,
               frontend: dict | None = None) -> dict:
    """Step ``step``'s batch of the synthetic data the launcher and the loop
    read (seed 0), on the card, with the run's stub ``frontend`` if any."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  batch_per_host=batch, seed=0))
    out = {k: torch.as_tensor(v, device="cuda").long()
           for k, v in data.batch(step).items()}
    if frontend is not None:
        out["frontend"] = frontend
    return out


def check_plain_attention(entry, cfg, tcfg, policy, state, batch,
                          label: str) -> None:
    """The duplex loss on the final state and one batch through the flash
    kernel and through the plain attention path (blockwise, PyTorch ops).
    bf16 backbone: the two attention outputs differ by bf16 rounding, so
    the losses agree to 1e-2 relative, not bit for bit."""
    from repro_torch.train import train_step as ts
    with torch.no_grad():
        lf, _ = ts.make_loss_fn(entry, cfg, tcfg, policy)(
            state["branch"], state["backbone"], batch)
        lp, _ = ts.make_loss_fn(entry, dc.replace(cfg, use_flash=False),
                                tcfg, policy)(
            state["branch"], state["backbone"], batch)
    rel = abs(float(lf) - float(lp)) / abs(float(lp))
    print(f"{label}_path_reference: loss_flash {float(lf)!r} "
          f"loss_plain_attention {float(lp)!r} rel_diff {rel!r}", flush=True)
    if not rel <= 1e-2:
        raise AssertionError(f"flash path loss {float(lf)} vs plain attention"
                             f" path {float(lp)}: rel diff {rel} > 1e-2")


def report_moe_path(run: dict, label: str = "moe") -> None:
    """The MoE duplex path's own readings: each step's backbone aux loss
    (the backbone is frozen, so each step's forward again), and the routing
    (gates + top-k passes) and whole MoE layer of the first layer's input,
    timed alone, with its dropped share."""
    from repro_torch.models import moe
    entry, cfg, policy = run["entry"], run["cfg"], run["policy"]
    backbone, first = run["state"]["backbone"], []
    with torch.no_grad(), first_call(moe, "moe_apply", first):
        aux = [float(entry.module.forward(backbone, cfg, b["tokens"],
                                          policy=policy)["aux"])
               for b in run["batches"]]
    for step, a in zip(run["steps"], aux):
        print(f"{label}_step {step}: backbone_aux {a!r}")
    if not all(map(math.isfinite, aux)):
        raise AssertionError(f"{label} path aux not finite: {aux}")
    params, x, mcfg = first[0]
    with torch.no_grad():
        keep, cap, g = routing(params, x, mcfg, policy)
        route_ms = time_ms(lambda: routing(params, x, mcfg, policy), 10)
        layer_ms = time_ms(lambda: moe.moe_apply(params, x, mcfg,
                                                 policy=policy), 10)
    step_s = min(run["step_times"][1:])
    n = run["n_layers"]
    print(f"{label}_route: layer 0 tokens {x.shape[0] * x.shape[1]} "
          f"group {g} capacity {cap} dropped_share "
          f"{1.0 - float(keep.float().mean())!r} route_ms {route_ms!r} "
          f"moe_layer_ms {layer_ms!r} moe_layers {n} "
          f"route_share_of_step {n * route_ms / 1e3 / step_s!r} "
          f"moe_share_of_step {n * layer_ms / 1e3 / step_s!r}", flush=True)


def report_attention_layers(run: dict, label: str) -> None:
    """Where a model's attention time goes: the first layer of each
    attention kind of each stack's first superblock, timed alone with CUDA
    events on the normed input the path's first batch gives it, times its
    count in the stack, over the step time (``<label>_attention`` line).
    gemma2: ``local`` layers keep their window on the blockwise path, in f32
    as the reference's, and ``attn`` layers run the flash kernel.  whisper:
    the encoder's self-attention over the frames (non-causal, blockwise
    f32), the decoder's ``cross`` layer (the tokens over the encoder's
    output, blockwise f32) and its ``attn`` layer (causal, flash).
    recurrentgemma-9b: its ``local`` layers (window 2048, MQA at head dim
    256), blockwise f32."""
    from repro_torch.models import encdec, layers as L, transformer as tr
    cfg, policy = run["cfg"], run["policy"]
    backbone = run["state"]["backbone"]
    batch = run["batches"][0]
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device="cuda").expand(b, s)
    step_s = min(run["step_times"][1:])
    rows = {}

    def stack(c, params, x, pos, kv=None, prefix=""):
        p0 = tr._index(params["stack"], 0)
        for i, spec in enumerate(c.pattern):
            if spec.kind not in ("attn", "local", "cross"):
                continue
            sub, acfg = p0[f"sub{i}"], tr.attn_cfg_for(c, spec)
            u = tr._norm(c, sub["norm"], x)
            kv_x = kv if spec.kind == "cross" else None
            ms = time_ms(lambda: L.attention_layer(
                sub["attn"], u, acfg, policy=policy, kv_x=kv_x,
                positions=pos), 5)
            keys = (u if kv_x is None else kv_x).shape[1]
            core = ("flash kernel" if acfg.use_flash and acfg.window is None
                    else "blockwise f32"
                    if max(u.shape[1], keys) > acfg.blockwise_threshold
                    else "full f32")
            n = kind_layers(c, spec.kind)
            rows[prefix + spec.kind] = {
                "core": core, "window": acfg.window, "queries": u.shape[1],
                "keys": keys, "causal": acfg.causal and kv_x is None,
                "layers": n, "layer_ms": ms,
                "share_of_step": n * ms / 1e3 / step_s}

    with torch.no_grad():
        if cfg.encoder is None:
            stack(cfg, backbone, tr.embed_tokens(backbone, cfg, tokens,
                                                 positions, policy),
                  positions)
        else:
            ecfg, frames = cfg.encoder, batch["frontend"]["frames"]
            fpos = torch.arange(frames.shape[1], device="cuda").expand(
                b, frames.shape[1])
            h = frames.to(policy.compute_dtype)
            h = h + tr.sinusoidal_embed(fpos, ecfg.d_model).to(h.dtype)
            stack(ecfg, backbone["encoder"], h, fpos, prefix="encoder_")
            stack(cfg, backbone["decoder"],
                  tr.embed_tokens(backbone["decoder"], cfg, tokens,
                                  positions, policy),
                  positions, encdec.encode(backbone, cfg, frames,
                                           policy=policy), "decoder_")
    print(f"{label}_attention: step_s {step_s!r} {json.dumps(rows)}",
          flush=True)


def report_mixers(run: dict, label: str) -> None:
    """Where a recurrent model's duplex step goes: the first layer's mixer
    block on the normed embedding of the path's first batch, and the scan
    inside it, each timed alone with CUDA events, times the count of layers
    of its kind (the pattern's and the remainder's), over the step time
    (``<label>_mixers`` line).  mamba2-780m: ``ssd_block`` and its chunked
    scan ``ssm._ssd_chunked``; recurrentgemma-9b: ``lru_block`` and its
    odd-even scan ``hybrid._scan`` (over the gates the block gives it)."""
    from repro_torch.models import hybrid, ssm, transformer as tr
    cfg, policy = run["cfg"], run["policy"]
    backbone = run["state"]["backbone"]
    sub = tr._index(backbone["stack"], 0)["sub0"]
    kind = cfg.pattern[0].kind
    mod, block, scan_name, mcfg = {
        "ssd": (ssm, ssm.ssd_block, "_ssd_chunked", tr._ssd_cfg(cfg)),
        "lru": (hybrid, hybrid.lru_block, "_scan", tr._lru_cfg(cfg))}[kind]
    tokens = run["batches"][0]["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device="cuda").expand(b, s)
    n = kind_layers(cfg, kind)
    step_s = min(run["step_times"][1:])
    scan = []
    with torch.no_grad():
        u = tr._norm(cfg, sub["norm"], tr.embed_tokens(backbone, cfg, tokens,
                                                       positions, policy))
        with first_call(mod, scan_name, scan):
            block(sub[kind], u, mcfg, policy=policy)
        block_ms = time_ms(lambda: block(sub[kind], u, mcfg,
                                         policy=policy), 5)
        scan_fn = getattr(mod, scan_name)
        scan_ms = time_ms(lambda: scan_fn(*scan[0]), 5)
    names = {"ssd": ("ssd_block", "ssd_chunked_scan"),
             "lru": ("lru_block", "lru_scan")}[kind]
    rows = {name: {"layers": n, "ms": ms, "share_of_step": n * ms / 1e3 /
                   step_s}
            for name, ms in zip(names, (block_ms, scan_ms))}
    print(f"{label}_mixers: step_s {step_s!r} {json.dumps(rows)}",
          flush=True)


def profile_step(entry, cfg, tcfg, policy, state, batch, label="profile"):
    """One more step under torch.profiler (``profile_call``)."""
    from repro_torch.train import train_step as ts
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    profile_call(lambda: float(step(state, batch)[1]["loss"]), label)


def profile_call(fn, label: str) -> dict:
    """``fn()`` once, then once more under torch.profiler: device time by
    kernel and the device's busy share of the call's wall time, on
    ``<label>_step`` and ``<label>_kernel`` lines.  Returns the wall time,
    the busy time and the share."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []      # device-side events only: op rows repeat their kernels
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if e.device_type == torch.autograd.DeviceType.CUDA and dev > 0:
            rows.append((dev, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"{label}_step: wall_s {wall!r} device_busy_s "
          f"{busy_us / 1e6!r} busy_share {busy_us / 1e6 / wall!r} "
          f"(profiler on)")
    for dev, key, count in rows[:12]:
        print(f"{label}_kernel: {dev / 1e3:.3f} ms x{count} "
              f"{dev / busy_us:.3f} {key[:100]}")
    return {"wall_s": wall, "busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall}


def f1_check() -> None:
    """The kernel wrappers refuse autograd on CUDA tensors, as on the CPU
    and as ``jax.grad`` through the reference's kernels; under
    ``torch.no_grad()`` they launch."""
    from repro_torch.kernels import flash_attention as fa, ops
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(s, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for s in ((1, 8, 256, 128), (1, 2, 256, 128),
                         (1, 2, 256, 128)))
    a = torch.randn((256, 128), generator=gen, device="cuda")
    b = torch.randn((128, 96), generator=gen, device="cuda")
    kw = dict(q_chunk=256, kv_chunk=256)
    cases = {"flash_attention": (lambda x: fa.flash_attention(x, k, v, **kw),
                                 q, "flash_attention"),
             "ops.matmul": (lambda x: ops.matmul(x, b), a, "bfp_matmul")}
    for name, (call, x, kernel) in cases.items():
        try:
            call(x.clone().requires_grad_())
            raised = False
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            raised = True
        if not raised:
            raise AssertionError(f"f1_check: {name} on a CUDA input that "
                                 f"requires grad did not raise")
        zero_counts()
        with torch.no_grad():
            out = call(x.clone().requires_grad_())
        torch.cuda.synchronize()
        launched = read_counts()[kernel]
        finite = bool(torch.isfinite(out.float()).all())
        if launched != 1 or not finite:
            raise AssertionError(f"f1_check: {name} under no_grad launched "
                                 f"{kernel} {launched} times, finite "
                                 f"{finite}")
        print(f"f1_check {name}: raises_under_grad True "
              f"launches_under_no_grad {launched}", flush=True)


# SSD on the card: the chunked scan against the recurrent oracle, and the
# block on the card against the block on the CPU (the reference tests'
# bound, tests/test_special_layers.py:26-31)
SSD_TOL = 1e-4
FR_PEAK_LIMIT = 75e9    # bytes; the FR depth is cut to stay under it
LOG_F32_MAX = math.log(torch.finfo(torch.float32).max)  # exp is inf past it


def close_gate(phase: str, label: str, got: torch.Tensor,
               want: torch.Tensor, tol: float) -> float:
    """|got - want| <= tol (1 + |want|), everywhere finite; returns the
    max |diff|."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{phase} {label}: non-finite values")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not float((diff - tol * (1 + want.float().abs())).max()) <= 0:
        raise AssertionError(f"{phase} {label}: |got - want| exceeds "
                             f"{tol} (1 + |want|); max |diff| {err}")
    return err


def ssd_check() -> dict:
    """mamba2-780m's SSD on the card, in f32, at its head shape (H=48,
    P=64, N=128, G=1, chunk 256), B=1, S=1024, from a seeded generator:
    the port's ``_ssd_chunked`` against ``ssd_reference`` (y and the final
    state); then one full-width ``ssd_block`` (f32 policy) on the card
    against the same block on the CPU, with the same params and input.
    Times by CUDA events (the CPU block by the host clock)."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L, registry, ssm, \
        transformer as tr
    from repro_torch.utils import tree_map
    cfg = tr._ssd_cfg(registry.get("mamba2-780m").full)
    b, s = 1, 1024
    h, p, g, n = cfg.n_heads, cfg.headdim, cfg.n_groups, cfg.d_state
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, dt = randn(b, s, h, p), F.softplus(randn(b, s, h) - 1.0)
    A = -torch.exp(randn(h) * 0.3)
    B, C = randn(b, s, g, n) * 0.5, randn(b, s, g, n) * 0.5
    y, hf = ssm._ssd_chunked(x, dt, A, B, C, cfg.chunk)
    yr, hr = ssm.ssd_reference(x, dt, A, B, C)
    row = {"x": [b, s, h, p], "B": [b, s, g, n], "chunk": cfg.chunk,
           "tol": SSD_TOL,
           "scan_y_max_abs_err": close_gate("ssd_check", "scan y", y, yr,
                                            SSD_TOL),
           "scan_h_max_abs_err": close_gate("ssd_check", "scan h_final", hf,
                                            hr, SSD_TOL),
           "chunked_ms": time_ms(
               lambda: ssm._ssd_chunked(x, dt, A, B, C, cfg.chunk), 10),
           "reference_ms": time_ms(
               lambda: ssm.ssd_reference(x, dt, A, B, C), 2, warmup=1)}
    cpu_gen = torch.Generator().manual_seed(4)
    params = ssm.ssd_init(cpu_gen, cfg)
    xin = torch.randn((b, s, cfg.d_model), generator=cpu_gen)
    pol = L.Policy(compute_dtype=torch.float32)
    with torch.no_grad():
        t0 = time.perf_counter()
        want, _ = ssm.ssd_block(params, xin, cfg, policy=pol)
        cpu_s = time.perf_counter() - t0
        pc, xc = tree_map(lambda t: t.cuda(), params), xin.cuda()
        got, _ = ssm.ssd_block(pc, xc, cfg, policy=pol)
        row["block_max_abs_err"] = close_gate(
            "ssd_check", "block cuda vs cpu", got.cpu(), want, SSD_TOL)
        row["block_ms"] = time_ms(
            lambda: ssm.ssd_block(pc, xc, cfg, policy=pol), 10)
    row.update({"block_d_model": cfg.d_model, "block_cpu_s": cpu_s})
    print("ssd_check " + json.dumps(row), flush=True)
    del x, dt, A, B, C, y, hf, yr, hr, pc, xc, got
    torch.cuda.empty_cache()
    return row


# RG-LRU on the card: prefill then decode against the stateless block at the
# reference test's bound (tests/test_special_layers.py:93-105); the scan's
# gradients against the oracle's at this share of each leaf's largest entry
LRU_DECODE_TOL = 2e-4
LRU_GRAD_TOL = 1e-4


def scale_gate(phase: str, label: str, got: torch.Tensor,
               want: torch.Tensor, tol: float) -> float:
    """max |got - want| <= tol · max |want|, everywhere finite; returns
    max |got - want| / max |want|."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{phase} {label}: non-finite values")
    rel = float((got - want).abs().max() / want.abs().max())
    if not rel <= tol:
        raise AssertionError(f"{phase} {label}: max |got - want| is {rel} "
                             f"of max |want|, over {tol}")
    return rel


def lru_check() -> dict:
    """recurrentgemma-9b's RG-LRU block (``models/hybrid.py``) on the card at
    its widths (d 4096, lru width 4096, conv width 4, from the port's config
    copy), seeded; the layer reaches no kernel, so every launch count must
    stay 0.  At B=2, S=4096, f32: ``_rg_lru``'s scan against
    ``rg_lru_reference`` without and with a seeded ``h0`` (y and the final
    state), and the chunked form at ``scan_chunk`` 4096 (the reference's
    tuned setting, ``repro/launch/cells.py:116``: the full scan here)
    and 256 against the full scan, all at ``SSD_TOL``.  At B=1, S=1024: the
    gradients of ``_rg_lru``'s output under a seeded cotangent with respect
    to x, ``wr``, ``wi`` and Λ against the oracle's; one f32 ``lru_block``
    on the card against the CPU.  At B=2: a 1024-token prefill through the
    state, then 32 decode steps, against the stateless block over all 1056
    tokens.  Times by CUDA events at B=2, S=4096, each beside its bound: the
    scan alone (full, chunked, the oracle's step loop) and the bytes
    autograd keeps for its backward, the block forward in f32 and in bf16,
    a bf16 forward + backward (f32 master params, as FR keeps them) with its
    peak over the memory held before it, one S=1 decode step."""
    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.models import hybrid, layers as L
    from repro_torch.utils import cast_tree, tree_leaves, tree_map
    full = recurrentgemma_9b.FULL
    cfg = hybrid.LRUConfig(d_model=full.d_model, lru_width=full.lru_width,
                           conv_width=full.conv_width)
    b, s, d, w = 2, 4096, cfg.d_model, cfg.lru_width
    pol = L.Policy(compute_dtype=torch.float32)
    pol16 = L.Policy(compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    zero_counts()
    params = hybrid.lru_init(gen, cfg, device="cuda")
    x, h0 = randn(b, s, w), randn(b, w, scale=0.1)
    row = {"arch": full.name, "d_model": d, "lru_width": w, "x": [b, s, w],
           "tol": SSD_TOL}
    with torch.no_grad():
        for tag, h in (("", None), ("h0_", h0)):
            y, hf = hybrid._rg_lru(params, x, pol, h0=h)
            yr, hr = hybrid.rg_lru_reference(params, x, pol, h0=h)
            row[f"scan_{tag}y_max_abs_err"] = close_gate(
                "lru_check", f"scan {tag}y", y, yr, SSD_TOL)
            row[f"scan_{tag}h_max_abs_err"] = close_gate(
                "lru_check", f"scan {tag}h_final", hf, hr, SSD_TOL)
        for chunk in (4096, 256):
            yc, hc = hybrid._rg_lru(params, x, pol, h0=h0, scan_chunk=chunk)
            row[f"chunk{chunk}_y_max_abs_err"] = close_gate(
                "lru_check", f"chunk {chunk} y", yc, y, SSD_TOL)
            row[f"chunk{chunk}_h_max_abs_err"] = close_gate(
                "lru_check", f"chunk {chunk} h_final", hc, hf, SSD_TOL)
        del y, hf, yr, hr, yc, hc
        a, gx = hybrid._gates(params, x, pol)
        row.update({
            "scan_ms": time_ms(lambda: hybrid._scan_from(a, gx), 10),
            "chunk4096_ms": time_ms(
                lambda: hybrid._scan_from(a, gx, h0, 4096), 10),
            "chunk256_ms": time_ms(
                lambda: hybrid._scan_from(a, gx, h0, 256), 10),
            "oracle_ms": time_ms(lambda: hybrid._recurrence(a, gx, h0), 2,
                                 warmup=1),
            # a and gated_x read once, y written once
            "scan_bound_ms": 3 * b * s * w * 4 / PEAK_BYTES * 1e3,
            "scan_bound_by": "bytes"})

    def saved_bytes(scan_chunk) -> int:
        """Bytes autograd keeps for the scan's backward beyond its inputs
        (each storage once)."""
        ag, gg = a.detach().requires_grad_(), gx.detach().requires_grad_()
        held = {}

        def pack(t):
            held[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            hybrid._scan_from(ag, gg, h0, scan_chunk)
        for t in (ag, gg):
            held.pop(t.untyped_storage().data_ptr(), None)
        return sum(held.values())

    row.update({"scan_input_bytes": 2 * a.numel() * a.element_size(),
                "scan_saved_bytes": saved_bytes(None),
                "chunk256_saved_bytes": saved_bytes(256)})
    del a, gx

    sg = 1024                    # the gradient against the oracle's
    xg = x[:1, :sg].clone().requires_grad_()
    pg = {**params, "lambda": params["lambda"].clone().requires_grad_(),
          **{k: tree_map(lambda t: t.clone().requires_grad_(), params[k])
             for k in ("wr", "wi")}}
    wrt = {"x": xg, "wr/w": pg["wr"]["w"], "wr/b": pg["wr"]["b"],
           "wi/w": pg["wi"]["w"], "wi/b": pg["wi"]["b"],
           "lambda": pg["lambda"]}
    ct = randn(1, sg, w)

    def grads(fn):
        return torch.autograd.grad(fn(pg, xg, pol)[0], list(wrt.values()),
                                   ct)

    got, want = grads(hybrid._rg_lru), grads(hybrid.rg_lru_reference)
    row["grad_tol"] = LRU_GRAD_TOL
    row["grad_max_err_over_scale"] = {
        n: scale_gate("lru_check", f"grad {n}", g, wt, LRU_GRAD_TOL)
        for n, g, wt in zip(wrt, got, want)}
    del xg, pg, wrt, got, want, x

    cpu_gen = torch.Generator().manual_seed(9)
    cparams = hybrid.lru_init(cpu_gen, cfg)
    xin = torch.randn((1, 1024, d), generator=cpu_gen)
    with torch.no_grad():
        t0 = time.perf_counter()
        want, _ = hybrid.lru_block(cparams, xin, cfg, policy=pol)
        row["block_cpu_s"] = time.perf_counter() - t0
        got, _ = hybrid.lru_block(tree_map(lambda t: t.cuda(), cparams),
                                  xin.cuda(), cfg, policy=pol)
        row["block_max_abs_err"] = close_gate(
            "lru_check", "block cuda vs cpu", got.cpu(), want, SSD_TOL)
        del cparams, got

        xb = randn(b, 1056, d)
        want, _ = hybrid.lru_block(params, xb, cfg, policy=pol)
        st = hybrid.lru_state_init(cfg, b, device="cuda")
        outs = []
        for lo, hi in [(0, 1024)] + [(t, t + 1) for t in range(1024, 1056)]:
            o, st = hybrid.lru_block(params, xb[:, lo:hi], cfg, policy=pol,
                                     state=st)
            outs.append(o)
        row["decode_tol"] = LRU_DECODE_TOL
        row["prefill_decode_max_abs_err"] = close_gate(
            "lru_check", "prefill then decode", torch.cat(outs, 1), want,
            LRU_DECODE_TOL)
        last = xb[:, -1:]
        row["decode_ms"] = time_ms(lambda: hybrid.lru_block(
            params, last, cfg, policy=pol, state=st), 20)
        # every param read once, the state read and written once
        row["decode_bound_ms"] = (tree_nbytes(params) + 2 * tree_nbytes(st)
                                  ) / PEAK_BYTES * 1e3
        del xb, want, outs

        flops = 2 * b * s * (3 * d * w + 2 * w * w)     # wx, wy, wo; wr, wi
        xf = randn(b, s, d)
        p16, x16 = cast_tree(params, torch.bfloat16), xf.bfloat16()
        row.update({
            "block_x": [b, s, d],
            "block_f32_ms": time_ms(
                lambda: hybrid.lru_block(params, xf, cfg, policy=pol), 5),
            "block_f32_bound_ms": flops / PEAK_FLOPS[torch.float32] * 1e3,
            "block_bf16_ms": time_ms(
                lambda: hybrid.lru_block(p16, x16, cfg, policy=pol16), 10),
            "block_bf16_bound_ms": flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
            "block_bound_by": "operations"})
        del p16, xf

    leaves = [t.requires_grad_() for t in tree_leaves(params)] + \
        [x16.requires_grad_()]
    ct16 = randn(b, s, d).bfloat16()

    def fwd_bwd():
        y, _ = hybrid.lru_block(params, x16, cfg, policy=pol16)
        return torch.autograd.grad(y, leaves, ct16)

    fwd_bwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = fwd_bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del g
    row.update({"fwd_bwd_base_bytes": base, "fwd_bwd_peak_bytes": peak,
                "fwd_bwd_over_base_bytes": peak - base,
                "fwd_bwd_ms": time_ms(fwd_bwd, 5),
                # forward, and the two products of each GEMM's backward
                "fwd_bwd_bound_ms": 3 * flops / PEAK_FLOPS[torch.bfloat16]
                * 1e3})
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"lru_check launched kernels: {counts}")
    row["launches"] = counts
    print("lru_check " + json.dumps(row), flush=True)
    del params, leaves, x16, ct16, st, last
    torch.cuda.empty_cache()
    return row


def masked_exponents(entry, cfg, policy, backbone, tokens) -> list:
    """Each SSD layer's largest exponent in the scan's masked exp, in a
    forward of ``tokens``: the largest dAcs_i - dAcs_j with i < j (above the
    diagonal, the entries the mask drops after the exp) over batch, chunks
    and heads, i.e. a chunk's sum of dt·|A| over all its steps but the
    first."""
    import torch.nn.functional as F
    from repro_torch.models import ssm
    out = []

    def see(x, dt, A, B, C, chunk, h0=None):
        b, s, h = dt.shape
        q = min(chunk, s)
        dA = F.pad(dt * A, (0, 0, 0, -s % q)).reshape(b, -1, q, h)
        out.append(float(-dA[:, :, 1:].sum(dim=2).min()))

    with torch.no_grad(), watching(ssm, "_ssd_chunked", see):
        entry.module.forward(backbone, cfg, tokens, policy=policy)
    return out


def first_layers(state: dict, n: int) -> dict:
    """``state`` with every layer-stacked leaf (``.../stack/...``: the
    backbone's and the optimizer's) cut to its first ``n`` layers."""
    from repro_torch.utils import tree_flatten, tree_unflatten
    return tree_unflatten([
        (p, t[:n].clone() if "stack" in p.split("/") else t)
        for p, t in tree_flatten(state)])


def valid_depth(cfg, n: int) -> int:
    """The deepest layer count of ``cfg``'s shape at most ``n``: its
    remainder and a whole number, at least one, of pattern repeats (0 if
    none fits)."""
    reps = max(n - len(cfg.remainder), 0) // len(cfg.pattern)
    return len(cfg.remainder) + reps * len(cfg.pattern) if reps else 0


def reckon_full_depth(arch: str, label: str, cuts: tuple = (2, 4),
                      batch_size: int = 4, seq: int = 1024) -> tuple:
    """The FR depth of a model at full width, as (layers drawn at init,
    layers kept).  Drawn: the deepest valid cut (``valid_depth``) whose
    peak, reckoned as a line through two shallow cuts' measured peaks
    (``cuts``, each valid; init and two steps each, at the path's B and
    S), stays under FR_PEAK_LIMIT (``<label>_reckon`` line).  Kept, for an
    SSD model: at that cut's init (``run_full_path``'s seed) and first
    batch, each ``ssd`` layer's largest masked exponent is read
    (``<label>_exponents`` line); past log(f32 max) the exp above the
    diagonal is inf, and the reference's ``where`` after the exp makes the
    backward NaN there (a zero cotangent times an infinite derivative), in
    JAX as here.  The same draw is kept up to the first layer that passes
    it; the layers kept see the same inputs, so their exponents stay as
    read.  A model with no ``ssd`` layer keeps the whole draw, and its line
    says so."""
    from repro_torch.models import layers as L, registry
    from repro_torch.train import train_step as ts
    entry = registry.get(arch)
    policy = L.Policy(compute_dtype=torch.bfloat16)
    tcfg = ts.TrainConfig(mode="full")
    batch = cuda_batch(entry.full, seq, batch_size, 0)
    peaks = {}
    for n in cuts:
        if valid_depth(entry.full, n) != n:
            raise AssertionError(f"{label}: a cut of {n} layers is not a "
                                 f"depth of {arch}'s pattern")
        cfg = dc.replace(entry.full, n_layers=n).validate()
        step = ts.make_train_step(entry, cfg, tcfg, policy)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = ts.init_state(torch.Generator(device="cuda").manual_seed(0),
                           entry, cfg, tcfg, policy, device="cuda")
        for _ in range(2):
            st, m = step(st, batch)
        float(m["loss"])
        peaks[n] = torch.cuda.max_memory_allocated()
        del st, m
    (n1, p1), (n2, p2) = sorted(peaks.items())
    per_layer = (p2 - p1) / (n2 - n1)
    fixed = p1 - n1 * per_layer
    depth = valid_depth(entry.full, min(
        entry.full.n_layers, int((FR_PEAK_LIMIT - fixed) // per_layer)))
    print(f"{label}_reckon: batch {batch_size} seq {seq} peaks_bytes "
          f"{json.dumps(peaks)} per_layer_bytes {per_layer!r} fixed_bytes "
          f"{fixed!r} limit_bytes {FR_PEAK_LIMIT!r} depth {depth} of "
          f"{entry.full.n_layers} (rounded down to the pattern) "
          f"reckoned_peak_bytes {fixed + depth * per_layer!r}", flush=True)
    cfg = dc.replace(entry.full, n_layers=depth).validate()
    n_ssd = kind_layers(cfg, "ssd")
    exps = []
    if n_ssd:
        st = ts.init_state(torch.Generator(device="cuda").manual_seed(0),
                           entry, cfg, tcfg, policy, device="cuda")
        exps = masked_exponents(entry, cfg, policy, st["backbone"],
                                batch["tokens"])
        del st
        torch.cuda.empty_cache()
    over = [i for i, e in enumerate(exps) if e > LOG_F32_MAX]
    kept = over[0] if over else depth
    print(f"{label}_exponents: depth {depth} ssd_layers {n_ssd} "
          f"log_f32_max {LOG_F32_MAX!r} max_masked_exponent_by_layer "
          f"{json.dumps(exps)} overflow_layers {over} kept {kept}"
          + ("" if n_ssd else " (no ssd layer: no masked exponent, the "
             "whole draw is kept)"), flush=True)
    if not kept:
        raise AssertionError(f"{label}: layer 0's masked exponent overflows "
                             f"f32; no depth is finite")
    return depth, kept


def run_full_path(duplex: dict, arch: str = "granite-3-8b",
                  n_layers: int | None = 8, label: str = "full",
                  batch_size: int = 4, seq: int = 1024,
                  drawn: int | None = None) -> dict:
    """The full finetune (FR) through ``train.loop``: TrainConfig(mode=
    "full") as the launcher builds it (SGD momentum 0.9, lr 1e-3), f32
    params, bf16 compute, flash off, random weights from seed 0.
    ``full``: granite-3-8b at full width, depth cut to 8 of 40 layers, B=4,
    S=1024 (the full_attention path); ``moe_full``: granite-moe-1b-a400m
    whole at the same B and S, which also checks that the router and the
    experts of the first layer moved and that the loss carries
    ``aux_weight·aux``; ``gemma2_full``: gemma2-9b at full width, depth cut
    to 4 of 42 layers (two local, two global), B=1, S=2048, so that every
    layer takes the blockwise path and its backward, and the softcapped
    unembedding too; ``mamba2_full``: mamba2-780m at full width, B=4,
    S=1024, the first ``n_layers`` of a ``drawn``-layer init, as
    ``reckon_full_depth`` gives them, which also checks that layer 0's SSD
    leaves moved; ``whisper_full``: whisper-base whole, B=4, S=1024, with
    the launcher's stub frames, which also checks that layer 0's encoder
    query projection, decoder cross-layer key projection (which reads only
    the encoder's output) and that layer's MLP input moved;
    ``recurrentgemma_full``: recurrentgemma-9b at full width, B=1, S=4096
    (past its 2048 window), at the depth ``reckon_full_depth`` gives, which
    also checks that layer 0's RG-LRU input projection, Λ and conv and the
    first ``local`` layer's query projection moved.  ``duplex`` is the
    numbers of the same model's duplex path, whose peak is printed
    beside."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import loop_step, stub_frontend
    from repro_torch.models import layers as L, registry, transformer as tr
    from repro_torch.train import loop, train_step as ts
    from repro_torch.utils import count_params, tree_checksum
    entry = registry.get(arch)
    cfg = entry.full if n_layers is None else \
        dc.replace(entry.full, n_layers=n_layers).validate()
    policy = L.Policy(compute_dtype=torch.bfloat16)
    tcfg = ts.TrainConfig(mode="full")
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    moe, ssm = cfg.family == "moe", cfg.family == "ssm"
    hybrid, encdec = cfg.family == "hybrid", cfg.encoder is not None
    fe = stub_frontend(entry, cfg, batch_size, policy.compute_dtype, "cuda")
    initial = {}

    def watched(backbone):
        """Leaves the FR gradient must reach: the MoE router and experts
        (stacked over the layers), layer 0's SSD input projection, decay,
        step bias and conv, layer 0's RG-LRU ``wx``, Λ and conv and the
        first ``local`` layer's ``attn/wq``, or layer 0's encoder
        ``attn/wq`` and decoder cross layer's ``attn/wk`` and
        ``mlp/wi``."""
        if encdec:
            enc = tr._index(backbone["encoder"]["stack"], 0)["sub0"]
            i = [s.kind for s in cfg.pattern].index("cross")
            cross = tr._index(backbone["decoder"]["stack"], 0)[f"sub{i}"]
            return {"encoder/attn/wq": tree_checksum(enc["attn"]["wq"]),
                    f"decoder/sub{i}/attn/wk": tree_checksum(
                        cross["attn"]["wk"]),
                    f"decoder/sub{i}/mlp/wi": tree_checksum(
                        cross["mlp"]["wi"])}
        sub = backbone["stack"]["sub0"]
        if moe:
            return {"router": tree_checksum(sub["moe"]["router"]["w"]),
                    "wi": tree_checksum(sub["moe"]["wi"])}
        if ssm:
            return {k: tree_checksum(tr._index({k: sub["ssd"][k]}, 0))
                    for k in ("x_proj", "A_log", "dt_bias", "conv_x")}
        if hybrid:
            i = [s.kind for s in cfg.pattern].index("local")
            local = tr._index(backbone["stack"], 0)[f"sub{i}"]
            return {**{f"sub0/lru/{k}": tree_checksum(
                           tr._index({k: sub["lru"][k]}, 0))
                       for k in ("wx", "lambda", "conv_w")},
                    f"sub{i}/attn/wq": tree_checksum(local["attn"]["wq"])}
        return {}

    def init_fn():
        st = ts.init_state(
            torch.Generator(device="cuda").manual_seed(0), entry,
            cfg if drawn is None else dc.replace(cfg, n_layers=drawn),
            tcfg, policy, device="cuda")
        if drawn not in (None, cfg.n_layers):
            st = first_layers(st, cfg.n_rep)
        initial["checksum"] = tree_checksum(st["backbone"])
        initial["params"] = count_params(st["backbone"])
        initial["watched"] = watched(st["backbone"])
        return st

    data = DataConfig(vocab=cfg.vocab, seq_len=seq,
                      batch_per_host=batch_size, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    report = loop.run(loop.LoopConfig(total_steps=MAIN_STEPS, log_every=1),
                      data, loop_step(step, "cuda", fe), init_fn,
                      log_fn=lambda s: None)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    after = tree_checksum(report.state["backbone"])
    for m in report.metrics_history:
        print(f"{label}_step {m['step']}: loss {m['loss']!r} step_time_s "
              f"{m['step_time_s']!r} grad_norm {m['grad_norm']!r}",
              flush=True)
    kinds = [s.kind for s in cfg.pattern] * cfg.n_rep + \
        [s.kind for s in cfg.remainder]
    print(f"{label}_path: arch {arch} layers {cfg.n_layers} of "
          f"{entry.full.n_layers} kinds {json.dumps(kinds)} encoder_layers "
          f"{cfg.encoder.n_layers if encdec else 0} frontend "
          f"{frontend_shapes(fe)} "
          f"backbone_params "
          f"{initial['params']} batch {batch_size} seq {seq} steps "
          f"{report.steps_run} "
          f"wall_s {wall!r} max_memory_allocated_bytes {peak} "
          f"duplex_{duplex['label']}_path_peak_bytes "
          f"{duplex['peak_bytes']} "
          f"backbone_checksum {initial['checksum']} -> {after} launches "
          f"{json.dumps(counts)}", flush=True)
    losses = [m["loss"] for m in report.metrics_history]
    if len(losses) != MAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label} path losses not finite: {losses}")
    if after == initial["checksum"]:
        raise AssertionError(f"{label} path: the backbone did not change")
    if any(counts.values()):
        raise AssertionError(f"{label} path launched kernels {counts}; with "
                             f"flash off and no BFP op it launches none")
    batch = cuda_batch(cfg, seq, batch_size, 0, fe)
    moved = {k: v != initial["watched"][k]
             for k, v in watched(report.state["backbone"]).items()}
    if ssm or hybrid or encdec:
        where = "layer 0" if encdec else \
            "stack/sub0/ssd layer 0" if ssm else "stack layer 0"
        print(f"{label}_moved: {where} changed {json.dumps(moved)}",
              flush=True)
        if not all(moved.values()):
            raise AssertionError(f"{label} path: the gradient did not reach "
                                 f"layer 0's leaves: {moved}")
    if moe:
        # the step's objective (metrics["loss"] is the cross-entropy alone)
        with torch.no_grad():
            total, ms = ts.make_loss_fn(entry, cfg, tcfg, policy)(
                report.state["backbone"], None, batch)
            aux = float(entry.module.forward(report.state["backbone"], cfg,
                                             batch["tokens"],
                                             policy=policy)["aux"])
        gap = float(total) - float(ms["loss"])
        print(f"{label}_aux: objective {float(total)!r} cross_entropy "
              f"{float(ms['loss'])!r} aux {aux!r} aux_weight "
              f"{tcfg.aux_weight!r} objective_minus_ce {gap!r} "
              f"stack/sub0/moe changed {json.dumps(moved)}", flush=True)
        if not all(moved.values()):
            raise AssertionError(f"{label} path: the gradient did not reach "
                                 f"the router and the experts: {moved}")
        if not (math.isfinite(aux) and aux > 0 and math.isclose(
                gap, tcfg.aux_weight * aux, rel_tol=1e-3, abs_tol=1e-5)):
            raise AssertionError(f"{label} path: objective - cross-entropy "
                                 f"{gap} is not aux_weight * aux = "
                                 f"{tcfg.aux_weight * aux}")
    profile_step(entry, cfg, tcfg, policy, report.state, batch,
                 label=f"{label}_profile")
    times = [m["step_time_s"] for m in report.metrics_history]
    del report, batch
    torch.cuda.empty_cache()
    return {"peak_bytes": peak, "step_times": times}


def run_cut_path(arch: str, n_layers: int, label: str,
                 steps: int = 2) -> tuple:
    """A model at full width with its depth cut to ``n_layers``: the duplex
    step, flash on, B=2, S=4096, ``steps`` steps, through ``train.loop``,
    every batch with the launcher's stub frontend if the arch has one; then
    the flash loss against the plain attention loss on the final state and
    the first batch.  Gates: finite losses, the backbone unchanged, the
    branch moved, one flash launch per ``attn`` layer and step and no other
    kernel.  Returns the path's numbers and its run (entry, configs, final
    state, first batch), which the caller reads further and then drops."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.cells import duplex_tcfg
    from repro_torch.launch.train import loop_step, stub_frontend
    from repro_torch.models import layers as L, registry
    from repro_torch.train import loop, train_step as ts
    from repro_torch.utils import count_params, tree_checksum, tree_leaves
    entry = registry.get(arch)
    cfg = dc.replace(entry.full, n_layers=n_layers, use_flash=True).validate()
    policy = L.Policy(compute_dtype=torch.bfloat16)
    tcfg = duplex_tcfg(cfg)
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    fe = stub_frontend(entry, cfg, 2, policy.compute_dtype, "cuda")
    initial = {}

    def init_fn():
        st = ts.init_state(torch.Generator(device="cuda").manual_seed(0),
                           entry, cfg, tcfg, policy, device="cuda")
        initial["checksum"] = tree_checksum(st["backbone"])
        initial["params"] = count_params(st["backbone"])
        initial["bytes"] = tree_nbytes(st["backbone"])
        initial["branch"] = [t.clone() for t in tree_leaves(st["branch"])]
        return st

    data = DataConfig(vocab=cfg.vocab, seq_len=4096, batch_per_host=2,
                      seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    report = loop.run(loop.LoopConfig(total_steps=steps, log_every=1),
                      data, loop_step(step, "cuda", fe), init_fn,
                      log_fn=lambda s: None)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    after = tree_checksum(report.state["backbone"])
    moved = max(float((a - b).abs().max()) for a, b in zip(
        initial.pop("branch"), tree_leaves(report.state["branch"])))
    n_attn = flash_layers(cfg)
    for m in report.metrics_history:
        print(f"{label}_step {m['step']}: loss {m['loss']!r} step_time_s "
              f"{m['step_time_s']!r} grad_norm {m['grad_norm']!r}",
              flush=True)
    kinds = [s.kind for s in cfg.pattern] * cfg.n_rep + \
        [s.kind for s in cfg.remainder]
    print(f"{label}_path: arch {arch} layers {cfg.n_layers} of "
          f"{entry.full.n_layers} kinds {json.dumps(kinds)} frontend "
          f"{frontend_shapes(fe)} backbone_params {initial['params']} "
          f"backbone_bytes {initial['bytes']} batch 2 seq 4096 steps "
          f"{report.steps_run} wall_s {wall!r} max_memory_allocated_bytes "
          f"{peak} flash_launches {counts['flash_attention']} expected "
          f"{n_attn * steps} backbone_checksum {initial['checksum']} -> "
          f"{after} branch_max_abs_change {moved!r} launches "
          f"{json.dumps(counts)}", flush=True)
    losses = [m["loss"] for m in report.metrics_history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label} path losses not finite: {losses}")
    if after != initial["checksum"]:
        raise AssertionError(f"{label} path: the backbone changed")
    if not moved > 0:
        raise AssertionError(f"{label} path: the branch did not move")
    if counts["flash_attention"] != n_attn * steps or \
            sum(counts.values()) != counts["flash_attention"]:
        raise AssertionError(f"{label} path launched {counts}; expected "
                             f"{n_attn * steps} flash launches and no "
                             f"other kernel")
    batch = cuda_batch(cfg, 4096, 2, report.metrics_history[0]["step"], fe)
    check_plain_attention(entry, cfg, tcfg, policy, report.state, batch,
                          label)
    run = {"entry": entry, "cfg": cfg, "policy": policy,
           "state": report.state, "batch": batch,
           "params": initial["params"]}
    return {"launches": counts["flash_attention"], "peak_bytes": peak}, run


def run_moe_top1_path() -> dict:
    """llama4-maverick-400b-a17b at full width (128 experts top-1 with a
    shared expert, d 5120, 40 heads, kv 8, head dim 128, vocab 202,048),
    depth cut to 1 of 48 layers (one layer's experts are 16.1 B params,
    32.2 GB in bf16), through ``run_cut_path``; then the share of (token,
    pass) assignments that the first step's MoE layer dropped, from the
    port's routing of that layer's input (``moe_top1_route`` line)."""
    from repro_torch.models import moe
    numbers, run = run_cut_path("llama4-maverick-400b-a17b", 1, "moe_top1")
    first = []     # the backbone is frozen: step 0's MoE input again
    with torch.no_grad(), first_call(moe, "moe_apply", first):
        run["entry"].module.forward(run["state"]["backbone"], run["cfg"],
                                    run["batch"]["tokens"],
                                    policy=run["policy"])
        keep, cap, g = routing(*first[0], run["policy"])
    dropped = 1.0 - float(keep.float().mean())
    print(f"moe_top1_route: layer 0 group {g} capacity {cap} dropped_share "
          f"{dropped!r}", flush=True)
    if not 0.0 <= dropped < 1.0:
        raise AssertionError(f"moe_top1 path: dropped share {dropped}")
    del first, keep, run
    torch.cuda.empty_cache()
    return numbers


VISION_LAYERS = 5       # one superblock of llama-3.2-vision: 4 attn + cross


def run_vision_path() -> tuple:
    """llama-3.2-vision-90b at full width (d 8192, 64 heads, kv 8, head dim
    128, d_ff 28,672, vocab 128,256), depth cut to one superblock, 5 of 100
    layers (4 ``attn`` + 1 ``cross``; 100 layers are 86.6 G params), through
    ``run_cut_path`` with the launcher's stub ``cross_kv`` [2, 1600, 8192]
    in bf16.  Returns the path's numbers and its run, which
    ``vision_causality`` reads."""
    numbers, run = run_cut_path("llama-3.2-vision-90b", VISION_LAYERS,
                                "vision")
    params = run["params"]
    print(f"vision_full_path: not run: one superblock at full width is "
          f"{params} params, so FR's f32 params, gradients and SGD momentum "
          f"alone take {12 * params} bytes of the card's 80 GB before any "
          f"activation; its full-mode steps are held against JAX on the CPU "
          f"(tests/test_torch_encdec.py)", flush=True)
    return numbers, run


def vision_causality(run: dict, position: int = 4000) -> None:
    """On the vision path's final state: change token ``position`` of the
    first batch and read the largest change of the backbone's hidden state
    at the positions before it, with the run's stub frontend (gated: 0,
    since the cross layer reads the stub) and without a frontend (printed,
    not gated: the cross layer then attends to its own input, non-causally,
    as the reference's does)."""
    entry, cfg, policy = run["entry"], run["cfg"], run["policy"]
    backbone, batch = run["state"]["backbone"], run["batch"]
    tokens = batch["tokens"]
    late = tokens.clone()
    late[:, position] = (late[:, position] + 1) % cfg.vocab

    def change(frontend):
        kw = {} if frontend is None else {"frontend": frontend}
        with torch.no_grad():
            a, b = (entry.module.forward(backbone, cfg, t, policy=policy,
                                         **kw)["hidden"][:, :position]
                    for t in (tokens, late))
            return float((a.float() - b.float()).abs().max())

    with_fe, without = change(batch["frontend"]), change(None)
    print(f"vision_causality: changed token {position} of "
          f"{tokens.shape[1]}; max |change| of the hidden state at positions "
          f"0-{position - 1}: with_frontend {with_fe!r} "
          f"without_frontend {without!r} (the reference's cross layer "
          f"without a frontend attends to its own input, non-causally)",
          flush=True)
    if with_fe != 0.0:
        raise AssertionError(f"vision_causality: with the stub frontend a "
                             f"late token moved earlier hidden states by "
                             f"{with_fe}")


def window_gate(run: dict, label: str, seq: int = 4096) -> dict:
    """A ``local`` layer's window at full width on the card: the first
    ``local`` sublayer of the path's final (frozen) backbone, cast to f32,
    over a seeded f32 input [1, ``seq``, d], and the same input with
    position 0 changed; the largest change of the sublayer's output at
    positions ``window``..``seq - 1`` must be exactly 0 (those queries'
    windows exclude key 0), and at some position in 1..``window - 1`` not
    0 (``<label>_window`` line, with the sublayer's time)."""
    from repro_torch.models import layers as L, transformer as tr
    from repro_torch.utils import cast_tree
    cfg = run["cfg"]
    i = [sp.kind for sp in cfg.pattern].index("local")
    spec, w = cfg.pattern[i], cfg.window
    sub = cast_tree(tr._index(run["state"]["backbone"]["stack"], 0)[
        f"sub{i}"], torch.float32)
    pol = L.Policy(compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((1, seq, cfg.d_model), generator=gen, device="cuda")
    moved = x.clone()
    moved[:, 0] += torch.randn((cfg.d_model,), generator=gen, device="cuda")
    positions = torch.arange(seq, device="cuda")[None]

    def apply(h):
        return tr._sub_apply(sub, h, spec, cfg, policy=pol, bfp=L.NO_BFP,
                             cross_kv=None, positions=positions)[0]

    with torch.no_grad():
        change = (apply(moved) - apply(x)).abs().amax(dim=(0, 2))
        row = {"sublayer": f"stack/sub{i}", "kind": spec.kind, "window": w,
               "x": list(x.shape), "changed_position": 0,
               "max_change_inside_window": float(change[1:w].max()),
               "max_change_past_window": float(change[w:].max()),
               "last_moved_position": int(change.nonzero().max()),
               "sublayer_f32_ms": time_ms(lambda: apply(x), 5)}
    print(f"{label}_window " + json.dumps(row), flush=True)
    if row["max_change_past_window"] != 0.0:
        raise AssertionError(f"{label}_window: position 0 moved outputs "
                             f"past the window by "
                             f"{row['max_change_past_window']}")
    if not row["max_change_inside_window"] > 0:
        raise AssertionError(f"{label}_window: position 0 moved no output "
                             f"inside the window")
    del sub, x, moved, change
    torch.cuda.empty_cache()
    return row


# Serving: granite-3-8b at B=4 with a 2048-token prompt, gemma2-9b at B=2
# with a 4608-token prompt, past its 4096 window, so that every local ring
# wraps, mamba2-780m at B=4 with a 2048-token prompt, whisper-base at B=8
# with a 384-token prompt over 1500 stub frames, and llama-3.2-vision-90b,
# cut to one superblock, at B=2 with a 2048-token prompt over a stub
# cross_kv of 1600, and recurrentgemma-9b at B=2 with a 4608-token prompt,
# past its 2048 window, so that every local ring wraps; 32 generated tokens
# give max_len prompt + 32 + 8, as the launcher reckons it (2088; 4648;
# mamba2's state has no length; 424, under whisper's 448-position decoder
# context; 4648).
SERVE_GEN = 32
SERVE_CASES = {"granite-3-8b": (4, 2048), "gemma2-9b": (2, 4608),
               "mamba2-780m": (4, 2048), "whisper-base": (8, 384),
               "llama-3.2-vision-90b": (2, 2048),
               "recurrentgemma-9b": (2, 4608)}
DECODE_TOL = 1e-4
# k is cached after rope, whose angle at position p is p x a frequency
# that the card's exp and the CPU's may round one ulp apart (about 1.2e-4
# rad at 2047); the written k slot is held to this bound instead
ROPE_K_TOL = 1e-3
# granite-3-8b's bf16 serving against its bf16 forward
SERVE_REL_TOL = 2e-2
# f32 serving against the f32 forward: the same function in another order
SERVE_F32_TOL = 1e-4
# bf16 serving's error against the f32 forward, over the bf16 forward's
BF16_FLOOR_RATIO = 1.1


def serve_max_len(arch: str) -> int:
    return SERVE_CASES[arch][1] + SERVE_GEN + 8


def serve_cfg(arch: str):
    """The config an arch is served at: its full one, llama-3.2-vision-90b's
    cut to ``VISION_LAYERS`` (its 100 layers are 86.6 G params, 173 GB in
    bf16)."""
    from repro_torch.models import registry
    cfg = registry.get(arch).full
    if arch == "llama-3.2-vision-90b":
        cfg = dc.replace(cfg, n_layers=VISION_LAYERS).validate()
    return cfg


def cross_cache_bytes(cfg, cache) -> int:
    """The bytes of a serving cache's ``cross`` layers (k and v)."""
    keys = [f"sub{i}" for i, s in enumerate(cfg.pattern) if s.kind == "cross"]
    return sum(tree_nbytes(cache["stack"][k]) for k in keys)


def cache_positions(cache) -> list:
    """The positions a serving cache holds, sorted and distinct: every
    ``len`` leaf's values, or its ``step`` when it has one (no ``attn`` or
    ``local`` layer)."""
    from repro_torch.utils import tree_flatten
    return sorted({int(x) for p, t in tree_flatten(cache)
                   if p.endswith("len") or p == "step"
                   for x in t.reshape(-1)})


def _decode_case(case: str, arch: str, spec_i: int, batch: int, held: int):
    """One ``decode_check`` case: ``arch``'s pattern layer ``spec_i`` at full
    width, f32, ``batch`` rows, a seeded cache holding positions up to
    ``held - 1`` (a ring keeps the last ``size`` of them at slots ``t %
    size``), then one step at position ``held`` on the card and on the CPU
    with the same params and inputs: the output and v at ``DECODE_TOL``,
    the k slot written at ``ROPE_K_TOL`` beside the largest angle
    difference the two devices' rope frequencies give there, every other k
    slot equal, ``len`` (and a ring's ``pos``) exact.  The card's step is
    timed by CUDA events, each call on the same slot (a fresh ``len``)."""
    from repro_torch.models import layers as L, registry, transformer as tr
    from repro_torch.utils import tree_map
    cfg = registry.get(arch).full
    spec = cfg.pattern[spec_i]
    acfg = tr.attn_cfg_for(cfg, spec)
    gen = torch.Generator().manual_seed(5)
    params = L.attn_init(gen, acfg)
    x = torch.randn((batch, 1, cfg.d_model), generator=gen)
    cache = tr._sub_cache_init(cfg, spec, batch, serve_max_len(arch),
                               torch.float32, device="cpu")
    size = cache["k"].shape[1]
    ring = "pos" in cache
    kept = torch.arange(max(0, held - size), held)
    slots = kept % size
    for leaf in ("k", "v"):
        cache[leaf][:, slots] = torch.randn(
            (batch, len(kept), acfg.n_kv, acfg.head_dim), generator=gen)
    if ring:
        cache["pos"][slots] = kept.to(torch.int32)
    cache["len"].fill_(held)
    slot = held % size

    def step(p, x_, c):
        if ring:
            return tr._ring_decode(p, x_, c, acfg, policy=pol), c
        return L.attention_decode(p, x_, c, acfg, policy=pol)

    card = tree_map(lambda t: t.to("cuda", copy=True),
                    {"p": params, "x": x, "c": cache})
    half = acfg.head_dim // 2      # the exponents of rope's frequencies
    expo = -math.log(acfg.rope_theta) * torch.arange(
        half, dtype=torch.float32) / half
    pol = L.Policy(compute_dtype=torch.float32)
    with torch.inference_mode():
        got, gc = step(card["p"], card["x"], card["c"])
        t0 = time.perf_counter()
        want, wc = step(params, x, cache)
        cpu_s = time.perf_counter() - t0
        k_got, k_want = gc["k"].cpu(), wc["k"]
        row = {"case": case, "arch": arch, "x": list(x.shape),
               "cache": {k: list(t.shape) for k, t in cache.items()},
               "position": held, "slot": slot, "window": acfg.window,
               "softcap": acfg.softcap, "tol": DECODE_TOL,
               "k_tol": ROPE_K_TOL,
               "out_max_abs_err": close_gate("decode_check", "out",
                                             got.cpu(), want, DECODE_TOL),
               "v_max_abs_err": close_gate("decode_check", "v", gc["v"].cpu(),
                                           wc["v"], DECODE_TOL),
               "k_written_max_abs_err": close_gate(
                   "decode_check", "k written", k_got[:, slot],
                   k_want[:, slot], ROPE_K_TOL),
               "rope_angle_max_diff_at_position": held * float(
                   (torch.exp(expo.cuda()).cpu() - torch.exp(expo)).abs()
                   .max()),
               "len": [int(gc["len"]), int(wc["len"])]}
        k_got[:, slot] = k_want[:, slot]
        if not torch.equal(k_got, k_want):
            raise AssertionError(f"decode_check {case}: a k slot other than "
                                 f"the written one differs")
        if row["len"] != [held + 1, held + 1]:
            raise AssertionError(f"decode_check {case}: len {row['len']}, "
                                 f"expected {held + 1}")
        if ring:
            want_pos = torch.full((size,), -1, dtype=torch.int32)
            want_pos[slots] = kept.to(torch.int32)
            want_pos[slot] = held
            if not (torch.equal(gc["pos"].cpu(), want_pos)
                    and torch.equal(wc["pos"], want_pos)):
                raise AssertionError(f"decode_check {case}: pos differs from "
                                     f"the positions held")
            row["pos_range"] = [int(want_pos.min()), int(want_pos.max())]
        at = torch.full((), held, dtype=torch.int32, device="cuda")
        row["card_ms"] = time_ms(lambda: step(
            card["p"], card["x"], {**gc, "len": at.clone()}), 10)
    row["cpu_s"] = cpu_s
    print(f"decode_check {case} " + json.dumps(row), flush=True)
    del card, gc, got
    torch.cuda.empty_cache()
    return row


def _ssd_decode_case(batch: int = 4) -> dict:
    """``decode_check ssd``: mamba2-780m's ``ssd_block`` at full width (d
    1536, 48 heads of 64, state 128, conv width 4), f32, ``batch`` rows,
    one step (S=1) from a seeded state (``h`` and the three conv states
    drawn, not zeros) on the card and on the CPU with the same params and
    input: the output and every leaf of the new state at ``DECODE_TOL``.
    The card's step is timed by CUDA events (the block returns a new state,
    so every call starts from the same one)."""
    from repro_torch.models import layers as L, registry, ssm, \
        transformer as tr
    from repro_torch.utils import tree_map
    cfg = tr._ssd_cfg(registry.get("mamba2-780m").full)
    gen = torch.Generator().manual_seed(6)
    params = ssm.ssd_init(gen, cfg)
    x = torch.randn((batch, 1, cfg.d_model), generator=gen)
    state = {k: torch.randn(t.shape, generator=gen) * 0.5
             for k, t in ssm.ssd_state_init(cfg, batch).items()}
    pol = L.Policy(compute_dtype=torch.float32)
    card = tree_map(lambda t: t.to("cuda", copy=True),
                    {"p": params, "x": x, "c": state})

    def step(p, x_, c):
        return ssm.ssd_block(p, x_, cfg, policy=pol, state=c)

    with torch.inference_mode():
        got, gc = step(card["p"], card["x"], card["c"])
        t0 = time.perf_counter()
        want, wc = step(params, x, state)
        cpu_s = time.perf_counter() - t0
        row = {"case": "ssd", "arch": "mamba2-780m", "x": list(x.shape),
               "cache": {k: list(t.shape) for k, t in state.items()},
               "tol": DECODE_TOL,
               "out_max_abs_err": close_gate("decode_check", "ssd out",
                                             got.cpu(), want, DECODE_TOL)}
        for k in sorted(wc):
            if gc[k].dtype != wc[k].dtype or gc[k].shape != state[k].shape:
                raise AssertionError(f"decode_check ssd: {k} is "
                                     f"{gc[k].dtype} {list(gc[k].shape)}")
            row[f"{k}_max_abs_err"] = close_gate(
                "decode_check", f"ssd {k}", gc[k].cpu(), wc[k], DECODE_TOL)
        row["card_ms"] = time_ms(lambda: step(card["p"], card["x"],
                                              card["c"]), 10)
    row["cpu_s"] = cpu_s
    print("decode_check ssd " + json.dumps(row), flush=True)
    del card, gc, got
    torch.cuda.empty_cache()
    return row


def _lru_decode_case(batch: int = 2, prompt: int = 256,
                     steps: int = 8) -> dict:
    """``decode_check lru``: recurrentgemma-9b's first ``lru`` sublayer at
    full width (norm, ``lru_block`` at d 4096, lru width 4096, then its
    gelu MLP, d_ff 12,288), f32, ``batch`` rows, seeded params and inputs:
    ``transformer._sub_prefill`` of ``prompt`` tokens from the zero state,
    then ``steps`` decode steps (``_sub_decode``), each writing the state
    in place, on the card and on the CPU: every output at ``DECODE_TOL``,
    and the state leaves ``h`` and ``conv`` after the last step.  The
    card's step is timed by CUDA events (each call advances the state)."""
    from repro_torch.models import layers as L, registry, transformer as tr
    from repro_torch.utils import tree_map
    cfg = registry.get("recurrentgemma-9b").full
    spec = cfg.pattern[0]
    gen = torch.Generator().manual_seed(10)
    params = tr._sub_init(gen, cfg, spec)
    x = torch.randn((batch, prompt + steps, cfg.d_model), generator=gen)
    pol = L.Policy(compute_dtype=torch.float32)

    def run(p, x_):
        c = tr._sub_cache_init(cfg, spec, batch, prompt + steps,
                               torch.float32, device=x_.device)
        outs = [tr._sub_prefill(p, x_[:, :prompt], spec, cfg, c,
                                policy=pol, positions=None, cross_kv=None)]
        for t in range(prompt, prompt + steps):
            outs.append(tr._sub_decode(p, x_[:, t:t + 1], spec, cfg, c,
                                       policy=pol))
        return outs, c

    card = tree_map(lambda t: t.to("cuda", copy=True), {"p": params, "x": x})
    with torch.inference_mode():
        got, gc = run(card["p"], card["x"])
        t0 = time.perf_counter()
        want, wc = run(params, x)
        cpu_s = time.perf_counter() - t0
        row = {"case": "lru", "arch": cfg.name, "x": list(x.shape),
               "prompt": prompt, "steps": steps,
               "cache": {k: list(t.shape) for k, t in wc.items()},
               "tol": DECODE_TOL,
               "prefill_max_abs_err": close_gate(
                   "decode_check", "lru prefill", got[0].cpu(), want[0],
                   DECODE_TOL),
               "decode_max_abs_err": max(
                   close_gate("decode_check", f"lru step {i}", g.cpu(), w,
                              DECODE_TOL)
                   for i, (g, w) in enumerate(zip(got[1:], want[1:])))}
        for k in sorted(wc):
            if gc[k].dtype != wc[k].dtype:
                raise AssertionError(f"decode_check lru: {k} is "
                                     f"{gc[k].dtype}, {wc[k].dtype} on the "
                                     f"CPU")
            row[f"{k}_max_abs_err"] = close_gate(
                "decode_check", f"lru {k}", gc[k].cpu(), wc[k], DECODE_TOL)
        last = card["x"][:, -1:]
        row["card_ms"] = time_ms(lambda: tr._sub_decode(
            card["p"], last, spec, cfg, gc, policy=pol), 10)
    row["cpu_s"] = cpu_s
    print("decode_check lru " + json.dumps(row), flush=True)
    del card, gc, got
    torch.cuda.empty_cache()
    return row


def _cross_decode_case(batch: int = 2, slots: int = 1600) -> dict:
    """``decode_check cross``: llama-3.2-vision-90b's ``cross`` layer at full
    width (d 8192, 64 heads, kv 8, head dim 128), f32, ``batch`` rows, one
    step of ``transformer._cross_decode`` over a seeded cross cache of
    ``slots`` patch positions, on the card and on the CPU with the same
    params and input: the output at ``DECODE_TOL``, and both caches bit for
    bit what they were (decode only reads a cross cache).  The card's step
    is timed by CUDA events."""
    from repro_torch.models import layers as L, registry, transformer as tr
    from repro_torch.utils import tree_map
    cfg = registry.get("llama-3.2-vision-90b").full
    spec = next(s for s in cfg.pattern if s.kind == "cross")
    acfg = tr.attn_cfg_for(cfg, spec)
    gen = torch.Generator().manual_seed(8)
    params = L.attn_init(gen, acfg)
    x = torch.randn((batch, 1, cfg.d_model), generator=gen)
    cache = {n: torch.randn((batch, slots, acfg.n_kv, acfg.head_dim),
                            generator=gen) for n in ("k", "v")}
    frozen = {n: t.clone() for n, t in cache.items()}
    pol = L.Policy(compute_dtype=torch.float32)
    card = tree_map(lambda t: t.to("cuda", copy=True),
                    {"p": params, "x": x, "c": cache})

    def step(c):
        return tr._cross_decode(c["p"], c["x"], c["c"], acfg, policy=pol)

    with torch.inference_mode():
        got = step(card)
        t0 = time.perf_counter()
        want = step({"p": params, "x": x, "c": cache})
        cpu_s = time.perf_counter() - t0
        row = {"case": "cross", "arch": "llama-3.2-vision-90b",
               "x": list(x.shape),
               "cache": {n: list(t.shape) for n, t in cache.items()},
               "softcap": acfg.softcap, "tol": DECODE_TOL,
               "out_max_abs_err": close_gate("decode_check", "cross out",
                                             got.cpu(), want, DECODE_TOL)}
        for n in frozen:
            if not (torch.equal(card["c"][n].cpu(), frozen[n])
                    and torch.equal(cache[n], frozen[n])):
                raise AssertionError(f"decode_check cross: the step wrote "
                                     f"the cache's {n}")
        row["cache_unchanged"] = True
        row["card_ms"] = time_ms(lambda: step(card), 10)
    row["cpu_s"] = cpu_s
    print("decode_check cross " + json.dumps(row), flush=True)
    del card, got
    torch.cuda.empty_cache()
    return row


def decode_check() -> list:
    """One decode step of one layer at full width, f32, card against CPU:
    ``attn``, granite-3-8b's layer (d 4096, 32 heads, kv 8, head dim 128),
    B=4, ``attention_decode`` over a 2088-slot cache holding 2047 tokens;
    ``ring``, gemma2-9b's ``local`` layer (d 3584, 16 heads, kv 8, head dim
    256, softcap 50, window 4096), B=2, ``transformer._ring_decode`` over a
    4096-slot ring holding positions 512-4607, at position 4608: it
    overwrites slot 512, the oldest, and masks nothing else; ``ssd``,
    mamba2-780m's block, B=4, from a seeded state (``_ssd_decode_case``);
    ``cross``, llama-3.2-vision-90b's cross layer, B=2, over a 1600-slot
    cross cache (``_cross_decode_case``); ``lru``, recurrentgemma-9b's
    ``lru`` sublayer, B=2, a 256-token prefill and 8 steps
    (``_lru_decode_case``)."""
    return [_decode_case("attn", "granite-3-8b", 0, 4, 2047),
            _decode_case("ring", "gemma2-9b", 0, 2, 4608),
            _ssd_decode_case(), _cross_decode_case(), _lru_decode_case()]


def serve_check(arch: str, label: str) -> dict:
    """``arch`` FULL on the card, B and prompt from ``SERVE_CASES``, flash
    off (so serving and the forward take the same blockwise attention):
    ``prefill`` of tokens[:, :n-1] and one ``decode_step`` on token n-1,
    their logits against ``forward`` + ``lm_logits`` over all n tokens at
    positions n-2 and n-1; first with f32 params, compute and cache, then
    with the same params cast to bf16 (the values ``init_params`` draws in
    bf16).

    Gates, by relative Frobenius error (``rel_fro``): (a) f32 serving
    against the f32 forward at ``SERVE_F32_TOL``: the same function in
    another order, so a wrong slot, mask or position shows far above f32
    rounding (on an H100, gemma2-9b's read 3.5e-6 and 3.3e-6); (b) bf16
    serving against the f32 forward at most ``BF16_FLOOR_RATIO`` times the
    bf16 forward's own error there.  bf16 over 42 layers and a 256,000-row
    unembedding sets a floor near 2e-2 (on the H100, gemma2-9b's bf16
    forward read 1.92e-2 against f32 and its bf16 decode 1.91e-2), which a
    fixed gate of 2e-2 on bf16 serving against the bf16 forward meets only
    by luck: the two bf16 paths round apart, so their distance reaches
    about the floor times sqrt(2).  A ratio of 1.1 lets serving add an
    error of at most about 0.46 of the floor's (sqrt(1.1^2 - 1), if
    independent); that H100 run read ratios of 1.00 and 0.99.
    granite-3-8b also keeps its fixed 2e-2 gate on bf16 serving against the
    bf16 forward; the other archs (mamba2-780m's bf16 forward alone sits
    near 3e-2 of f32) take the derived gates only.  An arch with a stub
    frontend (whisper-base's frames, llama-3.2-vision-90b's ``cross_kv``,
    the launcher's draw, seed 7, made in f32 and cast with the params)
    feeds the same one to prefill and to the forward; vision is served
    cut to ``VISION_LAYERS`` (``serve_cfg``).  Printed only: argmax
    agreement and bf16 serving against the bf16 forward.  Then one more
    greedy bf16 step through ``make_decode_step`` under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    from repro_torch.launch.train import stub_frontend
    from repro_torch.models import layers as L, registry
    from repro_torch.train import serve_step as ss
    from repro_torch.utils import cast_tree
    entry = registry.get(arch)
    cfg, (b, n) = serve_cfg(arch), SERVE_CASES[arch]
    v = cfg.vocab
    params = entry.module.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg,
        dtype=torch.float32, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (b, n), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    fe32 = stub_frontend(entry, cfg, b, torch.float32, "cuda", seed=7)
    got, ref = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        if dt is torch.bfloat16:
            params = cast_tree(params, dt)
        kw = {} if fe32 is None else {"frontend": cast_tree(fe32, dt)}
        policy = L.Policy(compute_dtype=dt)
        with torch.inference_mode():
            pre = entry.module.prefill(params, cfg, tokens[:, :n - 1],
                                       max_len=serve_max_len(arch),
                                       policy=policy, cache_dtype=dt,
                                       logits_mode="last", **kw)
            step, cache = entry.module.decode_step(
                params, cfg, tokens[:, n - 1:], pre["cache"], policy=policy)
            hidden = entry.module.forward(params, cfg, tokens,
                                          policy=policy, **kw)["hidden"]
            full = entry.module.lm_logits(params, cfg, hidden[:, -2:],
                                          policy)
        got[dt] = (pre["logits"][:, -1, :v].float(), step[:, 0, :v].float())
        ref[dt] = (full[:, 0, :v].float(), full[:, 1, :v].float())
        del pre, hidden, full
        if dt is torch.float32:
            del cache
        torch.cuda.empty_cache()
    f32, bf = torch.float32, torch.bfloat16
    row = {"arch": arch, "layers": cfg.n_layers,
           "of_layers": entry.full.n_layers, "batch": b, "prompt": n,
           "frontend": json.loads(frontend_shapes(fe32)),
           "max_len": serve_max_len(arch), "f32_tol": SERVE_F32_TOL,
           "bf16_floor_ratio": BF16_FLOOR_RATIO,
           "tol": SERVE_REL_TOL if arch == "granite-3-8b" else None}
    for i, name in enumerate((f"prefill_{n - 2}", f"decode_{n - 1}")):
        for dt in (f32, bf):
            if not torch.isfinite(got[dt][i]).all():
                raise AssertionError(f"{label} {name}: non-finite "
                                     f"{dt} logits")
        r = {"f32_vs_f32_forward": rel_fro(got[f32][i], ref[f32][i]),
             "bf16_vs_f32_forward": rel_fro(got[bf][i], ref[f32][i]),
             "bf16_forward_vs_f32_forward": rel_fro(ref[bf][i], ref[f32][i]),
             "bf16_vs_bf16_forward": rel_fro(got[bf][i], ref[bf][i]),
             "argmax_agree": float((got[bf][i].argmax(-1)
                                    == ref[bf][i].argmax(-1)).float().mean()),
             "argmax_agree_f32": float((got[f32][i].argmax(-1)
                                        == ref[f32][i].argmax(-1))
                                       .float().mean())}
        r["floor_ratio"] = r["bf16_vs_f32_forward"] / \
            r["bf16_forward_vs_f32_forward"]
        row[name] = r
        if not r["f32_vs_f32_forward"] <= SERVE_F32_TOL:
            raise AssertionError(f"{label} {name}: f32 relative "
                                 f"Frobenius {r['f32_vs_f32_forward']} > "
                                 f"{SERVE_F32_TOL}")
        if not r["floor_ratio"] <= BF16_FLOOR_RATIO:
            raise AssertionError(f"{label} {name}: bf16 serving "
                                 f"is {r['floor_ratio']} x the bf16 forward's "
                                 f"error against f32 > {BF16_FLOOR_RATIO}")
        if row["tol"] is not None and \
                not r["bf16_vs_bf16_forward"] <= row["tol"]:
            raise AssertionError(f"{label} {name}: relative "
                                 f"Frobenius {r['bf16_vs_bf16_forward']} > "
                                 f"{row['tol']}")
    decode = ss.make_decode_step(entry, cfg,
                                 policy=L.Policy(compute_dtype=bf))
    tok = got[bf][1].argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        live = False          # the mode is on: a host read raises
        try:
            tok.sum().item()
        except RuntimeError:
            live = True
        nxt, cache = decode(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not live:
        raise AssertionError(f"{label}: the sync debug mode let a "
                             "Tensor.item pass")
    row["sync_free_step"] = {"tokens": list(nxt.shape),
                             "positions": cache_positions(cache)}
    print(f"{label} " + json.dumps(row), flush=True)
    del params, cache, got, ref, fe32, kw
    torch.cuda.empty_cache()
    return row


def serve_path(arch: str, label: str) -> dict:
    """The serving launcher, ``repro_torch.launch.serve``, on ``arch`` FULL
    (bf16 params and cache; through ``serve.main``, or through
    ``serve.serve`` with llama-3.2-vision-90b cut by ``serve_cfg``), B and
    prompt from ``SERVE_CASES``, 32 generated tokens, the launcher's stub
    frontend if the arch has one: prefill seconds, each decode step by CUDA
    events (the first apart from the rest), tok/s, the peaks while the
    params are drawn (each leaf is drawn in f32, then cast) and while
    serving (from the launcher's ``make_prefill_step`` call on) beside the
    params' and the cache's bytes (the cross layers' apart), and a decode
    step's byte bound, (param + cache bytes) / 3.35 TB/s, whose params are
    what a step reads: an encoder-decoder's decoder, not its encoder,
    which runs once at prefill (``bound_counts`` says which); the local
    rings' slots and the positions they hold; then one more decode step
    profiled (``<label>_profile`` lines).  Gates: finite prefill logits,
    every generated token in the vocabulary, no kernel launched, every
    ``len`` (or the cache's ``step``) at prompt + 31, every ring holding
    the last ``size`` positions, the params unchanged."""
    from repro_torch.launch import serve
    from repro_torch.models import layers as L, registry
    from repro_torch.train import serve_step as ss
    from repro_torch.utils import tree_flatten
    batch, prompt = SERVE_CASES[arch]
    entry, cfg = registry.get(arch), serve_cfg(arch)
    argv = ["--arch", arch, "--preset", "full", "--batch", str(batch),
            "--prompt-len", str(prompt), "--gen", str(SERVE_GEN)]
    init_peak = []

    def params_drawn(*args, **kw):
        init_peak.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with watching(ss, "make_prefill_step", params_drawn):
        if cfg is entry.full:
            out = serve.main(argv)
        else:
            out = serve.serve(entry, cfg, batch=batch, prompt_len=prompt,
                              gen=SERVE_GEN, dtype=torch.bfloat16,
                              device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_flatten(out["cache"])
    lens = cache_positions(out["cache"])
    pos = [t for p, t in leaves if p.endswith("pos")]
    encdec = "decoder" in out["params"]
    read = out["params"]["decoder"] if encdec else out["params"]
    param_bytes, cache_bytes = tree_nbytes(read), tree_nbytes(out["cache"])
    steps = out["decode_step_ms"]
    rest = sorted(steps[1:])
    row = {"arch": arch, "layers": cfg.n_layers,
           "of_layers": entry.full.n_layers,
           "frontend": json.loads(frontend_shapes(out["frontend"])),
           "batch": batch, "prompt": prompt, "gen": SERVE_GEN,
           "max_len": serve_max_len(arch), "wall_s": wall,
           "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "first_step_ms": steps[0],
           "step_ms_median": statistics.median(rest),
           "step_ms_min": rest[0], "step_ms_max": rest[-1],
           "tok_per_s": out["tok_per_s"],
           "init_max_memory_allocated_bytes": init_peak[0],
           "serve_max_memory_allocated_bytes": peak,
           "param_bytes": param_bytes,
           "encoder_param_bytes": (tree_nbytes(out["params"]["encoder"])
                                   if encdec else None),
           "cache_bytes": cache_bytes,
           "cross_cache_bytes": cross_cache_bytes(cfg, out["cache"]),
           "step_bound_ms": (param_bytes + cache_bytes) / PEAK_BYTES * 1e3,
           "bound_counts": ("decoder " if encdec else "") + "params + cache"
           + (" (self and cross)" if out["frontend"] is not None else ""),
           "lens": lens, "launches": counts,
           "backbone_checksum": list(out["backbone_checksum"])}
    last = prompt + SERVE_GEN - 1
    if pos:
        held = torch.stack([t.reshape(-1, t.shape[-1]) for t in pos])
        size = held.shape[-1]
        row["rings"] = {"layers": held.shape[0] * held.shape[1],
                        "slots": size, "positions": [int(held.min()),
                                                     int(held.max())]}
        want = torch.arange(last - size, last, device=held.device)
        if not torch.equal(held.sort(-1).values,
                           want.to(held.dtype).expand_as(held)):
            raise AssertionError(f"{label}: a ring does not hold positions "
                                 f"{last - size}-{last - 1}")
    if not torch.isfinite(out["prefill_logits"][:, :cfg.vocab]).all():
        raise AssertionError(f"{label}: non-finite prefill logits")
    tokens = out["tokens"]
    if tokens.shape != (batch, SERVE_GEN) or \
            not 0 <= int(tokens.min()) <= int(tokens.max()) < cfg.vocab:
        raise AssertionError(f"{label}: tokens {tuple(tokens.shape)} in "
                             f"[{int(tokens.min())}, {int(tokens.max())}]")
    if any(counts.values()):
        raise AssertionError(f"{label} launched {counts}; serving reaches "
                             f"no kernel, as the reference's")
    if lens != [last]:
        raise AssertionError(f"{label}: cache positions {lens}, expected "
                             f"{last}")
    before, after = out["backbone_checksum"]
    if before != after:
        raise AssertionError(f"{label}: params changed {before} -> {after}")
    print(f"{label} " + json.dumps(row), flush=True)
    decode = ss.make_decode_step(
        entry, cfg, policy=L.Policy(compute_dtype=torch.bfloat16))
    tok = tokens[:, -1:]
    row["profile"] = profile_call(
        lambda: decode(out["params"], out["cache"], tok),
        label.replace("_path", "_profile"))
    del out, decode
    torch.cuda.empty_cache()
    return {**row, "launches": counts["flash_attention"]}


def run_resume_path() -> dict:
    """Checkpoint and resume of the duplex step at full width, depth cut to
    4 layers (bf16 backbone of 1.0 B params, flash on), B=2, S=4096."""
    from repro_torch.ckpt.checkpoint import CheckpointConfig, Checkpointer
    from repro_torch.configs.granite_3_8b import FULL
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.cells import duplex_tcfg
    from repro_torch.launch.train import loop_step
    from repro_torch.models import layers as L, registry
    from repro_torch.train import loop, train_step as ts
    from repro_torch.utils import tree_flatten
    cfg = dc.replace(FULL, n_layers=4, use_flash=True).validate()
    entry = registry.get("granite-3-8b")
    policy = L.Policy(compute_dtype=torch.bfloat16)
    tcfg = duplex_tcfg(cfg)
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    data = DataConfig(vocab=cfg.vocab, seq_len=4096, batch_per_host=2, seed=0)

    def init_fn():
        return ts.init_state(torch.Generator(device="cuda").manual_seed(0),
                             entry, cfg, tcfg, policy, device="cuda")

    def run(total, ckpt=None):
        return loop.run(loop.LoopConfig(total_steps=total, ckpt_every=2,
                                        ckpt=ckpt, log_every=1),
                        data, loop_step(step, "cuda"), init_fn,
                        log_fn=lambda s: None, device="cuda")

    zero_counts()
    straight = run(4)
    with tempfile.TemporaryDirectory(prefix="_smoke_ckpt_",
                                     dir=ROOT) as tmp:
        ck_cfg = CheckpointConfig(str(Path(tmp) / "run"))
        first = run(2, ck_cfg)
        saved = first.state
        nbytes = tree_nbytes(saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = Checkpointer(ck_cfg).restore(device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mismatched = [p for (p, a), (_, b) in zip(tree_flatten(restored),
                                                  tree_flatten(saved))
                      if a.dtype != b.dtype or not torch.equal(a, b)]
        if [p for p, _ in tree_flatten(restored)] != \
                [p for p, _ in tree_flatten(saved)] or mismatched:
            raise AssertionError(f"resume_path: the restored state differs "
                                 f"from the saved one at {mismatched[:5]}")
        del restored
        t0 = time.perf_counter()
        Checkpointer(CheckpointConfig(str(Path(tmp) / "timed"))).save(
            2, saved)
        save_s = time.perf_counter() - t0
        del first, saved
        resumed = run(4, ck_cfg)
    counts = read_counts()
    if resumed.resumed_from != 2 or resumed.steps_run != 2:
        raise AssertionError(f"resume_path: resumed_from "
                             f"{resumed.resumed_from}, ran "
                             f"{resumed.steps_run} steps")
    want = {m["step"]: m["loss"] for m in straight.metrics_history}
    got = {m["step"]: m["loss"] for m in resumed.metrics_history}
    if sorted(got) != [2, 3]:
        raise AssertionError(f"resume_path: resumed steps {sorted(got)}")
    for s_ in (2, 3):
        if not math.isclose(got[s_], want[s_], rel_tol=1e-5, abs_tol=1e-6):
            raise AssertionError(f"resume_path: step {s_} loss {got[s_]} vs "
                                 f"{want[s_]} straight through")
    branch_err = max(float((a.float() - b.float()).abs().max())
                     for (_, a), (_, b) in zip(
                         tree_flatten(resumed.state["branch"]),
                         tree_flatten(straight.state["branch"])))
    for (p, a), (_, b) in zip(tree_flatten(resumed.state["branch"]),
                              tree_flatten(straight.state["branch"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=p)
    n_attn = cfg.n_rep * len(cfg.pattern)
    if counts["flash_attention"] != n_attn * 8 or \
            sum(counts.values()) != counts["flash_attention"]:
        raise AssertionError(f"resume_path launched {counts}; expected "
                             f"{n_attn * 8} flash launches (8 steps) and no "
                             f"other kernel")
    print(f"resume_path: layers {cfg.n_layers} state_bytes {nbytes} "
          f"resumed_from {resumed.resumed_from} restored_bit_identical True "
          f"loss_step2 {got[2]!r} vs {want[2]!r} loss_step3 {got[3]!r} vs "
          f"{want[3]!r} branch_max_abs_diff {branch_err!r} save_s "
          f"{save_s!r} save_GBps {nbytes / save_s / 1e9!r} restore_s "
          f"{restore_s!r} restore_GBps {nbytes / restore_s / 1e9!r} "
          f"launches {json.dumps(counts)}", flush=True)
    del straight, resumed
    torch.cuda.empty_cache()
    return {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes}


def run_arms() -> dict:
    """The four accuracy arms (Table II) on the card, at the reference's
    step counts (pretrain 150, each arm 200)."""
    from repro_torch.bench import table2_accuracy
    zero_counts()
    t0 = time.perf_counter()
    rows, results = table2_accuracy.run("cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    for row in rows:
        print(f"arms_row {row}", flush=True)
    print("arms: " + json.dumps({
        "val": {arm: {"loss": l, "accuracy": a, "train_s": t}
                for arm, (l, a, t) in results.items()},
        "wall_s": wall, "launches": counts}), flush=True)
    check_arms("arms", results)
    if any(counts.values()):
        raise AssertionError(f"arms launched kernels {counts}; flash is off "
                             f"and the branch quantizes by fake-quant")
    return {"wall_s": wall}


def check_arms(label: str, results: dict) -> None:
    """Every arm's validation loss finite and accuracy in [0, 1]."""
    for name, (l, a, _) in results.items():
        if not (math.isfinite(l) and 0.0 <= a <= 1.0):
            raise AssertionError(f"{label}: {name} gave loss {l}, accuracy "
                                 f"{a}")


def run_ablations() -> dict:
    """Fig. 21's ablations and the 2D-BFP fidelity benchmark on the card, at
    the reference's step counts, each with its own launch counts; returns
    the fidelity kernel row's numbers at 128x128."""
    from repro_torch.bench import bfp_fidelity, fig21_ablations
    from repro_torch.core import bfp as cbfp
    from repro_torch.kernels import bfp_matmul as bm
    from repro_torch.kernels.bfp_common import qdq_block

    zero_counts()
    t0 = time.perf_counter()
    rows, results = fig21_ablations.run("cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    for row in rows:
        print(f"fig21_row {row}", flush=True)
    # the same configuration trained twice: how far apart the card lands
    twice = abs(results["fig21b/norm_free"][0] - results["fig21a/pool4"][0])
    print("fig21: " + json.dumps({
        "val": {name: {"loss": l, "accuracy": a, "train_s": t}
                for name, (l, a, t) in results.items()},
        "norm_free_minus_pool4_abs": twice, "wall_s": wall,
        "launches": counts}), flush=True)
    check_arms("fig21", results)
    if any(counts.values()):
        raise AssertionError(f"fig21 launched kernels {counts}; flash is off "
                             f"and the branch quantizes by fake-quant")

    zero_counts()
    t0 = time.perf_counter()
    rows, values = bfp_fidelity.run("cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    for row in rows:
        print(f"bfp_fidelity_row {row}", flush=True)
    mm = values["matmul"]
    print("bfp_fidelity: " + json.dumps({
        "rmse": values["rmse"], "bits": values["bits"],
        "transpose_max_diff": values["transpose_max_diff"],
        "matmul": {k: mm[k] for k in ("route", "us", "max_abs_err")},
        "training_parity": {name: {"loss": l, "accuracy": a, "train_s": t}
                            for name, (l, a, t) in
                            values["training_parity"].items()},
        "wall_s": wall, "launches": counts}), flush=True)
    check_arms("bfp_fidelity", values["training_parity"])
    products = 1 + bfp_fidelity.MATMUL_ITERS     # one warm call
    want = dict.fromkeys(counts, 0) | {
        "bfp_matmul": products, "quantize_operand": 2 * products,
        "gemm_tn": products}
    if counts != want or mm["route"] != "cuda":
        raise AssertionError(f"bfp_fidelity launched {counts} on route "
                             f"{mm['route']}; expected {want}")
    a = mm["a"]
    err, rel = bfp_gate("bfp_fidelity 128", mm["out"],
                        bm.bfp_matmul_plain(a, a, group=32))
    x_cpu = values["x"].cpu()
    for (group, mbits), name in zip(bfp_fidelity.RMSE_CASES,
                                    values["rmse"]):
        want_rmse = float(cbfp.quantization_rmse(x_cpu, group=group,
                                                 mbits=mbits))
        bits = cbfp.bfp_quantize(x_cpu, group=group,
                                 mbits=mbits).bits_per_value
        if not math.isclose(values["rmse"][name], want_rmse, rel_tol=1e-6,
                            abs_tol=0.0) or values["bits"][name] != bits:
            raise AssertionError(f"bfp_fidelity {name}: card rmse "
                                 f"{values['rmse'][name]!r} bits "
                                 f"{values['bits'][name]} against CPU "
                                 f"{want_rmse!r} bits {bits}")
    if values["transpose_max_diff"] != 0.0:
        raise AssertionError(f"bfp_fidelity: Q(x.T) - Q(x).T max "
                             f"{values['transpose_max_diff']}, not 0")

    # the kernel row's product at 128x128 beside its plain version, the
    # library's product of the quantized operands, and its bound
    n = a.shape[0]
    qa = qdq_block(a, 32, 5, 4).bfloat16()
    row = {"mkn": [n, n, n], "ms": mm["us"] * 1e-3,
           "plain_ms": time_ms(lambda: bm.bfp_matmul_plain(a, a, group=32),
                               20),
           "library_ms": time_ms(lambda: torch.matmul(qa, qa), 20),
           "max_abs_err": err, "rel_fro_err": rel,
           "launches": counts["bfp_matmul"],
           **dict(zip(("bound_ms", "bound_by"), matmul_bound_ms(n, n, n, 4)))}
    print("bfp_fidelity_time bfp_matmul: " + json.dumps(row), flush=True)
    del values, mm, a, qa
    torch.cuda.empty_cache()
    return row


def ptxas_lines(log: str) -> list[str]:
    """ptxas -v's register and spill lines, each after the name of the entry
    function it describes, every warning, and every coded performance note
    (C75xx: wgmma serialized, setmaxnreg ignored, warpgroup.arrive
    injected)."""
    out, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif any(k in line for k in ("warning", "registers", "spill",
                                     "(C7")):
            out.append(f"{entry}: {line.strip()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)

    from repro_torch.kernels import build
    built = build.build()
    for name, info in built.items():
        lines = ptxas_lines(info["log"])
        # the entry each C7519 names (ptxas prints these before the entry)
        c7519 = sorted({ln.split("in function '")[-1].rstrip("'")
                        for ln in lines if "C7519" in ln})
        print(f"build {name}: seconds {info['seconds']!r} ptxas {lines} "
              f"C7519 in {c7519}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rows = check_flash(gen)
    flash, flash_moe = flash_rows["main"], flash_rows["granite_moe_d64"]
    check_bfp(gen)
    check_bfp_stages(gen)
    f1_check()
    ssd_check()
    lru_check()
    bfp = run_bfp_path()     # before the step, and freed: its peak stands
    main_path, run = run_main_path()
    del run          # each path frees its state: its peak stands alone
    run_full_path(main_path)
    moe_path, run = run_main_path("granite-moe-1b-a400m", label="moe")
    report_moe_path(run)
    del run
    run_full_path(moe_path, "granite-moe-1b-a400m", None, label="moe_full")
    top1 = run_moe_top1_path()
    flash_top1 = flash_rows["llama4_h40"]
    gemma2, run = run_main_path("gemma2-9b", label="gemma2")
    report_attention_layers(run, "gemma2")
    del run
    run_full_path(gemma2, "gemma2-9b", 4, label="gemma2_full", batch_size=1,
                  seq=2048)
    starcoder2, run = run_main_path("starcoder2-7b", label="starcoder2")
    del run
    mamba2, run = run_main_path("mamba2-780m", label="mamba2")
    report_mixers(run, "mamba2")
    del run
    drawn, kept = reckon_full_depth("mamba2-780m", "mamba2_full")
    run_full_path(mamba2, "mamba2-780m", kept, label="mamba2_full",
                  drawn=drawn)
    whisper, run = run_main_path("whisper-base", label="whisper")
    report_attention_layers(run, "whisper")
    del run
    run_full_path(whisper, "whisper-base", None, label="whisper_full")
    vision, run = run_vision_path()
    vision_causality(run)
    del run
    rgemma, run = run_main_path("recurrentgemma-9b", label="recurrentgemma")
    report_mixers(run, "recurrentgemma")
    report_attention_layers(run, "recurrentgemma")
    window_gate(run, "recurrentgemma")
    del run
    drawn, kept = reckon_full_depth("recurrentgemma-9b", "recurrentgemma_full",
                                    cuts=(5, 8), batch_size=1, seq=4096)
    run_full_path(rgemma, "recurrentgemma-9b", kept,
                  label="recurrentgemma_full", batch_size=1, seq=4096,
                  drawn=drawn)
    decode_check()
    serve_check("granite-3-8b", "serve_check")
    serve_check("gemma2-9b", "gemma2_serve_check")
    serve = serve_path("granite-3-8b", "serve_path")
    gemma2_serve = serve_path("gemma2-9b", "gemma2_serve_path")
    serve_check("mamba2-780m", "mamba2_serve_check")
    mamba2_serve = serve_path("mamba2-780m", "mamba2_serve_path")
    serve_check("whisper-base", "whisper_serve_check")
    whisper_serve = serve_path("whisper-base", "whisper_serve_path")
    serve_check("llama-3.2-vision-90b", "vision_serve_check")
    vision_serve = serve_path("llama-3.2-vision-90b", "vision_serve_path")
    serve_check("recurrentgemma-9b", "recurrentgemma_serve_check")
    rgemma_serve = serve_path("recurrentgemma-9b",
                              "recurrentgemma_serve_path")
    run_resume_path()
    run_arms()
    fidelity = run_ablations()

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": main_path["launches"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["kernel_ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "launches_by_path": {"main_path": main_path["launches"],
                             "moe_path": moe_path["launches"],
                             "moe_top1_path": top1["launches"],
                             "gemma2_path": gemma2["launches"],
                             "starcoder2_path": starcoder2["launches"],
                             "mamba2_path": mamba2["launches"],
                             "whisper_path": whisper["launches"],
                             "vision_path": vision["launches"],
                             "recurrentgemma_path": rgemma["launches"],
                             "serve_path": serve["launches"],
                             "gemma2_serve_path": gemma2_serve["launches"],
                             "mamba2_serve_path": mamba2_serve["launches"],
                             "whisper_serve_path": whisper_serve["launches"],
                             "vision_serve_path": vision_serve["launches"],
                             "recurrentgemma_serve_path":
                                 rgemma_serve["launches"]},
        **{name: {k: row[k] for k in (
            "q", "kv", "softcap", "max_abs_err", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "library", "library_ms",
            "library_ms_without_softcap", "kernel_over_library")}
           for name, row in (("moe_shape", flash_moe),
                             ("moe_top1_shape", flash_top1),
                             ("gemma2_shape", flash_rows["gemma2_d256"]),
                             ("gemma2_shape_without_softcap",
                              flash_rows["gemma2_d256_nocap"]),
                             ("starcoder2_shape",
                              flash_rows["starcoder2_h36"]),
                             ("whisper_shape",
                              flash_rows["whisper_mha_d64"]),
                             ("vision_shape", flash_rows["vision_h64"]))},
    }]
    bfp["bfp_matmul"]["launches_by_path"] = {
        "bfp_path": bfp["bfp_matmul"]["launches"],
        "bfp_fidelity": fidelity["launches"]}
    bfp["bfp_matmul"]["fidelity_shape"] = fidelity
    for name, replaces in BFP_REPLACES.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bfp.cu",
            "replaces": replaces,
            **{k: bfp[name][k] for k in ("launches", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "prepass_ms",
                                         "gemm_ms", "launches_by_path",
                                         "fidelity_shape")
               if k in bfp[name]}})
    print(f"total_s {time.perf_counter() - t_start!r}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
