"""repro_torch flash attention: the plain version against the JAX Pallas
kernel (interpret mode, as tests/test_kernels_flash.py runs it), and the CUDA
kernel against the plain version on the card.

JAX is imported inside the tests that use it, so that the card's machine,
which has no JAX, can collect this file and run the ``cuda`` tests."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tf


def _jax_flash():
    return pytest.importorskip("repro.kernels.flash_attention").flash_attention


def _inputs(seed, b, h, kv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, kv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, kv, skv, d), dtype=np.float32)
    return q, k, v


def _torch(*xs, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(x).to(device=device, dtype=dtype) for x in xs]


SHAPES = [
    (1, 2, 2, 64, 64, 16),     # MHA, single block pair
    (2, 4, 2, 128, 128, 32),   # GQA 2:1, multi-block
    (1, 8, 2, 64, 128, 16),    # GQA 4:1, rectangular
    (1, 3, 1, 96, 96, 8),      # MQA, 3 heads
]


@pytest.mark.parametrize("b,h,kv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_flash(b, h, kv, sq, skv, d, causal):
    import jax.numpy as jnp
    jflash = _jax_flash()
    q, k, v = _inputs(0, b, h, kv, sq, skv, d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, q_chunk=32, kv_chunk=32, interpret=True)
    got = tf.flash_attention(*_torch(q, k, v), causal=causal, q_chunk=32,
                             kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_plain_softcap_matches_jax_flash():
    import jax.numpy as jnp
    jflash = _jax_flash()
    q, k, v = _inputs(1, 1, 2, 2, 64, 64, 16)
    q, k = q * 3, k * 3
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, softcap=20.0, q_chunk=32, kv_chunk=32,
                  interpret=True)
    got = tf.flash_attention(*_torch(q, k, v), causal=True, softcap=20.0,
                             q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_plain_bf16_io_matches_jax_flash():
    import jax.numpy as jnp
    jflash = _jax_flash()
    q, k, v = _inputs(2, 1, 2, 2, 64, 64, 16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jflash(jq, jk, jv, causal=True, q_chunk=32, kv_chunk=32,
                  interpret=True)
    got = tf.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16),
                             causal=True, q_chunk=32, kv_chunk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_plain_d256_matches_jax_flash(softcap, causal):
    """Head dim 256 (gemma2's global layers): GQA 2:1, softcap 50 as gemma2
    sets it and none.  With the cap, q and k are scaled by 4 so that the
    scores (std 16) reach it; without it they stay unscaled, as in the
    tests above, since uncapped scores of that size turn the f32 rounding
    of a 256-term dot product into weight errors past 2e-5 in either
    implementation."""
    import jax.numpy as jnp
    jflash = _jax_flash()
    q, k, v = _inputs(10, 1, 4, 2, 64, 64, 256)
    if softcap is not None:
        q, k = q * 4, k * 4
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, softcap=softcap, q_chunk=32, kv_chunk=32,
                  interpret=True)
    got = tf.flash_attention(*_torch(q, k, v), causal=causal,
                             softcap=softcap, q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("qc,kc", [(16, 32), (32, 16), (64, 64), (128, 128)])
def test_plain_chunk_sweep_matches_jax_flash(qc, kc):
    import jax.numpy as jnp
    jflash = _jax_flash()
    q, k, v = _inputs(3, 1, 2, 1, 128, 128, 16)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, q_chunk=qc, kv_chunk=kc, interpret=True)
    got = tf.flash_attention(*_torch(q, k, v), causal=True, q_chunk=qc,
                             kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_wrapper_validates_like_jax():
    q, k, v = _torch(*_inputs(4, 1, 3, 2, 64, 64, 16))
    with pytest.raises(ValueError, match="multiple"):
        tf.flash_attention(q, k, v, q_chunk=32, kv_chunk=32)
    q, k, v = _torch(*_inputs(4, 1, 2, 2, 64, 64, 16))
    with pytest.raises(ValueError, match="tile"):
        tf.flash_attention(q, k, v, q_chunk=48, kv_chunk=32)


def test_cpu_tensors_take_plain_version_without_counting():
    q, k, v = _torch(*_inputs(5, 1, 2, 1, 32, 32, 16))
    before = tf.flash_attention.launches
    out = tf.flash_attention(q, k, v, q_chunk=32, kv_chunk=32)
    assert tf.flash_attention.launches == before
    torch.testing.assert_close(
        out, tf.flash_attention_plain(q, k, v, causal=True), rtol=0, atol=0)


def test_bf16_alignment_rule():
    """What the wrapper copies before a bf16 launch: operands whose pointer
    is not 16-byte aligned or whose strides are not multiples of 8."""
    x = torch.zeros((2, 64, 8, 128), dtype=torch.bfloat16)
    assert tf._aligned16(x) and tf._aligned16(x.transpose(1, 2))  # main path
    assert not tf._aligned16(x[..., 4:68])               # 8-byte offset rows
    y = torch.zeros((2, 8, 64, 65), dtype=torch.bfloat16)
    assert not tf._aligned16(y[..., 1:])                 # row stride 65


# (b, h, kv, sq, skv, d, causal, softcap, dtype): the main path's shape at
# reduced sequence, MQA, rectangular causal with ragged tiles, softcap,
# non-causal with Skv < Sq — in bf16 (tensor-core kernel) and f32 (SIMT);
# then the bf16 kernel's 128 x 128 tiling: several query and kv tiles with
# GQA group 4, Sq and Skv off the 128 grid (causal and not), and d=64 over
# more kv tiles than the two stages of the K/V ring; then llama4-maverick's
# odd GQA group of 5 (40 heads over 8), on a multi-wave bf16 grid and on the
# f32 kernel; then head dim 256 (gemma2's global layers, softcap 50): its
# own bf16 kernel (64-key tiles) on a multi-wave grid, ragged Sq/Skv (causal
# and not, MQA, and causal with Sq > Skv), and the f32 kernel at d=256,
# ragged with softcap and multi-wave; last, starcoder2's odd GQA group of 9
# (36 heads over 4).
CUDA_CASES = [
    (2, 32, 8, 512, 512, 128, True, None, torch.bfloat16),
    (1, 4, 1, 192, 192, 64, True, None, torch.bfloat16),
    (1, 8, 2, 96, 160, 128, True, None, torch.bfloat16),
    (2, 4, 2, 128, 128, 64, True, 20.0, torch.bfloat16),
    (1, 4, 4, 128, 64, 128, False, None, torch.bfloat16),
    (1, 8, 2, 96, 160, 128, True, None, torch.float32),
    (2, 4, 2, 128, 128, 64, True, 20.0, torch.float32),
    (1, 4, 4, 128, 64, 128, False, None, torch.float32),
    (1, 8, 2, 384, 384, 128, True, None, torch.bfloat16),
    (2, 4, 2, 200, 328, 128, True, None, torch.bfloat16),
    (1, 4, 1, 328, 200, 64, False, None, torch.bfloat16),
    (1, 4, 2, 640, 640, 64, True, None, torch.bfloat16),
    (2, 40, 8, 1024, 1024, 128, True, None, torch.bfloat16),
    (1, 10, 2, 96, 160, 64, True, None, torch.float32),
    (2, 16, 8, 1024, 1024, 256, True, 50.0, torch.bfloat16),
    (2, 4, 2, 200, 328, 256, True, None, torch.bfloat16),
    (1, 4, 1, 328, 200, 256, False, None, torch.bfloat16),
    (1, 4, 2, 328, 200, 256, True, 50.0, torch.bfloat16),
    (1, 8, 2, 96, 160, 256, True, 50.0, torch.float32),
    (2, 8, 4, 640, 640, 256, True, None, torch.float32),
    (1, 36, 4, 512, 512, 128, True, None, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,softcap,dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain(b, h, kv, sq, skv, d, causal, softcap,
                                   dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = _torch(*_inputs(6, b, h, kv, sq, skv, d), dtype=dtype,
                     device="cuda")
    before = tf.flash_attention.launches
    got = tf.flash_attention(q, k, v, causal=causal, softcap=softcap,
                             q_chunk=math.gcd(sq, 32),
                             kv_chunk=math.gcd(skv, 32))
    torch.cuda.synchronize()
    assert tf.flash_attention.launches == before + 1
    want = tf.flash_attention_plain(q, k, v, causal=causal, softcap=softcap)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_takes_transposed_views():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(7)
    x = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()
         for s in ((2, 128, 8, 64), (2, 128, 2, 64), (2, 128, 2, 64))]
    q, k, v = (t.transpose(1, 2) for t in x)          # [B,S,H,d] → [B,H,S,d]
    got = tf.flash_attention(q, k, v, causal=True, q_chunk=64, kv_chunk=64)
    want = tf.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert got.transpose(1, 2).is_contiguous()


# (S, H, KV, d, softcap): a d=128 stack, and gemma2's global layers (d=256,
# softcap 50) over 256 CTAs, more than one wave of the 132 SMs
@pytest.mark.cuda
@pytest.mark.parametrize("s,h,kv,d,softcap", [(384, 16, 4, 128, None),
                                              (1024, 16, 8, 256, 50.0)])
def test_cuda_bf16_kernel_takes_main_path_views(s, h, kv, d, softcap):
    """Batch 2 of [B,S,H,d] tensors seen as [B,H,S,d], as attention_layer
    passes them: q's sequence stride is H*d, k/v's KV*d."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(9)
    x = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        "cuda", torch.bfloat16)
         for shape in ((2, s, h, d), (2, s, kv, d), (2, s, kv, d))]
    q, k, v = (t.transpose(1, 2) for t in x)          # [B,S,H,d] → [B,H,S,d]
    before = tf.flash_attention.launches
    got = tf.flash_attention(q, k, v, causal=True, softcap=softcap,
                             q_chunk=128, kv_chunk=128)
    assert tf.flash_attention.launches == before + 1
    assert got.stride() == q.stride()
    want = tf.flash_attention_plain(q, k, v, causal=True, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_kernel_unaligned_bf16_is_realigned():
    """bf16 rows that are not 16-byte aligned are copied, then launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(8)
    big = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        "cuda", torch.bfloat16) for s in ((1, 4, 128, 65), (1, 2, 128, 65),
                                          (1, 2, 128, 65))]
    q, k, v = (t[..., 1:] for t in big)              # 2-byte offset rows
    before = tf.flash_attention.launches
    got = tf.flash_attention(q, k, v, causal=True, q_chunk=64, kv_chunk=64)
    assert tf.flash_attention.launches == before + 1
    want = tf.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
