"""repro_torch BFP kernels (``kernels/{bfp_matmul,bfp_quant,ops}.py``): the
plain versions against the JAX Pallas kernels (interpret mode, as
tests/test_kernels_bfp.py runs them), and the CUDA kernels against the plain
versions on the card.

JAX is imported inside the tests that use it, so that a machine without JAX
can collect this file and run the ``cuda`` tests."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import bfp_common as bc, ops
from repro_torch.kernels.bfp_matmul import (bfp_matmul, bfp_matmul_plain,
                                            quantize_operand,
                                            quantize_operand_plain)
from repro_torch.kernels.bfp_quant import (bfp_matmul_packed,
                                           bfp_matmul_packed_plain,
                                           bfp_quantize, bfp_quantize_plain,
                                           dequantize_operand,
                                           dequantize_operand_plain)
from repro_torch.utils import ceil_to

RTOL, ATOL = 1e-5, 1e-4          # tests/test_kernels_bfp.py
SHAPES = [(32, 32, 32), (64, 96, 32), (100, 70, 36), (256, 128, 512)]
DTYPES = ["float32", "bfloat16"]
BLK64 = dict(block_m=64, block_n=64, block_k=64)


def _rand(seed, shape, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jnp():
    return pytest.importorskip("jax.numpy")


def _jax_kernels():
    bm = pytest.importorskip("repro.kernels.bfp_matmul")
    bq = pytest.importorskip("repro.kernels.bfp_quant")
    return bm.bfp_matmul, bq.bfp_quantize_pallas, bq.bfp_matmul_packed


def _pair(x, dtype, device="cpu"):
    """The same array for JAX (lazily) and for torch, in ``dtype``."""
    t = torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))
    return lambda jnp: jnp.asarray(x, getattr(jnp, dtype)), t


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bfp_matmul_matches_jax(m, k, n, dtype):
    jnp = _jnp()
    jmatmul, _, _ = _jax_kernels()
    ja, a = _pair(_rand(0, (m, k)), dtype)
    jb, b = _pair(_rand(1, (k, n)), dtype)
    want = jmatmul(ja(jnp), jb(jnp), group=32, interpret=True, **BLK64)
    got = bfp_matmul(a, b, group=32, **BLK64)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("group,blk,shape", [
    (8, 64, (64, 64, 64)), (16, 64, (64, 64, 64)), (32, 64, (64, 64, 64)),
    (3, 48, (100, 70, 36)),          # the paper's group, blocks of 48
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bfp_matmul_group_sweep_matches_jax(group, blk, shape, dtype):
    jnp = _jnp()
    jmatmul, _, _ = _jax_kernels()
    m, k, n = shape
    ja, a = _pair(_rand(2, (m, k)), dtype)
    jb, b = _pair(_rand(3, (k, n)), dtype)
    kw = dict(group=group, block_m=blk, block_n=blk, block_k=blk)
    want = jmatmul(ja(jnp), jb(jnp), interpret=True, **kw)
    _close(bfp_matmul(a, b, **kw), want)


@pytest.mark.parametrize("skip", [False, True])
def test_bfp_matmul_zero_gating_matches_jax(skip):
    jnp = _jnp()
    jmatmul, _, _ = _jax_kernels()
    x = _rand(4, (64, 64))
    x[:32, :] = 0.0                  # one all-zero operand tile
    ja, a = _pair(x, "float32")
    jb, b = _pair(_rand(5, (64, 64)), "float32")
    kw = dict(group=32, block_m=32, block_n=32, block_k=32)
    want = jmatmul(ja(jnp), jb(jnp), skip_zero_groups=skip, interpret=True,
                   **kw)
    _close(bfp_matmul(a, b, skip_zero_groups=skip, **kw), want,
           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,n,group,blk", [
    (32, 32, 32, 64), (96, 64, 32, 64), (70, 40, 32, 64), (100, 70, 32, 64),
    (100, 70, 3, 48), (37, 70, 8, 64),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bfp_quantize_bit_exact_against_jax(m, n, group, blk, dtype):
    """Whole padded arrays, shapes included: the padding is quantized too."""
    jnp = _jnp()
    _, jquant, _ = _jax_kernels()
    jx, x = _pair(_rand(6, (m, n), scale=3.0), dtype)
    jmant, jexp = jquant(jx(jnp), group=group, block_m=blk, block_n=blk,
                         interpret=True)
    mant, exp = bfp_quantize(x, group=group, block_m=blk, block_n=blk)
    assert mant.dtype == exp.dtype == torch.int8
    assert tuple(mant.shape) == jmant.shape and tuple(exp.shape) == jexp.shape
    np.testing.assert_array_equal(mant.numpy(), np.asarray(jmant))
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))


def test_bfp_quantize_padded_region_is_zero_groups():
    """(100, 70), group 32, blocks 64: mant (128, 128), last exponent
    column all -8 (a zero group's -127 clipped to the 4-bit minimum)."""
    mant, exp = bfp_quantize(torch.from_numpy(_rand(6, (100, 70), 3.0)),
                             group=32, block_m=64, block_n=64)
    assert tuple(mant.shape) == (128, 128) and tuple(exp.shape) == (4, 4)
    assert (exp[:, -1] == -8).all() and (mant[:, 96:] == 0).all()


@pytest.mark.parametrize("group,blk", [(32, 32), (3, 48)])
def test_bfp_matmul_packed_matches_jax(group, blk):
    jnp = _jnp()
    _, jquant, jpacked = _jax_kernels()
    ja, a = _pair(_rand(7, (96, 96), scale=3.0), "float32")
    jb, b = _pair(_rand(8, (96, 48), scale=3.0), "float32")
    qkw = dict(group=group, block_m=blk, block_n=blk)
    jam, jae = jquant(ja(jnp), interpret=True, **qkw)
    jbm, jbe = jquant(jb(jnp), interpret=True, **qkw)
    kw = dict(group=group, block_m=blk, block_n=blk, block_k=blk)
    want = jpacked(jam, jae, jbm, jbe, interpret=True, **kw)
    am, ae = bfp_quantize(a, **qkw)
    bm_, be = bfp_quantize(b, **qkw)
    got = bfp_matmul_packed(am, ae, bm_, be, **kw)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("group,blk", [(32, 32), (3, 48)])
def test_bfp_dense_matches_jax_vjp(group, blk):
    """y, dx and dw against jax.vjp of the JAX ops.bfp_dense."""
    jax = pytest.importorskip("jax")
    jnp = _jnp()
    jops = pytest.importorskip("repro.kernels.ops")
    blocks = dict(block_m=blk, block_n=blk, block_k=blk)
    jcfg = jops.BFPKernelConfig(group=group, interpret=True, **blocks)
    x, w, g = _rand(9, (4, 8, 96)), _rand(10, (96, 48)), _rand(11, (4, 8, 48))
    y_j, vjp = jax.vjp(lambda xx, ww: jops.bfp_dense(xx, ww, jcfg),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = ops.bfp_dense(xt, wt, ops.BFPKernelConfig(group=group, **blocks))
    y.backward(torch.from_numpy(g))
    _close(y.detach(), y_j)
    _close(xt.grad, dx_j)
    _close(wt.grad, dw_j)


def test_bfp_dense_backward_is_transposed_bfp_not_ste():
    """dx = Q(g)·Q(wᵀ), which differs from the STE's g·Q(w)ᵀ."""
    x, w, g = _rand(12, (2, 16, 64)), _rand(13, (64, 32)), _rand(14, (2, 16, 32))
    cfg = ops.BFPKernelConfig(group=32, block_m=32, block_n=32, block_k=32)
    xt = torch.from_numpy(x).requires_grad_()
    ops.bfp_dense(xt, torch.from_numpy(w), cfg).backward(torch.from_numpy(g))
    g2 = torch.from_numpy(g).reshape(-1, 32)
    want = bfp_matmul_plain(g2, torch.from_numpy(w).T, group=32)
    torch.testing.assert_close(xt.grad.reshape(-1, 64), want, rtol=0, atol=0)
    from repro_torch.core import bfp
    ste = g2 @ bfp.bfp_qdq(torch.from_numpy(w), (32, 32)).T
    assert not torch.allclose(xt.grad.reshape(-1, 64), ste, rtol=RTOL,
                              atol=ATOL)


# ---------------------------------------------------------------------------
# validation and dispatch
# ---------------------------------------------------------------------------

def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


I8 = torch.int8
VALUE_ERRORS = {
    "block_not_group_multiple": (lambda: bfp_matmul(
        _t(64, 64), _t(64, 64), group=32, block_m=48), "multiple of group"),
    "matmul_contraction": (lambda: bfp_matmul(_t(32, 64), _t(32, 32)),
                           "contraction"),
    "matmul_not_2d": (lambda: bfp_matmul(_t(2, 32, 32), _t(32, 32)), "2D"),
    "quantize_not_2d": (lambda: bfp_quantize(_t(2, 32, 32)), "2D"),
    "packed_not_group_padded": (lambda: bfp_matmul_packed(
        _t(48, 64, dtype=I8), _t(1, 2, dtype=I8), _t(64, 64, dtype=I8),
        _t(2, 2, dtype=I8), group=32), "group-padded"),
    "packed_not_tiling_by_blocks": (lambda: bfp_matmul_packed(
        _t(96, 64, dtype=I8), _t(3, 2, dtype=I8), _t(64, 64, dtype=I8),
        _t(2, 2, dtype=I8), group=32, block_m=64), "tile by blocks"),
    "packed_contraction": (lambda: bfp_matmul_packed(
        _t(64, 64, dtype=I8), _t(2, 2, dtype=I8), _t(32, 64, dtype=I8),
        _t(1, 2, dtype=I8), group=32), "contraction"),
    "matmul_meta_device": (lambda: bfp_matmul(
        _t(32, 32, device="meta"), _t(32, 32, device="meta")),
        "unsupported device"),
    "quantize_meta_device": (lambda: bfp_quantize(_t(32, 32, device="meta")),
                             "unsupported device"),
    "gemm_tn_not_bf16": (lambda: bc.gemm_tn(
        _t(bc.GEMM_TILE_M, bc.GEMM_TILE_K), _t(bc.GEMM_TILE_N, bc.GEMM_TILE_K),
        8, 8), "contiguous bf16"),
    "gemm_tn_not_tile_multiple": (lambda: bc.gemm_tn(
        _t(bc.GEMM_TILE_M + 8, bc.GEMM_TILE_K, dtype=torch.bfloat16),
        _t(bc.GEMM_TILE_N, bc.GEMM_TILE_K, dtype=torch.bfloat16), 8, 8),
        "do not tile"),
    "quantize_operand_meta_device": (lambda: quantize_operand(
        _t(32, 32, device="meta"), bc.GEMM_TILE_M), "CUDA tensor"),
    "dequantize_operand_meta_device": (lambda: dequantize_operand(
        _t(32, 32, dtype=I8, device="meta"), _t(1, 1, dtype=I8,
                                                device="meta"),
        bc.GEMM_TILE_M), "CUDA device"),
    "gemm_tn_meta_device": (lambda: bc.gemm_tn(
        _t(bc.GEMM_TILE_M, bc.GEMM_TILE_K, dtype=torch.bfloat16,
           device="meta"),
        _t(bc.GEMM_TILE_N, bc.GEMM_TILE_K, dtype=torch.bfloat16,
           device="meta"), 8, 8), "unsupported device"),
    "gemm_tn_one_flag": (lambda: bc.gemm_tn(
        _t(bc.GEMM_TILE_M, bc.GEMM_TILE_K, dtype=torch.bfloat16),
        _t(bc.GEMM_TILE_N, bc.GEMM_TILE_K, dtype=torch.bfloat16), 8, 8,
        a_flags=_t(1, 1, dtype=torch.uint8)), "both zero-gate flags"),
}


@pytest.mark.parametrize("case", sorted(VALUE_ERRORS))
def test_wrappers_raise_value_error(case):
    fn, match = VALUE_ERRORS[case]
    with pytest.raises(ValueError, match=match):
        fn()


def test_cpu_tensors_take_plain_versions_without_counting():
    a, b = torch.from_numpy(_rand(15, (64, 96))), \
        torch.from_numpy(_rand(16, (96, 32)))
    counters = (bfp_matmul, bfp_quantize, bfp_matmul_packed)
    before = [f.launches for f in counters]
    got = bfp_matmul(a, b, group=32)
    torch.testing.assert_close(got, bfp_matmul_plain(a, b, group=32),
                               rtol=0, atol=0)
    mant, exp = bfp_quantize(a, group=32)
    pm, pe = bfp_quantize_plain(a, group=32)
    assert torch.equal(mant, pm) and torch.equal(exp, pe)
    bm_, be = bfp_quantize(b, group=32)
    torch.testing.assert_close(
        bfp_matmul_packed(mant, exp, bm_, be, group=32),
        bfp_matmul_packed_plain(mant, exp, bm_, be, group=32), rtol=0, atol=0)
    assert [f.launches for f in counters] == before


def test_kernel_config_has_no_interpret_switch():
    fields = {f.name for f in dataclasses.fields(ops.BFPKernelConfig)}
    assert fields == {"group", "mbits", "ebits", "block_m", "block_n",
                      "block_k"}


def test_oracles_agree_with_plain_versions():
    from repro_torch.kernels import ref
    a, b = torch.from_numpy(_rand(17, (70, 40))), \
        torch.from_numpy(_rand(18, (40, 36)))
    torch.testing.assert_close(bfp_matmul_plain(a, b, group=8),
                               ref.ref_bfp_matmul(a, b, group=8),
                               rtol=RTOL, atol=ATOL)
    mant, exp = ref.ref_bfp_quantize(a, group=8)
    pm, pe = bfp_quantize_plain(a, group=8, block_m=8, block_n=8)
    assert torch.equal(mant, pm) and torch.equal(exp, pe)
    bm_, be = ref.ref_bfp_quantize(b, group=8)
    torch.testing.assert_close(
        ref.ref_bfp_matmul_packed(mant, exp, bm_, be, group=8),
        bfp_matmul_packed_plain(mant, exp, bm_, be, group=8),
        rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the two stages of each product on the card (operand passes, then one bf16
# GEMM), held here through their plain versions
# ---------------------------------------------------------------------------

TILES = {"A": bc.GEMM_TILE_M, "B": bc.GEMM_TILE_N}
BITS = [(1, 1), (2, 5), (3, 7), (5, 4), (7, 2), (7, 7)]


def _qdq_group_padded(x, group, mbits, ebits):
    """The port's ``qdq_block`` of ``x`` zero-padded to group multiples, as
    the reference pads before quantizing."""
    rows, k = x.shape
    xp = torch.zeros((ceil_to(rows, group), ceil_to(k, group)))
    xp[:rows, :k] = x.float()
    return bc.qdq_block(xp, group, mbits, ebits)


def _assert_operand_buffer(buf, q, rows, k, tile_rows):
    """``buf`` is the GEMM buffer of a (rows x k) operand whose values are
    ``q`` (zeros past the matrix): shape, bf16, ``q`` bit for bit (signed
    zeros included) and zeros everywhere else."""
    rp, kp = bc.operand_shape(rows, k, tile_rows)
    assert tuple(buf.shape) == (rp, kp) and buf.dtype == torch.bfloat16
    got = buf.float()
    r, c = min(rp, q.shape[0]), min(kp, q.shape[1])
    want = torch.zeros((rp, kp))
    want[:r, :c] = q[:r, :c]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _operand_input(seed, rows, k, dtype, transposed, span=0):
    """(rows x k) input in ``dtype``; a transposed view of a (k x rows)
    array when ``transposed``; columns scaled by 2^u, u uniform in
    [-span, span]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)) * 2.0 ** rng.integers(
        -span, span + 1, size=k)
    x = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    return x.T.contiguous().T if transposed else x


@pytest.mark.parametrize("group", bc.SUPPORTED_GROUPS)
@pytest.mark.parametrize("mbits,ebits", BITS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("operand", ["A", "B"])
def test_operand_pass_plain_is_qdq_block_bit_exact(group, mbits, ebits,
                                                    dtype, operand):
    """A as its (M x K) array, B through its transposed view (N x K):
    the bf16 buffer, cast back to f32, is qdq_block bit for bit, padding
    included, with exponents over the whole clip range of 1..7 bits."""
    rows, k = (100, 70) if operand == "A" else (37, 130)
    x = _operand_input(30, rows, k, dtype, operand == "B", span=6)
    kw = dict(group=group, mbits=mbits, ebits=ebits)
    buf, flags = quantize_operand_plain(x, TILES[operand], **kw)
    assert flags is None
    _assert_operand_buffer(buf, _qdq_group_padded(x, **kw), rows, k,
                           TILES[operand])


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), log2_scale=st.integers(-12, 12),
       group=st.sampled_from(bc.SUPPORTED_GROUPS), mbits=st.integers(1, 7),
       ebits=st.integers(1, 7), rows=st.integers(1, 80),
       k=st.integers(1, 80), dtype=st.sampled_from(DTYPES),
       transposed=st.booleans())
def test_operand_pass_plain_bit_exact_on_scaled_inputs(
        seed, log2_scale, group, mbits, ebits, rows, k, dtype, transposed):
    """Inputs scaled by 2^-12 .. 2^12 (and columns spread by up to 2^+-4 on
    top): the bf16 buffer still holds qdq_block exactly."""
    x = _operand_input(seed, rows, k, "float32", transposed, span=4)
    x = (x * 2.0 ** log2_scale).to(getattr(torch, dtype))
    kw = dict(group=group, mbits=mbits, ebits=ebits)
    buf, _ = quantize_operand_plain(x, bc.GEMM_TILE_M, **kw)
    _assert_operand_buffer(buf, _qdq_group_padded(x, **kw), rows, k,
                           bc.GEMM_TILE_M)


@pytest.mark.parametrize("group", [3, 32])
def test_operand_pass_values_match_jax_qdq_block(group):
    jnp = _jnp()
    jcommon = pytest.importorskip("repro.kernels.bfp_common")
    x = _rand(31, (ceil_to(100, group), ceil_to(70, group)), scale=3.0)
    want = np.asarray(jcommon.qdq_block(jnp.asarray(x), group, 5, 4))
    buf, _ = quantize_operand_plain(torch.from_numpy(x), bc.GEMM_TILE_M,
                                    group=group)
    got = buf.float().numpy()[:x.shape[0], :x.shape[1]]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("group", bc.SUPPORTED_GROUPS)
@pytest.mark.parametrize("operand", ["A", "B"])
def test_dequantize_operand_plain_is_dequant_block_bit_exact(group, operand):
    """Packed mantissas and exponents (B through transposed views) → the
    bf16 buffer holds dequant_block bit for bit, zeros past the matrix."""
    x = torch.from_numpy(_rand(32, (100, 70), scale=3.0))
    mant, exp = bfp_quantize_plain(x, group=group, block_m=group,
                                   block_n=group)
    if operand == "B":
        mant, exp = mant.T.contiguous().T, exp.T.contiguous().T
    buf = dequantize_operand_plain(mant, exp, TILES[operand], group=group)
    want = bc.dequant_block(mant, exp, group, 5)
    _assert_operand_buffer(buf, want, *mant.shape, TILES[operand])


@pytest.mark.parametrize("rows,k,operand", [
    (1, 1, "A"), (100, 70, "A"), (128, 64, "A"), (129, 65, "B"),
    (257, 1000, "B"), (8192, 4096, "A"), (12800, 4096, "B"),
    (4096, 8192, "A")])
def test_operand_shape_pads_to_tile_multiples(rows, k, operand):
    tile = TILES[operand]
    rp, kp = bc.operand_shape(rows, k, tile)
    assert rp % tile == 0 and rows <= rp < rows + tile
    assert kp % bc.GEMM_TILE_K == 0 and k <= kp < k + bc.GEMM_TILE_K
    if rows % tile == 0 and k % bc.GEMM_TILE_K == 0:
        assert (rp, kp) == (rows, k)   # the full-width shapes add nothing


def test_tile_flags_mark_nonzero_tiles():
    tm, tk = bc.GEMM_TILE_M, bc.GEMM_TILE_K
    buf = torch.zeros((2 * tm, 3 * tk), dtype=torch.bfloat16)
    buf[tm + 5, 2 * tk + 1] = -0.5
    buf[3, 0] = 1.0
    want = torch.tensor([[1, 0, 0], [0, 0, 1]], dtype=torch.uint8)
    assert torch.equal(bc.tile_flags(buf, tm), want)
    x = torch.from_numpy(_rand(33, (2 * tm, 3 * tk)))
    x[:tm] = 0
    _, flags = quantize_operand_plain(x, tm, gate=True)
    assert flags.tolist() == [[0, 0, 0], [1, 1, 1]]


def _two_stage(a, b, gate=False, **kw):
    """The card's decomposition of ``bfp_matmul``, through the plain
    versions on the CPU: both operand passes, then the GEMM."""
    aq, fa = quantize_operand(a, bc.GEMM_TILE_M, gate=gate, **kw)
    bq, fb = quantize_operand(b.T, bc.GEMM_TILE_N, gate=gate, **kw)
    return bc.gemm_tn(aq, bq, a.shape[0], b.shape[1], fa, fb)


@pytest.mark.parametrize("m,k,n,group,blk", [
    *[(m, k, n, 32, 64) for m, k, n in SHAPES],
    (64, 64, 64, 8, 64), (64, 64, 64, 16, 64), (100, 70, 36, 3, 48)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_stage_plain_pipeline_matches_plain_and_jax(m, k, n, group, blk,
                                                         dtype):
    jnp = _jnp()
    jmatmul, _, _ = _jax_kernels()
    ja, a = _pair(_rand(34, (m, k)), dtype)
    jb, b = _pair(_rand(35, (k, n)), dtype)
    got = _two_stage(a, b, group=group)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got, bfp_matmul_plain(a, b, group=group))
    _close(got, jmatmul(ja(jnp), jb(jnp), group=group, block_m=blk,
                        block_n=blk, block_k=blk, interpret=True))


def test_two_stage_plain_pipeline_with_zero_gate_matches_jax():
    jnp = _jnp()
    jmatmul, _, _ = _jax_kernels()
    x = _rand(36, (64, 64))
    x[:32, :] = 0.0
    ja, a = _pair(x, "float32")
    jb, b = _pair(_rand(37, (64, 64)), "float32")
    want = jmatmul(ja(jnp), jb(jnp), skip_zero_groups=True, interpret=True,
                   group=32, block_m=32, block_n=32, block_k=32)
    _close(_two_stage(a, b, gate=True), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("group,blk", [(32, 32), (8, 64), (3, 48)])
def test_two_stage_packed_pipeline_matches_plain(group, blk):
    a = torch.from_numpy(_rand(38, (192, 288), scale=3.0))
    b = torch.from_numpy(_rand(39, (288, 96), scale=3.0))
    qkw = dict(group=group, block_m=blk, block_n=blk)
    am, ae = bfp_quantize_plain(a, **qkw)
    bm_, be = bfp_quantize_plain(b, **qkw)
    aq = dequantize_operand(am, ae, bc.GEMM_TILE_M, group=group)
    bq = dequantize_operand(bm_.T, be.T, bc.GEMM_TILE_N, group=group)
    got = bc.gemm_tn(aq, bq, am.shape[0], bm_.shape[1])
    _close(got, bfp_matmul_packed_plain(am, ae, bm_, be, group=group))
    # the same buffers as the quantizing pass's, so the same product
    _close(got[:a.shape[0], :b.shape[1]], _two_stage(a, b, group=group))


def test_cpu_stage_wrappers_take_plain_versions_without_counting():
    counters = (quantize_operand, dequantize_operand, bc.gemm_tn)
    before = [f.launches for f in counters]
    a = torch.from_numpy(_rand(40, (64, 96)))
    buf, flags = quantize_operand(a, bc.GEMM_TILE_M, gate=True)
    want = quantize_operand_plain(a, bc.GEMM_TILE_M, gate=True)
    assert torch.equal(buf, want[0]) and torch.equal(flags, want[1])
    mant, exp = bfp_quantize_plain(a, group=32)
    assert torch.equal(
        dequantize_operand(mant, exp, bc.GEMM_TILE_N),
        dequantize_operand_plain(mant, exp, bc.GEMM_TILE_N))
    bq, fb = quantize_operand(a, bc.GEMM_TILE_N, gate=True)
    torch.testing.assert_close(bc.gemm_tn(buf, bq, 64, 64, flags, fb),
                               bc.gemm_tn_plain(buf, bq, 64, 64),
                               rtol=0, atol=0)
    assert [f.launches for f in counters] == before


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions, on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


CUDA_MATMUL = [(m, k, n, 32, 64) for m, k, n in SHAPES] + [
    (64, 64, 64, 8, 64), (64, 64, 64, 16, 64), (100, 70, 36, 3, 48),
    (200, 300, 100, 3, 48), (250, 190, 130, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group,blk", CUDA_MATMUL)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_bfp_matmul_matches_plain(m, k, n, group, blk, dtype):
    _need_card()
    _, a = _pair(_rand(20, (m, k)), dtype, "cuda")
    _, b = _pair(_rand(21, (k, n)), dtype, "cuda")
    kw = dict(group=group, block_m=blk, block_n=blk, block_k=blk)
    before = bfp_matmul.launches
    got = bfp_matmul(a, b, **kw)
    torch.cuda.synchronize()
    assert bfp_matmul.launches == before + 1
    _close(got, bfp_matmul_plain(a, b, group=group))


@pytest.mark.cuda
def test_cuda_bfp_matmul_transposed_views_and_zero_gate():
    _need_card()
    x = torch.from_numpy(_rand(22, (200, 192))).cuda()
    x[:96] = 0.0                     # whole kernel tiles of zeros
    w = torch.from_numpy(_rand(23, (160, 200))).cuda()
    want = bfp_matmul_plain(x.T.contiguous(), w.T.contiguous(), group=32)
    for skip in (False, True):
        got = bfp_matmul(x.T, w.T, group=32, skip_zero_groups=skip)
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,group,blk", [
    (32, 32, 32, 64), (96, 64, 32, 64), (70, 40, 32, 64), (100, 70, 32, 64),
    (100, 70, 3, 48), (37, 70, 8, 64), (300, 200, 16, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_bfp_quantize_bit_exact(m, n, group, blk, dtype):
    _need_card()
    _, x = _pair(_rand(24, (m, n), scale=3.0), dtype, "cuda")
    before = bfp_quantize.launches
    mant, exp = bfp_quantize(x, group=group, block_m=blk, block_n=blk)
    torch.cuda.synchronize()
    assert bfp_quantize.launches == before + 1
    pm, pe = bfp_quantize_plain(x, group=group, block_m=blk, block_n=blk)
    assert torch.equal(mant, pm) and torch.equal(exp, pe)


def _quantize_layout(x, layout):
    """x (m, n) as the kernel may meet it: contiguous (row stride n), rows
    16-byte aligned with a ragged n (a view of a wider buffer), a transposed
    view (column-major), or rows whose start is 4 bytes off 16."""
    m, n = x.shape
    if layout == "transposed":
        return x.T.contiguous().T
    if layout in ("aligned_rows", "offset"):
        lead = 0 if layout == "aligned_rows" else 1
        wide = torch.zeros((m, ceil_to(n + lead, 16)), dtype=x.dtype,
                           device=x.device)
        wide[:, lead:lead + n] = x
        return wide[:, lead:lead + n]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("group", bc.SUPPORTED_GROUPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "layout", ["contiguous", "aligned_rows", "transposed", "offset"])
def test_cuda_bfp_quantize_bit_exact_by_layout(group, dtype, layout):
    """Ragged (m, n) off every group and vector width, padding included."""
    _need_card()
    _, x = _pair(_rand(30, (203, 141), scale=3.0), dtype, "cuda")
    x = _quantize_layout(x, layout)
    blk = 48 if group == 3 else 64
    mant, exp = bfp_quantize(x, group=group, block_m=blk, block_n=blk)
    torch.cuda.synchronize()
    pm, pe = bfp_quantize_plain(x, group=group, block_m=blk, block_n=blk)
    assert mant.shape == pm.shape and exp.shape == pe.shape
    assert torch.equal(mant, pm) and torch.equal(exp, pe)


@pytest.mark.cuda
@pytest.mark.parametrize("group,blk", [(32, 32), (8, 64), (3, 48)])
def test_cuda_bfp_matmul_packed_matches_plain(group, blk):
    _need_card()
    a = torch.from_numpy(_rand(25, (192, 288), scale=3.0)).cuda()
    b = torch.from_numpy(_rand(26, (288, 96), scale=3.0)).cuda()
    qkw = dict(group=group, block_m=blk, block_n=blk)
    am, ae = bfp_quantize_plain(a, **qkw)
    bm_, be = bfp_quantize_plain(b, **qkw)
    before = bfp_matmul_packed.launches
    got = bfp_matmul_packed(am, ae, bm_, be, group=group, block_m=blk,
                            block_n=blk, block_k=blk)
    torch.cuda.synchronize()
    assert bfp_matmul_packed.launches == before + 1
    _close(got, bfp_matmul_packed_plain(am, ae, bm_, be, group=group))
    # the packed product equals the fused one on the same operands
    _close(got[:a.shape[0], :b.shape[1]],
           bfp_matmul(a, b, group=group, block_m=blk, block_n=blk,
                      block_k=blk))


@pytest.mark.cuda
def test_cuda_bfp_dense_launches_three_kernels():
    _need_card()
    cfg = ops.BFPKernelConfig(group=32)
    x = torch.from_numpy(_rand(27, (2, 64, 128))).cuda().requires_grad_()
    w = torch.from_numpy(_rand(28, (128, 96))).cuda().requires_grad_()
    g = torch.from_numpy(_rand(29, (2, 64, 96))).cuda()
    before = bfp_matmul.launches
    y = ops.bfp_dense(x, w, cfg)
    y.backward(g)
    torch.cuda.synchronize()
    assert bfp_matmul.launches == before + 3
    x2, g2 = x.detach().reshape(-1, 128), g.reshape(-1, 96)
    _close(y.detach().reshape(-1, 96), bfp_matmul_plain(x2, w.detach()))
    _close(x.grad.reshape(-1, 128), bfp_matmul_plain(g2, w.detach().T))
    _close(w.grad, bfp_matmul_plain(x2.T, g2))


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["group", "mbits", "dtype"])
def test_cuda_unsupported_arguments_raise(what):
    _need_card()
    a = _t(64, 64, device="cuda")
    kw = dict(group=32)
    if what == "group":
        kw = dict(group=4, block_m=64, block_n=64, block_k=64)
    elif what == "mbits":
        kw = dict(group=32, mbits=8)
    else:
        a = a.half()
    with pytest.raises(ValueError):
        bfp_matmul(a, a, **kw)
    kw.pop("block_k", None)
    with pytest.raises(ValueError):
        bfp_quantize(a, **kw)


# (rows, k, group, dtype, transposed, gate): ragged shapes, transposed
# views, group 3, the zero gate on and off
CUDA_OPERAND = [
    (100, 70, 32, "float32", False, False), (100, 70, 32, "bfloat16", False,
                                             True),
    (250, 190, 3, "float32", True, True), (200, 300, 3, "bfloat16", True,
                                           False),
    (300, 200, 8, "float32", False, True), (64, 520, 16, "float32", True,
                                            False),
    (129, 1000, 32, "bfloat16", True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,group,dtype,transposed,gate", CUDA_OPERAND)
@pytest.mark.parametrize("operand", ["A", "B"])
def test_cuda_quantize_operand_matches_plain(rows, k, group, dtype,
                                             transposed, gate, operand):
    _need_card()
    x = _operand_input(41, rows, k, dtype, transposed, span=6).cuda()
    x[: rows // 3] = 0               # whole tiles of zeros for the gate
    kw = dict(group=group, gate=gate)
    before = quantize_operand.launches
    buf, flags = quantize_operand(x, TILES[operand], **kw)
    torch.cuda.synchronize()
    assert quantize_operand.launches == before + 1
    want, want_flags = quantize_operand_plain(x, TILES[operand], **kw)
    assert torch.equal(buf.view(torch.int16), want.view(torch.int16))
    assert flags is None if not gate else torch.equal(flags, want_flags)


@pytest.mark.cuda
@pytest.mark.parametrize("group", bc.SUPPORTED_GROUPS)
@pytest.mark.parametrize("operand", ["A", "B"])
def test_cuda_dequantize_operand_matches_plain(group, operand):
    _need_card()
    x = torch.from_numpy(_rand(42, (250, 190), scale=3.0)).cuda()
    mant, exp = bfp_quantize_plain(x, group=group, block_m=group,
                                   block_n=group)
    if operand == "B":
        mant, exp = mant.T.contiguous().T, exp.T.contiguous().T
    before = dequantize_operand.launches
    buf = dequantize_operand(mant, exp, TILES[operand], group=group)
    torch.cuda.synchronize()
    assert dequantize_operand.launches == before + 1
    want = dequantize_operand_plain(mant, exp, TILES[operand], group=group)
    assert torch.equal(buf.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(100, 36, 70), (300, 520, 200),
                                   (257, 129, 1000), (128, 256, 64)])
@pytest.mark.parametrize("gate", [False, True])
def test_cuda_gemm_tn_matches_plain(m, n, k, gate):
    _need_card()
    a = torch.from_numpy(_rand(43, (m, k))).cuda()
    b = torch.from_numpy(_rand(44, (n, k))).cuda()
    a[: m // 2] = 0
    aq, fa = quantize_operand(a, bc.GEMM_TILE_M, gate=gate)
    bq, fb = quantize_operand(b, bc.GEMM_TILE_N, gate=gate)
    before = bc.gemm_tn.launches
    got = bc.gemm_tn(aq, bq, m, n, fa, fb)
    torch.cuda.synchronize()
    assert bc.gemm_tn.launches == before + 1
    _close(got, bc.gemm_tn_plain(aq, bq, m, n))
