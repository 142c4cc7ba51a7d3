"""repro_torch.core.bfp against repro.core.bfp: the integer mantissas and
exponents are bit-identical, qdq matches exactly, the STE is identity."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfp as jbfp
from repro_torch.core import bfp as tbfp


def _x(shape, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cases():
    x_zero = _x((64, 96), 3)
    x_zero[:32, :32] = 0.0           # a whole (32,32) group of zeros
    x_zero[3:6, 6:9] = 0.0           # a whole (3,3) group of zeros
    x_range = _x((48, 48), 4) * np.float32(2.0) ** np.arange(
        -12, 12, 0.5, dtype=np.float32)[None, :]   # exponents clip both ends
    return {
        "square": _x((48, 48), 0),
        "padded_batched": _x((2, 5, 7), 1),
        "padded_2d": _x((37, 70), 2),
        "zero_groups": x_zero,
        "wide_range": x_range,
    }


CASES = _cases()


@pytest.mark.parametrize("group", [(3, 3), (32, 32)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_bit_identical_to_jax(name, group):
    x = CASES[name]
    want = jbfp.bfp_quantize(jnp.asarray(x), group=group)
    got = tbfp.bfp_quantize(torch.from_numpy(x), group=group)
    assert got.mant.dtype == torch.int8 and got.exp.dtype == torch.int8
    np.testing.assert_array_equal(got.mant.numpy(), np.asarray(want.mant))
    np.testing.assert_array_equal(got.exp.numpy(), np.asarray(want.exp))
    assert got.shape == tuple(want.shape)


@pytest.mark.parametrize("group", [(3, 3), (32, 32)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_qdq_exact_against_jax(name, group):
    x = CASES[name]
    want = jbfp.bfp_qdq(jnp.asarray(x), group)
    got = tbfp.bfp_qdq(torch.from_numpy(x), group)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qdq_keeps_input_dtype():
    x = torch.from_numpy(CASES["square"]).to(torch.bfloat16)
    assert tbfp.bfp_qdq(x, (32, 32)).dtype == torch.bfloat16


def test_ste_gradient_is_identity():
    x = torch.from_numpy(CASES["padded_2d"]).requires_grad_()
    g = torch.from_numpy(_x((37, 70), 9))
    (gx,) = torch.autograd.grad(tbfp.bfp_qdq(x, (3, 3)), x, g)
    np.testing.assert_array_equal(gx.numpy(), g.numpy())


@pytest.mark.parametrize("group", [(3, 3), (2, 2), (8, 8), (32, 32)])
def test_transpose_invariance(group):
    w = torch.from_numpy(_x((64, 96), 1))
    qt = tbfp.bfp_quantize(w.t(), group=group)
    tq = tbfp.bfp_quantize(w, group=group).transpose
    np.testing.assert_array_equal(qt.mant.numpy(), tq.mant.numpy())
    np.testing.assert_array_equal(qt.exp.numpy(), tq.exp.numpy())
    assert qt.shape == tq.shape and qt.group == tq.group


def test_dequantize_matmul_ref_and_rmse_match_jax():
    a, b = _x((40, 33), 5), _x((33, 29), 6)
    np.testing.assert_allclose(
        tbfp.bfp_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbfp.bfp_matmul_ref(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(tbfp.quantization_rmse(torch.from_numpy(a))),
        float(jbfp.quantization_rmse(jnp.asarray(a))), rtol=1e-6)
    t = tbfp.bfp_quantize(torch.from_numpy(a), group=(3, 3))
    assert t.bits_per_value == pytest.approx(
        jbfp.bfp_quantize(jnp.asarray(a), group=(3, 3)).bits_per_value)
