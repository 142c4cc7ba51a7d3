"""The kernel wrappers refuse autograd, as the reference's Pallas kernels
do (``jax.grad`` through them raises): under grad mode an input that
requires grad raises ``RuntimeError`` on every device.  Under
``torch.no_grad()`` and on detached inputs they run; ``ops.bfp_dense``,
its own autograd.Function, still differentiates."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bfp_matmul as bm, bfp_quant as bq, ops
from repro_torch.kernels import flash_attention as fa

CFG = ops.BFPKernelConfig(group=32, block_m=32, block_n=32, block_k=32)


def _inputs(device, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen).to(device=device,
                                                    dtype=dtype)
    q, k, v = r(1, 4, 64, 64), r(1, 2, 64, 64), r(1, 2, 64, 64)
    a, b = r(64, 96), r(96, 32)
    am, ae = bq.bfp_quantize_plain(a.float().cpu(), group=32, block_m=32,
                                   block_n=32)
    bm_, be = bq.bfp_quantize_plain(b.float().cpu(), group=32, block_m=32,
                                    block_n=32)
    packed = tuple(t.to(device) for t in (am, ae, bm_, be))
    return q, k, v, a, b, packed


def _calls(device, dtype=torch.float32):
    """name → (float inputs that may require grad, the inputs it runs on,
    call, plain version)."""
    q, k, v, a, b, (am, ae, bm_, be) = _inputs(device, dtype)
    kw = dict(q_chunk=64, kv_chunk=64)
    packed = dict(group=32, block_m=32, block_n=32, block_k=32)
    calls = {
        "flash_attention": ((q, k, v),
                            lambda q, k, v: fa.flash_attention(q, k, v, **kw),
                            lambda q, k, v: fa.flash_attention_plain(q, k, v)),
        "bfp_matmul": ((a, b), lambda a, b: bm.bfp_matmul(a, b, group=32),
                       lambda a, b: bm.bfp_matmul_plain(a, b, group=32)),
        "bfp_quantize": ((a,), lambda a: bq.bfp_quantize(a, group=32)[0],
                         lambda a: bq.bfp_quantize_plain(a, group=32)[0]),
        "ops.matmul": ((a, b), lambda a, b: ops.matmul(a, b, CFG),
                       lambda a, b: bm.bfp_matmul_plain(a, b, group=32)),
        "ops.quantize": ((a,), lambda a: ops.quantize(a, CFG)[1],
                         lambda a: bq.bfp_quantize_plain(
                             a, group=32, block_m=32, block_n=32)[1]),
    }
    out = {n: (ins, ins, call, plain) for n, (ins, call, plain)
           in calls.items()}
    # int8 mantissas cannot require grad: the packed products meet a float
    # input that does only if a caller passes float mantissas, which the
    # refusal catches before any type check; they run on the int8 ones
    plain = lambda x, y: bq.bfp_matmul_packed_plain(x, ae, y, be, group=32)
    out["bfp_matmul_packed"] = (
        (am.float(), bm_.float()), (am, bm_),
        lambda x, y: bq.bfp_matmul_packed(x, ae, y, be, **packed), plain)
    out["ops.matmul_packed"] = (
        (am.float(), bm_.float()), (am, bm_),
        lambda x, y: ops.matmul_packed(x, ae, y, be, CFG), plain)
    return out


KERNEL_OF = {"ops.matmul": "bfp_matmul", "ops.quantize": "bfp_quantize",
             "ops.matmul_packed": "bfp_matmul_packed"}
NAMES = sorted(_calls("cpu"))


def _check_refusal(name, device):
    grad_inputs, inputs, call, plain = _calls(device)[name]
    for i in range(len(grad_inputs)):   # each float input on its own
        args = [t.clone().requires_grad_(j == i)
                for j, t in enumerate(grad_inputs)]
        with pytest.raises(RuntimeError,
                           match=f"{KERNEL_OF.get(name, name)}.*no backward"):
            call(*args)
    args = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
    with torch.no_grad():
        under_no_grad = call(*args)
    detached = call(*(t.detach() for t in args))
    want = plain(*inputs)
    torch.testing.assert_close(under_no_grad, detached, rtol=0, atol=0)
    torch.testing.assert_close(detached.cpu(), want.cpu(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_refuses_autograd_on_cpu(name):
    _check_refusal(name, "cpu")


def test_refusal_needs_grad_mode_and_a_grad_input():
    q, k, v, *_ = _inputs("cpu")
    kw = dict(q_chunk=64, kv_chunk=64)
    fa.flash_attention(q, k, v, **kw)               # nothing requires grad
    with torch.enable_grad():
        fa.flash_attention(q, k, v, **kw)
    with torch.inference_mode():
        fa.flash_attention(q.requires_grad_(), k, v, **kw)


def test_bfp_dense_still_differentiates():
    """Its backward runs the wrappers with grad mode off; its gradients are
    the transposed BFP products (dx = Q(g)·Q(wᵀ), dw = Q(xᵀ)·Q(g))."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, 64), generator=gen).requires_grad_()
    w = torch.randn((64, 32), generator=gen).requires_grad_()
    g = torch.randn((2, 16, 32), generator=gen)
    ops.bfp_dense(x, w, CFG).backward(g)
    x2, g2 = x.detach().reshape(-1, 64), g.reshape(-1, 32)
    torch.testing.assert_close(
        x.grad.reshape(-1, 64),
        bm.bfp_matmul_plain(g2, w.detach().T, group=32), rtol=0, atol=0)
    torch.testing.assert_close(
        w.grad, bm.bfp_matmul_plain(x2.T, g2, group=32), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_wrapper_refuses_autograd(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _check_refusal(name, "cuda")


@pytest.mark.cuda
def test_cuda_bf16_flash_refuses_autograd_and_launches_under_no_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, *_ = _inputs("cuda", torch.bfloat16)
    q.requires_grad_()
    kw = dict(q_chunk=64, kv_chunk=64)
    with pytest.raises(RuntimeError, match="flash_attention"):
        fa.flash_attention(q, k, v, **kw)
    before = fa.flash_attention.launches
    with torch.no_grad():
        o = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert np.isfinite(o.float().cpu().numpy()).all()
