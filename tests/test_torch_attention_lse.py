"""The row log-sum-exp that the packed forward saves for its backward, and the
backward's form that reads it, against the JAX package: the plain versions on
the CPU (the CUDA kernels are held against them in
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.ops.fused_attention import fused_self_attention_packed
from polyffusion_tpu_torch.ops import fused_attention as fa
from polyffusion_tpu_torch.ops.fused_attention import (
    packed_attention_bwd,
    packed_attention_bwd_reference,
    packed_attention_lse_reference,
    packed_self_attention,
)

# (B, T, H, D)
SHAPES = [(1, 64, 1, 64), (2, 128, 2, 64), (1, 128, 2, 128)]
# the bf16 limit of the backward kernel against its plain version (chip_smoke.py)
BWD_BF16_ATOL, BWD_BF16_RTOL = 2e-3, 2**-6


def _arrays(b, t, h, d, seed, n=4, spread=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, t, h * d)) * spread).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_packed_grads():
    """jax.grad through the interpret-mode Pallas kernel, whose custom VJP
    runs the Pallas backward ``_packed_bwd_kernel``."""

    def grads(q, k, v, co, scale, h):
        def loss(q, k, v):
            out = fused_self_attention_packed(q, k, v, scale, h, interpret=True)
            return jnp.sum(co * out.astype(jnp.float32))

        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    return grads


@pytest.mark.parametrize("b,t,h,d", SHAPES + [(2, 256, 4, 64)])
@pytest.mark.parametrize("spread", [1.0, 4.0])
def test_lse_reference_matches_jax_logsumexp(b, t, h, d, spread):
    q, k = _arrays(b, t, h, d, seed=b * t + h, n=2, spread=spread)
    scale = d**-0.5
    got = packed_attention_lse_reference(torch.from_numpy(q), torch.from_numpy(k), scale, h)
    jq = jnp.asarray(q).reshape(b, t, h, d)
    jk = jnp.asarray(k).reshape(b, t, h, d)
    logits = jnp.einsum("bihd,bjhd->bhij", jq, jk) * scale
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    assert got.shape == (b, h, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_lse_backward_matches_pallas_fp32(jax_packed_grads, b, t, h, d):
    """The plain backward given the forward's lse (P = exp(S scale - lse), the
    kernel's form) against the Pallas backward, which renormalises P."""
    q, k, v, co = _arrays(b, t, h, d, seed=30 + t + h)
    scale = d**-0.5
    want = jax_packed_grads(*map(jnp.asarray, (q, k, v, co)), scale, h)
    tq, tk, tv, tco = map(torch.from_numpy, (q, k, v, co))
    lse = packed_attention_lse_reference(tq, tk, scale, h)
    got = packed_attention_bwd_reference(tq, tk, tv, tco, scale, h, lse)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("b,t,h,d", SHAPES + [(2, 256, 4, 64)])
def test_lse_backward_matches_its_own_form_in_bf16(b, t, h, d):
    """bf16: P from the saved lse against P renormalised by its own row max and
    sum, within the limit that holds the backward kernel to its plain version."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(b, t, h, d, seed=7 * t))
    scale = d**-0.5
    lse = packed_attention_lse_reference(q, k, scale, h)
    got = packed_attention_bwd_reference(q, k, v, do, scale, h, lse)
    want = packed_attention_bwd_reference(q, k, v, do, scale, h)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        w = w.float()
        assert ((a.float() - w).abs() <= BWD_BF16_ATOL + BWD_BF16_RTOL * w.abs()).all()


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_autograd_through_the_kernel_function_matches_jax(jax_packed_grads, b, t, h, d):
    """fp32 CPU autograd through ``packed_self_attention`` (no lse is saved in
    fp32; the backward recomputes its row statistics, as the fp32 kernel does)
    against the JAX custom VJP, at the tolerance of
    tests/test_fused_attention.py:145."""
    q, k, v, co = _arrays(b, t, h, d, seed=50 + t + d)
    scale = d**-0.5
    want = jax_packed_grads(*map(jnp.asarray, (q, k, v, co)), scale, h)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(packed_self_attention(*leaves, scale, h), leaves,
                              torch.from_numpy(co))
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("b,t,h,d", SHAPES)
def test_bf16_autograd_reads_the_saved_lse(b, t, h, d):
    """bf16 CPU autograd through ``packed_self_attention``: the forward saves
    lse and the backward is the plain backward in its lse form, bit for bit."""
    q, k, v, co = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _arrays(b, t, h, d, seed=70 + t + d))
    scale = d**-0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(packed_self_attention(*leaves, scale, h), leaves, co)
    want = packed_attention_bwd_reference(q, k, v, co, scale, h,
                                          packed_attention_lse_reference(q, k, scale, h))
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, w), f"d{name}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("needs_grad", [False, True])
def test_forward_computes_lse_only_for_a_bf16_gradient(monkeypatch, dtype, needs_grad):
    """lse is computed only when a gradient will be taken, and only in bf16:
    the fp32 backward recomputes its row statistics."""
    calls = []
    real = fa.packed_attention_lse_reference
    monkeypatch.setattr(fa, "packed_attention_lse_reference",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(needs_grad)
               for a in _arrays(1, 64, 1, 64, 3, 3))
    out = packed_self_attention(q, k, v, 0.125, 1)
    wanted = int(needs_grad and dtype == torch.bfloat16)
    assert len(calls) == wanted
    if needs_grad:
        out.float().sum().backward()
        assert len(calls) == wanted  # the backward reads the saved lse or none


def test_forward_refuses_lse_for_fp32():
    q = torch.zeros(1, 64, 64)
    with pytest.raises(ValueError, match="bfloat16 only"):
        fa._forward(q, q, q, 0.125, 1, True)


@pytest.mark.parametrize(
    "make_lse,match",
    [
        (lambda: torch.zeros(1, 2, 128), "shape"),
        (lambda: torch.zeros(1, 2, 64), "shape"),
        (lambda: torch.zeros(1, 1, 64, dtype=torch.float64), "float32"),
        (lambda: torch.zeros(1, 1, 64, dtype=torch.bfloat16), "float32"),
        (lambda: torch.zeros(1, 1, 64, device="meta"), "lies on"),
        (lambda: torch.zeros(1, 1, 128)[:, :, ::2], "contiguous"),
    ],
)
def test_bwd_wrapper_refuses_a_bad_lse(make_lse, match):
    q = torch.zeros(1, 64, 64)
    with pytest.raises(ValueError, match=match):
        packed_attention_bwd(q, q, q, q, 0.125, 1, lse=make_lse())
