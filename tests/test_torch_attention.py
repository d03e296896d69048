"""The port's attention against the JAX package's: the plain version of the
packed kernel against the Pallas kernel in interpret mode and its einsum
reference, and the cross-attention path; and the checks of the kernel's
wrapper. The CUDA kernel itself is held against its plain version in
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.ops.attention import multihead_attention as jax_mha
from polyffusion_tpu.ops.fused_attention import (
    _einsum_reference_packed,
    fused_self_attention_packed,
)
from polyffusion_tpu_torch.ops.attention import multihead_attention
from polyffusion_tpu_torch.ops.fused_attention import (
    packed_attention_reference,
    packed_self_attention,
)

T, D = 256, 64


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h * d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h", [2, 4])
def test_packed_reference_matches_pallas_fp32(b, h):
    q, k, v = _qkv(b, T, h, D, seed=10 * b + h)
    scale = D**-0.5
    got = packed_attention_reference(*map(torch.from_numpy, (q, k, v)), scale, h).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(fused_self_attention_packed(jq, jk, jv, scale, h, interpret=True))
    einsum = np.asarray(_einsum_reference_packed(jq, jk, jv, scale, h))
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, einsum, atol=1e-5)
    # the wrapper takes the plain version for a CPU tensor
    wrapped = packed_self_attention(*map(torch.from_numpy, (q, k, v)), scale, h).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_packed_reference_bf16_close_to_fp32():
    q, k, v = _qkv(2, T, 4, D, seed=3)
    scale = D**-0.5
    want = packed_attention_reference(*map(torch.from_numpy, (q, k, v)), scale, 4)
    got = packed_attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), scale, 4
    )
    assert got.dtype == torch.bfloat16
    # bf16 inputs, P and output (8 mantissa bits) against fp32: the same bound
    # the JAX package holds its bf16 kernel to (tests/test_fused_attention.py:59)
    err = (got.float() - want).abs().max().item()
    assert err < 0.05, err


def test_cross_attention_matches_jax():
    rng = np.random.default_rng(5)
    b, tq, tk, h, d = 2, 64, 1, 4, 64
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    got = multihead_attention(*map(torch.from_numpy, (q, k, v)), d**-0.5).numpy()
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_self_attention_dispatch_matches_jax():
    """Shapes the kernel takes go through ``packed_self_attention``."""
    rng = np.random.default_rng(6)
    b, t, h, d = 1, 128, 2, 64
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    got = multihead_attention(*map(torch.from_numpy, (q, k, v)), d**-0.5).numpy()
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "shapes,n_heads,dtype,match",
    [
        ([(1, 96, 128)] * 3, 2, torch.float32, "multiple of 64"),
        ([(1, 64, 96)] * 3, 3, torch.float32, "head dim"),
        ([(1, 64, 128)] * 3, 2, torch.float16, "dtype"),
        ([(1, 64, 128), (1, 128, 128), (1, 64, 128)], 2, torch.float32, "one \\(B, T, H\\*D\\)"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(shapes, n_heads, dtype, match):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(ValueError, match=match):
        packed_self_attention(q, k, v, 0.125, n_heads)


def test_wrapper_rejects_strided_input():
    q = torch.zeros(1, 64, 256)[:, :, :128]
    with pytest.raises(ValueError, match="contiguous"):
        packed_self_attention(q, q, q, 0.125, 2)


# -- the backward -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_packed_grads():
    """jax.grad through the interpret-mode Pallas kernel (its custom VJP runs
    the Pallas backward ``_packed_bwd_kernel``), compiled once per dtype."""
    import jax

    def grads(q, k, v, co, scale, h):
        def loss(q, k, v):
            out = fused_self_attention_packed(q, k, v, scale, h, interpret=True)
            return jnp.sum(co * out.astype(jnp.float32))

        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    return grads


def _port_grads(q, k, v, co, scale, h, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = packed_self_attention(*leaves, scale, h)
    return torch.autograd.grad(out.float(), leaves, torch.from_numpy(co))


@pytest.mark.parametrize("b,h", [(2, 4), (1, 2)])
def test_packed_backward_matches_pallas_fp32(jax_packed_grads, b, h):
    q, k, v = _qkv(b, T, h, D, seed=20 + b)
    co = np.random.default_rng(21).standard_normal(q.shape).astype(np.float32)
    scale = D**-0.5
    want = jax_packed_grads(*map(jnp.asarray, (q, k, v, co)), scale, h)
    got = _port_grads(q, k, v, co, scale, h)
    for name, a, w in zip("qkv", got, want):
        # the tolerance of tests/test_fused_attention.py:145
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-4, err_msg=f"d{name}")


def test_packed_backward_bf16_close_to_fp32(jax_packed_grads):
    """bf16 grads of the port within bf16 resolution of the JAX kernel's fp32
    VJP: the bound of tests/test_fused_attention.py:184."""
    q, k, v = _qkv(2, T, 4, D, seed=6)
    co = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    scale = D**-0.5
    want = jax_packed_grads(*map(jnp.asarray, (q, k, v, co)), scale, 4)
    got = _port_grads(q, k, v, co, scale, 4, torch.bfloat16)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        w = np.asarray(w)
        err = np.abs(a.float().numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err < 0.06, (name, err)


def test_attention_output_is_differentiable_through_the_kernel_function():
    """The kernel path carries its own backward: the output's grad_fn is the
    autograd function whose backward is ``packed_attention_bwd`` (the CUDA
    kernel on the card), and it takes a non-contiguous output gradient."""
    from polyffusion_tpu_torch.ops.fused_attention import packed_attention_bwd

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 128, 2, D, seed=8))
    out = multihead_attention(*(x.view(1, 128, 2, D) for x in (q, k, v)), D**-0.5)
    node = out.grad_fn
    while node is not None and "PackedAttention" not in type(node).__name__:
        node = node.next_functions[0][0]
    assert node is not None, "the output does not come from the kernel's autograd function"
    before = packed_attention_bwd.launches
    co = torch.randn(1, 2, 128, D).transpose(1, 2)  # (1, 128, 2, D), not contiguous
    out.backward(co)
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))
    assert packed_attention_bwd.launches == before  # the CPU runs the plain version


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    from polyffusion_tpu_torch.ops.fused_attention import packed_attention_bwd

    q = torch.zeros(1, 64, 128)
    with pytest.raises(ValueError, match="contiguous"):
        packed_attention_bwd(q, q, q, torch.zeros(1, 64, 256)[:, :, :128], 0.125, 2)
    with pytest.raises(ValueError, match="dtype"):
        packed_attention_bwd(q, q, q, q.to(torch.bfloat16), 0.125, 2)
