"""The port's head-major (BH, T, D) attention against the JAX package's
``fused_self_attention`` (kernel 3, ``_attn_kernel``) run in Pallas interpret
mode on the CPU: forward in fp32 and bf16, at tile multiples and a ragged
length, gradients through both custom backwards, the wrapper's checks, and
that the model's attention never takes this op. The CUDA kernel itself is
held against its plain version in ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.ops.fused_attention import _einsum_reference
from polyffusion_tpu.ops.fused_attention import fused_self_attention as jax_fused
from polyffusion_tpu_torch.ops import fused_attention as fa
from polyffusion_tpu_torch.ops.attention import multihead_attention
from polyffusion_tpu_torch.ops.fused_attention import (
    fused_self_attention,
    head_major_attention_reference,
)

SHAPES = [(4, 128, 64), (6, 128, 128), (7, 256, 64), (3, 96, 64)]  # (BH, T, D); T 96 is ragged
# bf16: kernel 1's limit (chip_smoke.py), two output ulps and, near zero, the
# rounding of P before or after its normalisation
BF16_ATOL, BF16_RTOL = 2e-3, 2**-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(bh, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("bh,t,d", SHAPES)
def test_fp32_matches_pallas_interpret(bh, t, d):
    q, k, v = _qkv(bh, t, d, seed=t + d + bh)
    scale = d**-0.5
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)), scale, interpret=True))
    got = fused_self_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.dtype == torch.float32 and got.shape == (bh, t, d)
    # the JAX package's own bound for this kernel (tests/test_fused_attention.py:32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(
        head_major_attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy(),
        np.asarray(_einsum_reference(*map(jnp.asarray, (q, k, v)), scale)), atol=2e-5)


@pytest.mark.parametrize("bh,t,d", SHAPES)
def test_bf16_matches_pallas_interpret(bh, t, d):
    q, k, v = _qkv(bh, t, d, seed=100 + t + d + bh)
    scale = d**-0.5
    want = np.asarray(jax_fused(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale,
                                interpret=True), np.float32)
    got = fused_self_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                               scale)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= BF16_ATOL + BF16_RTOL * np.abs(want)).all(), err.max()


@pytest.mark.parametrize("bh,t,d", [(4, 128, 64), (3, 96, 64)])
def test_gradients_match_jax_custom_vjp(bh, t, d):
    q, k, v = _qkv(bh, t, d, seed=7 + t)
    co = np.random.default_rng(8).standard_normal((bh, t, d)).astype(np.float32)
    scale = d**-0.5

    def loss(q_, k_, v_):
        return jnp.sum(jnp.asarray(co) * jax_fused(q_, k_, v_, scale, interpret=True))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fused_self_attention(*qkv, scale)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(co))
    for name, a, w in zip("qkv", got, want):
        # the JAX package's gradient bound (tests/test_fused_attention.py:99)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-4, err_msg=f"d{name}")


def test_output_comes_from_the_kernel_function():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(2, 64, 64, seed=3))
    out = fused_self_attention(q, k, v, 0.125)
    assert type(out.grad_fn).__name__ == "_HeadMajorAttentionBackward"
    plain = fused_self_attention(q.detach(), k.detach(), v.detach(), 0.125)
    torch.testing.assert_close(plain, head_major_attention_reference(q, k, v, 0.125).detach(),
                               rtol=0, atol=0)


def test_block_bh_does_not_change_the_result():
    q, k, v = map(torch.from_numpy, _qkv(5, 64, 64, seed=4))
    want = fused_self_attention(q, k, v, 0.125)
    for block_bh in (1, 2, 5, 8):
        torch.testing.assert_close(fused_self_attention(q, k, v, 0.125, block_bh=block_bh), want,
                                   rtol=0, atol=0)
    for bad in (-1, 1.5, True, "2"):
        with pytest.raises(ValueError, match="block_bh"):
            fused_self_attention(q, k, v, 0.125, block_bh=bad)


def test_single_query_matches_jax():
    q, k, v = _qkv(3, 1, 128, seed=5)
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)), 0.1, interpret=True))
    got = fused_self_attention(*map(torch.from_numpy, (q, k, v)), 0.1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "shapes", "rank", "strided", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    q = torch.zeros(2, 64, 64)
    args = {
        "head_dim": (torch.zeros(2, 64, 32),) * 3,
        "dtype": (q.half(),) * 3,
        "shapes": (q, torch.zeros(2, 65, 64), q),
        "rank": (q[None],) * 3,
        "strided": (torch.zeros(2, 64, 128)[..., ::2],) * 3,
        "empty": (torch.zeros(2, 0, 64),) * 3,
    }[case]
    with pytest.raises(ValueError):
        fused_self_attention(*args, 0.125)


def test_wrapper_bounds_bh_by_the_grid():
    q = torch.zeros(fa.MAX_BH + 1, 1, 64)
    with pytest.raises(ValueError, match="65535"):
        fused_self_attention(q, q, q, 0.125)


def test_model_attention_never_takes_the_head_major_op(monkeypatch):
    """JAX's dispatcher (``ops/attention.py:116-136``) sends the UNet's
    attention to the packed kernel, never to ``fused_self_attention``."""

    def refuse(*args, **kwargs):
        raise AssertionError("multihead_attention called the head-major op")

    monkeypatch.setattr(fa._HeadMajorAttention, "apply", refuse)
    monkeypatch.setattr(fa, "fused_self_attention", refuse)
    rng = np.random.default_rng(6)
    for tq, tk in ((128, 128), (96, 96), (64, 1), (64, 128)):
        q = torch.from_numpy(rng.standard_normal((2, tq, 2, 64)).astype(np.float32))
        kv = torch.from_numpy(rng.standard_normal((2, tk, 2, 64)).astype(np.float32))
        assert multihead_attention(q, kv, kv, 0.125).shape == (2, tq, 2, 64)
