"""``remat`` in the port's ``SDFTask.loss_fn`` (JAX ``tasks/sdf.py:218-221``,
``jax.checkpoint(self.apply_eps)``): the loss and gradients equal the plain
loss's, and match the JAX package's ``loss_fn`` under ``remat: true`` on the
same weights, batch, t and noise, fp32 on the CPU, with the GroupNorm-SiLU-conv
sites unfused and fused (the JAX Pallas kernel in interpret mode, the port's
plain version). The recompute runs the attention forward again, with its row
log-sum-exp, and keeps fewer tensors for the backward."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.models.unet import SpatialTransformer
from polyffusion_tpu_torch.ops import fused_attention
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.tasks.sdf import StepNoise
from polyffusion_tpu_torch.utils.precision import cast_sampling_params

# one level with attention on 8 x 8 = 64 tokens (one tile), one head of 64
# (the packed kernel's path), the widths of tests/test_torch_train.py
CFG = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-3, max_grad_norm=1.0,
    bf16=False, in_channels=2, out_channels=2, channels=64, attention_levels=[0], n_res_blocks=1,
    channel_multipliers=[1], n_heads=1, tf_layers=1, d_cond=32 * 36, linear_start=0.00085,
    linear_end=0.012, n_steps=1000, img_h=8, img_w=8, cond_type="chord", cond_mode="cond",
    use_enc=False,
)
B, HW = 2, 8
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # the limits of tests/test_torch_train.py
SELF_RTOL = 1e-6  # remat against no remat, both in the port


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x0 = (rng.random((B, 2, HW, HW)) > 0.9).astype(np.float32)
    chord = (rng.random((B, 32, 36)) > 0.8).astype(np.float32)
    return x0, chord


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    jtask = JaxSDFTask(JaxParams(CFG))
    return jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init_params)(jax.random.PRNGKey(seed)))


def _port_grads(params, x0, chord, noise, remat, gn_conv):
    task = SDFTask(Params({**CFG, "remat": remat}), device="cpu", training=True,
                   gn_conv=gn_conv)
    task.load_unet_state(unet_state_from_jax(params))
    batch = (torch.from_numpy(x0), None, torch.from_numpy(chord), None)
    loss, _ = task.loss_fn(batch, noise)
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in task.unet.named_parameters()}


def _rel_norm(got, want):
    num = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("gn_conv", ["unfused", "fused"])
def test_remat_matches_jax_remat(gn_conv, monkeypatch):
    """JAX ``loss_fn(params, batch, rng)`` under ``remat: true`` draws t and
    the noise from ``rng`` (``diffusion_loss``); the test draws the same ones
    and hands them to the port's loss under ``remat: true``."""
    for name in ("POLYFF_FUSED_GN_CONV", "POLYFF_INT8_CONV", "POLYFF_INT8_XLA"):
        monkeypatch.delenv(name, raising=False)
    params = _jax_params()
    if gn_conv == "fused":
        monkeypatch.setenv("POLYFF_FUSED_GN_CONV", "1")
    x0, chord = _batch()
    jtask = JaxSDFTask(JaxParams({**CFG, "remat": True}))
    rng = jax.random.PRNGKey(7)
    jbatch = (jnp.asarray(x0), None, jnp.asarray(chord), None)
    loss_fn = jax.jit(lambda p: jtask.loss_fn(p, jbatch, rng, {})[0])
    want_loss, want_g = jax.value_and_grad(loss_fn)(params)
    # the draws of JAX's loss_fn: (cond, loss) keys, then (t, eps) keys
    _, loss_rng = jax.random.split(rng)
    t_key, eps_key = jax.random.split(loss_rng)
    t = np.asarray(jax.random.randint(t_key, (B,), 0, CFG["n_steps"]))
    noise = np.asarray(jax.random.normal(eps_key, (B, HW, HW, 2))).transpose(0, 3, 1, 2)

    loss, grads = _port_grads(params, x0, chord, StepNoise(
        torch.from_numpy(t.copy()), torch.from_numpy(noise.copy()), torch.tensor(False)),
        remat=True, gn_conv=gn_conv)
    want = unet_state_from_jax(jax.tree_util.tree_map(np.asarray, want_g))
    assert set(grads) == set(want)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert _rel_norm(grads, want) <= GRAD_RTOL


@pytest.mark.parametrize("gn_conv", ["unfused", "fused"])
def test_remat_equals_no_remat(gn_conv):
    params = _jax_params(seed=1)
    x0, chord = _batch(seed=1)
    rng = np.random.default_rng(2)
    noise = StepNoise(torch.tensor([17, 940]),
                      torch.from_numpy(rng.standard_normal((B, 2, HW, HW)).astype(np.float32)),
                      torch.tensor(False))
    loss_a, grads_a = _port_grads(params, x0, chord, noise, remat=False, gn_conv=gn_conv)
    loss_b, grads_b = _port_grads(params, x0, chord, noise, remat=True, gn_conv=gn_conv)
    np.testing.assert_allclose(loss_b, loss_a, rtol=SELF_RTOL)
    assert _rel_norm(grads_b, grads_a) <= SELF_RTOL


def test_remat_recomputes_attention_with_lse(monkeypatch):
    """In bf16 the attention forward runs twice per site under remat (the
    forward, then the recompute in the backward), each time writing the row
    log-sum-exp the backward reads; the backward runs once per site. The
    forward keeps fewer tensors for the backward than without remat."""
    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = fused_attention._forward, fused_attention.packed_attention_bwd

    def count_fwd(q, k, v, scale, n_heads, with_lse=False, **kw):
        calls["fwd"].append(with_lse)
        return fwd(q, k, v, scale, n_heads, with_lse, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        assert kw["lse"] is not None
        return bwd(*a, **kw)

    monkeypatch.setattr(fused_attention, "_forward", count_fwd)
    monkeypatch.setattr(fused_attention, "packed_attention_bwd", count_bwd)
    x0, chord = _batch(seed=3)
    batch = (torch.from_numpy(x0), None, torch.from_numpy(chord), None)
    gen = torch.Generator().manual_seed(0)
    noise = StepNoise(torch.tensor([5, 500]), torch.randn(B, 2, HW, HW, generator=gen),
                      torch.tensor(False))
    saved = {}
    for remat in (False, True):
        task = SDFTask(Params({**CFG, "remat": remat, "bf16": True}), device="cpu",
                       training=True, generator=torch.Generator().manual_seed(3))
        cast_sampling_params(task.unet)
        calls["fwd"].clear()
        calls["bwd"] = 0
        n = [0]

        def pack(x):
            n[0] += 1
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss, _ = task.loss_fn(batch, noise)
        saved[remat] = n[0]
        loss.backward()
        sites = sum(len(m.transformer_blocks) for m in task.unet.modules()
                    if isinstance(m, SpatialTransformer))
        assert calls["fwd"] == [True] * (2 * sites if remat else sites)
        assert calls["bwd"] == sites
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in task.unet.parameters())
    assert saved[True] < saved[False] / 4, saved
