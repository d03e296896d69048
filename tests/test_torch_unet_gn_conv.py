"""The port's UNet with ``gn_conv="fused"`` against the JAX package's UNet under
``POLYFF_FUSED_GN_CONV=1`` (its Pallas kernel in interpret mode), fp32 on the
CPU with the same weights, and DDIM + CFG ``predict`` through both sessions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.models.unet import UNetModel as JaxUNet
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.inference import InferenceSession
from polyffusion_tpu_torch.models.unet import UNetModel
from polyffusion_tpu_torch.tasks import SDFTask

# the tiny UNet of tests/test_fused_gn_conv.py:87-89
TINY = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1, attention_levels=(1,),
            channel_multipliers=(1, 2), n_heads=2, tf_layers=1, d_cond=12)
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4  # tests/test_unet_parity.py:68
SESSION_ATOL, SESSION_RTOL = 2e-3, 1e-3  # the DDIM tolerance of tests/test_torch_slice.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_unet_pair(monkeypatch, gn_conv, env, seed=0, hw=16):
    """(JAX eps of the tiny UNet under the environment switches ``env``, the
    port's UNet in ``gn_conv`` mode with the same weights, the inputs). The
    weights are made with the switches off (their structure is the same); the
    JAX apply is jitted through a fresh function, so no trace cached under
    another setting is reused."""
    for name in ("POLYFF_FUSED_GN_CONV", "POLYFF_INT8_CONV", "POLYFF_INT8_XLA"):
        monkeypatch.delenv(name, raising=False)
    jm = JaxUNet(**TINY)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, hw, hw)).astype(np.float32)
    t = np.array([3, 977], np.int32)
    cond = rng.standard_normal((2, 3, TINY["d_cond"])).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 2)),
                              jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, TINY["d_cond"])))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(cond))
    tm = UNetModel(**TINY, gn_conv=gn_conv)
    tm.load_state_dict(unet_state_from_jax(params), strict=True)
    tm.prepare_gn_conv()
    inputs = (torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)), torch.from_numpy(cond))
    return np.asarray(want).transpose(0, 3, 1, 2), tm.eval(), inputs


def test_fused_unet_matches_jax(monkeypatch):
    want, tm, inputs = jax_unet_pair(monkeypatch, "fused", {"POLYFF_FUSED_GN_CONV": "1"})
    with torch.no_grad():
        got = tm(*inputs)
    np.testing.assert_allclose(got.numpy(), want, atol=UNET_ATOL, rtol=UNET_RTOL)


def test_modes_share_parameters_and_agree_in_fp32():
    """Every mode has the same state_dict names and shapes; with the same
    weights in fp32 the fused route computes the unfused one up to rounding
    (the affine is applied in fp32 either way)."""
    g = torch.Generator().manual_seed(0)
    x, t, cond = torch.randn(2, 2, 16, 16, generator=g), torch.tensor([5, 700]), torch.randn(2, 3, 12)
    base = UNetModel(**TINY).eval()
    want = base(x, t, cond).detach()
    for mode in ("fused", "int8"):
        m = UNetModel(**TINY, gn_conv=mode).eval()
        assert {k: v.shape for k, v in m.state_dict().items()} == {
            k: v.shape for k, v in base.state_dict().items()}
        m.load_state_dict(base.state_dict(), strict=True)
        m.prepare_gn_conv()
        got = m(x, t, cond).detach()
        if mode == "fused":
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=UNET_ATOL, rtol=UNET_RTOL)
        else:
            assert (got - want).abs().mean() < 0.05 * want.abs().mean()


def test_fused_decoder_never_builds_the_concat(monkeypatch):
    """In the fused modes the decoder's ResBlocks get (h, skip) apart, and the
    two-input form runs at each of their in_layers sites."""
    from polyffusion_tpu_torch.ops import fused_gn_conv

    calls = {"one": 0, "two": 0}
    one, two = fused_gn_conv.gn_silu_conv3x3, fused_gn_conv.gn_silu_conv3x3_concat
    import polyffusion_tpu_torch.models.unet as U

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(U, "gn_silu_conv3x3", count("one", one))
    monkeypatch.setattr(U, "gn_silu_conv3x3_concat", count("two", two))
    m = UNetModel(**TINY, gn_conv="fused").eval()
    with torch.no_grad():
        m(torch.zeros(1, 2, 16, 16), torch.tensor([1]), torch.zeros(1, 3, 12))
    # 2 + 2 encoder and middle ResBlocks; 4 decoder ResBlocks (2 levels x 2)
    n_dec = len(m.output_blocks)
    assert calls == {"one": 2 * (2 + 2) + n_dec, "two": n_dec}


# the session: as tests/test_torch_inference.py's tiny config, at 16 x 16
CFG = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-4, max_grad_norm=10,
    bf16=False, in_channels=2, out_channels=2, channels=32, attention_levels=[1],
    n_res_blocks=1, channel_multipliers=[1, 2], n_heads=2, tf_layers=1, d_cond=32 * 36,
    linear_start=0.00085, linear_end=0.012, n_steps=40, img_h=16, img_w=16,
    cond_type="chord", cond_mode="mix", use_enc=False,
)


def test_fused_session_predict_matches_jax(monkeypatch):
    """DDIM-4 at CFG 5 through ``InferenceSession`` with ``gn_conv="fused"``
    against JAX's session under ``POLYFF_FUSED_GN_CONV=1``, from the same
    noise."""
    monkeypatch.delenv("POLYFF_INT8_CONV", raising=False)
    monkeypatch.setenv("POLYFF_FUSED_GN_CONV", "1")
    rng = np.random.default_rng(3)
    chords = np.zeros((2, 32, 36), np.float32)
    chords[:, np.arange(32), rng.integers(0, 12, 32)] = 1.0
    chords[:, :, 12:24] = rng.integers(0, 2, (2, 32, 12))
    jtask = JaxSDFTask(JaxParams(CFG))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init_params)(jax.random.PRNGKey(4)))
    noise = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    jcond = np.asarray(jtask.encode_chord(jnp.asarray(chords)))
    want = JaxSession(jtask, params, use_ddim=True, ddim_steps=4, seed=0).predict(
        jcond, uncond_scale=5.0, noise=noise)

    task = SDFTask(Params(CFG), device="cpu", gn_conv="fused")
    task.load_unet_state(unet_state_from_jax(params))
    cond = task.encode_chord(torch.from_numpy(chords)).numpy()
    np.testing.assert_array_equal(cond, jcond)
    got = InferenceSession(task, sampler="ddim", ddim_steps=4, device="cpu").predict(
        cond, uncond_scale=5.0, noise=noise)
    assert got.shape == (2, 2, 16, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SESSION_ATOL, rtol=SESSION_RTOL)
