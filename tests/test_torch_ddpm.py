"""The port's DDPM and DPM-Solver++ samplers against the JAX package's, fp32 on
the CPU: a tiny UNet with one attention level under the same JAX-initialised
weights, the same starting images and the same replayed per-step noises.
RePaint runs with CFG 1 and 5, repaint_n 1 and 2 and three masks, against
JAX's ``ddpm_paint`` both on its default path and with its Pallas epilogue
(``POLYFF_PALLAS_EPILOGUE=1``, interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polyffusion_tpu.ops.pallas_sampler as jax_pallas_sampler
from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.diffusion import make_ddim_schedule as jax_make_ddim
from polyffusion_tpu.diffusion import sampler as JS
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.diffusion import make_ddim_schedule
from polyffusion_tpu_torch.diffusion import sampler as S
from polyffusion_tpu_torch.inference import get_mask
from polyffusion_tpu_torch.tasks import SDFTask

# one head of 64 at level 1 (16 x 8 = 128 tokens) takes the packed-attention
# path; 32 time steps hold two 16-step bars
CFG = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-4, max_grad_norm=10,
    bf16=False, in_channels=2, out_channels=2, channels=32, attention_levels=[1],
    n_res_blocks=1, channel_multipliers=[1, 2], n_heads=1, tf_layers=1, d_cond=32,
    linear_start=0.00085, linear_end=0.012, n_steps=10, img_h=32, img_w=16,
    cond_type="chord", cond_mode="mix", use_enc=False,
)
B, H, W, C = 2, 32, 16, 2
T = CFG["n_steps"]
DDIM_STEPS = 5
# the tolerance of tests/test_torch_slice.py
ATOL, RTOL = 2e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps test workers that share the cores from oversubscribing
    them (each thread pool spins while it waits for the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jtask = JaxSDFTask(JaxParams(CFG))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    task = SDFTask(Params(CFG), device="cpu")
    task.load_unet_state(unet_state_from_jax(params))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    cond = rng.standard_normal((B, 1, CFG["d_cond"])).astype(np.float32)
    uncond = -np.ones_like(cond)
    orig = (rng.random((B, C, H, W)) > 0.8).astype(np.float32)
    return jtask, params, task, x, cond, uncond, orig


def _masks(orig):
    return {
        "zeros": np.zeros_like(orig),
        "below": get_mask(orig, "below"),
        "bars": get_mask(orig, "bars", bar_list=[1]),
    }


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


_JAX_PAINTS = {}


@pytest.fixture
def epilogue_switch(monkeypatch):
    """Sets ``POLYFF_PALLAS_EPILOGUE`` for the next trace of JAX's ddpm_paint
    (the switch is cached, as tests/test_pallas_epilogue.py clears it) and
    leaves the cache empty behind."""

    def switch(on: bool):
        jax_pallas_sampler.pallas_epilogue_enabled.cache_clear()
        if on:
            monkeypatch.setenv("POLYFF_PALLAS_EPILOGUE", "1")
        else:
            monkeypatch.delenv("POLYFF_PALLAS_EPILOGUE", raising=False)
        assert jax_pallas_sampler.pallas_epilogue_enabled() == on

    yield switch
    jax_pallas_sampler.pallas_epilogue_enabled.cache_clear()


def _jax_ddpm_paint(pair, scale, repaint_n, pallas):
    """JAX's ddpm_paint, jitted once per (scale, repaint_n, pallas)."""
    key = (scale, repaint_n, pallas)
    if key not in _JAX_PAINTS:
        jtask, params, _, _, _, uncond, _ = pair

        def paint(x, cond, orig, mask, noise):
            return JS.ddpm_paint(
                jtask.apply_eps, params, jtask.schedule, x, cond, T - 1, jax.random.PRNGKey(0),
                orig=orig, mask=mask, uncond_scale=scale, uncond_cond=jnp.asarray(uncond),
                repaint_n=repaint_n, noise_override=noise,
            )

        _JAX_PAINTS[key] = jax.jit(paint)
    return _JAX_PAINTS[key]


@pytest.mark.parametrize("pallas", [False, True], ids=["jax-default", "jax-pallas-epilogue"])
@pytest.mark.parametrize("mask_kind", ["zeros", "below", "bars"])
@pytest.mark.parametrize("scale,repaint_n", [(1.0, 1), (5.0, 1), (1.0, 2), (5.0, 2)])
def test_ddpm_paint_matches_jax(pair, epilogue_switch, scale, repaint_n, mask_kind, pallas):
    jtask, params, task, x, cond, uncond, orig = pair
    mask = _masks(orig)[mask_kind]
    rng = np.random.default_rng(repaint_n)
    noise = rng.standard_normal((T, repaint_n, 3, B, H, W, C)).astype(np.float32)
    epilogue_switch(pallas)
    fn = _jax_ddpm_paint(pair, scale, repaint_n, pallas)
    want = fn(jnp.asarray(x), jnp.asarray(cond), jnp.asarray(_nhwc(orig)),
              jnp.asarray(_nhwc(mask)), jnp.asarray(noise))
    got = S.ddpm_paint(
        task.apply_eps, task.schedule, torch.from_numpy(x), torch.from_numpy(cond), T - 1,
        orig=torch.from_numpy(_nhwc(orig)), mask=torch.from_numpy(_nhwc(mask)),
        uncond_scale=scale, uncond_cond=torch.from_numpy(uncond), repaint_n=repaint_n,
        noise_override=torch.from_numpy(noise),
    )
    assert got.shape == (B, H, W, C) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    if mask_kind != "zeros":  # the known region ends at q_sample(orig, 0)
        keep = _nhwc(mask) == 1
        want_known = task.schedule.sqrt_alpha_bar[0] * _nhwc(orig)
        np.testing.assert_allclose(got.numpy()[keep], want_known[keep], atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 5.0])
def test_ddpm_sample_matches_jax(pair, scale):
    jtask, params, task, x, cond, uncond, _ = pair
    noise = np.random.default_rng(5).standard_normal((T, B, H, W, C)).astype(np.float32)
    want = JS.ddpm_sample(
        jtask.apply_eps, params, jtask.schedule, jnp.asarray(x), jnp.asarray(cond),
        jax.random.PRNGKey(0), uncond_scale=scale, uncond_cond=jnp.asarray(uncond),
        noise_override=jnp.asarray(noise),
    )
    got = S.ddpm_sample(
        task.apply_eps, task.schedule, torch.from_numpy(x), torch.from_numpy(cond),
        uncond_scale=scale, uncond_cond=torch.from_numpy(uncond),
        noise_override=torch.from_numpy(noise),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # skipping the first steps starts lower on the same schedule, as in JAX
    want = JS.ddpm_sample(
        jtask.apply_eps, params, jtask.schedule, jnp.asarray(x), jnp.asarray(cond),
        jax.random.PRNGKey(0), uncond_scale=scale, uncond_cond=jnp.asarray(uncond), t_start=3,
        noise_override=jnp.asarray(noise[3:]),
    )
    got = S.ddpm_sample(
        task.apply_eps, task.schedule, torch.from_numpy(x), torch.from_numpy(cond),
        uncond_scale=scale, uncond_cond=torch.from_numpy(uncond), t_start=3,
        noise_override=torch.from_numpy(noise[3:]),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("order", [1, 2])
def test_dpmpp_matches_jax(pair, order, masked):
    jtask, params, task, x, cond, uncond, orig = pair
    jdd = jax_make_ddim(jtask.schedule, DDIM_STEPS, "uniform", 0.0)
    dd = make_ddim_schedule(task.schedule, DDIM_STEPS, "uniform", 0.0)
    common = dict(uncond_scale=5.0, order=order)
    if masked:
        mask = _nhwc(_masks(orig)["below"])
        orig_noise = np.random.default_rng(6).standard_normal((B, H, W, C)).astype(np.float32)
        want = JS.dpmpp_paint(
            jtask.apply_eps, params, jdd, jnp.asarray(x), jnp.asarray(cond), dd.n_steps - 1,
            orig=jnp.asarray(_nhwc(orig)), mask=jnp.asarray(mask),
            orig_noise=jnp.asarray(orig_noise), uncond_cond=jnp.asarray(uncond), **common,
        )
        got = S.dpmpp_paint(
            task.apply_eps, dd, torch.from_numpy(x), torch.from_numpy(cond), dd.n_steps - 1,
            orig=torch.from_numpy(_nhwc(orig)), mask=torch.from_numpy(mask),
            orig_noise=torch.from_numpy(orig_noise), uncond_cond=torch.from_numpy(uncond),
            **common,
        )
    else:
        want = JS.dpmpp_sample(jtask.apply_eps, params, jdd, jnp.asarray(x), jnp.asarray(cond),
                               uncond_cond=jnp.asarray(uncond), **common)
        got = S.dpmpp_sample(task.apply_eps, dd, torch.from_numpy(x), torch.from_numpy(cond),
                             uncond_cond=torch.from_numpy(uncond), **common)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_dpmpp_order_1_is_ddim(pair):
    """First-order DPM-Solver++ is the DDIM eta = 0 update (the JAX package's
    tests/test_dpmpp.py pins the same identity)."""
    _, _, task, x, cond, uncond, _ = pair
    dd = make_ddim_schedule(task.schedule, DDIM_STEPS, "uniform", 0.0)
    args = (task.apply_eps, dd, torch.from_numpy(x), torch.from_numpy(cond))
    kw = dict(uncond_scale=5.0, uncond_cond=torch.from_numpy(uncond))
    got = S.dpmpp_sample(*args, order=1, **kw)
    want = S.ddim_sample(*args, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        S.dpmpp_sample(*args, order=3, **kw)
