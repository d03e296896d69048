"""The blurry-image condition (``sdf_concat``, ``concat_blurry``): the port
against the JAX package on the CPU in fp32. ``blurry_image`` at both preset
ratios, the diffusion loss with the concatenated channels, a tiny
``sdf_concat`` task's loss and gradients, CFG's repeat of the channels over
the double batch, and sessions under DDPM (RePaint, repaint_n 2), DDIM and
DPM-Solver++ that pass each request's (or window's) original roll."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.diffusion import sampler as JS
from polyffusion_tpu.diffusion.gaussian import diffusion_loss as jax_diffusion_loss
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu.tasks.sdf import blurry_image as jax_blurry_image
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.diffusion import sampler as S
from polyffusion_tpu_torch.diffusion.gaussian import diffusion_loss
from polyffusion_tpu_torch.inference import InferenceSession, get_mask
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.tasks.sdf import StepNoise, blurry_image

BLUR_ATOL = 1e-6
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ATOL, RTOL = 2e-3, 1e-3  # the session tolerance of tests/test_torch_inference.py
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4  # the UNet tolerance of tests/test_unet_parity.py:68
D_COND = 32 * 36  # the raw chord one-hots, as sdf_concat (use_enc: false)
# the sdf_concat preset at a tiny width: one head of 64 at level 1
CFG = dict(load_params("sdf_concat"), model_name="sdf_concat_test", bf16=False, channels=32,
           attention_levels=[1], n_res_blocks=1, channel_multipliers=[1, 2], n_heads=1,
           n_steps=10, img_h=32, img_w=16)
# the loss and gradients: 64 channels put two in each of the 32 groups (with one,
# a GroupNorm cancels the bias before it and its gradient is rounding noise)
LOSS_CFG = dict(CFG, channels=64, attention_levels=[0], channel_multipliers=[1], n_steps=1000,
                img_h=16, img_w=16)
B, H, W = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps test workers that share the cores from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def _pair(cfg, seed=0):
    jtask = JaxSDFTask(JaxParams(cfg))
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(seed)))
    task = SDFTask(Params(cfg), device="cpu")
    task.load_unet_state(unet_state_from_jax(params))
    return jtask, params, task


@pytest.fixture(scope="module")
def pair():
    return _pair(CFG)


# -- blurry_image --------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["binary", "uniform"])
@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_blurry_image_matches_jax(ratio, kind, batch):
    """A 5 % binary roll and a uniform one, (B, 2, 128, 128): antialiased bicubic
    down, nearest up, clipped."""
    rng = np.random.default_rng(int(ratio * 100) + batch)
    shape = (batch, 2, 128, 128)
    x = (rng.random(shape) < 0.05) if kind == "binary" else rng.random(shape)
    x = x.astype(np.float32)
    want = np.asarray(jax_blurry_image(jnp.asarray(_nhwc(x)), ratio))
    got = blurry_image(torch.from_numpy(x), ratio).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(_nhwc(got), want, atol=BLUR_ATOL, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0 and np.ptp(got) > 0.05


# -- the loss ---------------------------------------------------------------------------------


def _jax_draws(key, b, shape_nhwc, n_steps):
    """JAX ``diffusion_loss``'s t and noise from ``key`` (gaussian.py:56-59)."""
    t_key, eps_key = jax.random.split(key)
    t = np.array(jax.random.randint(t_key, (b,), 0, n_steps))
    noise = np.array(jax.random.normal(eps_key, shape_nhwc, jnp.float32))
    return t, np.ascontiguousarray(np.transpose(noise, (0, 3, 1, 2)))


def test_diffusion_loss_with_concat_matches_jax(pair):
    jtask, params, task = pair
    rng = np.random.default_rng(1)
    x0 = (rng.random((B, 2, H, W)) > 0.9).astype(np.float32)
    cond = rng.standard_normal((B, 1, D_COND)).astype(np.float32)
    blur = blurry_image(torch.from_numpy(x0), 0.25)
    key = jax.random.PRNGKey(3)
    want = jax_diffusion_loss(jtask.apply_eps, params, jtask.schedule, jnp.asarray(_nhwc(x0)),
                              jnp.asarray(cond), key, jnp.asarray(_nhwc(blur.numpy())))
    t, noise = _jax_draws(key, B, (B, H, W, 2), CFG["n_steps"])
    got = diffusion_loss(task.apply_eps, task.schedule, torch.from_numpy(x0),
                         torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(noise),
                         blur)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    plain = diffusion_loss(task.apply_eps, task.schedule, torch.from_numpy(x0),
                           torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(noise),
                           torch.zeros_like(blur))
    assert abs(plain.item() - got.item()) > 1e3 * LOSS_RTOL * abs(got.item())


def test_concat_task_loss_and_gradients_match_jax():
    """``SDFTask.loss_fn`` of a tiny sdf_concat (cond_mode uncond: the
    condition is -1s): JAX's key split into the condition's and the loss's,
    the loss's into t and noise."""
    jtask, params, task = _pair(LOSS_CFG, seed=1)
    rng = np.random.default_rng(2)
    b, hw = 3, LOSS_CFG["img_h"]
    x0 = (rng.random((b, 2, hw, hw)) > 0.9).astype(np.float32)
    chord = np.zeros((b, 32, 36), np.float32)
    chord[:, np.arange(32), rng.integers(0, 36, 32)] = 1.0
    placeholder = np.zeros((b, 1), np.float32)
    key = jax.random.PRNGKey(7)

    def loss_of(p):
        batch = (jnp.asarray(x0), jnp.asarray(placeholder), jnp.asarray(chord),
                 jnp.asarray(placeholder))
        return jtask.loss_fn(p, batch, key, {})[0]

    want, want_g = jax.value_and_grad(loss_of)(params)
    want_g = unet_state_from_jax(_np_tree(want_g))
    _, loss_key = jax.random.split(key)
    t, noise = _jax_draws(loss_key, b, (b, hw, hw, 2), LOSS_CFG["n_steps"])
    batch = (torch.from_numpy(x0), torch.from_numpy(placeholder), torch.from_numpy(chord),
             torch.from_numpy(placeholder))
    got, _ = task.loss_fn(batch, StepNoise(torch.from_numpy(t), torch.from_numpy(noise),
                                           torch.tensor(False)))
    task.unet.zero_grad()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for name, p in task.unet.named_parameters():
        w = want_g[name]
        err = (p.grad - w).norm().item()
        assert err <= GRAD_RTOL * w.norm().item() + 1e-9, (name, err, w.norm().item())
    assert task.unet.input_blocks[0][0].weight.shape[1] == 4  # x_t and the blurry roll


def test_sdf_concat_preset_builds_with_four_input_channels():
    cfg = load_params("sdf_concat")
    task = SDFTask(cfg, device="cpu")
    assert task.concat_blurry and task.concat_ratio == 0.25
    assert (cfg.in_channels, cfg.out_channels, cfg.d_cond) == (4, 2, D_COND)
    assert task.unet.input_blocks[0][0].weight.shape[1] == 4
    assert task.used_batch_fields == {"prmat2c", "chord"}


# -- CFG's repeat over the double batch ------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 5.0])
def test_eps_fn_repeats_the_concat_over_the_double_batch(pair, scale):
    jtask, params, task = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    cc = rng.random((B, H, W, 2)).astype(np.float32)
    cond = rng.standard_normal((B, 1, D_COND)).astype(np.float32)
    t = np.array([7, 2], np.int32)
    uncond = -np.ones_like(cond)
    want = JS.make_eps_fn(jtask.apply_eps, scale, jnp.asarray(uncond))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(cc))
    calls = []

    def apply(xx, tt, c):
        calls.append(xx.shape)
        return task.apply_eps(xx, tt, c)

    with torch.no_grad():
        got = S.make_eps_fn(apply, scale, torch.from_numpy(uncond))(
            torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(cond),
            torch.from_numpy(cc).permute(0, 3, 1, 2))
    assert calls == [(B * (1 if scale == 1.0 else 2), 4, H, W)]
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), atol=UNET_ATOL,
                               rtol=UNET_RTOL)


# -- sessions -------------------------------------------------------------------------------


def _ddpm_noise(seed, repaint_n, shape, n_steps):
    """The per-step RePaint noises of a JAX session of ``seed`` given its
    starting noise: its one key for the paint, split per step
    (inference.py:471, sampler.py:202-222)."""
    _, paint_key = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.split(paint_key, n_steps)
    return np.stack([np.asarray(jax.random.normal(k, (repaint_n, 3, *shape), jnp.float32))
                     for k in keys])


SESSIONS = {"ddpm": dict(), "ddim": dict(sampler="ddim", ddim_steps=5),
            "dpmpp": dict(sampler="dpmpp", ddim_steps=5)}


@pytest.mark.parametrize("op", ["generate", "inpaint"])
@pytest.mark.parametrize("sampler", list(SESSIONS))
def test_session_matches_jax(pair, monkeypatch, sampler, op):
    """Generation (the concat is blurry_image(0) = 0) and "below" inpainting
    (the concat is the original's blurry image) at CFG 5, DDPM at repaint_n
    2, the same starting noise; DDPM's step noises replayed from the JAX
    session's key."""
    jtask, params, task = pair
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((B, 1, D_COND)).astype(np.float32)
    noise = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    orig = mask = None
    if op == "inpaint":
        orig = (rng.random((B, 2, H, W)) > 0.85).astype(np.float32)
        mask = get_mask(orig, "below")
    kw = dict(SESSIONS[sampler])
    if sampler == "ddpm":
        kw["repaint_n"] = 2
        replay = torch.from_numpy(_ddpm_noise(0, 2, (B, H, W, 2), CFG["n_steps"]))
        monkeypatch.setattr(S, "ddpm_paint", functools.partial(S.ddpm_paint,
                                                                noise_override=replay))
    jkw = {k: v for k, v in kw.items() if k != "sampler"}
    if "sampler" in kw:
        jkw.update(sampler=kw["sampler"], use_ddim=True)
    jsess = JaxSession(jtask, params, seed=0, **jkw)
    want = jsess.predict(cond, None, 5.0, False, orig, mask, noise)
    got = InferenceSession(task, device="cpu", **kw).predict(cond, None, 5.0, False, orig, mask,
                                                             noise)
    assert got.shape == (B, 2, H, W) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_autoreg_windows_pass_their_orig(pair):
    """DDIM-5 long-form generation at CFG 5: each window after the first
    forces its first half to the previous window's output, and its concat is
    the blurry image of that roll."""
    jtask, params, task = pair
    rng = np.random.default_rng(6)
    conds = rng.standard_normal((3, 1, D_COND)).astype(np.float32)
    cond_mids = rng.standard_normal((2, 1, D_COND)).astype(np.float32)
    noise = rng.standard_normal((3, H, W, 2)).astype(np.float32)
    jsess = JaxSession(jtask, params, use_ddim=True, ddim_steps=5, seed=0)
    want = jsess.predict(conds, cond_mids, 5.0, True, noise=noise)
    got = InferenceSession(task, sampler="ddim", ddim_steps=5, device="cpu").predict(
        conds, cond_mids, 5.0, True, noise=noise)
    assert got.shape == (6, 2, H // 2, W)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- the CLIs ---------------------------------------------------------------------------------


def test_train_then_inpaint_through_the_clis(tmp_path):
    """``--model sdf_concat`` through the training CLI (2 steps, tiny: four
    levels put the middle block at 16 x 16 of the 128 x 128 roll, no
    attention), then the inference CLI's DDIM "below" inpainting on its run
    directory."""
    import os

    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main
    from test_torch_distill import _write_song

    data = tmp_path / "songs"
    data.mkdir()
    for i in range(3):
        _write_song(str(data / f"song{i}.npz"), seed=i)
    run = str(tmp_path / "run")
    args = ["--model", "sdf_concat", "--output_dir", run, "--data_dir", str(data), "--device",
            "cpu", "--batch_size", "2", "--max_steps", "2", "--log_every", "1"]
    for kv in ["channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]",
               "n_res_blocks=1", "bf16=false", "n_steps=10"]:
        args += ["--set", kv]
    assert train_main(args).step == 2
    out = tmp_path / "gen"
    ((gen, mask),) = infer_main(["--chkpt_path", run, "--data_dir", str(data), "--song_fn",
                                 "song1.npz", "--output_dir", str(out), "--device", "cpu",
                                 "--ddim", "--ddim_steps", "5", "--length", "2",
                                 "--inpaint_type", "below"])
    assert gen.shape == mask.shape == (2, 2, 128, 128) and np.isfinite(gen).all()
    assert 0 < mask.mean() < 1
    (mid,) = os.listdir(out)
    assert mid.startswith("sdf_concat_inp1_below[scale=1.0,ddim5_eta0.0_uniform]_")
