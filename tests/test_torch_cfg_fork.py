"""CFG forked inside the UNet (``cfg_fork``), the port against the JAX package
on the CPU in fp32: the UNet's fork (before the first cross-attention, or
before the middle block where no input level attends) against JAX's
``cfg_fork=True`` and against the port's own double batch on every
``gn_conv`` route; ``make_eps_fn``'s fork against JAX's under
``POLYFF_CFG_FORK=1``, with and without ``cond_concat``; a distilled
student's eps, which does not fork; every sampler of ``InferenceSession``
(DDPM RePaint, DDIM, DPM-Solver++, autoregressive) against JAX's session
under the switch; a 2-rank dp session with ``cfg_fork`` against one process;
the inference CLI's ``--cfg_fork``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.diffusion import sampler as JS
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.models.unet import UNetModel as JaxUNet
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.diffusion import sampler as S
from polyffusion_tpu_torch.inference import InferenceSession, build_task_for_inference, main
from polyffusion_tpu_torch.models import ChordEncoder, init_weights_
from polyffusion_tpu_torch.models.unet import GN_CONV_MODES, UNetModel
from polyffusion_tpu_torch.tasks import SDFTask

import test_torch_concat as CONCAT
import test_torch_inference as INF
import torch_parallel_worker as W
from test_torch_parallel import PAINT, Ranks, _paint_draws

FORK_ATOL = 1e-5  # JAX's fork against its double batch (tests/test_unet_parity.py:117)
ATOL, RTOL = 2e-3, 1e-3  # the session tolerance of tests/test_torch_inference.py
# tests/test_unet_parity.py's widths; no input level attends in the second
TINY = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1, attention_levels=(1,),
            channel_multipliers=(1, 2), n_heads=2, tf_layers=1, d_cond=12)
LEVELS = [(1,), ()]
SCALE = 5.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _unet_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    t = np.array([5, 40], np.int32)
    cond = rng.standard_normal((2, 3, 12)).astype(np.float32)
    return x, t, np.concatenate([-np.ones_like(cond), cond])


@pytest.fixture(scope="module", params=LEVELS, ids=["fork_at_attention", "fork_at_middle"])
def unet_pair(request):
    cfg = dict(TINY, attention_levels=request.param)
    jm = JaxUNet(**cfg)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 2)),
                                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, 12)))["params"])
    return cfg, jm, params


def _port_unet(cfg, params, gn_conv="unfused"):
    tm = UNetModel(**cfg, gn_conv=gn_conv)
    tm.load_state_dict(unet_state_from_jax(params), strict=True)
    tm.prepare_gn_conv()
    return tm.eval()


def test_unet_fork_matches_jax(unet_pair):
    cfg, jm, params = unet_pair
    x, t, c_in = _unet_inputs()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(_nhwc(x)), jnp.asarray(t),
                               jnp.asarray(c_in), cfg_fork=True)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = _port_unet(cfg, params)(torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(c_in), cfg_fork=True).numpy()
    assert got.shape == want.shape == (4, 2, 16, 16)
    np.testing.assert_allclose(got, want, atol=FORK_ATOL, rtol=0)


@pytest.mark.parametrize("gn_conv", GN_CONV_MODES)
def test_unet_fork_equals_double_batch(unet_pair, gn_conv):
    """Every GroupNorm-SiLU-conv route (the fused kernels' plain versions on
    the CPU see batch B before the fork and 2B after it)."""
    cfg, _, params = unet_pair
    x, t, c_in = _unet_inputs(4)
    tm = _port_unet(cfg, params, gn_conv)
    x, t, c_in = map(torch.from_numpy, (x, t, c_in))
    with torch.no_grad():
        double = tm(torch.cat([x, x]), torch.cat([t, t]), c_in)
        forked = tm(x, t, c_in, cfg_fork=True)
    np.testing.assert_allclose(forked.numpy(), double.numpy(), atol=FORK_ATOL, rtol=0)


# -- the eps function ------------------------------------------------------------------------


def _task_pair(cfg, seed=0):
    jtask = JaxSDFTask(JaxParams(cfg))
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(seed)))
    task = SDFTask(Params(cfg), device="cpu")
    task.load_unet_state(unet_state_from_jax(params))
    return jtask, params, task


@pytest.fixture(scope="module")
def chord_pair():
    return _task_pair(INF.CFG)


@pytest.fixture(scope="module")
def concat_pair():
    return _task_pair(CONCAT.CFG)


class _Calls:
    """Wraps an apply function and records the ``cfg_fork`` and the batch of
    x (argument ``x_at``: 1 after JAX's params, 0 in the port) of each call,
    and its output; advertises what the wrapped one does."""

    def __init__(self, fn, x_at):
        self.fn, self.x_at, self.calls, self.outs = fn, x_at, [], []
        self.supports_cfg_fork = getattr(fn, "supports_cfg_fork", False)

    def __call__(self, *args, **kwargs):
        self.calls.append((kwargs.get("cfg_fork", False), args[self.x_at].shape[0]))
        out = self.fn(*args, **kwargs)
        self.outs.append(np.asarray(out))
        return out


@pytest.mark.parametrize("concat", [False, True], ids=["plain", "cond_concat"])
def test_eps_fork_matches_jax(concat, chord_pair, concat_pair, monkeypatch):
    """The port's ``make_eps_fn(cfg_fork=True)`` against JAX's under
    ``POLYFF_CFG_FORK=1``: both run the net once, at batch B with the
    condition at 2B (``cond_concat`` joined to x at B); and against the
    port's double batch."""
    jtask, params, task = concat_pair if concat else chord_pair
    cfg = CONCAT.CFG if concat else INF.CFG
    rng = np.random.default_rng(5)
    b, h, w = 2, cfg["img_h"], cfg["img_w"]
    x = rng.standard_normal((b, 2, h, w)).astype(np.float32)
    t = np.array([9, 3], np.int32)
    cond = rng.standard_normal((b, 1, cfg["d_cond"])).astype(np.float32)
    cc = rng.random((b, 2, h, w)).astype(np.float32) if concat else None

    monkeypatch.setenv("POLYFF_CFG_FORK", "1")
    japply = _Calls(jtask.apply_eps, 1)
    jeps = JS.make_eps_fn(japply, SCALE, jnp.asarray(-np.ones_like(cond)))
    want = np.asarray(jeps(params, jnp.asarray(_nhwc(x)), jnp.asarray(t), jnp.asarray(cond),
                           None if cc is None else jnp.asarray(_nhwc(cc))))
    assert japply.calls == [(True, b)]

    apply = _Calls(task.apply_eps, 0)
    eps = S.make_eps_fn(apply, SCALE, -torch.ones(b, 1, cfg["d_cond"]), cfg_fork=True)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
            None if cc is None else torch.from_numpy(cc))
    with torch.no_grad():
        got = eps(*args).numpy()
        double = S.make_eps_fn(task.apply_eps, SCALE, -torch.ones(b, 1, cfg["d_cond"]))(*args)
    assert apply.calls == [(True, b)]
    # the forked net's 2B outputs, then their combination e_u + s (e_c - e_u),
    # whose error is at most (|1 - s| + |s|) times theirs
    np.testing.assert_allclose(apply.outs[0], japply.outs[0].transpose(0, 3, 1, 2),
                               atol=FORK_ATOL, rtol=0)
    eps_atol = (abs(1 - SCALE) + abs(SCALE)) * FORK_ATOL
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=eps_atol, rtol=0)
    np.testing.assert_allclose(got, double.numpy(), atol=eps_atol, rtol=0)
    # s = 1 and s = 0 stay single passes
    for s in (0.0, 1.0):
        single = _Calls(task.apply_eps, 0)
        with torch.no_grad():
            S.make_eps_fn(single, s, -torch.ones(b, 1, cfg["d_cond"]), cfg_fork=True)(*args)
        assert single.calls == [(False, b)]


def test_student_eps_does_not_fork(chord_pair, monkeypatch):
    """A distilled student's v->eps adapter does not advertise the fork (JAX's
    ``make_v_to_eps_apply``): its eps runs the double batch, as JAX's does
    under the switch."""
    _, params, _ = chord_pair
    cfg = dict(INF.CFG, v_prediction=True)
    jtask = JaxSDFTask(JaxParams(cfg))
    task = SDFTask(Params(cfg), device="cpu")
    task.load_unet_state(unet_state_from_jax(params))
    assert not getattr(task.apply_eps, "supports_cfg_fork", False)
    calls = []
    forward = task.unet.forward

    def spy(x, t, cond, cfg_fork=False):
        calls.append((cfg_fork, x.shape[0]))
        return forward(x, t, cond, cfg_fork=cfg_fork)

    monkeypatch.setattr(task.unet, "forward", spy)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    t = np.array([7, 2], np.int32)
    cond = rng.standard_normal((2, 1, cfg["d_cond"])).astype(np.float32)
    uncond = -np.ones_like(cond)
    with torch.no_grad():
        got = S.make_eps_fn(task.apply_eps, SCALE, torch.from_numpy(uncond), cfg_fork=True)(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)).numpy()
    assert calls == [(False, 4)]
    monkeypatch.setenv("POLYFF_CFG_FORK", "1")
    want = np.asarray(JS.make_eps_fn(jtask.apply_eps, SCALE, jnp.asarray(uncond))(
        params, jnp.asarray(_nhwc(x)), jnp.asarray(t), jnp.asarray(cond)))
    eps_atol = (abs(1 - SCALE) + abs(SCALE)) * FORK_ATOL  # as test_eps_fork_matches_jax
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=eps_atol, rtol=0)


# -- the samplers -------------------------------------------------------------------------------

SESSIONS = {
    "ddpm": dict(),  # DDPM over all of the schedule's steps, RePaint with the mask
    "ddim": dict(use_ddim=True, ddim_steps=4),
    "dpmpp": dict(sampler="dpmpp", ddim_steps=4),
    "autoreg": dict(use_ddim=True, ddim_steps=4),
}


def _request(cfg, b=2, seed=7):
    rng = np.random.default_rng(seed)
    h, w = cfg["img_h"], cfg["img_w"]
    cond = rng.standard_normal((b, 1, cfg["d_cond"])).astype(np.float32)
    orig = (rng.random((b, 2, h, w)) > 0.8).astype(np.float32)
    mask = np.zeros_like(orig)
    mask[:, :, : h // 2] = 1.0
    noise = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    return cond, orig, mask, noise


def _jax_ddpm_repaint(jtask, params, cond, orig, mask, x, noise):
    """JAX's DDPM RePaint from the session's first step with replayed noises
    (the port's session draws its own, so the samplers meet here)."""
    t = INF.CFG["n_steps"]

    def paint(x, cond, orig, mask, noise):
        return JS.ddpm_paint(jtask.apply_eps, params, jtask.schedule, x, cond, t - 1,
                             jax.random.PRNGKey(0), orig=orig, mask=mask, uncond_scale=SCALE,
                             uncond_cond=-jnp.ones_like(cond), noise_override=noise)

    return np.asarray(jax.jit(paint)(*map(jnp.asarray, (x, cond, _nhwc(orig), _nhwc(mask),
                                                        noise))))


@pytest.mark.parametrize("kind", list(SESSIONS))
def test_sessions_fork_match_jax(kind, chord_pair, monkeypatch):
    """Each sampler with ``cfg_fork`` against JAX's under ``POLYFF_CFG_FORK=1``
    (the session tolerance; DDPM RePaint through the samplers with replayed
    noises) and the port's session with the fork against the one without
    (the fork's tolerance: the same nets, the same draws)."""
    jtask, params, task = chord_pair
    kw = SESSIONS[kind]
    monkeypatch.setenv("POLYFF_CFG_FORK", "1")
    sess = InferenceSession(task, device="cpu", seed=0, cfg_fork=True, **kw)
    plain = InferenceSession(task, device="cpu", seed=0, **kw)
    if kind == "autoreg":
        conds, cond_mids, noise = INF._autoreg_inputs(1, 3)
        args, kwargs = (conds[0], cond_mids[0], SCALE, True), dict(noise=noise[0])
    else:
        cond, orig, mask, noise = _request(INF.CFG)
        args, kwargs = (cond, None, SCALE, False, orig, mask, noise), {}
    got = sess.predict(*args, **kwargs)
    np.testing.assert_allclose(got, plain.predict(*args, **kwargs), atol=FORK_ATOL, rtol=0)
    if kind != "ddpm":
        want = np.asarray(JaxSession(jtask, params, seed=0, **kw).predict(*args, **kwargs))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        return
    t = INF.CFG["n_steps"]
    replay = np.random.default_rng(8).standard_normal((t, 1, 3, *noise.shape)).astype(np.float32)
    want = _jax_ddpm_repaint(jtask, params, cond, orig, mask, noise, replay)
    got = S.ddpm_paint(task.apply_eps, task.schedule, torch.from_numpy(noise),
                       torch.from_numpy(cond), t - 1, orig=torch.from_numpy(_nhwc(orig)),
                       mask=torch.from_numpy(_nhwc(mask)), uncond_scale=SCALE,
                       uncond_cond=-torch.ones(cond.shape), cfg_fork=True,
                       noise_override=torch.from_numpy(replay))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_concat_session_fork_matches_jax(concat_pair, monkeypatch):
    """``sdf_concat``: the blurry channels join x at batch B before the fork."""
    jtask, params, task = concat_pair
    monkeypatch.setenv("POLYFF_CFG_FORK", "1")
    cond, orig, mask, noise = _request(CONCAT.CFG)
    args = (cond, None, SCALE, False, orig, mask, noise)
    want = np.asarray(JaxSession(jtask, params, use_ddim=True, ddim_steps=4).predict(*args))
    got = InferenceSession(task, device="cpu", use_ddim=True, ddim_steps=4,
                           cfg_fork=True).predict(*args)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- data parallelism ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paint_inputs():
    jtask = JaxSDFTask(JaxParams(PAINT))
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    mask = np.zeros((8, 2, 32, 32), np.float32)
    mask[:, :, :16] = 1.0
    return dict(paint_cfg=PAINT, paint_state=unet_state_from_jax(params), p_mask=mask,
                **dict(zip(("p_cond", "p_orig", "p_noise"), _paint_draws())))


@pytest.fixture(scope="module")
def fork_ranks(paint_inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("fork_ranks")
    torch.save(paint_inputs, d / "inputs.pt")
    r = Ranks(str(d), 2, "fork")
    yield r
    r.wait()


@pytest.mark.parametrize("route", ["dp", "fsdp"])
def test_dp_session_fork_matches_one_process(route, fork_ranks, paint_inputs):
    """2 ranks, each forking its own rows ([uncond_local | cond_local]
    beside its rows of x): the whole batch on every rank, equal to the
    one-process session with the fork and without it (the tolerance of
    tests/test_torch_parallel.py's sessions)."""
    one = W.paint(paint_inputs, None, cfg_fork=True)
    got = fork_ranks.results[route]
    assert got.shape == one.shape == (8, 2, 32, 32)
    np.testing.assert_allclose(got, one, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, W.paint(paint_inputs, None), atol=1e-5, rtol=1e-5)


# -- the CLI ---------------------------------------------------------------------------------------

CLI_TINY = dict(channels=32, channel_multipliers=[1, 1, 1, 1], attention_levels=[],
                n_res_blocks=1, chd_hidden_dim=16, bf16=False, n_steps=10)


@pytest.fixture(scope="module")
def cli_work(tmp_path_factory):
    """A tiny ``sdf_chd8bar`` yaml (no input level attends: the fork comes
    before the middle block), a reference-layout UNet of seeded random
    weights, a random ``chd8bar.pt`` and one song."""
    root = tmp_path_factory.mktemp("cfg_fork_cli")
    pre = root / "pretrained"
    pre.mkdir()
    chd = init_weights_(ChordEncoder(36, 16, 512), torch.Generator().manual_seed(3))
    torch.save({"model": {f"chord_enc.{k}": v for k, v in chd.state_dict().items()}},
               pre / "chd8bar.pt")
    cfg = dict(load_params("sdf_chd8bar"), **CLI_TINY)
    with open(root / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    task = build_task_for_inference(Params(cfg), str(pre), device="cpu")
    init_weights_(task.unet, torch.Generator().manual_seed(4))
    torch.save({"model": {f"eps_model.{k}": v for k, v in task.unet.state_dict().items()}},
               root / "tiny.pt")
    os.makedirs(root / "songs")
    INF._write_song(str(root / "songs" / "song0.npz"), seed=0, n_bars=20)
    return root


def cli(work, out, *extra):
    """The inference CLI on ``cli_work``: DDIM-5, CFG 5, one segment."""
    return main(["--model", str(work / "tiny.yaml"), "--chkpt_path", str(work / "tiny.pt"),
                 "--pretrained_dir", str(work / "pretrained"), "--data_dir", str(work / "songs"),
                 "--song_fn", "song0.npz", "--device", "cpu", "--output_dir", str(out),
                 "--ddim", "--ddim_steps", "5", "--uncond_scale", "5", "--length", "1", *extra])


def test_cli_cfg_fork(cli_work, tmp_path, monkeypatch):
    """``--cfg_fork`` reaches the UNet (every eval forked) and samples what
    the double batch samples."""
    calls = []
    forward = UNetModel.forward

    def spy(self, x, t, cond, cfg_fork=False):
        calls.append(cfg_fork)
        return forward(self, x, t, cond, cfg_fork=cfg_fork)

    monkeypatch.setattr(UNetModel, "forward", spy)
    (forked,) = cli(cli_work, tmp_path / "fork", "--cfg_fork")
    assert calls == [True] * 5
    calls.clear()
    (plain,) = cli(cli_work, tmp_path / "plain")
    assert calls == [False] * 5
    assert forked.shape == (1, 2, 128, 128)
    np.testing.assert_allclose(forked, plain, atol=FORK_ATOL, rtol=0)
    assert any(f.endswith(".mid") for f in os.listdir(tmp_path / "fork"))


def test_cli_s2d(cli_work, tmp_path):
    """``--gn_conv s2d``, alone and with ``--cfg_fork``, answers the DDIM
    request with the unfused route's roll (fp32, the DDIM tolerance)."""
    (plain,) = cli(cli_work, tmp_path / "plain")
    for name, extra in (("s2d", ()), ("s2d_fork", ("--cfg_fork",))):
        (roll,) = cli(cli_work, tmp_path / name, "--gn_conv", "s2d", *extra)
        assert roll.shape == (1, 2, 128, 128) and np.isfinite(roll).all()
        np.testing.assert_allclose(roll, plain, atol=ATOL, rtol=RTOL)
        assert any(f.endswith(".mid") for f in os.listdir(tmp_path / name))
