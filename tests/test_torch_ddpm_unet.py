"""The plain DDPM family, the port against the JAX package on the CPU in fp32:
the UNet's eps, time embedding and gradients under the same JAX-initialised
weights, its reference state-dict names and converter, ``DDPMTask``'s loss
and one train step on JAX's draws, DDPM and DDIM sampling with replayed
noise, and the training and inference CLIs end to end."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.convert.torch_import import ddpm_unet_params_from_torch
from polyffusion_tpu.diffusion import make_ddim_schedule as jax_make_ddim
from polyffusion_tpu.diffusion import sampler as JS
from polyffusion_tpu.models.ddpm_unet import DDPMUNet as JaxDDPMUNet
from polyffusion_tpu.models.ddpm_unet import ddpm_time_embedding as jax_time_embedding
from polyffusion_tpu.tasks.ddpm import DDPMTask as JaxDDPMTask
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import DDPM_PREFIXES, ddpm_unet_state_from_jax
from polyffusion_tpu_torch.data import write_song_npz
from polyffusion_tpu_torch.diffusion import make_ddim_schedule
from polyffusion_tpu_torch.diffusion import sampler as S
from polyffusion_tpu_torch.inference import load_unet_params
from polyffusion_tpu_torch.models.ddpm_unet import DDPMUNet, ddpm_time_embedding
from polyffusion_tpu_torch.tasks import DDPMTask
from polyffusion_tpu_torch.tasks.ddpm import DDPMNoise
from polyffusion_tpu_torch.train import create_state, make_train_step
from polyffusion_tpu_torch.utils.midi import load_midi

# The widths of JAX's tests/test_ddpm_unet_parity.py:37-44, but 64 channels:
# with 32, each of level 0's 32 groups holds one channel, so the GroupNorm
# after conv1 cancels conv1's bias and the time term, whose gradients are
# then rounding noise (tests/test_torch_train.py's reason). The final norm
# keeps its 8 groups.
TINY = dict(image_channels=2, n_channels=64, ch_mults=(1, 2), is_attn=(False, True), n_blocks=1)
B, HW = 2, 16
ATOL, RTOL = 2e-4, 1e-4  # tests/test_unet_parity.py:68
GRAD_RTOL, LOSS_RTOL = 1e-4, 1e-5
# the task: JAX's DDPMTask has two blocks a level whatever the config says
CFG = dict(model_name="ddpm", batch_size=B, max_epoch=1, learning_rate=1e-3, max_grad_norm=1.0,
           bf16=False, image_channels=2, image_size_h=HW, image_size_w=HW, n_channels=64,
           channel_multipliers=[1, 2], is_attention=[False, True], n_steps=20)
T = CFG["n_steps"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def _nchw(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _assert_grads_close(got, want):
    """Per tensor: |g - w| <= GRAD_RTOL |w| in norm."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        err = np.linalg.norm(got[k] - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + 1e-9, (k, err, np.linalg.norm(w))


@pytest.fixture(scope="module")
def unet_pair():
    jm = JaxDDPMUNet(**TINY)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 2, HW, HW)).astype(np.float32)
    t = np.array([7, 890], np.int32)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_nhwc(x)),
                                       jnp.asarray(t))["params"])
    tm = DDPMUNet(**TINY)
    tm.load_state_dict(ddpm_unet_state_from_jax(params), strict=True)
    return jm, params, tm, x, t


def test_time_embedding_matches_jax():
    """To the UNet's tolerance: the two packages' exp of the frequencies may
    differ by an ulp, which t = 999 turns into an ulp of a sine's argument
    near 1000 (6.1e-5)."""
    t = np.array([0, 1, 7, 500, 999], np.int32)
    for n in (64, 256):
        got = ddpm_time_embedding(torch.from_numpy(t), n).numpy()
        want = np.asarray(jax_time_embedding(jnp.asarray(t), n))
        assert got.shape == (5, n // 4)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_eps_matches_jax(unet_pair):
    jm, params, tm, x, t = unet_pair
    want = _nchw(jm.apply({"params": params}, jnp.asarray(_nhwc(x)), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_eps_mse_gradients_match_jax(unet_pair):
    jm, params, tm, x, t = unet_pair
    target = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def loss_of(p):
        eps = jm.apply({"params": p}, jnp.asarray(_nhwc(x)), jnp.asarray(t))
        return jnp.mean((jnp.asarray(_nhwc(target)) - eps) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    tm.zero_grad()
    got = torch.mean((torch.from_numpy(target) - tm(torch.from_numpy(x), torch.from_numpy(t))) ** 2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
    want = ddpm_unet_state_from_jax(_np_tree(grads))
    norms = {k: v for k, v in want.items() if ".attn.norm." not in k}
    _assert_grads_close({k: p.grad.numpy() for k, p in tm.named_parameters() if k in norms},
                        norms)
    # the attention's norm is never applied: no gradient reaches it
    assert all(p.grad is None for k, p in tm.named_parameters() if ".attn.norm." in k)


def test_state_dict_has_the_reference_names(unet_pair):
    """The reference ``ddpm.unet.UNet`` names, the unused ``attn.norm``
    included; JAX's importer maps the port's state dict back onto its tree."""
    _, params, tm, _, _ = unet_pair
    sd = tm.state_dict()
    for key in ("image_proj.weight", "time_emb.lin1.weight", "time_emb.lin2.bias",
                "down.0.res.norm1.weight", "down.0.res.conv1.weight", "down.0.res.time_emb.weight",
                "down.1.conv.weight", "down.2.res.shortcut.weight", "down.2.attn.norm.weight",
                "down.2.attn.projection.weight", "down.2.attn.output.bias",
                "middle.res1.conv2.weight", "middle.attn.norm.bias", "middle.res2.norm2.bias",
                "up.0.res.conv1.weight", "up.0.attn.projection.weight", "up.2.conv.weight",
                "norm.weight", "final.weight"):
        assert key in sd, key
    assert sd["up.2.conv.weight"].shape == (64, 64, 4, 4)  # ConvTranspose2d (in, out, kH, kW)
    assert tm.norm.groups == 8 and sd["norm.weight"].shape == (64,)
    back = ddpm_unet_params_from_torch({k: v.numpy() for k, v in sd.items()})
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))


def test_reference_checkpoint_loads_strictly(unet_pair, tmp_path):
    """A reference learner ``.pt`` under each DDPM prefix, another module
    beside it, loads strictly (the unused norms included)."""
    _, _, tm, _, _ = unet_pair
    sd = tm.state_dict()
    for prefix in DDPM_PREFIXES:
        path = str(tmp_path / "ddpm.pt")
        torch.save({"model": {**{prefix + k: v for k, v in sd.items()},
                              "model.other.weight": torch.zeros(1)}}, path)
        got = load_unet_params(path, prefixes=DDPM_PREFIXES)
        fresh = DDPMUNet(**TINY)
        fresh.load_state_dict(got, strict=True)
        for k, v in sd.items():
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


# -- the task -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def task_pair():
    jtask = JaxDDPMTask(JaxParams(CFG))
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    task = DDPMTask(Params(CFG), device="cpu", training=True)
    task.load_unet_state(ddpm_unet_state_from_jax(params))
    return jtask, params, task


def _jax_draws(key, shape):
    """What JAX's ``DDPMTask.loss_fn`` draws from ``key`` (:56-58): t, then
    the NHWC noise, handed to the port as NCHW."""
    t_key, eps_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (shape[0],), 0, T))
    noise = np.asarray(jax.random.normal(eps_key, (shape[0], shape[2], shape[3], shape[1])))
    return DDPMNoise(torch.from_numpy(t.copy()), torch.from_numpy(_nchw(noise)))


def _jax_loss_grad(jtask):
    """JAX's ``DDPMTask.loss_fn`` and its gradient, jitted."""
    return jax.jit(lambda p, x0, key: jax.value_and_grad(jtask.loss_fn, has_aux=True)(
        p, (x0, None, None, None), key, {}))


def _roll(rng):
    return (rng.random((B, 2, HW, HW)) > 0.85).astype(np.float32)


def test_task_loss_and_gradients_match_jax(task_pair):
    jtask, params, task = task_pair
    x0 = _roll(np.random.default_rng(2))
    key = jax.random.PRNGKey(5)
    (loss, metrics), grads = _jax_loss_grad(jtask)(params, jnp.asarray(x0), key)
    task.unet.zero_grad()
    got, got_m = task.loss_fn((torch.from_numpy(x0), None, None, None), _jax_draws(key, x0.shape))
    got.backward()
    assert set(got_m) == set(metrics) == {"loss"}
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
    want = {k: v for k, v in ddpm_unet_state_from_jax(_np_tree(grads)).items()
            if ".attn.norm." not in k}
    _assert_grads_close({k: p.grad.numpy() for k, p in task.unet.named_parameters() if k in want},
                        want)


def test_one_train_step_matches_jax(task_pair):
    """One step of the port's ``make_train_step`` against JAX's loss under
    ``value_and_grad`` and ``make_optimizer`` (clip, then Adam); the unused
    attention norms stay as they were."""
    jtask, params, _ = task_pair
    opt = jax_make_optimizer(CFG["learning_rate"], CFG["max_grad_norm"])
    x0 = _roll(np.random.default_rng(3))
    key = jax.random.PRNGKey(9)

    @jax.jit
    def step(p, x0, key):
        (loss, _), grads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
            p, (x0, None, None, None), key, {})
        updates, _ = opt.update(grads, opt.init(p), p)
        gnorm = jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads)))
        return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), loss, gnorm

    new, loss, gnorm = step(params, jnp.asarray(x0), key)
    new, gnorm = _np_tree(new), float(gnorm)

    task = DDPMTask(Params(CFG), device="cpu", training=True)
    task.load_unet_state(ddpm_unet_state_from_jax(params))
    state = create_state(task.model, CFG["learning_rate"], CFG["max_grad_norm"])
    metrics = make_train_step(task)(state, (torch.from_numpy(x0), None, None, None), seed=0,
                                    noise=_jax_draws(key, x0.shape))
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm, rtol=GRAD_RTOL)
    assert gnorm > CFG["max_grad_norm"]  # the clip is active
    want = ddpm_unet_state_from_jax(new)
    err = np.concatenate([np.abs(v.detach().numpy() - want[k].numpy()).ravel()
                          for k, v in state.params().items()])
    # Adam's first step moves an element by lr g / (|g| + 1e-8): where a
    # gradient lies within a few 1e-8 of zero, its rounding decides the
    # update anywhere in (-lr, lr) (chip_smoke.py's train-step limits); the
    # gradients themselves are held above
    assert err.max() <= 2 * CFG["learning_rate"], err.max()
    assert (err > 2e-6).mean() < 1e-3
    for k, v in state.params().items():
        if ".attn.norm." in k:
            assert torch.equal(v, torch.ones_like(v) if k.endswith("weight") else
                               torch.zeros_like(v)), k


# -- sampling ---------------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["ddpm", "ddim_eta0", "ddim_eta0.5"])
def test_sampling_matches_jax_with_replayed_noise(task_pair, sampler):
    jtask, params, task = task_pair
    task.unet.eval()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, HW, HW, 2)).astype(np.float32)
    cond = np.zeros((B, 1, 1), np.float32)
    if sampler == "ddpm":
        noise = rng.standard_normal((T, B, HW, HW, 2)).astype(np.float32)
        want = JS.ddpm_sample(jtask.apply_eps, params, jtask.schedule, jnp.asarray(x),
                              jnp.asarray(cond), jax.random.PRNGKey(0),
                              noise_override=jnp.asarray(noise))
        got = S.ddpm_sample(task.apply_eps, task.schedule, torch.from_numpy(x),
                            torch.from_numpy(cond), noise_override=torch.from_numpy(noise))
    else:
        eta = float(sampler[len("ddim_eta"):])
        jdd = jax_make_ddim(jtask.schedule, 5, "uniform", eta)
        dd = make_ddim_schedule(task.schedule, 5, "uniform", eta)
        noise = rng.standard_normal((5, B, HW, HW, 2)).astype(np.float32)
        want = JS.ddim_sample(jtask.apply_eps, params, jdd, jnp.asarray(x), jnp.asarray(cond),
                              jax.random.PRNGKey(0), noise_override=jnp.asarray(noise))
        got = S.ddim_sample(task.apply_eps, dd, torch.from_numpy(x), torch.from_numpy(cond),
                            noise_override=torch.from_numpy(noise))
    task.unet.train()
    assert got.shape == x.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# -- the CLIs ---------------------------------------------------------------------------------


def _write_song(path, seed, n_bars=8):
    """A synthetic three-track song (the idea of tests/synth.py)."""
    rng = np.random.default_rng(seed)
    n_beats = n_bars * 4
    n_bins = n_beats * 4
    tracks = []
    for t in range(3):
        n = rng.integers(20, 40)
        onsets = np.sort(rng.integers(0, n_bins - 8, n))
        tracks.append(np.stack([onsets, rng.integers(36 + 12 * t, 72 + 12 * t, n),
                                rng.integers(1, 8, n), rng.integers(60, 100, n),
                                np.zeros(n, np.int64)], 1))
    chord = np.zeros((n_beats, 14), np.int32)
    chord[:, 0] = rng.integers(0, 12, n_beats)
    chord[:, 1:13] = rng.integers(0, 2, (n_beats, 12))
    chord[:, 13] = chord[:, 0]
    db_pos = np.arange(0, n_bins, 16)
    write_song_npz(path, tracks, chord, db_pos, db_pos + 128 <= n_bins, n_beats=n_beats)


# the data's rolls are 128 x 128: a narrow UNet whose only attention, the
# middle block's, sees 32 x 32 positions keeps a CPU step short
TINY_SET = ["n_channels=32", "channel_multipliers=[1,1,1]", "is_attention=[false,false,false]",
            "n_steps=10"]


def test_train_resume_then_sample_through_the_clis(tmp_path, capsys):
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main

    data = tmp_path / "songs"
    os.makedirs(data)
    for i in range(2):
        _write_song(str(data / f"song{i}.npz"), seed=i)
    run = str(tmp_path / "run")
    args = ["--model", "ddpm", "--output_dir", run, "--data_dir", str(data), "--device", "cpu",
            "--batch_size", "1", "--log_every", "1"]
    for kv in TINY_SET:
        args += ["--set", kv]
    assert train_main(args + ["--max_steps", "1"]).step == 1
    assert train_main(args + ["--max_steps", "2", "--resume"]).step == 2
    assert "[resume] restored checkpoint at step 1" in capsys.readouterr().out
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2]
    assert [r["step"] for r in records if "val/loss" in r] == [1, 2]
    assert all(np.isfinite(r.get("train/loss", r.get("val/loss"))) for r in records)

    out = str(tmp_path / "gen")
    (gen,) = infer_main(["--chkpt_path", run, "--device", "cpu", "--length", "1",
                         "--output_dir", out])
    assert gen.shape == (1, 2, 128, 128) and np.isfinite(gen).all()
    (gen,) = infer_main(["--chkpt_path", run, "--device", "cpu", "--length", "2", "--ddim",
                         "--ddim_steps", "5", "--output_dir", out])
    assert gen.shape == (2, 2, 128, 128) and np.isfinite(gen).all()
    mids = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    assert len(mids) >= 1 and all(f.startswith("ddpm_") for f in mids)
    for f in mids:
        load_midi(os.path.join(out, f))
    with pytest.raises(SystemExit, match="--uncond_scale"):
        infer_main(["--chkpt_path", run, "--device", "cpu", "--uncond_scale", "5",
                    "--output_dir", out])
