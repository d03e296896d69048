"""The KL autoencoder family, the port against the JAX package on the CPU in
fp32: the autoencoder's moments, decode and forward for a given noise, the
PatchGAN discriminator (batch statistics, also under ``.eval()``), LPIPS on
seeded random VGG weights in the reference's and torchvision's layouts, the
losses and the adaptive weight, ``AutoencoderTask``'s loss, metrics and
gradients below and at ``disc_start`` with and without LPIPS, the converters
and a strict load of a reference checkpoint, and the training CLI with a
resume across the discriminator's gate."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.convert.torch_import import autoencoder_params_from_torch
from polyffusion_tpu.models import losses as JL
from polyffusion_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from polyffusion_tpu.models.lpips import LPIPS as JaxLPIPS
from polyffusion_tpu.models.lpips import lpips_params_from_torch
from polyffusion_tpu.tasks.autoencoder import AutoencoderTask as JaxAutoencoderTask
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import (
    autoencoder_state_from_jax,
    lpips_state_from_jax,
    nlayer_discriminator_state_from_jax,
    reference_state,
)
from polyffusion_tpu_torch.data import write_song_npz
from polyffusion_tpu_torch.models import losses as L
from polyffusion_tpu_torch.models.autoencoder import Autoencoder
from polyffusion_tpu_torch.models.lpips import CHNS, LPIPS, VGG_CONVS, lpips_state_from_torch
from polyffusion_tpu_torch.tasks import AutoencoderTask
from polyffusion_tpu_torch.tasks.autoencoder import AENoise
from polyffusion_tpu_torch.train import create_state, make_train_step

# The widths of JAX's tests/test_autoencoder.py, but 64 channels (two in each
# of level 0's 32 groups: with one, the GroupNorm after conv1 cancels its
# bias, whose gradient is then rounding noise); 32 x 32, the least the
# discriminator's five kernel-4 convs take
TINY = dict(channels=64, channel_multipliers=(1, 2), n_resnet_blocks=1, in_channels=3,
            out_channels=3, z_channels=4, emb_channels=4)
B, HW = 2, 32
ATOL, RTOL = 2e-4, 1e-4  # tests/test_unet_parity.py:68
GRAD_RTOL, LOSS_RTOL = 1e-4, 1e-5
CFG = dict(model_name="autoencoder", batch_size=B, max_epoch=1, learning_rate=5e-5,
           max_grad_norm=10, bf16=False, in_channels=3, out_channels=3, z_channels=4, channels=64,
           n_res_blocks=1, channel_multipliers=[1, 2], emb_channels=4, disc_start=5,
           kl_weight=1e-6, disc_weight=0.5, img_h=HW)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 2, 3, 1)))


def _nchw(a):
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def _assert_grads_close(got, want):
    """Per tensor: |g - w| <= GRAD_RTOL |w| in norm. The attention's key
    bias has a zero gradient in exact arithmetic (the softmax over the keys
    does not see a shift that is the same for every key): both sides' must be
    rounding noise, under GRAD_RTOL times the key weight's gradient."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        if k.endswith("attn_1.k.bias"):
            scale = np.linalg.norm(np.asarray(want[k[:-len("bias")] + "weight"]))
            assert max(np.linalg.norm(got[k]), np.linalg.norm(w)) <= GRAD_RTOL * scale, k
            continue
        err = np.linalg.norm(got[k] - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + 1e-9, (k, err, np.linalg.norm(w))


def _jax_eps(key, b=B, hw=HW):
    """The noise JAX's ``Autoencoder.__call__`` draws from ``key``, NCHW."""
    return _nchw(jax.random.normal(key, (b, hw // 2, hw // 2, TINY["emb_channels"])))


# -- the autoencoder ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ae_pair():
    jm = JaxAutoencoder(**TINY)
    img = np.random.default_rng(0).standard_normal((B, 3, HW, HW)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    params = _np_tree(jax.jit(jm.init)(key, jnp.asarray(_nhwc(img)), key)["params"])
    tm = Autoencoder(**TINY)
    tm.load_state_dict(autoencoder_state_from_jax(params), strict=True)
    return jm, params, tm, img


def test_moments_decode_and_forward_match_jax(ae_pair):
    jm, params, tm, img = ae_pair
    x = jnp.asarray(_nhwc(img))
    mean, log_var = jm.apply({"params": params}, x, method=jm.encode_moments)
    z = np.random.default_rng(1).standard_normal((B, HW // 2, HW // 2, 4)).astype(np.float32)
    dec = jm.apply({"params": params}, jnp.asarray(z), method=jm.decode)
    key = jax.random.PRNGKey(3)
    recon, (fmean, flog_var) = jm.apply({"params": params}, x, key)
    with torch.no_grad():
        got_m, got_v = tm.encode_moments(torch.from_numpy(img))
        got_d = tm.decode(torch.from_numpy(_nchw(z)))
        got_r, _ = tm(torch.from_numpy(img), torch.from_numpy(_jax_eps(key)))
    assert got_m.shape == (B, 4, HW // 2, HW // 2) and got_r.shape == img.shape
    for got, want in ((got_m, mean), (got_v, log_var), (got_d, dec), (got_r, recon)):
        np.testing.assert_allclose(got.numpy(), _nchw(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_m.numpy(), _nchw(fmean), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_v.numpy(), _nchw(flog_var), atol=ATOL, rtol=RTOL)


def test_downsample_pads_bottom_right():
    """The asymmetric (0, 1) pad before the stride-2 conv differs from
    padding=1 at the top and left edges: a delta at the corner reaches the
    output only through the former's window."""
    from polyffusion_tpu_torch.models.autoencoder import DownSample

    ds = DownSample(1)
    with torch.no_grad():
        ds.conv.weight.zero_()
        ds.conv.bias.zero_()
        ds.conv.weight[0, 0, 0, 0] = 1.0  # picks the window's top-left input
    x = torch.zeros(1, 1, 4, 4)
    x[0, 0, 0, 0] = 1.0
    y = ds(x)
    assert y.shape == (1, 1, 2, 2) and y[0, 0, 0, 0] == 1.0 and y.sum() == 1.0


def test_converter_inverts_the_jax_import_and_a_reference_pt_loads(ae_pair, tmp_path):
    _, params, tm, _ = ae_pair
    sd = tm.state_dict()
    for key in ("encoder.down.0.block.0.norm1.weight", "encoder.down.0.downsample.conv.weight",
                "encoder.down.1.block.0.nin_shortcut.weight", "encoder.mid.attn_1.q.weight",
                "encoder.norm_out.bias", "decoder.up.1.upsample.conv.weight",
                "decoder.up.0.block.1.conv2.bias", "decoder.mid.block_2.norm2.weight",
                "quant_conv.weight", "post_quant_conv.bias"):
        assert key in sd, key
    back = autoencoder_params_from_torch({k: v.numpy() for k, v in sd.items()})
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))
    path = str(tmp_path / "ae.pt")
    torch.save({"model": sd}, path)  # a learner checkpoint's layout
    task = AutoencoderTask(Params(CFG), device="cpu")
    task.ae.load_state_dict(reference_state(path), strict=True)
    for k, v in sd.items():
        torch.testing.assert_close(task.ae.state_dict()[k], v, rtol=0, atol=0)


# -- the discriminator and the losses ----------------------------------------------------------


@pytest.fixture(scope="module")
def disc_pair():
    jd = JL.NLayerDiscriminator()
    x = np.random.default_rng(2).standard_normal((B, 3, HW, HW)).astype(np.float32)
    params = _np_tree(jax.jit(jd.init)(jax.random.PRNGKey(1), jnp.asarray(_nhwc(x)))["params"])
    td = L.NLayerDiscriminator(3)
    td.load_state_dict(nlayer_discriminator_state_from_jax(params), strict=True)
    return jd, params, td, x


def test_discriminator_matches_jax_in_train_and_eval_mode(disc_pair):
    """Batch statistics always: ``.eval()`` changes nothing (a BatchNorm2d
    would switch to running averages)."""
    jd, params, td, x = disc_pair
    # the batch norms' scales and biases away from 1 and 0
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(lambda a: a, params)
    for name in [k for k in params if k.startswith("bn_")]:
        params[name] = {k: (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                        for k, v in params[name].items()}
    td.load_state_dict(nlayer_discriminator_state_from_jax(params), strict=True)
    want = _nchw(jd.apply({"params": params}, jnp.asarray(_nhwc(x))))
    assert sorted(td.state_dict()) == sorted(
        ["main.0.weight", "main.0.bias", "main.2.weight", "main.3.weight", "main.3.bias",
         "main.5.weight", "main.6.weight", "main.6.bias", "main.8.weight", "main.9.weight",
         "main.9.bias", "main.11.weight", "main.11.bias"])
    for mode in (True, False):
        td.train(mode)
        with torch.no_grad():
            got = td(torch.from_numpy(x)).numpy()
        assert got.shape == (B, 1, 2, 2)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_d_losses_kl_and_adaptive_weight_match_jax():
    rng = np.random.default_rng(4)
    real, fake = (rng.standard_normal((B, 1, 3, 3)).astype(np.float32) for _ in range(2))
    for ours, theirs in ((L.hinge_d_loss, JL.hinge_d_loss), (L.vanilla_d_loss, JL.vanilla_d_loss)):
        np.testing.assert_allclose(ours(torch.from_numpy(real), torch.from_numpy(fake)).item(),
                                   float(theirs(jnp.asarray(real), jnp.asarray(fake))),
                                   rtol=LOSS_RTOL)
    mean, log_var = (rng.standard_normal((B, 4, 8, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(L.kl_per_sample(torch.from_numpy(mean), torch.from_numpy(log_var)).item(),
                               float(JL.kl_per_sample(jnp.asarray(mean), jnp.asarray(log_var))),
                               rtol=LOSS_RTOL)
    for scale in (1.0, 1e-7):  # the second clips at 1e4
        a, b = rng.standard_normal((3, 64, 3, 3)), scale * rng.standard_normal((3, 64, 3, 3))
        a, b = a.astype(np.float32), b.astype(np.float32)
        got = L.adaptive_disc_weight(torch.from_numpy(a), torch.from_numpy(b), 0.5)
        want = JL.adaptive_disc_weight(jnp.asarray(a), jnp.asarray(b), 0.5)
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert got.item() == 0.5 * 1e4


# -- LPIPS ------------------------------------------------------------------------------------


def _random_lpips_torchvision(rng):
    """Seeded random VGG16 ``features.*`` and LPIPS ``lin*`` weights (JAX's
    tests/test_lpips.py pattern)."""
    sd, in_c = {}, 3
    for idx, out_c in VGG_CONVS.items():
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((out_c, in_c, 3, 3)) * (in_c * 9) ** -0.5).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.standard_normal(out_c) * 0.1).astype(np.float32))
        in_c = out_c
    for k, c in enumerate(CHNS):
        sd[f"lin{k}.model.1.weight"] = torch.from_numpy(
            np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def lpips_file(tmp_path_factory):
    """A seeded random LPIPS checkpoint in the reference's layout
    (``net.slice<s>.<idx>``, ``lin<k>.model.1``, the ScalingLayer's buffers),
    as both packages read it from ``lpips_path``."""
    tv = _random_lpips_torchvision(np.random.default_rng(5))
    port = LPIPS()
    port.load_state_dict(lpips_state_from_torch(tv), strict=True)
    sd = dict(port.state_dict())
    sd["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188])[None, :, None, None]
    sd["scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450])[None, :, None, None]
    path = str(tmp_path_factory.mktemp("lpips") / "vgg.pth")
    torch.save(sd, path)
    return tv, path


def test_lpips_matches_jax_in_both_layouts(lpips_file):
    tv, path = lpips_file
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((B, 3, 16, 16)).astype(np.float32) for _ in range(2))
    jparams = lpips_params_from_torch({k: v.numpy() for k, v in tv.items()})
    want = np.asarray(JaxLPIPS().apply({"params": jparams}, jnp.asarray(_nhwc(x)),
                                       jnp.asarray(_nhwc(y))))
    from_jax = LPIPS()
    from_jax.load_state_dict(lpips_state_from_jax(jparams), strict=True)
    from_ref = LPIPS()
    from_ref.load_state_dict(lpips_state_from_torch(reference_state(path)), strict=True)
    for m in (from_jax, from_ref):
        with torch.no_grad():
            got = m(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert got.shape == (B,)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert "net.slice2.5.weight" in from_ref.state_dict() and "lin4.model.1.weight" in from_ref.state_dict()


# -- the task ---------------------------------------------------------------------------------


def _port_state(params):
    out = {f"ae.{k}": v for k, v in autoencoder_state_from_jax(params["ae"]).items()}
    out.update({f"disc.{k}": v
                for k, v in nlayer_discriminator_state_from_jax(params["disc"]).items()})
    out["logvar"] = torch.tensor(np.asarray(params["logvar"]))
    return out


@pytest.fixture(scope="module")
def jax_params():
    jtask = JaxAutoencoderTask(JaxParams(CFG))
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    params["logvar"] = np.float32(0.3)  # away from 0, so that its scaling shows
    return params


def _roll(rng):
    return (rng.random((B, 2, HW, HW)) > 0.85).astype(np.float32)


@pytest.mark.parametrize("step,lpips,adaptive", [
    (4, False, True), (5, False, True), (4, True, True), (5, True, True), (5, False, False)],
    ids=["below-disc_start", "at-disc_start", "below-disc_start-lpips", "at-disc_start-lpips",
         "at-disc_start-fixed-weight"])
def test_task_loss_metrics_and_gradients_match_jax(jax_params, lpips_file, step, lpips,
                                                   adaptive):
    """The global step reaches the gate on both sides of ``disc_start``; the
    adaptive weight comes from the forward's own noise, and none of its
    gradient reaches the parameters (compared after the backward); with
    ``adaptive_disc_weight: false`` the weight is ``disc_weight`` itself."""
    cfg = dict(CFG, adaptive_disc_weight=adaptive)
    if lpips:
        cfg["lpips_path"] = lpips_file[1]
    jtask = JaxAutoencoderTask(JaxParams(cfg))
    x0 = _roll(np.random.default_rng(7))
    key = jax.random.PRNGKey(11)
    loss_grad = jax.jit(lambda p: jax.value_and_grad(jtask.loss_fn, has_aux=True)(
        p, (jnp.asarray(x0), None, None, None), key, {"global_step": step}))
    (loss, metrics), grads = loss_grad(jax_params)
    task = AutoencoderTask(Params(cfg), device="cpu")
    task.model.load_state_dict(_port_state(jax_params), strict=True)
    got, got_m = task.loss_fn((torch.from_numpy(x0), None, None, None),
                              AENoise(torch.from_numpy(_jax_eps(key)), step))
    got.backward()
    assert set(got_m) == set(metrics)
    assert ("p_loss" in got_m) == lpips
    assert float(metrics["disc_factor"]) == (1.0 if step >= CFG["disc_start"] else 0.0)
    for k, w in metrics.items():
        np.testing.assert_allclose(got_m[k].item(), float(w), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    want = _port_state(_np_tree(grads))
    _assert_grads_close({k: p.grad.numpy() for k, p in task.model.named_parameters()},
                        {k: v.numpy() for k, v in want.items()})


def test_adaptive_weight_matches_jax(jax_params):
    jtask = JaxAutoencoderTask(JaxParams(CFG))
    x0 = _roll(np.random.default_rng(8))
    key = jax.random.PRNGKey(12)
    x = jtask._pad_channels(jnp.asarray(x0))
    want = float(jax.jit(lambda p: jtask._adaptive_weight(p, x, None, key))(jax_params))
    task = AutoencoderTask(Params(CFG), device="cpu")
    task.model.load_state_dict(_port_state(jax_params), strict=True)
    xp = task.pad_channels(torch.from_numpy(x0))
    np.testing.assert_array_equal(xp.numpy(), _nchw(x))
    recon, _ = task.ae(xp, torch.from_numpy(_jax_eps(key)))
    got = task.adaptive_weight(xp, recon.float())
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), want, rtol=1e-4)


def test_train_step_reads_the_global_step():
    """The train step hands the task its step number; the eval step +inf."""
    task = AutoencoderTask(Params(CFG), device="cpu", generator=torch.Generator().manual_seed(0))
    seen = []
    draw = task.draw_noise
    task.draw_noise = lambda *a: seen.append(draw(*a)) or seen[-1]
    state = create_state(task.model, 1e-4, 10.0)
    batch = (torch.from_numpy(_roll(np.random.default_rng(9))), None, None, None)
    step = make_train_step(task)
    metrics = [step(state, batch, seed=0) for _ in range(2)]
    assert [n.global_step for n in seen] == [0, 1]
    assert seen[0].eps.shape == (B, 4, HW // 2, HW // 2)
    assert [m["disc_factor"].item() for m in metrics] == [0.0, 0.0]
    state.step = CFG["disc_start"]
    assert step(state, batch, seed=0)["disc_factor"].item() == 1.0
    from polyffusion_tpu_torch.train import make_eval_step

    assert make_eval_step(task)(batch)["disc_factor"].item() == 1.0
    assert seen[-1].global_step == float("inf")


def test_bf16_training_keeps_the_fp32_parameters_jax_uses_uncast():
    task = AutoencoderTask(Params(dict(CFG, bf16=True)), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    state = create_state(task.model, 1e-4, 10.0, bf16=True)
    assert task.model.logvar.dtype == torch.float32
    assert task.model.disc.main[3].weight.dtype == torch.float32  # a batch norm
    assert task.model.disc.main[2].weight.dtype == torch.bfloat16
    assert task.ae.encoder.norm_out.weight.dtype == torch.float32
    batch = (torch.from_numpy(_roll(np.random.default_rng(10))), None, None, None)
    metrics = make_train_step(task)(state, batch, seed=0)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


# -- the CLI ----------------------------------------------------------------------------------


def _write_song(path, seed, n_bars=8):
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


def test_train_then_resume_across_disc_start_through_the_cli(tmp_path, capsys):
    from polyffusion_tpu_torch.main import main as train_main

    data = tmp_path / "songs"
    os.makedirs(data)
    for i in range(2):
        _write_song(str(data / f"song{i}.npz"), seed=i)
    run = str(tmp_path / "run")
    args = ["--model", "autoencoder", "--output_dir", run, "--data_dir", str(data), "--device",
            "cpu", "--batch_size", "1", "--log_every", "1", "--set", "channels=32", "--set",
            "channel_multipliers=[1,2]", "--set", "n_res_blocks=1", "--set", "disc_start=1"]
    assert train_main(args + ["--max_steps", "1"]).step == 1
    assert train_main(args + ["--max_steps", "2", "--resume"]).step == 2
    assert "[resume] restored checkpoint at step 1" in capsys.readouterr().out
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    train = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    # the step before the gate, then the one at it (the resumed run's)
    assert [r["train/disc_factor"] for r in train] == [0.0, 1.0]
    assert all(np.isfinite(v) for r in records for k, v in r.items() if "/" in k)
    ckpt = torch.load(os.path.join(run, "chkpts", "last.pt"), weights_only=True)
    assert {k.split(".")[0] for k in ckpt["params"]} == {"ae", "disc", "logvar"}
