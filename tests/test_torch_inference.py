"""The inference slice: ``InferenceSession`` (its defaults and argument order,
DDPM with masks, piece-batched autoregression), whole-song conditions and
the inference CLI, the port against the JAX package on the CPU in fp32, and
the CLI end to end on a tiny run directory of the port's trainer."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.data.dataset import SongNpz as JaxSongNpz
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.inference import get_autoreg_data as jax_get_autoreg_data
from polyffusion_tpu.inference import song_conditions as jax_song_conditions
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu.utils.midi import load_midi
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.data import SongNpz, write_song_npz
from polyffusion_tpu_torch.diffusion.schedule import make_schedule
from polyffusion_tpu_torch.inference import (
    InferenceSession,
    build_task_for_inference,
    get_autoreg_data,
    load_unet_params,
    main,
    song_conditions,
)
from polyffusion_tpu_torch.models import ChordEncoder, UNetModel, init_weights_
from polyffusion_tpu_torch.tasks import SDFTask

# as tests/test_inference_utils.py:109-116, one head of 64 at level 1
CFG = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-4, max_grad_norm=10,
    bf16=False, in_channels=2, out_channels=2, channels=32, attention_levels=[1],
    n_res_blocks=1, channel_multipliers=[1, 2], n_heads=1, tf_layers=1, d_cond=32 * 36,
    linear_start=0.00085, linear_end=0.012, n_steps=8, img_h=32, img_w=32,
    cond_type="chord", cond_mode="mix", use_enc=False,
)
ATOL, RTOL = 2e-3, 1e-3  # the tolerance of tests/test_torch_slice.py


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
    return jtask, params, task


# -- the session's defaults and argument order (fault 3) -----------------------------


def test_session_defaults_match_jax(pair):
    jtask, params, task = pair
    jsess, sess = JaxSession(jtask, params), InferenceSession(task, device="cpu")
    assert sess.sampler_kind == jsess.sampler_kind == "ddpm"
    assert sess.t_idx == jsess.t_idx == CFG["n_steps"] - 1
    assert not sess.use_ddim and sess.repaint_n == jsess.repaint_n == 1
    for kind, kw in (("ddim", dict(use_ddim=True, ddim_steps=4)), ("dpmpp", dict(sampler="dpmpp", ddim_steps=4))):
        jsess, sess = JaxSession(jtask, params, **kw), InferenceSession(task, device="cpu", **kw)
        assert sess.sampler_kind == jsess.sampler_kind == kind
        assert (sess.t_idx, sess.ddim_label) == (jsess.t_idx, jsess.ddim_label)
    with pytest.raises(ValueError):
        InferenceSession(task, sampler="euler", device="cpu")


@pytest.mark.parametrize("method", ["predict", "generate", "inpaint"])
def test_positional_order_matches_jax(method):
    """``predict(cond, 5.0)`` meant CFG 5 in the port and cond_mid=5.0 in JAX."""
    names = list(inspect.signature(getattr(InferenceSession, method)).parameters)
    jax_names = list(inspect.signature(getattr(JaxSession, method)).parameters)
    assert names == jax_names


# -- DDPM -------------------------------------------------------------------------------


def test_ddpm_predict_keeps_known_region(pair):
    """With an all-ones mask, DDPM RePaint returns sqrt_alpha_bar[0] * orig."""
    jtask, params, task = pair
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((2, 1, CFG["d_cond"])).astype(np.float32)
    orig = (rng.random((2, 2, 32, 32)) > 0.8).astype(np.float32)
    ones = np.ones_like(orig)
    noise = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    want = task.schedule.sqrt_alpha_bar[0] * orig
    got = InferenceSession(task, device="cpu").predict(cond, None, 5.0, False, orig, ones, noise)
    jgot = JaxSession(jtask, params).predict(cond, None, 5.0, False, orig, ones, noise)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(jgot, want, atol=1e-6, rtol=0)


# -- autoregression -------------------------------------------------------------------------


def _autoreg_inputs(p, b):
    rng = np.random.default_rng(7)
    conds = rng.standard_normal((p, b, 1, CFG["d_cond"])).astype(np.float32)
    cond_mids = rng.standard_normal((p, b - 1, 1, CFG["d_cond"])).astype(np.float32)
    noise = rng.standard_normal((p, b, 32, 32, 2)).astype(np.float32)
    return conds, cond_mids, noise


@pytest.mark.parametrize("pieces", [1, 4])
def test_autoreg_matches_jax(pair, pieces):
    """DDIM-4 at eta 0 (deterministic given the starting noise), CFG 5, B = 3:
    2B - 1 = 5 windows; P = 1 through the per-piece call, P = 4 piece-batched."""
    jtask, params, task = pair
    b = 3
    conds, cond_mids, noise = _autoreg_inputs(pieces, b)
    if pieces == 1:
        conds, cond_mids, noise = conds[0], cond_mids[0], noise[0]
    jsess = JaxSession(jtask, params, use_ddim=True, ddim_steps=4, seed=0)
    sess = InferenceSession(task, sampler="ddim", ddim_steps=4, device="cpu")
    want = jsess.predict(conds, cond_mids, 5.0, True, noise=noise)
    got = sess.predict(conds, cond_mids, 5.0, True, noise=noise)
    assert got.shape == want.shape == ((pieces,) if pieces > 1 else ()) + (2 * b, 2, 16, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_autoreg_piece_batched_equals_sequential(pair):
    _, _, task = pair
    p, b = 4, 3
    conds, cond_mids, noise = _autoreg_inputs(p, b)

    def session():
        return InferenceSession(task, sampler="ddim", ddim_steps=4, device="cpu")

    batched = session().predict(conds, cond_mids, 5.0, True, noise=noise)
    for i in range(p):
        solo = session().predict(conds[i], cond_mids[i], 5.0, True, noise=noise[i])
        np.testing.assert_allclose(batched[i], solo, atol=1e-5, rtol=1e-5, err_msg=f"piece {i}")
    # without explicit noise each piece draws its own starting noise
    same = np.broadcast_to(conds[:1], conds.shape).copy()
    out = session().predict(same, np.zeros_like(cond_mids), 0.0, True)
    assert not np.array_equal(out[0], out[1])


def test_autoreg_windows_force_previous_half(pair):
    """DDPM windows: each window after the first paints with its first half
    forced to the previous window's second half (mask 1 there), so that half
    ends at sqrt_alpha_bar[0] times it; the stacks are left unchanged."""
    _, _, task = pair
    conds, cond_mids, noise = _autoreg_inputs(1, 2)
    origs = np.zeros((1, 2, 2, 32, 32), np.float32)
    masks = np.zeros_like(origs)
    sess = InferenceSession(task, device="cpu")
    windows = []  # (orig, mask, output) of each window's paint, NHWC

    def paint(x, cond, orig, mask, *rest):
        out = InferenceSession._paint(sess, x, cond, orig, mask, *rest)
        windows.append((orig.clone(), mask.clone(), out))
        return out

    sess._paint = paint
    out = sess._predict_autoreg(conds, cond_mids, 1.0, origs, masks, noise)
    assert out.shape == (1, 4, 2, 16, 32) and np.isfinite(out).all()
    assert len(windows) == 3 and (origs == 0).all() and (masks == 0).all()
    assert (windows[0][1] == 0).all()
    sqrt_ab0 = np.float32(task.schedule.sqrt_alpha_bar[0])
    for (_, _, prev), (orig, mask, cur) in zip(windows, windows[1:]):
        torch.testing.assert_close(orig[:, :16], prev[:, 16:], rtol=0, atol=0)
        assert (mask[:, :16] == 1).all() and (mask[:, 16:] == 0).all()
        torch.testing.assert_close(cur[:, :16], sqrt_ab0 * prev[:, 16:], rtol=0, atol=1e-6)


# -- whole-song data and conditions ---------------------------------------------------------


def _write_song(path, seed, n_bars=24):
    """A synthetic three-track song (the idea of tests/synth.py)."""
    rng = np.random.default_rng(seed)
    n_beats = n_bars * 4
    n_bins = n_beats * 4
    tracks = []
    for t in range(3):
        n = rng.integers(40, 80)
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


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("songs")
    for i in range(4):
        _write_song(str(d / f"song{i}.npz"), seed=i)
    return str(d)


def test_whole_song_data_and_conditions_match_jax(data_dir):
    got = SongNpz("song0.npz", data_dir).get_whole_song_data()
    want = JaxSongNpz("song0.npz", data_dir).get_whole_song_data()
    assert got[0].shape == (3, 2, 128, 128)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    for axis, seg_axis in ((1, 0), (2, 0), (2, 1)):
        np.testing.assert_array_equal(get_autoreg_data(got[0], axis, seg_axis).numpy(),
                                      jax_get_autoreg_data(got[0], axis, seg_axis))
    task, jtask = SDFTask(Params(CFG), device="cpu"), JaxSDFTask(JaxParams(CFG))
    for length in (0, 2):
        cond, cond_mid, prmat2c = song_conditions(task, got, length, autoreg=True)
        jcond, jcond_mid, jprmat2c = jax_song_conditions(jtask, want, length, autoreg=True)
        np.testing.assert_array_equal(cond, jcond)
        np.testing.assert_array_equal(cond_mid, jcond_mid)
        np.testing.assert_array_equal(prmat2c, jprmat2c)
    assert song_conditions(task, got)[1] is None


# -- checkpoints ---------------------------------------------------------------------------

TINY_UNET = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1,
                 attention_levels=(), channel_multipliers=(1,), n_heads=1, tf_layers=1,
                 d_cond=32)


@pytest.mark.parametrize("prefix", ["model.ldm.eps_model.", "ldm.eps_model.", "eps_model."])
def test_load_unet_params_reads_reference_checkpoints(tmp_path, prefix):
    unet = init_weights_(UNetModel(**TINY_UNET), torch.Generator().manual_seed(2))
    sd = {prefix + k: v for k, v in unet.state_dict().items()}
    sd["model.other.weight"] = torch.zeros(1)  # another module of the learner
    path = str(tmp_path / "ref.pt")
    torch.save({"model": sd}, path)
    got = load_unet_params(path)
    assert set(got) == set(unet.state_dict())
    UNetModel(**TINY_UNET).load_state_dict(got, strict=True)
    for k, v in unet.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="use_ema"):
        load_unet_params(path, use_ema=True)


def test_load_unet_params_refuses_other_directories(tmp_path):
    (tmp_path / "chkpts" / "100").mkdir(parents=True)  # an orbax step directory
    with pytest.raises(NotImplementedError, match="item 15"):
        load_unet_params(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 10"):
        build_task_for_inference(Params(CFG, model_name="ddpm"), device="cpu")


# -- the CLI on a tiny run directory of the port's trainer -------------------------------------

# four levels put the middle block's attention at 16 x 16 tokens of the 128 x 128 image
TINY_SET = ["channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]",
            "n_res_blocks=1", "chd_hidden_dim=16", "bf16=false", "n_steps=10"]


def _train_run(data_dir, pretrained, out, ema: bool):
    from polyffusion_tpu_torch.main import main as train_main

    sets = TINY_SET + (["ema_decay=0.9"] if ema else [])
    args = ["--model", "sdf_chd8bar", "--output_dir", out, "--data_dir", data_dir,
            "--pretrained_dir", pretrained, "--device", "cpu", "--batch_size", "2",
            "--max_steps", "1", "--log_every", "1"]
    for kv in sets:
        args += ["--set", kv]
    train_main(args)
    return out


@pytest.fixture(scope="module")
def run_dir(data_dir, tmp_path_factory):
    """Two tiny runs of the training CLI (with and without an EMA branch) and
    a random chord encoder in the reference's ``chd8bar.pt`` layout."""
    root = tmp_path_factory.mktemp("cli")
    pretrained = str(root / "pretrained")
    os.makedirs(pretrained)
    enc = init_weights_(ChordEncoder(36, 16, 512), torch.Generator().manual_seed(3))
    torch.save({"model": {f"chord_enc.{k}": v for k, v in enc.state_dict().items()}},
               os.path.join(pretrained, "chd8bar.pt"))
    ema_run = _train_run(data_dir, pretrained, str(root / "ema_run"), ema=True)
    plain_run = _train_run(data_dir, pretrained, str(root / "plain_run"), ema=False)
    return ema_run, plain_run, pretrained


def _cli(run, data_dir, pretrained, out, *extra):
    return main(["--chkpt_path", run, "--data_dir", data_dir, "--song_fn", "song1.npz",
                 "--pretrained_dir", pretrained, "--output_dir", str(out), "--device", "cpu",
                 "--uncond_scale", "5", *extra])


def _mids(out):
    files = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    for f in files:
        load_midi(os.path.join(out, f))
    return files


def test_cli_ddpm_generation(run_dir, data_dir, tmp_path):
    ema_run, _, pretrained = run_dir
    (gen,) = _cli(ema_run, data_dir, pretrained, tmp_path, "--length", "1")
    assert gen.shape == (1, 2, 128, 128) and np.isfinite(gen).all()
    (name,) = _mids(tmp_path)
    assert name.startswith("sdf_chd8bar[scale=5.0]_")


def test_cli_ddpm_inpainting(run_dir, data_dir, tmp_path):
    ema_run, _, pretrained = run_dir
    ((gen, mask),) = _cli(ema_run, data_dir, pretrained, tmp_path, "--inpaint_type", "below",
                          "--length", "1")
    orig = SongNpz("song1.npz", data_dir).get_whole_song_data()[0][:1]
    sqrt_ab0 = np.float32(make_schedule(10, 0.00085, 0.012).sqrt_alpha_bar[0])  # TINY_SET's
    keep = mask == 1
    assert 0 < keep.mean() < 1
    np.testing.assert_allclose(gen[keep], sqrt_ab0 * orig[keep], atol=1e-6, rtol=0)
    (name,) = _mids(tmp_path)
    assert name.startswith("sdf_chd8bar_inp1_below[scale=5.0]_")
    midi = load_midi(os.path.join(tmp_path, name))
    assert len(midi.instruments) == 2  # the kept notes and the inpainted ones


def test_cli_autoreg_ddim(run_dir, data_dir, tmp_path):
    ema_run, _, pretrained = run_dir
    (gen,) = _cli(ema_run, data_dir, pretrained, tmp_path, "--autoreg", "--ddim",
                  "--ddim_steps", "5", "--length", "2")
    assert gen.shape == (4, 2, 64, 128) and np.isfinite(gen).all()
    (name,) = _mids(tmp_path)
    assert name.startswith("sdf_chd8bar[scale=5.0,autoreg,ddim5_eta0.0_uniform]_")
    # piece-batched: one .mid per piece
    (gen,) = _cli(ema_run, data_dir, pretrained, tmp_path / "pieces", "--autoreg", "--dpmpp",
                  "--ddim_steps", "5", "--length", "2", "--num_generate", "2")
    assert gen.shape == (2, 4, 2, 64, 128)
    assert len(_mids(tmp_path / "pieces")) == 2


def test_cli_split_inpaint(run_dir, data_dir, tmp_path):
    ema_run, _, pretrained = run_dir
    assert _cli(ema_run, data_dir, pretrained, tmp_path, "--split_inpaint", "--inpaint_type",
                "bars", "--bar_list", "1,3") is None
    assert _mids(tmp_path) == ["sdf_chd8bar_split_bars.mid"]


def test_cli_reads_run_dir_with_and_without_ema(run_dir, data_dir, tmp_path):
    ema_run, plain_run, pretrained = run_dir
    ckpt = torch.load(os.path.join(ema_run, "chkpts", "last.pt"), weights_only=True)
    for use_ema, branch in ((False, "params"), (True, "ema")):
        got = load_unet_params(ema_run, use_ema=use_ema)
        assert set(got) == set(ckpt[branch])
        for k, v in ckpt[branch].items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    outs = [_cli(ema_run, data_dir, pretrained, tmp_path / str(i), "--ddim", "--ddim_steps",
                 "5", "--length", "1", *extra)[0] for i, extra in enumerate(([], ["--use_ema"]))]
    assert not np.array_equal(outs[0], outs[1])  # one Adam step and an EMA of 0.9 differ
    with pytest.raises(ValueError, match="no EMA branch"):
        _cli(plain_run, data_dir, pretrained, tmp_path / "x", "--use_ema", "--length", "1")
