"""The chord-VAE pretraining slice (``chd_8bar``), the port against the JAX
package on the CPU in fp32: the teacher-forcing schedulers, ``ChordDecoder``
and its converter, ``chord_recon_loss``, the task's loss, metrics and
gradients, three train steps against an optax step, the trainer's scheduled
rates and fixed eval coins, fp32 training under the preset's ``bf16: true``,
and the training CLI end to end: ``chd_8bar``, then ``sdf_chd8bar`` with that
run directory as its frozen chord encoder, then the inference CLI."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.convert.torch_import import chord_decoder_params_from_torch
from polyffusion_tpu.models.encoders import ChordDecoder as JaxChordDecoder
from polyffusion_tpu.models.encoders import chord_recon_loss as jax_chord_recon_loss
from polyffusion_tpu.tasks.chd_8bar import Chd8BarTask as JaxChd8BarTask
from polyffusion_tpu.train import schedulers as jax_schedulers
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import chord_decoder_state_from_jax, chord_encoder_state_from_jax
from polyffusion_tpu_torch.data import write_song_npz
from polyffusion_tpu_torch.models import ChordDecoder, ChordEncoder, init_weights_
from polyffusion_tpu_torch.models.encoders import build_frozen_encoders, chord_recon_loss
from polyffusion_tpu_torch.tasks import Chd8BarTask, SDFTask
from polyffusion_tpu_torch.tasks.chd_8bar import ChordNoise
from polyffusion_tpu_torch.train import Trainer, create_state, make_eval_step, make_train_step
from polyffusion_tpu_torch.train import schedulers
from polyffusion_tpu_torch.train.step import step_generator

LOGIT_ATOL = 1e-4  # the JAX package's decoder parity (tests/test_pianotree_dec_parity.py:66)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # tests/test_torch_train.py's step limits
HIDDEN, Z_IN, Z = 16, 12, 8  # tiny chord VAE widths
CFG = dict(model_name="chd_8bar", batch_size=3, max_epoch=1, learning_rate=1e-3,
           max_grad_norm=0.5, bf16=True, tfr_chd=[0.5, 0], chd_n_step=32, chd_input_dim=36,
           chd_z_input_dim=Z_IN, chd_hidden_dim=HIDDEN, chd_z_dim=Z)
B, STEPS = 3, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _chords(rng, b):
    """(B, 32, 36) chord one-hots: root one-hot | chroma multi-hot | bass one-hot."""
    chords = np.zeros((b, 32, 36), np.float32)
    rows = np.arange(32)
    for i in range(b):
        chords[i, rows, rng.integers(0, 12, 32)] = 1.0
        chords[i, :, 12:24] = rng.integers(0, 2, (32, 12))
        chords[i, rows, 24 + rng.integers(0, 12, 32)] = 1.0
    return chords


def _port_state(tree):
    """A JAX chord VAE's params -> the port's ``VAE`` state dict."""
    out = {f"chord_enc.{k}": v for k, v in chord_encoder_state_from_jax(tree["chord_enc"]).items()}
    out.update({f"chord_dec.{k}": v
                for k, v in chord_decoder_state_from_jax(tree["chord_dec"]).items()})
    return out


def _assert_grads_close(got, want):
    """Per tensor: |g - w| <= GRAD_RTOL |w| in norm (exact zeros stay zero)."""
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w.numpy())
        assert err <= GRAD_RTOL * np.linalg.norm(w.numpy()) + 1e-9, (k, err)


# -- the schedulers -------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 20000, 40000, 40001, 10**6])
def test_schedulers_match_jax(step):
    ours = schedulers.TeacherForcingScheduler(0.8, 0.1)
    theirs = jax_schedulers.TeacherForcingScheduler(0.8, 0.1)
    assert ours.step(step) == theirs.step(step)
    assert schedulers.scheduled_sampling(step / 40000) == jax_schedulers.scheduled_sampling(
        step / 40000)
    assert schedulers.ConstantScheduler(0.3).step(step) == 0.3
    bundle = schedulers.ParameterScheduler(a=ours, c=schedulers.ConstantScheduler(0.3))
    jbundle = jax_schedulers.ParameterScheduler(a=theirs, c=jax_schedulers.ConstantScheduler(0.3))
    assert bundle.keys() == jbundle.keys() == ("a", "c")
    assert bundle.step(step) == jbundle.step(step)
    bundle.eval()
    jbundle.eval()
    assert bundle.step(step) == jbundle.step(step) == {"a": 0.1, "c": 0.3}
    bundle.train()
    assert bundle.step(step)["a"] == theirs.step(step)


@pytest.mark.parametrize("name", ["chd_8bar", "pnotree_vae", "sdf_chd8bar"])
def test_preset_schedulers_are_the_jax_clis(name):
    """``make_param_scheduler`` builds what JAX ``main.py:120-125`` builds."""
    cfg = load_params(name)
    got = schedulers.make_param_scheduler(cfg)
    keys = [k for k in ("tfr_chd", "tfr_pnt1", "tfr_pnt2") if k in cfg]
    if not keys:
        assert got is None
        return
    want = jax_schedulers.ParameterScheduler(
        **{k: jax_schedulers.TeacherForcingScheduler(*cfg[k]) for k in keys})
    for step in (0, 7, 30000):
        assert got.step(step) == want.step(step)


# -- the decoder --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder():
    jm = JaxChordDecoder(input_dim=36, z_input_dim=Z_IN, hidden_dim=HIDDEN, z_dim=Z, n_step=32)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    gt = _chords(rng, B)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(z), False, 0.5, jnp.asarray(gt),
                              jax.random.PRNGKey(1))["params"])
    tm = ChordDecoder(36, Z_IN, HIDDEN, Z, 32)
    tm.load_state_dict(chord_decoder_state_from_jax(params), strict=True)
    apply = jax.jit(jm.apply, static_argnums=(2,))
    return jm, params, tm, apply, z, gt


def test_chord_decoder_converter_inverts_the_jax_import(decoder):
    """The reference ``chord_dec.py`` names: JAX's importer maps the port's
    state dict back onto the JAX tree."""
    _, params, tm, _, _, _ = decoder
    back = chord_decoder_params_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))
    assert sorted(tm.state_dict()) == sorted(
        ["z2dec_hid.weight", "z2dec_hid.bias", "z2dec_in.weight", "z2dec_in.bias",
         "gru.weight_ih_l0", "gru.weight_hh_l0", "gru.bias_ih_l0", "gru.bias_hh_l0",
         "init_input", "root_out.weight", "root_out.bias", "chroma_out.weight",
         "chroma_out.bias", "bass_out.weight", "bass_out.bias"])


@pytest.mark.parametrize("mode", ["mixed", "all_true", "free"])
def test_chord_decoder_logits_match_jax(decoder, mode):
    """Training mode at JAX's own coins (``uniform(rng, (32,)) < tfr``, drawn
    with JAX and handed to the port), at all coins true, and free-running."""
    _, params, tm, apply, z, gt = decoder
    key = jax.random.PRNGKey(5)
    if mode == "free":
        want = apply({"params": params}, jnp.asarray(z), True)
        got = tm(torch.from_numpy(z))
    else:
        tfr = 0.5 if mode == "mixed" else 1.0
        coins = np.array(jax.random.uniform(key, (32,)) < tfr)
        assert coins.all() if mode == "all_true" else 0 < coins.sum() < 32
        want = apply({"params": params}, jnp.asarray(z), False, tfr, jnp.asarray(gt), key)
        got = tm(torch.from_numpy(z), torch.from_numpy(coins), torch.from_numpy(gt))
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        # the fed-back tokens first: the argmax of every head at every step
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)


def test_chord_recon_loss_matches_jax():
    rng = np.random.default_rng(1)
    chord = _chords(rng, B)
    logits = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, 32, 12), (B, 32, 12, 2), (B, 32, 12))]
    got = chord_recon_loss(torch.from_numpy(chord), *map(torch.from_numpy, logits))
    want = jax_chord_recon_loss(jnp.asarray(chord), *map(jnp.asarray, logits))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=LOSS_RTOL)


# -- the task ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_task():
    jtask = JaxChd8BarTask(JaxParams(CFG))
    params = _np_tree(jtask.init_params(jax.random.PRNGKey(0)))
    return jtask, params


def _jax_noise(rng_key, b, tfr):
    """What JAX's ``Chd8BarTask.loss_fn`` draws from ``rng_key`` (:56-61):
    the reparameterisation noise and the decoder's coins."""
    k_sample, k_tf = jax.random.split(rng_key)
    z = np.array(jax.random.normal(k_sample, (b, Z), jnp.float32))
    coins = np.array(jax.random.uniform(k_tf, (32,)) < tfr)
    return ChordNoise(torch.from_numpy(z), torch.from_numpy(coins))


def _port_task(params):
    task = Chd8BarTask(Params(CFG), device="cpu")
    task.model.load_state_dict(_port_state(params), strict=True)
    return task


def test_task_loss_metrics_and_gradients_match_jax(jax_task):
    jtask, params = jax_task
    chord = _chords(np.random.default_rng(2), B)
    key, tfr = jax.random.PRNGKey(7), 0.5
    (loss, metrics), grads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
        params, (None, None, jnp.asarray(chord), None), key, {"tfr_chd": tfr})
    task = _port_task(params)
    batch = (None, None, torch.from_numpy(chord), None)
    got_loss, got = task.loss_fn(batch, _jax_noise(key, B, tfr))
    got_loss.backward()
    assert set(got) == set(metrics) == {"loss", "root", "chroma", "bass"}
    for k, w in metrics.items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=LOSS_RTOL)
    _assert_grads_close({k: p.grad.numpy() for k, p in task.model.named_parameters()},
                        _port_state(_np_tree(grads)))


def test_three_train_steps_match_optax(jax_task):
    """Three steps of the port's ``make_train_step`` against JAX's loss under
    ``value_and_grad`` and ``make_optimizer`` (clip, then Adam), each step's
    rate from the preset's scheduler and its noise from one JAX key."""
    jtask, params = jax_task
    opt = jax_make_optimizer(CFG["learning_rate"], CFG["max_grad_norm"])

    @jax.jit
    def step(p, opt_state, chord, key, tfr):
        (loss, _), grads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
            p, (None, None, chord, None), key, {"tfr_chd": tfr})
        updates, opt_state = opt.update(grads, opt_state, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
        gnorm = jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads)))
        return p, opt_state, loss, gnorm

    task = _port_task(params)
    state = create_state(task.model, CFG["learning_rate"], CFG["max_grad_norm"])
    train_step = make_train_step(task)
    sched = schedulers.make_param_scheduler(CFG)
    rng = np.random.default_rng(3)
    p, opt_state = params, opt.init(params)
    for i in range(STEPS):
        chord = _chords(rng, B)
        key, tfr = jax.random.PRNGKey(100 + i), sched.step(i)["tfr_chd"]
        p, opt_state, loss, gnorm = step(p, opt_state, jnp.asarray(chord), key, tfr)
        metrics = train_step(state, (None, None, torch.from_numpy(chord), None), seed=0,
                             noise=_jax_noise(key, B, tfr))
        assert state.step == i + 1
        np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(gnorm), rtol=GRAD_RTOL)
        assert float(gnorm) > CFG["max_grad_norm"]  # the clip is active
        want = _port_state(_np_tree(p))
        err = np.concatenate([np.abs(v.detach().numpy() - want[k].numpy()).ravel()
                              for k, v in state.params().items()])
        # Adam divides by sqrt(v) + 1e-8: where a gradient lies within rounding
        # of zero the update moves by a fraction of lr (tests/test_torch_train.py)
        assert err.max() <= 0.1 * CFG["learning_rate"] * (i + 1), err.max()
        assert (err > 2e-6).mean() < 1e-3


def test_chd8bar_trains_in_fp32_under_the_presets_bf16():
    """``params/chd_8bar.yaml`` says ``bf16: true``, which JAX's chord VAE
    never reads: the port's task trains in fp32 too."""
    from polyffusion_tpu_torch.main import build_task

    cfg = load_params("chd_8bar")
    assert cfg.bf16 is True
    cfg.update(chd_hidden_dim=HIDDEN, chd_z_input_dim=Z_IN, chd_z_dim=Z)
    task = build_task(cfg, device="cpu")
    assert isinstance(task, Chd8BarTask) and task.bf16 is False
    state = create_state(task.model, 1e-3, 10.0, bf16=task.bf16)
    assert state.weights.shared
    assert all(p.dtype == torch.float32 for p in task.model.parameters())
    assert sorted({k.split(".")[0] for k in task.model.state_dict()}) == ["chord_dec", "chord_enc"]


def test_train_step_draws_coins_at_the_scheduled_rate():
    """The step's ``sched`` reaches ``draw_noise``: the coins are the step
    generator's uniforms below the rate, after the noise."""
    task = Chd8BarTask(Params(CFG), device="cpu", generator=torch.Generator().manual_seed(0))
    batch = (None, None, torch.from_numpy(_chords(np.random.default_rng(4), B)), None)
    seen = []
    draw = task.draw_noise
    task.draw_noise = lambda *a: seen.append(draw(*a)) or seen[-1]
    state = create_state(task.model, 1e-3, 10.0)
    make_train_step(task)(state, batch, seed=3, sched={"tfr_chd": 0.25})
    g = step_generator(3, 0, task.device)
    z = torch.randn((B, Z), generator=g)
    assert torch.equal(seen[0].z, z)
    assert torch.equal(seen[0].tf, torch.rand(32, generator=g) < 0.25)


def test_validation_coins_use_the_floor(tmp_path):
    """Validation puts the scheduler in eval mode (teacher forcing at
    ``low``), then training goes on at the scheduled rate; the eval step
    draws the same coins for every batch."""
    cfg = Params(dict(CFG, tfr_chd=[0.9, 0.3], max_epoch=2))
    task = Chd8BarTask(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rates = []
    draw = task.draw_noise
    task.draw_noise = lambda batch, g, sched=None: rates.append(sched["tfr_chd"]) or draw(
        batch, g, sched)
    batch = (None, None, torch.from_numpy(_chords(np.random.default_rng(5), B)), None)
    trainer = Trainer(task, cfg, str(tmp_path / "run"), log_every=1,
                      param_scheduler=schedulers.make_param_scheduler(cfg))
    trainer.fit([batch], [batch, batch], resume=False)
    high = schedulers.TeacherForcingScheduler(0.9, 0.3)
    assert rates == [high.step(0), 0.3, 0.3, high.step(1), 0.3, 0.3]

    eval_step = make_eval_step(task)
    other = (None, None, torch.from_numpy(_chords(np.random.default_rng(6), B)), None)
    seen = []
    task.draw_noise = lambda *a: seen.append(draw(*a)) or seen[-1]
    eval_step(batch, {"tfr_chd": 0.3})
    eval_step(other, {"tfr_chd": 0.3})
    assert torch.equal(seen[0].tf, seen[1].tf)
    g = step_generator(0, 0, task.device)
    torch.randn((B, Z), generator=g)
    assert torch.equal(seen[0].tf, torch.rand(32, generator=g) < 0.3)


# -- the CLIs ------------------------------------------------------------------------------


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


CHD_SET = ["--set", f"chd_hidden_dim={HIDDEN}", "--set", f"chd_z_input_dim={Z_IN}"]
# a one-level UNet without attention (tests/test_torch_conditions.py's TINY_SET)
SDF_SET = ["channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]",
           "n_res_blocks=1", f"chd_hidden_dim={HIDDEN}", "bf16=false", "n_steps=10"]


def test_chd8bar_run_feeds_sdf_chd8bar_through_the_clis(data_dir, tmp_path, capsys):
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main

    run = str(tmp_path / "chd")
    args = ["--model", "chd_8bar", "--output_dir", run, "--data_dir", data_dir, "--device",
            "cpu", "--batch_size", "2", "--log_every", "1"] + CHD_SET
    assert train_main(args + ["--max_steps", "2"]).step == 2
    state = train_main(args + ["--max_steps", "3", "--resume"])
    assert state.step == 3 and "[resume] restored checkpoint at step 2" in capsys.readouterr().out
    records = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2, 3]
    val = [r for r in records if "val/loss" in r]
    assert [r["step"] for r in val] == [2, 3]
    assert all(np.isfinite(r[f"val/{k}"]) for r in val for k in ("loss", "root", "chroma", "bass"))

    pre = tmp_path / "pre"
    os.makedirs(pre)
    os.symlink(run, pre / "chd8bar")
    sdf_run = str(tmp_path / "sdf")
    sets = [a for kv in SDF_SET for a in ("--set", kv)]
    assert train_main(["--model", "sdf_chd8bar", "--output_dir", sdf_run, "--data_dir", data_dir,
                       "--pretrained_dir", str(pre), "--device", "cpu", "--batch_size", "2",
                       "--max_steps", "2", "--log_every", "1"] + sets).step == 2

    # the condition is the trained chord encoder's mean, not a random one's
    cfg = load_params(os.path.join(sdf_run, "params.yaml"))
    trained = torch.load(os.path.join(run, "chkpts", "last.pt"), weights_only=True)["params"]
    enc = ChordEncoder(36, HIDDEN, 512)
    enc.load_state_dict({k[len("chord_enc."):]: v for k, v in trained.items()
                         if k.startswith("chord_enc.")}, strict=True)
    task = SDFTask(cfg, **build_frozen_encoders(cfg, str(pre)), device="cpu")
    chord = torch.from_numpy(_chords(np.random.default_rng(8), 2))
    cond = task.encode_cond((None, None, chord, None))
    torch.testing.assert_close(cond[:, 0], enc(chord)[0], rtol=0, atol=0)
    random_enc = init_weights_(ChordEncoder(36, HIDDEN, 512), torch.Generator().manual_seed(1))
    assert (cond[:, 0] - random_enc(chord)[0]).abs().max() > 1e-2

    out = tmp_path / "gen"
    (gen,) = infer_main(["--chkpt_path", sdf_run, "--data_dir", data_dir, "--song_fn",
                         "song1.npz", "--pretrained_dir", str(pre), "--output_dir", str(out),
                         "--device", "cpu", "--ddim", "--ddim_steps", "5", "--length", "2",
                         "--uncond_scale", "5"])
    assert gen.shape == (2, 2, 128, 128) and np.isfinite(gen).all()
    assert len([f for f in os.listdir(out) if f.endswith(".mid")]) == 1

    # a run directory of another model is refused, naming both
    wrong = tmp_path / "wrong"
    os.makedirs(wrong)
    os.symlink(sdf_run, wrong / "chd8bar")
    with pytest.raises(ValueError, match="'sdf_chd8bar' run, not a 'chd_8bar' run"):
        build_frozen_encoders(cfg, str(wrong))
