"""The port's training slice against the JAX package's, fp32 on the CPU: the
q process and loss, the gradient clip, three train steps of a tiny UNet with
attention (loss, grad norm, parameters and EMA after each), the song dataset
and batch loader, the frozen chord encoder's loader, and the ``Trainer``
(resume, NaN check, run-directory files)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.data import BatchLoader as JaxBatchLoader
from polyffusion_tpu.data import SegmentDataset as JaxSegmentDataset
from polyffusion_tpu.diffusion.gaussian import q_sample as jax_q_sample
from polyffusion_tpu.diffusion.gaussian import q_sample_step as jax_q_sample_step
from polyffusion_tpu.tasks.sdf import SDFTask as JaxSDFTask
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.data import BatchLoader, DeviceFeeder, SegmentDataset, write_song_npz
from polyffusion_tpu_torch.diffusion.gaussian import diffusion_loss, q_sample, q_sample_step
from polyffusion_tpu_torch.diffusion.schedule import make_schedule
from polyffusion_tpu_torch.models import ChordEncoder, init_weights_
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.tasks.sdf import StepNoise
from polyffusion_tpu_torch.train import Trainer, create_state, make_train_step
from polyffusion_tpu_torch.train.state import clip_by_global_norm_

# one level with attention on 16 x 16 = 256 tokens, one head of 64 (the
# kernel's path). 64 channels put two channels in each of the 32 groups: with
# one, a GroupNorm cancels the bias before it, whose gradient is then rounding
# noise that Adam scales up to the full step.
CFG = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-3, max_grad_norm=1.0,
    bf16=False, in_channels=2, out_channels=2, channels=64, attention_levels=[0], n_res_blocks=1,
    channel_multipliers=[1], n_heads=1, tf_layers=1, d_cond=32 * 36, linear_start=0.00085,
    linear_end=0.012, n_steps=1000, img_h=16, img_w=16, cond_type="chord", cond_mode="cond",
    use_enc=False, ema_decay=0.9,
)
HW, B, STEPS = 16, 2, 3


def _write_song(path, seed, n_bars=24):
    """A synthetic three-track song (the idea of tests/synth.py, written with
    the port's own ``write_song_npz``)."""
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
        _write_song(str(d / f"{i}.npz"), seed=i)
    return str(d)


# -- q process and loss ---------------------------------------------------------


def test_q_sample_and_loss_match_jax():
    sched = make_schedule(1000, 0.00085, 0.012)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 2, 8, 8)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 517, 999])
    got = q_sample(sched, torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    want = jax_q_sample(sched, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got = q_sample_step(sched, torch.from_numpy(x0), 250, torch.from_numpy(noise))
    want = jax_q_sample_step(sched, jnp.asarray(x0), 250, jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    # eps-MSE through a fixed linear "net" on both sides
    w = rng.standard_normal(8).astype(np.float32)
    loss = diffusion_loss(lambda x, tt, c: x * torch.from_numpy(w), sched, torch.from_numpy(x0),
                          None, torch.from_numpy(t), torch.from_numpy(noise))
    xt = jax_q_sample(sched, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    want = jnp.mean((jnp.asarray(noise) - xt * jnp.asarray(w)) ** 2)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_clip_matches_optax_near_small_norms(scale):
    """At a max norm of 1e-3 the ``+ 1e-6`` of ``clip_grad_norm_`` would move
    the result by 1e-3 relative; the port's clip is optax's."""
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((7, 3), (5,), (2, 2, 2))]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [g * np.float32(scale * 1e-3 / norm) for g in grads]
    got = [torch.from_numpy(g.copy()) for g in grads]
    got_norm = clip_by_global_norm_(got, 1e-3)
    want, _ = optax.clip_by_global_norm(1e-3).update([jnp.asarray(g) for g in grads], None)
    np.testing.assert_allclose(got_norm.item(), scale * 1e-3, rtol=1e-5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# -- three train steps against the JAX step -----------------------------------------


@pytest.fixture(scope="module")
def jax_steps():
    """JAX: init, then three steps of make_optimizer + value_and_grad on the
    given t, noise and batch, with an EMA as ``train/step.py`` keeps it."""
    jtask = JaxSDFTask(JaxParams(CFG))
    params = jax.tree_util.tree_map(np.asarray, jtask.init_params(jax.random.PRNGKey(0)))
    opt = jax_make_optimizer(CFG["learning_rate"], CFG["max_grad_norm"])

    def loss_of(p, x0, chord, t, noise):
        cond = jtask.encode_cond((None, None, chord, None), None)
        xt = jax_q_sample(jtask.schedule, x0, t, noise)
        eps = jtask.apply_eps(p, xt, t, cond)
        return jnp.mean((noise - eps.astype(noise.dtype)) ** 2)

    @jax.jit
    def step(p, opt_state, ema, x0, chord, t, noise):
        loss, grads = jax.value_and_grad(loss_of)(p, x0, chord, t, noise)
        updates, opt_state = opt.update(grads, opt_state, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
        gnorm = jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads)))
        d = jnp.float32(CFG["ema_decay"])
        ema = jax.tree_util.tree_map(lambda e, a: e * d + a * (1 - d), ema, p)
        return p, opt_state, ema, loss, gnorm

    rng = np.random.default_rng(3)
    inputs = []
    for _ in range(STEPS):
        x0 = (rng.random((B, 2, HW, HW)) > 0.9).astype(np.float32)
        chord = (rng.random((B, 32, 36)) > 0.8).astype(np.float32)
        t = rng.integers(0, 1000, B)
        noise = rng.standard_normal(x0.shape).astype(np.float32)
        inputs.append((x0, chord, t, noise))

    p, opt_state, ema = params, opt.init(params), params
    records = []
    for x0, chord, t, noise in inputs:
        p, opt_state, ema, loss, gnorm = step(
            p, opt_state, ema, jnp.asarray(x0.transpose(0, 2, 3, 1)), jnp.asarray(chord),
            jnp.asarray(t), jnp.asarray(noise.transpose(0, 2, 3, 1)),
        )
        records.append((float(loss), float(gnorm), jax.tree_util.tree_map(np.asarray, p),
                        jax.tree_util.tree_map(np.asarray, ema)))
    return params, inputs, records


def test_three_train_steps_match_jax(jax_steps):
    params, inputs, records = jax_steps
    task = SDFTask(Params(CFG), device="cpu", training=True)
    task.load_unet_state(unet_state_from_jax(params))
    state = create_state(task.unet, CFG["learning_rate"], CFG["max_grad_norm"],
                         ema_decay=CFG["ema_decay"])
    step = make_train_step(task, ema_decay=CFG["ema_decay"])
    for i, ((x0, chord, t, noise), (loss, gnorm, jp, jema)) in enumerate(zip(inputs, records)):
        batch = (torch.from_numpy(x0), None, torch.from_numpy(chord), None)
        metrics = step(state, batch, seed=0, noise=StepNoise(
            torch.from_numpy(t), torch.from_numpy(noise), torch.tensor(False)))
        assert state.step == i + 1
        np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5, err_msg=f"step {i}")
        # the clip is active: grad norms of 2 to 6 against max_grad_norm 1
        np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm, rtol=1e-4, err_msg=f"step {i}")
        got = {k: v.detach().numpy() for k, v in state.params().items()}
        ema = {k: e.numpy() for k, e in zip(state.params(), state.ema)}
        _assert_adam_close(got, unet_state_from_jax(jp), i + 1)
        _assert_adam_close(ema, unet_state_from_jax(jema), i + 1)


def _assert_adam_close(got, want, steps):
    """Parameters after ``steps`` Adam steps of lr 1e-3. Adam divides by
    sqrt(v) + 1e-8, so where a gradient lies within a few 1e-8 of zero its
    rounding moves the update by a fraction of lr: every element agrees within
    0.1 lr per step, and all but 0.1 % of them to fp32 rounding (2e-6)."""
    err = np.concatenate([np.abs(got[k] - w.numpy()).ravel() for k, w in want.items()])
    assert err.max() <= 0.1 * CFG["learning_rate"] * steps, err.max()
    assert (err > 2e-6).mean() < 1e-3, (err > 2e-6).mean()


def test_bf16_training_keeps_fp32_masters():
    cfg = Params({**CFG, "bf16": True, "attention_levels": []})
    task = SDFTask(cfg, device="cpu", training=True, generator=torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in task.unet.named_parameters()}
    state = create_state(task.unet, 1e-3, 1.0, bf16=True)
    assert all(m.dtype == torch.float32 for m in state.weights.masters)
    assert task.unet.out[2].weight.dtype == torch.bfloat16  # the working copy
    assert task.unet.out[0].weight.dtype == torch.float32  # norms stay fp32
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy((rng.random((B, 2, HW, HW)) > 0.9).astype(np.uint8)), None,
             torch.from_numpy((rng.random((B, 32, 36)) > 0.8).astype(np.float32)), None)
    metrics = make_train_step(task)(state, batch, seed=0)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    masters = state.params()
    assert not torch.equal(masters["out.2.weight"], before["out.2.weight"])  # the masters moved
    for name, p in task.unet.named_parameters():
        assert torch.equal(p, masters[name].to(p.dtype)), name  # the working copy follows them


def test_train_step_randomness_repeats_per_step():
    """Each step's t, noise and CFG coin come from (seed, step) alone."""
    from polyffusion_tpu_torch.train.step import step_generator

    task = SDFTask(Params({**CFG, "attention_levels": []}), device="cpu")
    batch = (torch.zeros(B, 2, HW, HW), None, torch.zeros(B, 32, 36), None)
    a = task.draw_noise(batch, step_generator(7, 3, task.device))
    b = task.draw_noise(batch, step_generator(7, 3, task.device))
    c = task.draw_noise(batch, step_generator(7, 4, task.device))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.noise, c.noise)
    assert a.t.shape == (B,) and a.noise.shape == (B, 2, HW, HW) and a.drop.dtype == torch.bool


# -- the chord condition in training (fault of the first slice) -------------------------


def test_loss_backward_reaches_unet_not_chord_encoder():
    """``encode_chord`` ran under inference_mode, whose output cannot be saved
    for a backward: a training loss with ``use_enc`` raised."""
    cfg = Params({**CFG, "use_enc": True, "d_cond": 512, "attention_levels": [],
                  "cond_mode": "mix"})
    enc = ChordEncoder(36, 16, 512)
    init_weights_(enc, torch.Generator().manual_seed(1))
    task = SDFTask(cfg, enc, device="cpu", training=True, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    batch = (torch.from_numpy((rng.random((B, 2, HW, HW)) > 0.9).astype(np.float32)), None,
             torch.from_numpy((rng.random((B, 32, 36)) > 0.8).astype(np.float32)), None)
    for drop in (False, True):
        task.unet.zero_grad()
        noise = StepNoise(torch.tensor([10, 900]), torch.randn(B, 2, HW, HW), torch.tensor(drop))
        loss, _ = task.loss_fn(batch, noise)
        loss.backward()
        for name, p in task.unet.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert all(p.grad is None for p in enc.parameters())


# -- data -----------------------------------------------------------------------------


def test_dataset_items_match_jax(data_dir):
    ds = SegmentDataset.from_dir(data_dir)
    jds = JaxSegmentDataset.from_dir(data_dir)
    assert len(ds) == len(jds) > 16
    for i in (0, 5, len(ds) - 1):
        for a, w in zip(ds[i], jds[i]):
            np.testing.assert_array_equal(a, w)
    tr, va = SegmentDataset.train_val_from_dir(data_dir, 0.75)
    jtr, jva = JaxSegmentDataset.train_val_from_dir(data_dir, 0.75)
    assert (len(tr), len(va)) == (len(jtr), len(jva))


def test_batch_loader_matches_jax(data_dir):
    ds = SegmentDataset.from_dir(data_dir)
    jds = JaxSegmentDataset.from_dir(data_dir)
    got = list(BatchLoader(ds, 8, augment=True, shuffle=True, seed=5))
    want = list(JaxBatchLoader(jds, 8, augment=True, shuffle=True, seed=5))
    assert len(got) == len(want) == len(ds) // 8
    for g, w in zip(got, want):
        for a, b_ in zip(g, w):
            np.testing.assert_array_equal(a, b_)


def test_feeder_strips_and_compresses(data_dir):
    from polyffusion_tpu_torch.data import decompress_batch

    ds = SegmentDataset.from_dir(data_dir)
    loader = BatchLoader(ds, 4)
    feeder = DeviceFeeder(loader, "cpu", used_fields={"prmat2c", "chord"})
    got = next(iter(feeder))
    want = next(iter(loader))
    assert got.prmat2c.dtype == torch.uint8 and got.pnotree.shape == (4, 1)
    full = decompress_batch(got)
    np.testing.assert_array_equal(full.prmat2c.numpy(), want.prmat2c)
    np.testing.assert_array_equal(full.chord.numpy(), want.chord)
    assert len(list(feeder)) == len(loader)


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_frozen_chord_encoder_loads(tmp_path, fmt):
    """``chd8bar.pt`` in the reference's layout and ``chd8bar.npz`` as the JAX
    package's converter writes it give the same encoder."""
    from polyffusion_tpu.convert.__main__ import save_params_npz
    from polyffusion_tpu.convert.torch_import import chord_encoder_params_from_torch
    from polyffusion_tpu_torch.models.encoders import build_frozen_encoders

    src = ChordEncoder(36, 16, 512)
    init_weights_(src, torch.Generator().manual_seed(4))
    sd = {f"chord_enc.{k}": v for k, v in src.state_dict().items()}
    if fmt == "pt":
        torch.save({"model": sd}, tmp_path / "chd8bar.pt")
    else:
        tree = chord_encoder_params_from_torch(
            {k[len("chord_enc."):]: v.numpy() for k, v in sd.items()})
        save_params_npz({"chord_enc": tree}, str(tmp_path / "chd8bar.npz"))
    cfg = Params({**CFG, "use_enc": True, "chd_hidden_dim": 16, "chd_z_dim": 512})
    enc = build_frozen_encoders(cfg, str(tmp_path))["chord_enc"]
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(enc.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(FileNotFoundError):
        build_frozen_encoders(cfg, str(tmp_path / "missing"))


# -- the Trainer ----------------------------------------------------------------------

LOOP_CFG = dict(CFG, channels=32, channel_multipliers=[1], attention_levels=[], max_epoch=4,
                cond_mode="mix")


def _loop_batches():
    """One batch, compressed as the feeder sends it: each epoch is one step."""
    rng = np.random.default_rng(4)
    batch = (torch.from_numpy((rng.random((B, 2, HW, HW)) > 0.9).astype(np.uint8)), None,
             torch.from_numpy((rng.random((B, 32, 36)) > 0.8).astype(np.uint8)), None)
    return [batch]


def _fit(out_dir, max_steps, resume):
    task = SDFTask(Params(LOOP_CFG), device="cpu", training=True,
                   generator=torch.Generator().manual_seed(0))
    trainer = Trainer(task, Params(LOOP_CFG), str(out_dir), max_steps=max_steps, log_every=1)
    return trainer.fit(_loop_batches(), _loop_batches(), seed=3, resume=resume)


def test_trainer_resume_repeats_a_straight_run(tmp_path):
    straight = _fit(tmp_path / "straight", 4, resume=False)
    _fit(tmp_path / "split", 2, resume=False)
    resumed = _fit(tmp_path / "split", 4, resume=True)
    assert straight.step == resumed.step == 4
    for (k, a), b_ in zip(straight.params().items(), resumed.params().values()):
        torch.testing.assert_close(a, b_, rtol=0, atol=0, msg=k)
    for a, b_ in zip(straight.ema, resumed.ema):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)

    run = tmp_path / "straight"
    records = [json.loads(line) for line in open(run / "metrics.jsonl")]
    train = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(r["steps_per_sec"] > 0 and np.isfinite(r["train/grad_norm"]) for r in train)
    assert any("val/loss" in r for r in records)
    assert (run / "params.yaml").exists() and (run / "chkpts" / "last.pt").exists()
    best = json.load(open(run / "chkpts" / "best.json"))
    assert 1 <= len(best) <= 3
    assert all((run / "chkpts" / f"step_{e['step']}.pt").exists() for e in best)


def test_trainer_raises_on_nan_loss(tmp_path):
    task = SDFTask(Params(LOOP_CFG), device="cpu", training=True,
                   generator=torch.Generator().manual_seed(0))
    (batch,) = _loop_batches()
    poisoned = [(torch.full(batch[0].shape, float("nan")),) + batch[1:]]
    trainer = Trainer(task, Params(LOOP_CFG), str(tmp_path / "nan"), max_steps=2, log_every=1)
    with pytest.raises(RuntimeError, match="non-finite loss"):
        trainer.fit(poisoned, poisoned, resume=False)
    assert os.path.exists(tmp_path / "nan" / "params.yaml")
