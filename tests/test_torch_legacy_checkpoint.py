"""The trainer's leftovers: the legacy ``weights.pt`` mirror (JAX
``train/loop.py:128-180``) and the ``--profile_steps`` window (JAX
``main.py:132-146``, ``train/loop.py:254-265``).

The port's ``export_learner_checkpoint`` writes, from the port's fp32 weights
and ``torch.optim.Adam`` state, the file the JAX package's writes from the same
weights and an optax state holding the same moments (no JAX train step: the
moments are seeded NumPy arrays). A short CPU run with ``legacy_checkpoints:
true`` writes ``weights.pt``, ``weights_best.pt`` and ``info.txt``, and
``load_unet_params`` reads ``weights.pt`` back to the run's weights; a run
with a profiled window writes one Chrome trace of its steps and trains as a
run without one."""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.convert.torch_export import (
    export_learner_checkpoint as jax_export_learner_checkpoint,
)
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.convert.torch_export import (
    export_learner_checkpoint,
    reference_param_keys,
)
from polyffusion_tpu_torch.convert.torch_import import unet_params_from_torch
from polyffusion_tpu_torch.data import SegmentDataset, make_loaders, write_song_npz
from polyffusion_tpu_torch.inference import load_unet_params
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.train import Trainer, create_state

# a tiny UNet with attention (bias-free q/k/v), skip convolutions and both
# re-samplers: every kind of unet_param_order
TINY = dict(
    model_name="sdf_tiny", batch_size=2, learning_rate=5e-5, max_grad_norm=10, bf16=False,
    in_channels=2, out_channels=2, channels=32, attention_levels=[1], n_res_blocks=1,
    channel_multipliers=[1, 2], n_heads=2, tf_layers=1, d_cond=1152, linear_start=0.00085,
    linear_end=0.012, n_steps=20, img_h=16, img_w=16, cond_type="chord", cond_mode="cond",
    use_enc=False,
)
COUNT = 7  # Adam steps the moments stand for


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def same_state():
    """A JAX ``UNetModel`` tree (the port's seeded init, converted: its keys and
    shapes are flax's, ``tests/test_torch_convert_cli.py``) and an optax state
    holding seeded moments; the port's task and train state with the same
    weights and Adam moments."""
    jtask = JaxSDFTask(JaxParams(TINY))  # its schedule; the tree is the port's init's
    task = SDFTask(Params(TINY), device="cpu", training=True,
                   generator=torch.Generator().manual_seed(0))
    params = unet_params_from_torch(
        {k: v.detach().numpy() for k, v in task.unet.state_dict().items()})
    rng = np.random.default_rng(1)
    mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: rng.random(a.shape).astype(np.float32), params)
    opt_state = jax_make_optimizer(TINY["learning_rate"], TINY["max_grad_norm"]).init(params)
    opt_state = jax.tree_util.tree_map(
        lambda s: s._replace(count=np.int32(COUNT), mu=mu, nu=nu) if hasattr(s, "mu") else s,
        opt_state, is_leaf=lambda s: hasattr(s, "mu"))

    assert all(torch.equal(w, unet_state_from_jax(params)[k])
               for k, w in task.unet.state_dict().items())
    state = create_state(task.unet, TINY["learning_rate"], TINY["max_grad_norm"])
    exp_avg, exp_avg_sq = unet_state_from_jax(mu), unet_state_from_jax(nu)
    sd = state.optimizer.state_dict()
    names = list(state.params())
    sd["state"] = {i: {"step": torch.tensor(float(COUNT)), "exp_avg": exp_avg[n],
                       "exp_avg_sq": exp_avg_sq[n]} for i, n in enumerate(names)}
    state.optimizer.load_state_dict(sd)
    return jtask, params, opt_state, task, state


@pytest.mark.parametrize("case", ["moments", "moments_fp16", "no_optimizer"])
def test_weights_pt_equals_jax_export(same_state, tmp_path, case):
    jtask, params, opt_state, task, state = same_state
    kwargs = dict(step=11, epoch=3, learning_rate=TINY["learning_rate"],
                  fp16=case == "moments_fp16")
    with_opt = case != "no_optimizer"
    jax_export_learner_checkpoint(params, str(tmp_path / "jax.pt"), schedule=jtask.schedule,
                                  opt_state=opt_state if with_opt else None, **kwargs)
    export_learner_checkpoint(state.params(), str(tmp_path / "port.pt"), schedule=task.schedule,
                              opt_state=state.optimizer.state_dict() if with_opt else None,
                              **kwargs)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    assert list(got) == list(want) == ["step", "epoch", "model", "optimizer", "scaler"]
    assert (got["step"], got["epoch"], got["scaler"]) == (want["step"], want["epoch"],
                                                           want["scaler"])
    assert list(got["model"]) == list(want["model"])
    for k, w in want["model"].items():
        assert got["model"][k].dtype == w.dtype and torch.equal(got["model"][k], w), k
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    gs, ws = got["optimizer"]["state"], want["optimizer"]["state"]
    assert list(gs) == list(ws) and (len(ws) > 0) == with_opt
    for i, w in ws.items():
        assert list(gs[i]) == list(w) == ["step", "exp_avg", "exp_avg_sq"]
        assert all(torch.equal(gs[i][k], w[k]) for k in w), i


def test_param_keys_are_the_reference_order(same_state):
    """Kernels and biases alternate in module order, not the port's
    ``named_parameters()`` order; every UNet parameter appears once."""
    _, _, _, task, state = same_state
    keys = reference_param_keys(state.params())
    assert sorted(keys) == sorted(n for n, _ in task.unet.named_parameters())
    assert keys[:4] == ["time_embed.0.weight", "time_embed.0.bias", "time_embed.2.weight",
                        "time_embed.2.bias"]
    block = [k for k in keys if k.startswith("middle_block.1.transformer_blocks.0.")]
    assert block[:5] == [f"middle_block.1.transformer_blocks.0.attn1.{p}.weight"
                         for p in ("to_q", "to_k", "to_v")] + [
        "middle_block.1.transformer_blocks.0.attn1.to_out.0.weight",
        "middle_block.1.transformer_blocks.0.attn1.to_out.0.bias"]
    assert keys[-4:] == ["out.0.weight", "out.0.bias", "out.2.weight", "out.2.bias"]


# -- the trainer on the CPU -------------------------------------------------------------

# four levels put the middle block's attention at 16 x 16 tokens of the 128 x 128 roll
RUN = dict(channels=32, channel_multipliers=[1, 1, 1, 1], attention_levels=[], n_res_blocks=1,
           bf16=False, n_steps=10, use_enc=False, d_cond=32 * 36, batch_size=2)
STEPS = 4


def _write_song(path, seed, n_bars=12):
    rng = np.random.default_rng(seed)
    n_beats = n_bars * 4
    n_bins = n_beats * 4
    tracks = []
    for t in range(3):
        n = int(rng.integers(30, 50))
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


def _fit(tmp_path, name, legacy, profile_steps=None):
    data = tmp_path / "songs"
    if not data.exists():
        data.mkdir()
        for i in range(3):
            _write_song(str(data / f"{i}.npz"), seed=i)
    cfg = Params({**load_params("sdf_chd8bar"), **RUN, "legacy_checkpoints": legacy})
    task = SDFTask(cfg, device="cpu", training=True, generator=torch.Generator().manual_seed(0))
    train_ds, val_ds = SegmentDataset.train_val_from_dir(str(data), 0.7)
    train_dl, val_dl = make_loaders(train_ds, val_ds, cfg.batch_size, "cpu", seed=0,
                                    used_fields=task.used_batch_fields)
    out = str(tmp_path / name)
    state = Trainer(task, cfg, out, max_steps=STEPS, log_every=1,
                    profile_steps=profile_steps).fit(train_dl, val_dl, resume=False)
    assert state.step == STEPS
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    return out, state, [r["train/loss"] for r in records if "train/loss" in r]


@pytest.fixture(scope="module")
def legacy_run(tmp_path_factory):
    return _fit(tmp_path_factory.mktemp("legacy"), "run", legacy=True)


def test_legacy_checkpoint_writing(legacy_run):
    """As JAX ``tests/test_train_e2e.py::test_legacy_checkpoint_writing``."""
    out, state, _ = legacy_run
    ck_dir = os.path.join(out, "chkpts")
    for fn in ("weights.pt", "weights_best.pt", "info.txt"):
        assert os.path.exists(os.path.join(ck_dir, fn)), fn
    ck = torch.load(os.path.join(ck_dir, "weights.pt"), weights_only=True)
    assert set(ck) == {"step", "epoch", "model", "optimizer", "scaler"}
    assert ck["step"] == STEPS and ck["epoch"] == 0
    assert any(k.startswith("ldm.eps_model.") for k in ck["model"])
    n_unet = sum(1 for _ in state.weights.module.parameters())
    assert len(ck["optimizer"]["state"]) == n_unet  # every moment, after the schedule's 3
    assert ck["optimizer"]["param_groups"][0]["params"] == list(range(3 + n_unet))
    assert all(float(s["step"]) == STEPS for s in ck["optimizer"]["state"].values())
    (best,) = json.load(open(os.path.join(ck_dir, "best.json")))
    assert open(os.path.join(ck_dir, "info.txt")).read() == f"0{best['val_loss']}"
    best_ck = torch.load(os.path.join(ck_dir, "weights_best.pt"), weights_only=True)
    assert all(torch.equal(best_ck["model"][k], v) for k, v in ck["model"].items())


def test_load_unet_params_reads_weights_pt_back(legacy_run):
    out, _, _ = legacy_run
    want = torch.load(os.path.join(out, "chkpts", "last.pt"), weights_only=True)["params"]
    for fn in ("weights.pt", "weights_best.pt"):
        got = load_unet_params(os.path.join(out, "chkpts", fn))
        assert set(got) == set(want)
        assert all(torch.equal(got[k], w) for k, w in want.items()), fn


def test_profile_window_writes_one_trace(legacy_run, tmp_path, capsys):
    """Steps 1 and 2 traced: one Chrome trace with one ``train_step`` span
    each, JAX's ``[profile]`` line, and the same losses as the run without a
    window (which also wrote the legacy files: they change no update)."""
    _, _, want_losses = legacy_run
    out, _, losses = _fit(tmp_path, "run", legacy=False, profile_steps=(1, 3))
    assert f"[profile] trace written to {out}/profile" in capsys.readouterr().out
    (trace,) = os.listdir(os.path.join(out, "profile"))
    assert trace == "trace_steps_1_3.json"
    events = json.load(open(os.path.join(out, "profile", trace)))["traceEvents"]
    spans = sorted(e["name"] for e in events if str(e.get("name", "")).startswith("train_step "))
    assert spans == ["train_step 1", "train_step 2"]
    assert losses == want_losses
    assert not os.path.exists(os.path.join(out, "chkpts", "weights.pt"))


def test_profile_steps_must_be_a_window(tmp_path):
    task = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="START < STOP"):
        Trainer(task, Params(learning_rate=1e-4), str(tmp_path), profile_steps=(3, 3))


@pytest.mark.parametrize("task, line", [
    (types.SimpleNamespace(device=torch.device("cpu")),
     "[legacy ckpt] skipped: task has no diffusion schedule (SDF only)"),
    (types.SimpleNamespace(device=torch.device("cpu"), schedule=None, model=nn.Linear(2, 2)),
     "[legacy ckpt] skipped: the learner layout holds the sdf UNet only (SDF only)"),
])
def test_legacy_mirror_skips_other_tasks(task, line, tmp_path, capsys):
    """JAX prints the first line for a task without a schedule; the DDPM
    family has one but not the sdf UNet (JAX's exporter raises a KeyError
    there)."""
    trainer = Trainer(task, Params(learning_rate=1e-4, legacy_checkpoints=True), str(tmp_path))
    trainer._save_legacy(None, 1.0, 0)
    assert line in capsys.readouterr().out
    assert not os.path.exists(os.path.join(str(tmp_path), "chkpts", "weights.pt"))
