"""The trainer keys once refused as unported are honoured now (ROADMAP.md item
19, ported since): ``remat`` (JAX ``polyffusion_tpu/tasks/sdf.py:218-221``)
and ``legacy_checkpoints`` (JAX ``train/loop.py:128-180``). Until then each
raised ``NotImplementedError`` in ``SDFTask`` and in the training CLI's task
build; the tests keep their names and cases and show the opposite: ``SDFTask``
builds with either key and, with ``remat``, hands the loss a checkpointed
UNet; every family's ``build_task`` accepts both, and reads neither while
building (``remat`` is read by ``SDFTask``'s loss only, ``legacy_checkpoints``
by the trainer, as in JAX); the CLI trains with ``--set remat=true``. A key
set to false asks for nothing. ``ddpm`` and ``autoencoder`` (ported since
items 10 and 11) refuse only the sdf UNet's ``--gn_conv`` route."""

import functools
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.data import write_song_npz
from polyffusion_tpu_torch.main import build_task
from polyffusion_tpu_torch.main import main as train_main
from polyffusion_tpu_torch.models.encoders import ChordEncoder
from polyffusion_tpu_torch.tasks import (
    AutoencoderTask,
    Chd8BarTask,
    DDPMTask,
    PnoTreeVAETask,
    SDFTask,
)
from polyffusion_tpu_torch.tasks import sdf as sdf_module

# the keys' cases, as when they were refused
REFUSED = [{"remat": True}, {"legacy_checkpoints": True},
           {"remat": True, "legacy_checkpoints": True}]
TINY_UNET = dict(channels=32, channel_multipliers=[1], attention_levels=[], n_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sdf_cfg(**over):
    return Params({**load_params("sdf_chd8bar"), **TINY_UNET, "chd_hidden_dim": 16, **over})


def _loss_apply(task, monkeypatch):
    """The function ``task.loss_fn`` hands ``diffusion_loss`` (the loss itself
    is not run: the tiny UNet's one level attends over 16384 positions)."""
    handed = []
    monkeypatch.setattr(sdf_module, "diffusion_loss",
                        lambda apply, *a: handed.append(apply) or torch.zeros(()))
    batch = (torch.zeros(1, 2, 128, 128), None, torch.zeros(1, 32, 36), None)
    task.loss_fn(batch, sdf_module.StepNoise(torch.tensor([3]), torch.zeros(1, 2, 128, 128),
                                             torch.tensor(False)))
    (apply,) = handed
    return apply


@pytest.mark.parametrize("over", REFUSED)
def test_sdf_task_refuses(over, monkeypatch):
    """Once refused; now ``SDFTask`` builds, and with ``remat`` its loss runs
    the UNet under ``torch.utils.checkpoint`` (non-reentrant, no generator
    state kept: the forward draws no random number)."""
    task = SDFTask(_sdf_cfg(**over), chord_enc=ChordEncoder(36, 16, 512), device="cpu")
    apply = _loss_apply(task, monkeypatch)
    if over.get("remat"):
        assert isinstance(apply, functools.partial) and apply.func is checkpoint
        assert apply.args == (task.apply_eps,)
        assert apply.keywords == {"use_reentrant": False, "preserve_rng_state": False}
    else:
        assert apply == task.apply_eps


class _Recording(Params):
    """A config that records which keys are read."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        object.__setattr__(self, "read", set())

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


# each family at a tiny width (no pretrained encoder file is needed: sdf_chdvnl
# conditions on the raw chord)
TINY = {"sdf_chd8bar": dict(TINY_UNET, use_enc=False, d_cond=32 * 36),
        "chd_8bar": dict(chd_hidden_dim=16, chd_z_input_dim=16, chd_z_dim=16),
        "pnotree_vae": {},
        "ddpm": dict(n_channels=32, channel_multipliers=[1, 2]),
        "autoencoder": dict(channels=32, channel_multipliers=[1, 2], n_res_blocks=1)}
TASKS = {"sdf_chd8bar": SDFTask, "chd_8bar": Chd8BarTask, "pnotree_vae": PnoTreeVAETask,
         "ddpm": DDPMTask, "autoencoder": AutoencoderTask}


@pytest.mark.parametrize("name", ["sdf_chd8bar", "chd_8bar", "pnotree_vae", "ddpm", "autoencoder"])
@pytest.mark.parametrize("over", REFUSED)
def test_cli_task_build_refuses(name, over):
    """Once refused; now every family's task builds with the keys, and the
    build reads neither: ``remat`` is ``SDFTask.loss_fn``'s, and
    ``legacy_checkpoints`` the trainer's."""
    cfg = _Recording({**load_params(name), **TINY[name], **over})
    task = build_task(cfg, None, device="cpu")
    assert isinstance(task, TASKS[name])
    assert not {"remat", "legacy_checkpoints"} & cfg.read


def test_cli_refuses_a_set_key(tmp_path):
    """Once refused; now the CLI trains an sdf preset with ``--set
    remat=true`` (one step and a validation on the CPU) and records the key
    in the run directory's ``params.yaml``."""
    data = tmp_path / "songs"
    data.mkdir()
    rng = np.random.default_rng(0)
    n_beats = 48
    for i in range(3):
        notes = np.stack([np.arange(0, 4 * n_beats, 4), rng.integers(48, 72, n_beats),
                          np.full(n_beats, 2), np.full(n_beats, 80),
                          np.zeros(n_beats, np.int64)], 1)
        chord = np.zeros((n_beats, 14), np.int32)
        db_pos = np.arange(0, 4 * n_beats, 16)
        write_song_npz(str(data / f"{i}.npz"), [notes] * 3, chord, db_pos,
                       db_pos + 128 <= 4 * n_beats, n_beats=n_beats)
    out = str(tmp_path / "run")
    state = train_main(["--model", "sdf_chdvnl", "--output_dir", out, "--data_dir", str(data),
                        "--device", "cpu", "--batch_size", "1", "--max_steps", "1",
                        "--log_every", "1", "--set", "remat=true", "--set", "bf16=false",
                        "--set", "n_steps=10", "--set", "channels=32", "--set",
                        "channel_multipliers=[1,1,1,1]", "--set", "attention_levels=[]",
                        "--set", "n_res_blocks=1"])
    assert state.step == 1
    assert load_params(os.path.join(out, "params.yaml"))["remat"] is True
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert all(np.isfinite(r[k]) for r in records for k in r if k.endswith("/loss"))


@pytest.mark.parametrize("value", [False, None])
def test_a_config_without_them_still_builds(value):
    over = {"remat": value, "legacy_checkpoints": value}
    task = SDFTask(_sdf_cfg(**over), chord_enc=ChordEncoder(36, 16, 512), device="cpu")
    assert task.unet is task.model
    cfg = Params({**load_params("chd_8bar"), **over, "chd_hidden_dim": 16})
    assert isinstance(build_task(cfg, None, device="cpu"), Chd8BarTask)


# the two families ROADMAP.md items 10 and 11 ported, at a tiny width
ONCE_UNPORTED = {"ddpm": dict(n_channels=32, channel_multipliers=[1, 2]),
                 "autoencoder": dict(channels=32, channel_multipliers=[1, 2], n_res_blocks=1)}


@pytest.mark.parametrize("name, item", [("ddpm", 10), ("autoencoder", 11)])
def test_unported_families_are_refused(name, item):
    """Once refused as unported (ROADMAP.md items 10 and 11): ``build_task``
    now builds each family's task on the CPU, with fp32 weights from the
    seed, and refuses only the GroupNorm-SiLU-conv route they do not have."""
    cfg = Params({**load_params(name), **ONCE_UNPORTED[name]})
    task = build_task(cfg, None, device="cpu", seed=item)
    assert isinstance(task, DDPMTask if name == "ddpm" else AutoencoderTask)
    assert task.device == torch.device("cpu") and task.bf16 is False
    assert all(p.dtype == torch.float32 for p in task.model.parameters())
    again = build_task(cfg, None, device="cpu", seed=item).model.state_dict()
    assert all(torch.equal(v, again[k]) for k, v in task.model.state_dict().items())
    with pytest.raises(ValueError, match="gn_conv"):
        build_task(cfg, None, device="cpu", gn_conv="fused")


@pytest.mark.parametrize("name", ["chd_8bar", "pnotree_vae"])
def test_vae_tasks_refuse_a_gn_conv_route(name):
    """``--gn_conv`` is the sdf UNet's; a VAE has no such sites."""
    with pytest.raises(ValueError, match="gn_conv"):
        build_task(load_params(name), None, device="cpu", gn_conv="fused")


@pytest.mark.parametrize("cls", [Chd8BarTask, PnoTreeVAETask, DDPMTask, AutoencoderTask])
def test_vae_tasks_raise_without_cuda(cls, monkeypatch):
    """``device=None`` means CUDA, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(load_params(cls.name))
