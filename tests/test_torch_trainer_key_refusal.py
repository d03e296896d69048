"""Keys whose feature the port has not ported are refused, not ignored:
``remat`` (JAX ``polyffusion_tpu/tasks/sdf.py:218-221``) and
``legacy_checkpoints`` (JAX ``train/loop.py:128-160``) raise
``NotImplementedError`` naming ``ROADMAP.md`` item 19, in ``SDFTask`` and in
the training CLI's task build, for every model family (``ddpm`` and
``autoencoder`` too, ported since items 10 and 11; what they refuse is the
sdf UNet's ``--gn_conv`` route). A key set to false asks for nothing."""

import pytest
import torch

from polyffusion_tpu_torch.config import Params, load_params
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

REFUSED = [{"remat": True}, {"legacy_checkpoints": True},
           {"remat": True, "legacy_checkpoints": True}]
TINY_UNET = dict(channels=32, channel_multipliers=[1], attention_levels=[], n_res_blocks=1)


def _sdf_cfg(**over):
    return Params({**load_params("sdf_chd8bar"), **TINY_UNET, "chd_hidden_dim": 16, **over})


@pytest.mark.parametrize("over", REFUSED)
def test_sdf_task_refuses(over):
    with pytest.raises(NotImplementedError, match="item 19"):
        SDFTask(_sdf_cfg(**over), chord_enc=ChordEncoder(36, 16, 512), device="cpu")


@pytest.mark.parametrize("name", ["sdf_chd8bar", "chd_8bar", "pnotree_vae", "ddpm", "autoencoder"])
@pytest.mark.parametrize("over", REFUSED)
def test_cli_task_build_refuses(name, over):
    """Refused before any weight or file is read: no pretrained_dir needed."""
    cfg = Params({**load_params(name), **over})
    with pytest.raises(NotImplementedError, match="item 19"):
        build_task(cfg, None, device="cpu")


def test_cli_refuses_a_set_key(tmp_path):
    with pytest.raises(NotImplementedError, match="remat.*item 19"):
        train_main(["--model", "chd_8bar", "--output_dir", str(tmp_path / "run"), "--data_dir",
                    str(tmp_path), "--device", "cpu", "--set", "remat=true"])


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
