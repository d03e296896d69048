"""A distilled (v-prediction) config is refused by the port, which samples and
trains eps-prediction nets only: JAX wraps such a net's output into eps
(``polyffusion_tpu/tasks/sdf.py:71-80``) and refuses to train it (:204-207);
until distillation is ported (``ROADMAP.md`` item 9) the port must not read a
v-prediction as eps."""

import pytest
import torch

from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.inference import build_task_for_inference
from polyffusion_tpu_torch.models.encoders import ChordEncoder
from polyffusion_tpu_torch.tasks.sdf import SDFTask

DISTILLED = [
    {"v_prediction": True, "distill_grid": 4},
    {"v_prediction": True},
    {"distill_grid": 4},
    {"distilled_scale": 5.0},
]


def _cfg(**over):
    return Params({**load_params("sdf_chd8bar"), "chd_hidden_dim": 16, **over})


@pytest.mark.parametrize("over", DISTILLED)
def test_task_refuses_a_distilled_config(over):
    with pytest.raises(NotImplementedError, match="item 9"):
        SDFTask(_cfg(**over), chord_enc=ChordEncoder(36, 16, 512), device="cpu")


@pytest.mark.parametrize("over", DISTILLED[:1])
def test_inference_task_build_refuses_a_distilled_config(over, tmp_path):
    """The inference CLI's task build, with a seeded random chord encoder in
    the reference's ``chd8bar.pt`` layout."""
    torch.manual_seed(0)
    enc = ChordEncoder(36, 16, 512)
    torch.save({"model": {f"chord_enc.{k}": v for k, v in enc.state_dict().items()}},
               tmp_path / "chd8bar.pt")
    with pytest.raises(NotImplementedError, match="item 9"):
        build_task_for_inference(_cfg(**over), str(tmp_path), device="cpu")


def test_an_eps_config_is_still_built():
    task = SDFTask(_cfg(v_prediction=False, channels=32, channel_multipliers=[1],
                        attention_levels=[], n_res_blocks=1),
                   chord_enc=ChordEncoder(36, 16, 512), device="cpu")
    assert task.unet is not None
