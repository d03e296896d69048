"""A distilled config (``v_prediction``, ``distill_grid``, ``distilled_scale``,
as the distill CLI writes them) builds in the port: ``v_prediction`` wraps the
net's output into eps, held against JAX's adapter
(``polyffusion_tpu/tasks/sdf.py:71-80``); ``distill_grid`` alone or
``distilled_scale`` alone builds an eps task, as in JAX (only the session
reads them); the inference CLI's task build takes a student."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.inference import InferenceSession, build_task_for_inference
from polyffusion_tpu_torch.models.encoders import ChordEncoder
from polyffusion_tpu_torch.tasks.sdf import SDFTask

DISTILLED = [
    {"v_prediction": True, "distill_grid": [251, 751]},
    {"v_prediction": True},
    {"distill_grid": [251, 751]},
    {"distilled_scale": 5.0},
]
TINY = dict(channels=32, channel_multipliers=[1], attention_levels=[], n_res_blocks=1, img_h=16,
            img_w=16)
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4  # the UNet tolerance of tests/test_unet_parity.py:68


def _cfg(**over):
    return Params({**load_params("sdf_chd8bar"), "chd_hidden_dim": 16, "bf16": False, **TINY,
                   **over})


@pytest.mark.parametrize("over", DISTILLED)
def test_task_builds_a_distilled_config(over):
    """The port's eps on JAX-initialised weights against JAX's: the adapter's
    for a v model, the net's own for the others."""
    cfg = _cfg(**over)
    jtask = JaxSDFTask(JaxParams(cfg))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    task = SDFTask(cfg, chord_enc=ChordEncoder(36, 16, 512), device="cpu")
    task.load_unet_state(unet_state_from_jax(params))
    assert task.v_prediction == jtask.v_prediction == bool(over.get("v_prediction"))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    t = np.array([990, 20], np.int32)
    cond = rng.standard_normal((2, 1, cfg.d_cond)).astype(np.float32)
    want = jtask.apply_eps(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = task.apply_eps(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                             torch.from_numpy(cond))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=UNET_ATOL, rtol=UNET_RTOL)


@pytest.mark.parametrize("over", DISTILLED[:1])
def test_inference_task_build_takes_a_student(over, tmp_path):
    """The inference CLI's task build, with a seeded random chord encoder in
    the reference's ``chd8bar.pt`` layout; the session pins the student's
    grid."""
    torch.manual_seed(0)
    enc = ChordEncoder(36, 16, 512)
    torch.save({"model": {f"chord_enc.{k}": v for k, v in enc.state_dict().items()}},
               tmp_path / "chd8bar.pt")
    task = build_task_for_inference(_cfg(**over), str(tmp_path), device="cpu")
    assert task.v_prediction
    session = InferenceSession(task, use_ddim=True, device="cpu")
    np.testing.assert_array_equal(session.ddim.time_steps, over["distill_grid"])
    assert session.ddim_label == "ddim2_eta0.0_distilled"


def test_an_eps_config_is_still_built():
    task = SDFTask(_cfg(v_prediction=False), chord_enc=ChordEncoder(36, 16, 512), device="cpu")
    assert task.unet is not None and not task.v_prediction
