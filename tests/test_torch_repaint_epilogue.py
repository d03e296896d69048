"""The RePaint epilogue (kernel 7): the port's plain version against the JAX
package's Pallas kernel in interpret mode and its plain composition, with the
scalars the DDPM sampler gives it at the first, a middle and the last step of
the preset's schedule; the wrapper's CPU route and its checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from polyffusion_tpu.ops.pallas_sampler import fused_repaint_epilogue as jax_epilogue
from polyffusion_tpu.ops.pallas_sampler import repaint_epilogue_reference as jax_reference
from polyffusion_tpu_torch.config import load_params
from polyffusion_tpu_torch.diffusion.sampler import _epilogue_scalars
from polyffusion_tpu_torch.diffusion.schedule import make_schedule
from polyffusion_tpu_torch.ops.repaint_epilogue import (
    fused_repaint_epilogue,
    repaint_epilogue_reference,
)

ATOL, RTOL = 1e-6, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps test workers that share the cores from oversubscribing
    them (each thread pool spins while it waits for the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preset_schedules():
    cfg = load_params("sdf_chd8bar")
    args = (cfg.n_steps, cfg.linear_start, cfg.linear_end)
    return make_schedule(*args), jax_make_schedule(*args)


def _jax_scalars(tbl, step):
    """The scalars as ``polyffusion_tpu/diffusion/sampler.py:237-247`` stacks them."""
    zero = jnp.float32(0.0)
    return jnp.stack([
        tbl.sqrt_recip_alpha_bar[step],
        tbl.sqrt_recip_m1_alpha_bar[step],
        tbl.mean_x0_coef[step],
        tbl.mean_xt_coef[step],
        jnp.where(step == 0, zero, jnp.exp(0.5 * tbl.log_var[step])),
        tbl.sqrt_alpha_bar[step],
        jnp.where(step > 0, tbl.sqrt_1m_alpha_bar[step], zero),
    ])


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    five = [rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
    mask = (rng.random(shape) < 0.5).astype(np.float32)
    return five + [mask]  # x, eps, p_noise, orig, q_noise, mask


@pytest.mark.parametrize("step", [999, 500, 0])
@pytest.mark.parametrize("shape", [(2, 16, 16, 2), (1, 2, 128, 128)])
def test_plain_version_matches_pallas_kernel(shape, step):
    sched, jsched = _preset_schedules()
    jtbl = jsched._replace(**{k: jnp.asarray(v) for k, v in jsched._asdict().items()})
    scalars = _epilogue_scalars(sched, step)
    jscalars = _jax_scalars(jtbl, jnp.int32(step))
    np.testing.assert_allclose(np.asarray(scalars, np.float32), np.asarray(jscalars), rtol=1e-6)
    if step == 0:
        assert scalars[4] == 0.0 and scalars[6] == 0.0

    arrays = _inputs(shape, seed=step)
    got = repaint_epilogue_reference(*map(torch.from_numpy, arrays), scalars).numpy()
    want_kernel = jax_epilogue(*map(jnp.asarray, arrays), jscalars, interpret=True)
    want_plain = jax_reference(*map(jnp.asarray, arrays), jscalars)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(want_plain), atol=ATOL, rtol=RTOL)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    sched, _ = _preset_schedules()
    tensors = [torch.from_numpy(a) for a in _inputs((2, 2, 16, 16), seed=1)]
    # a permuted layout is fine on the CPU: the plain version is elementwise
    tensors = [t.permute(0, 2, 3, 1) for t in tensors]
    before = fused_repaint_epilogue.launches
    got = fused_repaint_epilogue(*tensors, _epilogue_scalars(sched, 500))
    assert fused_repaint_epilogue.launches == before
    torch.testing.assert_close(got, repaint_epilogue_reference(*tensors, _epilogue_scalars(sched, 500)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["shape", "dtype", "scalars"])
def test_wrapper_raises_on_mismatch(fault):
    tensors = [torch.zeros(1, 2, 8, 8) for _ in range(6)]
    scalars = [1.0] * 7
    if fault == "shape":
        tensors[3] = torch.zeros(1, 2, 8, 4)
    elif fault == "dtype":
        tensors[1] = torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16)
    else:
        scalars = scalars[:6]
    with pytest.raises(ValueError):
        fused_repaint_epilogue(*tensors, scalars)
