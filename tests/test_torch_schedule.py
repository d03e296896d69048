"""The port's schedule tables equal the JAX package's bit for bit."""

import numpy as np
import pytest

from polyffusion_tpu.diffusion import schedule as jax_schedule
from polyffusion_tpu_torch.config import load_params
from polyffusion_tpu_torch.diffusion import schedule as port_schedule


def _schedules(module):
    cfg = load_params("sdf_chd8bar")
    return module.make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end)


def _assert_tables_equal(a, b):
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


def test_noise_schedule_equal():
    _assert_tables_equal(_schedules(port_schedule), _schedules(jax_schedule))


@pytest.mark.parametrize("discretize", ["uniform", "quad"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_schedule_equal(discretize, eta):
    port = port_schedule.make_ddim_schedule(_schedules(port_schedule), 50, discretize, eta)
    ref = jax_schedule.make_ddim_schedule(_schedules(jax_schedule), 50, discretize, eta)
    _assert_tables_equal(port, ref)
