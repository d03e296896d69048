"""The port's chord encoder against the JAX package's, fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from polyffusion_tpu.models.encoders import ChordEncoder as JaxChordEncoder
from polyffusion_tpu_torch.convert import chord_encoder_state_from_jax
from polyffusion_tpu_torch.models.encoders import ChordEncoder


def test_chord_encoder_matches_jax():
    jm = JaxChordEncoder(hidden_dim=16, z_dim=32)
    chord = np.random.default_rng(0).standard_normal((3, 32, 36)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(chord))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    mu_j, std_j = jm.apply({"params": params}, jnp.asarray(chord))

    tm = ChordEncoder(36, 16, 32)
    tm.load_state_dict(chord_encoder_state_from_jax(params), strict=True)
    with torch.no_grad():
        mu, std = tm(torch.from_numpy(chord))
    # the tolerance of tests/test_encoder_parity.py:50
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=2e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(std_j), atol=2e-5, rtol=1e-5)
