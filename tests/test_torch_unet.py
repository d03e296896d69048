"""The port's UNet against the JAX package's at a tiny size, fp32 on the CPU,
with the same JAX-initialised weights; and the weight converters."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.convert.torch_export import save_reference_checkpoint, unet_params_to_torch
from polyffusion_tpu.models.unet import UNetModel as JaxUNet
from polyffusion_tpu.models.unet import timestep_embedding as jax_timestep_embedding
from polyffusion_tpu_torch.convert import load_reference_checkpoint, unet_state_from_jax
from polyffusion_tpu_torch.models.unet import UNetModel, timestep_embedding

# the widths of tests/test_unet_parity.py:24-34
TINY = dict(
    in_channels=2,
    out_channels=2,
    channels=32,
    n_res_blocks=1,
    attention_levels=(1,),
    channel_multipliers=(1, 2),
    n_heads=2,
    tf_layers=1,
    d_cond=12,
)


def _jax_params(cfg, seed, hw=16):
    jm = JaxUNet(**cfg)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, hw, hw, cfg["in_channels"])),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 3, cfg["d_cond"])),
    )["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port(cfg, params):
    tm = UNetModel(**cfg)
    tm.load_state_dict(unet_state_from_jax(params), strict=True)
    return tm.eval()


def test_timestep_embedding_matches_jax():
    t = np.arange(0, 1000, 37)
    got = timestep_embedding(torch.from_numpy(t), 32).numpy()
    want = np.asarray(jax_timestep_embedding(jnp.asarray(t), 32))
    np.testing.assert_allclose(got, want, atol=2e-6)


# n_heads=1 gives heads of 64 at 256 tokens: the packed-attention path
@pytest.mark.parametrize("seed,n_heads,hw", [(0, 2, 16), (1, 2, 16), (2, 1, 32)])
def test_unet_forward_matches_jax(seed, n_heads, hw):
    cfg = {**TINY, "n_heads": n_heads}
    jm, params = _jax_params(cfg, seed, hw)
    tm = _port(cfg, params)

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, hw, hw), dtype=np.float32)
    t = np.array([3, 977], dtype=np.int64)
    cond = rng.standard_normal((2, 3, 12), dtype=np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)).numpy()
    want_nhwc = jax.jit(jm.apply)(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(cond)
    )
    want = np.asarray(want_nhwc).transpose(0, 3, 1, 2)
    # the tolerance of tests/test_unet_parity.py:68
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_unet_state_equals_jax_export():
    _, params = _jax_params(TINY, 3)
    port = unet_state_from_jax(params)
    ref = unet_params_to_torch(params)
    assert set(port) == set(ref)
    assert set(port) == set(UNetModel(**TINY).state_dict())
    for k, v in ref.items():
        assert port[k].dtype == torch.float32
        np.testing.assert_array_equal(port[k].numpy(), v, err_msg=k)


def test_reference_checkpoint_loads_strictly():
    jm, params = _jax_params(TINY, 4)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "weights.pt")
        save_reference_checkpoint(params, path)
        tm = load_reference_checkpoint(path, UNetModel(**TINY))
    want = unet_state_from_jax(params)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_sampling_precision_policy():
    from polyffusion_tpu_torch.models.unet import GroupNorm32
    from polyffusion_tpu_torch.utils.precision import cast_sampling_params

    _, params = _jax_params(TINY, 5)
    tm = _port(TINY, params)
    x = torch.randn(2, 2, 16, 16, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([3, 977])
    cond = torch.randn(2, 3, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tm(x, t, cond)
        cast_sampling_params(tm)
        got = tm(x, t, cond)
    for mod in tm.modules():
        for p in mod.parameters(recurse=False):
            norm = isinstance(mod, (GroupNorm32, torch.nn.LayerNorm))
            assert p.dtype == (torch.float32 if norm else torch.bfloat16)
    assert got.dtype == torch.float32
    # bf16 weights and activations against fp32: a loose check of the dtype plumbing
    assert (got - want).abs().max().item() < 0.1 * want.abs().max().item() + 0.05
