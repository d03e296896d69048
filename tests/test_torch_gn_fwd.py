"""Kernel 8's dispatch and plain code on the CPU (``ops/gn_fwd.py``).

The kernel itself runs on the card only (``tests/test_torch_kernels_cuda.py``).
Here ``KERNEL_DEVICES`` is widened to the CPU, so that the models' dispatch
sends each GroupNorm it would give the kernel to ``group_norm_silu``, whose
plain code then stands in for the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from polyffusion_tpu.models.unet import UNetModel as JaxUNet
from polyffusion_tpu_torch import tracing
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.models import unet as unet_mod
from polyffusion_tpu_torch.models.unet import GroupNorm32, UNetModel
from polyffusion_tpu_torch.ops import gn_fwd
from polyffusion_tpu_torch.ops.gn_bwd import gn_primal, group_norm_affine
from polyffusion_tpu_torch.ops.gn_fwd import gn_fwd_plan, group_norm_silu, kernel_takes
from polyffusion_tpu_torch.utils.precision import cast_sampling_params

# the widths of tests/test_unet_parity.py:24-34
TINY = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1, attention_levels=(1,),
            channel_multipliers=(1, 2), n_heads=2, tf_layers=1, d_cond=12)
# sdf_chd8bar (params/sdf_chd8bar.yaml)
SDF = dict(in_channels=2, out_channels=2, channels=64, n_res_blocks=2, attention_levels=(2, 3),
           channel_multipliers=(1, 2, 4, 4), n_heads=4, tf_layers=1, d_cond=512)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    """The dispatch takes CPU tensors too; returns the list of (x, silu) of
    every ``group_norm_silu`` call the models make."""
    monkeypatch.setattr(gn_fwd, "KERNEL_DEVICES", ("cuda", "cpu"))
    calls = []

    def recording(x, weight, bias, groups, eps, silu=False):
        calls.append((x, silu))
        return group_norm_silu(x, weight, bias, groups, eps, silu)

    monkeypatch.setattr(unet_mod, "group_norm_silu", recording)
    return calls


def _inputs(shape, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    weight = torch.randn(c, generator=g) * 0.5 + 1.0
    bias = torch.randn(c, generator=g) * 0.1
    return x, weight, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("channels_last", [False, True])
def test_plain_code_is_gn_primal_then_silu(dtype, silu, channels_last):
    x, weight, bias = _inputs((2, 256, 8, 8), dtype, channels_last)
    got = group_norm_silu(x, weight, bias, 32, 1e-5, silu)
    want = gn_primal(x, weight, bias, 32, 1e-5)[0]
    want = F.silu(want) if silu else want
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last) == channels_last
    assert torch.equal(got, want)


@pytest.mark.parametrize("silu", [False, True])
def test_plain_code_keeps_no_graph(silu):
    """No gradient flows through ``group_norm_silu``: its output needs none
    under ``no_grad``, and the models call it only there."""
    x, weight, bias = _inputs((1, 32, 4, 8), torch.float32, False)
    with torch.no_grad():
        y = group_norm_silu(x.requires_grad_(), weight.requires_grad_(), bias, 32, 1e-5, silu)
    assert not y.requires_grad


def _jax_and_port(cfg, seed, hw):
    jm = JaxUNet(**cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 2)),
                              jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, cfg["d_cond"])))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = UNetModel(**cfg)
    tm.load_state_dict(unet_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("seed", [0, 1])
def test_unet_inference_mode_equals_autograd_and_jax(on_cpu, seed):
    """Under ``inference_mode`` every GroupNorm of the UNet goes to
    ``group_norm_silu`` (the SiLU inside at the ResBlock sites and the head;
    at these widths the channels-last sites have too few channels a group
    for the channels-last kernel and run as NCHW), and the output equals
    the autograd forward's bit for bit; both match the JAX UNet within
    tests/test_unet_parity.py's tolerance."""
    jm, params, tm = _jax_and_port(TINY, seed, 16)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, 16, 16), dtype=np.float32)
    t = np.array([3, 977], dtype=np.int64)
    cond = rng.standard_normal((2, 3, 12), dtype=np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    with torch.inference_mode():
        fast = tm(*args)
    n_norms = sum(isinstance(m, GroupNorm32) for m in tm.modules())
    assert 0 < sum(silu for _, silu in on_cpu) < len(on_cpu) == n_norms
    del on_cpu[:]
    slow = tm(*args)
    assert slow.requires_grad and on_cpu == []
    assert torch.equal(fast, slow.detach())
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                             jnp.asarray(t), jnp.asarray(cond))
    np.testing.assert_allclose(fast.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               atol=2e-4, rtol=1e-4)


def test_sdf_chd8bar_eval_sends_56_sites_45_with_silu(on_cpu):
    """The flagship's UNet at its widths and in its sampling precision
    (batch 1): all 56 GroupNorms of an evaluation go to the kernel, 45 of
    them with the SiLU, 29 of them channels-last."""
    tm = cast_sampling_params(UNetModel(**SDF).eval())
    with torch.inference_mode():
        tm(torch.zeros(1, 2, 128, 128), torch.zeros(1, dtype=torch.long), torch.zeros(1, 1, 512))
    assert len(on_cpu) == 56 and sum(silu for _, silu in on_cpu) == 45
    assert all(x.dtype == torch.bfloat16 for x, _ in on_cpu)
    assert sum(not x.is_contiguous() for x, _ in on_cpu) == 29


def test_autograd_keeps_group_norm_affine(on_cpu):
    """Under autograd the norm is ``group_norm_affine`` (the gradient flows
    through it), nothing reaches ``group_norm_silu`` and the kernel's
    counters do not move."""
    before = {k: v for k, v in tracing.counters().items() if "group_norm_silu" in k}
    assert set(before) == {"ops.group_norm_silu.launches", "ops.group_norm_silu.silu_launches"}
    gn = GroupNorm32(64)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5)
    x = torch.randn(2, 64, 8, 8, requires_grad=True)
    y = gn(x)
    assert y.grad_fn is not None and on_cpu == []
    assert torch.equal(y, group_norm_affine(x, gn.weight, gn.bias, 32, 1e-5))
    y.square().sum().backward()
    assert x.grad is not None and gn.weight.grad is not None and gn.bias.grad is not None
    after = {k: v for k, v in tracing.counters().items() if "group_norm_silu" in k}
    assert after == before


@pytest.mark.parametrize("shape,groups,layout", [
    ((1, 32, 3, 5), 32, "nchw"),          # H * W not a multiple of 8
    ((1, 8192, 8, 8), 32, "nchw"),        # 256 channels a group
    ((1, 64, 128, 128), 1, "nchw"),       # a span no cluster holds (4 MB)
    ((1, 8192, 8, 8), 32, "channels_last"),  # 256 channels a group: too wide in either layout
    ((1, 64, 8, 8), 32, "strided"),       # neither layout
])
def test_dispatch_keeps_the_plain_path_where_the_plan_refuses(on_cpu, shape, groups, layout):
    x = torch.randn(shape)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "strided":
        x = torch.randn(shape[0], shape[1], shape[2], 2 * shape[3])[..., ::2]
    gn = GroupNorm32(shape[1], groups=groups)
    with torch.inference_mode():
        assert not kernel_takes(x, groups)
        y = gn(x)
    assert on_cpu == []
    assert torch.equal(y, gn_primal(x, gn.weight, gn.bias, groups, 1e-5)[0])
    with pytest.raises(ValueError):
        group_norm_silu(x, gn.weight, gn.bias, groups, 1e-5)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 512, 32, 32), torch.float32),   # an item of 2 MB: no cluster holds it
    ((1, 96, 8, 8), torch.bfloat16),     # 3 channels a group: no whole 16-byte vector
])
def test_channels_last_beyond_its_plan_runs_as_nchw(on_cpu, shape, dtype):
    """A channels-last x that the channels-last kernel cannot take, but the
    NCHW one can, goes to the kernel (as an NCHW copy on the card), and y
    keeps x's layout."""
    x = torch.randn(shape).to(dtype).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        gn_fwd_plan(*shape[1:], dtype, 32, True)
    plan, nhwc = gn_fwd._plan(x, 32)
    assert not nhwc and plan == gn_fwd_plan(*shape[1:], dtype, 32, False)
    gn = GroupNorm32(shape[1]).to(dtype)
    with torch.inference_mode():
        assert kernel_takes(x, 32)
        y = gn(x)
    assert len(on_cpu) == 1 and y.stride() == x.stride()
    assert torch.equal(y, gn_primal(x, gn.weight, gn.bias, 32, 1e-5)[0])


def test_kernel_takes_no_cpu_tensor_by_default():
    x = torch.randn(2, 64, 8, 8)
    with torch.inference_mode():
        assert not kernel_takes(x, 32)


@pytest.mark.parametrize("c,h,w,dtype,cl,k", [
    (64, 128, 128, torch.bfloat16, False, 1),    # 64 KB: one CTA
    (192, 128, 128, torch.bfloat16, False, 4),   # the decoder's 192-channel input, 192 KB
    (128, 128, 128, torch.float32, False, 4),
    (256, 16, 16, torch.bfloat16, True, 2),      # an item of 128 KB, channels-last
    (512, 32, 32, torch.bfloat16, True, 8),      # 1 MB: eight CTAs of 128 KB
    (64, 128, 128, torch.float32, False, 2),
])
def test_plan_cluster_sizes(c, h, w, dtype, cl, k):
    plan = gn_fwd_plan(c, h, w, dtype, 32, cl)
    assert plan.cluster == k
    assert plan.share * k >= (c if cl else c // 32) * h * w
    assert plan.smem <= (64 if plan.cluster < 8 else 200) * 1024
    if cl:
        assert plan.share % c == 0
