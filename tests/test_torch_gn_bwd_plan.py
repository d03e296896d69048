"""The GroupNorm backward kernel's plan and its weight-dtype outputs, on the CPU.

``gn_bwd_plan`` decides how the CUDA kernel (``ops/csrc/gn_bwd.cu``) splits one
(item, group) span of x and dy over a thread-block cluster; it is pure
Python, so its choices for every GroupNorm of the train step are checked here.
The wrapper's CPU route gives dgamma and dbeta in the weight's dtype, as the
kernel writes them, and takes a bf16 weight."""

import numpy as np
import pytest
import torch

from polyffusion_tpu_torch.models.unet import GroupNorm32
from polyffusion_tpu_torch.ops.gn_bwd import (
    CHUNK_BYTES,
    CLUSTER_SIZES,
    SMEM_BUDGET,
    SMEM_LIMIT,
    gn_bwd_plan,
    gn_bwd_reference,
    gn_primal,
    group_norm_bwd,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are tiny, and test workers that
    share the cores would otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (C, H, W) of every GroupNorm backward of the full-width sdf_chd8bar train
# step (32 groups), as a forward hook on each GroupNorm32 counts them
TRAIN_STEP_SHAPES = [
    (64, 128, 128), (128, 128, 128), (192, 128, 128), (64, 64, 64), (128, 64, 64),
    (192, 64, 64), (256, 64, 64), (384, 64, 64), (128, 32, 32), (256, 32, 32), (384, 32, 32),
    (512, 32, 32), (256, 16, 16), (512, 16, 16),
]


@pytest.mark.parametrize("batch", [2, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h,w", TRAIN_STEP_SHAPES)
def test_plan_covers_every_train_step_span(c, h, w, dtype, batch):
    """A cluster size of 1, 2, 4 or 8, the smallest whose share fits the
    budget (else 8, within the limit); shares of whole 16-byte vectors that
    cover the span exactly; at most 16 chunks a share, each of whole vectors."""
    plan = gn_bwd_plan(batch, c, h, w, dtype, 32)
    itemsize = dtype.itemsize
    span = c // 32 * h * w

    def smem(k):
        return 2 * -(-(-(-span // k) // 8) * 8 * itemsize // 128) * 128

    assert plan.cluster in CLUSTER_SIZES and plan.smem == smem(plan.cluster)
    fits_budget = [k for k in CLUSTER_SIZES if smem(k) <= SMEM_BUDGET]
    assert plan.cluster == (fits_budget[0] if fits_budget else 8) and plan.smem <= SMEM_LIMIT
    assert plan.share * itemsize % 16 == 0 and plan.chunk * itemsize % 16 == 0
    bounds = [(min(r * plan.share, span), min((r + 1) * plan.share, span))
              for r in range(plan.cluster)]
    assert bounds[0][0] == 0 and bounds[-1][1] == span
    assert all(a < b for a, b in bounds)  # no CTA without a share
    assert all(bounds[r][1] == bounds[r + 1][0] for r in range(plan.cluster - 1))
    assert plan.chunk * itemsize <= CHUNK_BYTES and -(-plan.share // plan.chunk) <= 16


def test_plan_clusters_of_the_largest_spans():
    """The train step's largest spans: (192, 128, 128) takes eight CTAs of
    48 KB in bf16 and, over the budget, eight of 96 KB in fp32 (768 KB of x
    and dy); (64, 128, 128) bf16 takes two of 64 KB; (256, 16, 16) one."""
    assert gn_bwd_plan(16, 192, 128, 128, torch.bfloat16, 32).cluster == 8
    assert gn_bwd_plan(2, 192, 128, 128, torch.float32, 32) == (8, 12288, 4096, 98304)
    assert gn_bwd_plan(16, 64, 128, 128, torch.bfloat16, 32).cluster == 2
    assert gn_bwd_plan(16, 256, 16, 16, torch.bfloat16, 32).cluster == 1


def test_plan_refuses_a_span_no_cluster_holds():
    with pytest.raises(ValueError, match="does not fit 8 CTAs"):
        gn_bwd_plan(1, 2048, 128, 128, torch.float32, 32)


def _inputs(b, c, h, w, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((b, c, h, w)) * 2 + 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    # bf16-representable, so that its fp32 and bf16 forms hold the same values
    gamma = torch.from_numpy((rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32))
    gamma = gamma.bfloat16().float()
    beta = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
    x, dy = x.to(dtype), dy.to(dtype)
    _, mean_c, inv_c = gn_primal(x, gamma, beta, 32, 1e-5)
    return x, dy, mean_c, inv_c, gamma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_gives_params_in_the_asked_dtype(dtype):
    """dgamma and dbeta in ``param_dtype``: the plain version's fp32 sums cast
    with ``.to``, as the kernel rounds them; dx unchanged."""
    x, dy, mean_c, inv_c, gamma = _inputs(2, 64, 8, 8, seed=6, dtype=dtype)
    want = gn_bwd_reference(x, dy, mean_c, inv_c, gamma, 32)
    got = group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32, param_dtype=torch.bfloat16)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.to(torch.bfloat16))
    got32 = group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32)
    assert all(torch.equal(g, w) for g, w in zip(got32, want))


def test_cpu_route_takes_a_bf16_gamma():
    """A bf16 weight is read as it is: the same results as its fp32 values."""
    x, dy, mean_c, inv_c, gamma = _inputs(2, 96, 8, 16, seed=7)
    want = group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32)
    got = group_norm_bwd(x, dy, mean_c, inv_c, gamma.bfloat16(), 32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrapper_refuses_other_param_dtypes():
    x, dy, mean_c, inv_c, gamma = _inputs(1, 64, 8, 8, seed=8)
    with pytest.raises(ValueError, match="param_dtype"):
        group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32, param_dtype=torch.float16)
    with pytest.raises(ValueError, match="gamma"):
        group_norm_bwd(x, dy, mean_c, inv_c, gamma.half(), 32)


def test_bf16_weights_get_bf16_grads_from_the_backward():
    """A GroupNorm32 whose weights are bf16: the backward hands the weight to
    the kernel's route as it is and asks for its dtype, so the gradients come
    back bf16, equal to the fp32 weight's gradients cast."""
    x, dy, _, _, gamma = _inputs(2, 64, 8, 8, seed=9)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        gn = GroupNorm32(64)
        with torch.no_grad():
            gn.weight.copy_(gamma)
        gn.to(dtype)
        xt = x.clone().requires_grad_()
        gn(xt).backward(dy)
        grads[dtype] = (xt.grad, gn.weight.grad, gn.bias.grad)
    assert grads[torch.bfloat16][1].dtype == grads[torch.bfloat16][2].dtype == torch.bfloat16
    for g16, g32 in zip(grads[torch.bfloat16][1:], grads[torch.float32][1:]):
        assert torch.equal(g16, g32.to(torch.bfloat16))
