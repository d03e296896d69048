"""The frozen arithmetic: the copied bounds at the shapes of PERF.md's
kernel table, the FLOPs of a tiny reference UNet counted by hand, the trace
reduction."""

import pytest
import torch

from cardbench import yardstick as Y
from cardbench.families import ddpm, sdf
from cardbench.reference import sdf_unet
from cardbench.spec import load


def _sites(cell, batch):
    s = load(cell, held=True)
    return Y.sites(s.family.meta_unet(s.config), *s.family.eval_inputs(s.config, batch, "meta"))


@pytest.mark.parametrize("b, t, want", [(128, 1024, 0.1390), (128, 256, 0.0200),
                                        (16, 1024, 0.0174), (16, 256, 0.0025)])
def test_attention_bound_matches_the_kernel_table(b, t, want):
    assert Y.attention_bound(b, t, 4, 64, "bfloat16", 2) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("t, want", [(1024, 0.0434), (256, 0.0044)])
def test_attention_bwd_bound_matches_the_kernel_table(t, want):
    assert Y.attention_bwd_bound(16, t, 4, 64, "bfloat16", 2) == pytest.approx(want, abs=5e-5)


def test_gn_bwd_bound_matches_the_kernel_table():
    assert Y.gn_bwd_bound((16, 64, 128, 128), 2) == pytest.approx(0.0301, abs=5e-5)
    assert Y.gn_bwd_bound((16, 64, 128, 128), 4) == pytest.approx(0.0601, abs=5e-5)


def test_a_train_steps_group_norms_sum_to_the_kernel_table():
    """The 56 GroupNorms of the bf16 sdf step (0.8175 ms) and the 45 of the
    fp32 DDPM step (1.5822 ms) at batch 16, found on the reference."""
    gn = _sites("chd8bar.train-bf16-b64", 16).group_norm
    assert len(gn) == 56
    assert sum(Y.gn_bwd_bound(s, 2) for s in gn) == pytest.approx(0.8175, abs=5e-4)
    gn = _sites("ddpm.train-fp32-b16", 16).group_norm
    assert len(gn) == 45
    assert sum(Y.gn_bwd_bound(s, 4) for s in gn) == pytest.approx(1.5822, abs=5e-4)


def test_the_sdf_unet_has_eleven_self_attentions():
    att = _sites("chd8bar.gen-ddim50-b64", 128).attention
    assert sorted(att) == [(128, 256, 4, 64)] * 6 + [(128, 1024, 4, 64)] * 5


def test_flops_of_a_tiny_unet_by_hand():
    """One level (no downsample), one ResBlock, attention only in the
    middle, 4 x 4 image, width 32, d_cond 8, one condition token."""
    c, hw, d_cond, b = 32, 16, 8, 1
    with torch.device("meta"):
        m = sdf_unet.UNetModel(2, 2, c, 1, (), (1,), 2, 1, d_cond)
    x, t, cond = (torch.zeros(b, 2, 4, 4, device="meta"), torch.zeros(b, device="meta"),
                  torch.zeros(b, 1, d_cond, device="meta"))

    def conv(ci, co, k=3):
        return 2 * ci * co * k * k * hw

    def lin(i, o, rows=1):
        return 2 * i * o * rows

    res = conv(c, c) + conv(c, c) + lin(4 * c, c)              # a ResBlock of width c
    res_skip = conv(2 * c, c) + conv(c, c) + conv(2 * c, c, 1) + lin(4 * c, c)
    attn_self = 4 * lin(c, c, hw) + 2 * (2 * hw * hw * c)       # q, k, v, out; QK^T, PV
    # over one condition token P V contracts a length-1 axis: einsum makes it
    # an elementwise product, which the counter does not count
    attn_cross = 2 * lin(c, c, hw) + 2 * lin(d_cond, c) + 2 * hw * 1 * c
    ff = lin(c, 8 * c, hw) + lin(4 * c, c, hw)
    transformer = 2 * conv(c, c, 1) + attn_self + attn_cross + ff
    want = (lin(c, 4 * c) + lin(4 * c, 4 * c)                  # time embedding
            + conv(2, c)                                        # input conv
            + res                                               # input ResBlock
            + 2 * res + transformer                             # middle
            + 2 * res_skip                                      # two output ResBlocks
            + conv(c, 2))                                       # out
    assert Y.forward_flops(m, x, t, cond) == want


def test_breakdown_sums_classes_and_names_gaps_by_host_op():
    tr = Y.Trace(device=[("void cudnn_fprop", 0, 10), ("elementwise_kernel", 20, 25),
                         ("attention_fwd_wgmma<64, false>", 25, 30)],
                 host=[("aten::copy_", 8, 22), ("python loop", 0, 40)], wall_s=40e-6, units=1)
    assert Y.busy_us(tr.device) == 20
    bd = Y.breakdown(tr)
    assert bd["device_ops"][0] == ["convolution (cuDNN and its transposes)", 10e-6]
    assert bd["idle_gaps"] == [["aten::copy_", 10e-6]]
    assert Y.kernel_us(tr, "attention_fwd") == (5, 1)
