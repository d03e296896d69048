"""The reader of ``gn_fwd_roofline.gen`` (kernel 8's share of its roofline)
on synthetic traces of the gen cell's profiled request."""

import pytest

from cardbench import yardstick as Y
from cardbench.spec import load, reader

CELL = "chd8bar.gen-ddim50-b64"
# the kernel's names in a profiler trace: each layout, with and without the SiLU
NAMES = [f"void (anonymous namespace)::gn_fwd_{layout}_kernel<{t}, {silu}>((anonymous "
         f"namespace)::FwdArgs)" for layout in ("nchw", "nhwc")
         for t in ("__nv_bfloat16", "float") for silu in ("true", "false")]


def _ctx(launches_per_eval, evals=2, us_each=10.0, names=NAMES):
    device, t = [], 0.0
    for i in range(launches_per_eval * evals):
        device.append((names[i % len(names)], t, t + us_each))
        t += 2 * us_each
    device.append(("void cudnn::conv_kernel", t, t + 500.0))
    trace = Y.Trace(device=device, host=[], wall_s=1.0, units=evals)
    return {"spec": load(CELL), "eval_batch": 128, "trace": trace}


def _group_norms():
    s = load(CELL)
    return Y.sites(s.family.meta_unet(s.config),
                   *s.family.eval_inputs(s.config, 128, "meta")).group_norm


def test_the_bound_is_x_and_y_once_over_the_56_sites():
    """56 sites an eval at batch 128 hold 3.649 G elements; bf16, x read and
    y written once: 4 B an element at 3.35 TB/s."""
    mod = reader("gn_fwd_roofline.gen")
    gn = _group_norms()
    assert len(gn) == 56
    numel = sum(b * c * h * w for b, c, h, w in gn)
    assert numel == pytest.approx(3.649e9, rel=1e-3)
    bound = sum(mod.gn_fwd_bound(s, 2) for s in gn)
    assert bound == pytest.approx(4 * numel / 3.35e12 * 1e3)


def test_the_reader_reads_a_synthetic_request():
    mod = reader("gn_fwd_roofline.gen")
    ctx = _ctx(56, evals=2, us_each=100.0)
    bound = sum(mod.gn_fwd_bound(s, 2) for s in _group_norms())
    got = mod.read(ctx)
    assert got == pytest.approx(100.0 * bound * 2 / (56 * 2 * 100.0 / 1e3))


def test_the_reader_finds_nothing_without_the_kernel_or_with_other_counts():
    """The parent program launches no kernel 8: the metric is left out, and
    nothing raises; a count other than 56 an eval is refused the same way."""
    mod = reader("gn_fwd_roofline.gen")
    assert mod.read(_ctx(56, names=["void at::native::elementwise_kernel"])) is None
    assert mod.read(_ctx(55)) is None
    assert mod.read({"spec": load(CELL), "eval_batch": 128}) is None


def test_the_breakdown_files_kernel_8_under_other():
    assert {Y.classify(n) for n in NAMES} == {"other"}
    assert all("gn_fwd" in n for n in NAMES)
