"""The XLA int8 route (``gn_conv="int8_xla"``, JAX's ``POLYFF_INT8_XLA=1``),
the port against the JAX package on the CPU: ``quantize_act``,
``quantize_weight`` and ``int8_conv`` on the same inputs (the same codes, the
outputs within fp32 rounding), the concat form against JAX's
``Int8ConcatConv``, the int32 sums exact where an fp32 sum of the same codes
is not; the tiny UNet's eps against JAX's under the switch; the refusals (a
gradient, a train step, a tp mesh); the inference CLI's ``--gn_conv
int8_xla``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from polyffusion_tpu.models.unet import Int8ConcatConv as JaxInt8ConcatConv
from polyffusion_tpu.models.unet import UNetModel as JaxUNet
from polyffusion_tpu.ops import quant as JQ
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.models.unet import UNetModel
from polyffusion_tpu_torch.ops import quant as Q
from polyffusion_tpu_torch.parallel import shard_state
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.train import make_train_step

from test_torch_cfg_fork import cli, cli_work  # noqa: F401  (a fixture)
from test_torch_parallel import SDF, _Mesh

OUT_RTOL = 2**-22  # two fp32 ulps: the same sums, rescaled by the same scales in fp32
# tests/test_int8_gn_conv.py:150-156's UNet and inputs
TINY = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1, attention_levels=(1,),
            channel_multipliers=(1, 2), n_heads=2, tf_layers=1, d_cond=12)
INT8_EPS_REL = 0.05  # the int8 eps against the float eps (tests/test_int8_gn_conv.py:164)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _hwio(w):
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _inputs(rng, b, c, o, hw, w_scale=0.06):
    y = np.abs(rng.standard_normal((b, c, hw, hw))).astype(np.float32)
    y[0] *= 3.0  # items of different amax
    w = (rng.standard_normal((o, c, 3, 3)) * w_scale).astype(np.float32)
    bias = (rng.standard_normal(o) * 0.1).astype(np.float32)
    return y, w, bias


def test_quantize_act_and_weight_match_jax():
    rng = np.random.default_rng(1)
    y, w, _ = _inputs(rng, 3, 64, 32, 8)
    y[1] = 0.0  # the amax floor
    y[2, 0, 0, :4] = [0.5, 1.5, -2.5, 3.5]  # exact halves: round half to even
    q, scale = Q.quantize_act(torch.from_numpy(y))
    jq, jscale = JQ.quantize_act(jnp.asarray(_nhwc(y)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), _nchw(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    wq, wscale = Q.quantize_weight(torch.from_numpy(w))
    jwq, jwscale = JQ.quantize_weight(jnp.asarray(_hwio(w)))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(wscale.numpy(), np.asarray(jwscale))


@pytest.mark.parametrize("b,c,o,hw", [(2, 64, 64, 16), (2, 256, 256, 8), (1, 32, 96, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv_matches_jax(b, c, o, hw, dtype):
    """Per-item activation and per-channel weight scales (the weights
    quantized once here, per call in JAX), an fp32 rescale and bias, then the
    input's dtype."""
    rng = np.random.default_rng(c + o)
    y, w, bias = _inputs(rng, b, c, o, hw)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    yt = torch.from_numpy(y).to(tdt)
    got = Q.int8_conv(yt, *Q.quantize_weight(torch.from_numpy(w)), torch.from_numpy(bias))
    want = JQ.int8_conv(jnp.asarray(_nhwc(y)).astype(jdt), jnp.asarray(_hwio(w)),
                        jnp.asarray(bias))
    assert got.dtype == tdt and got.shape == (b, o, hw, hw)
    np.testing.assert_allclose(got.float().numpy(), _nchw(np.asarray(want, np.float32)),
                               rtol=OUT_RTOL if dtype == "float32" else 2**-7, atol=0)


def test_int8_concat_conv_matches_jax():
    """The decoder's concat: each part with its own activation scale and its
    own per-channel scales over its kernel slice (JAX's ``Int8ConcatConv``)."""
    rng = np.random.default_rng(2)
    y, w, bias = _inputs(rng, 2, 96, 64, 16)
    y2 = (np.abs(rng.standard_normal((2, 64, 16, 16))) * 0.2).astype(np.float32)
    w = np.concatenate([w, (rng.standard_normal((64, 64, 3, 3)) * 0.3).astype(np.float32)], 1)
    params = {"kernel": jnp.asarray(_hwio(w)), "bias": jnp.asarray(bias)}
    want = JaxInt8ConcatConv(64).apply({"params": params}, jnp.asarray(_nhwc(y)),
                                       jnp.asarray(_nhwc(y2)))
    wt = torch.from_numpy(w)
    parts = [Q.quantize_weight(wt[:, :96]), Q.quantize_weight(wt[:, 96:])]
    got = Q.int8_concat_conv(torch.from_numpy(y), torch.from_numpy(y2), parts,
                             torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=OUT_RTOL, atol=1e-7)
    # one weight scale over the whole kernel is another function
    whole = Q.quantize_weight(wt)
    one_scale = Q.int8_conv(torch.from_numpy(y), whole[0][:, :96], whole[1]) + Q.int8_conv(
        torch.from_numpy(y2), whole[0][:, 96:], whole[1]) + torch.from_numpy(bias)[:, None, None]
    assert (one_scale - got).abs().max() > 1e-3


def test_int8_sums_are_exact_where_fp32_is_not():
    """256 channels of codes near 127: sums past 2^24, where an fp32
    convolution of the same codes rounds; the int8 product is exact."""
    rng = np.random.default_rng(3)
    q = np.full((1, 256, 4, 4), 127, np.int8)
    q[0, :, 1, 2] = rng.integers(-127, 128, 256)
    w_q = np.full((16, 256, 3, 3), 127, np.int8)
    w_q[:, :, 1, 1] = rng.integers(-127, 128, (16, 256))
    got = Q.int8_conv_sums(torch.from_numpy(q), torch.from_numpy(w_q)).numpy()
    want = F.conv2d(torch.from_numpy(q).double(), torch.from_numpy(w_q).double(),
                    padding=1).numpy().transpose(0, 2, 3, 1)
    assert got.dtype == np.int32 and np.abs(want).max() > 2**24
    np.testing.assert_array_equal(got, want.astype(np.int64))
    fp32 = F.conv2d(torch.from_numpy(q).float(), torch.from_numpy(w_q).float(),
                    padding=1).numpy().transpose(0, 2, 3, 1)
    assert (fp32.astype(np.int64) != got).any()


def test_int8_product_shape_rules():
    """``torch._int_mm``'s: the contraction and the output channels multiples of 8."""
    q = torch.zeros(1, 3, 4, 4, dtype=torch.int8)  # 27 = 3 x 9
    with pytest.raises(ValueError, match="multiples of 8"):
        Q.int8_conv_sums(q, torch.zeros(8, 3, 3, 3, dtype=torch.int8))


# -- the UNet ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet_pair():
    jm = JaxUNet(**TINY)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 2)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 3, 12)))["params"])
    rng = np.random.default_rng(8)  # tests/test_int8_gn_conv.py:150-156's inputs
    x = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    t = np.array([3, 40], np.int32)
    cond = rng.standard_normal((2, 3, 12)).astype(np.float32)
    return jm, params, (x, t, cond)


def _port(params, gn_conv):
    tm = UNetModel(**TINY, gn_conv=gn_conv)
    tm.load_state_dict(unet_state_from_jax(params), strict=True)
    tm.prepare_gn_conv()
    return tm.eval()


class _Codes:
    """Records the codes and scales every ``quantize_act`` returns (codes
    NCHW); with ``replay`` (another recording of the same sites, in order)
    it returns those instead of its own."""

    def __init__(self, fn, nhwc, replay=None):
        self.fn, self.nhwc, self.replay, self.codes = fn, nhwc, replay, []

    def __call__(self, y):
        q, scale = self.fn(y)
        self.codes.append((_nchw(q) if self.nhwc else q.numpy(), np.array(scale)))
        if self.replay is not None:
            rq, rs = self.replay[len(self.codes) - 1]
            return torch.from_numpy(rq), torch.from_numpy(rs)
        return q, scale


@pytest.fixture(scope="module")
def jax_int8(unet_pair):
    """JAX's eps under ``POLYFF_INT8_XLA=1`` with the codes and scales of its
    20 sites (2 encoder and 2 middle blocks of 2, 4 decoder blocks of 3, in
    module order), and its float eps."""
    jm, params, (x, t, cond) = unet_pair
    mp = pytest.MonkeyPatch()
    mp.delenv("POLYFF_INT8_CONV", raising=False)
    mp.setenv("POLYFF_FUSED_GN_CONV", "0")
    base = _nchw(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond)))
    mp.setenv("POLYFF_INT8_XLA", "1")
    codes = _Codes(JQ.quantize_act, nhwc=True)
    mp.setattr(JQ, "quantize_act", codes)
    try:
        eps = _nchw(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(cond)))
    finally:
        mp.undo()
    assert len(codes.codes) == 2 * 2 + 2 * 2 + 4 * 3
    return eps, codes.codes, base


def _port_int8_eps(unet_pair, monkeypatch, replay=None):
    _, params, (x, t, cond) = unet_pair
    codes = _Codes(Q.quantize_act, nhwc=False, replay=replay)
    monkeypatch.setattr(Q, "quantize_act", codes)
    with torch.no_grad():
        eps = _port(params, "int8_xla")(torch.from_numpy(_nchw(x)), torch.from_numpy(t),
                                        torch.from_numpy(cond)).numpy()
    return eps, codes.codes


def test_unet_int8_xla_eps_matches_jax(unet_pair, jax_int8, monkeypatch):
    """Free-running against JAX's under the switch: the activations reach
    each site through both packages' float layers, which differ by ulps, so
    a code flips where its input lies at a rounding boundary, and each flip
    moves the activations downstream (the count of flipped codes and their
    largest step are printed). The port's int8 eps stays closer to JAX's
    than either int8 eps to the float one, which JAX's own test bounds
    (mean rel < 0.05)."""
    want, jcodes, base = jax_int8
    got, codes = _port_int8_eps(unet_pair, monkeypatch)
    assert [c.shape for c, _ in codes] == [c.shape for c, _ in jcodes]
    steps = [np.abs(a.astype(np.int32) - b.astype(np.int32)) for (a, _), (b, _) in
             zip(codes, jcodes)]
    flips, total = sum(int((s > 0).sum()) for s in steps), sum(s.size for s in steps)
    first = next((i for i, s in enumerate(steps) if s.any()), None)
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    q_rel = np.abs(want - base).mean() / np.abs(base).mean()
    print(f"[int8_xla] {flips} of {total} activation codes differ from JAX's (largest step "
          f"{max(int(s.max()) for s in steps)}, first at site {first}); eps vs JAX's int8 eps "
          f"mean rel {rel:.3g}; JAX's int8 eps vs its float eps mean rel {q_rel:.3g}")
    assert q_rel < INT8_EPS_REL
    assert np.abs(got - base).mean() / np.abs(base).mean() < INT8_EPS_REL
    assert rel < q_rel


def test_unet_int8_xla_on_jax_codes_matches_jax(unet_pair, jax_int8, monkeypatch):
    """Given JAX's codes and scales at every site (the port's own replaced,
    each site's input still the port's), the port's eps is JAX's at the
    UNet's float tolerance (tests/test_unet_parity.py:68): everything but
    the rounding points agrees. The port's first site, whose input both
    packages compute alike, takes JAX's codes exactly."""
    want, jcodes, _ = jax_int8
    got, codes = _port_int8_eps(unet_pair, monkeypatch, replay=jcodes)
    np.testing.assert_array_equal(codes[0][0], jcodes[0][0])
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_unet_int8_xla_keeps_the_parameters(unet_pair):
    """Parameter names and shapes are the other routes'."""
    _, params, _ = unet_pair
    a, b = _port(params, "int8_xla").state_dict(), _port(params, "unfused").state_dict()
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}


def test_unet_int8_xla_needs_prepared_weights(unet_pair):
    _, params, (x, t, cond) = unet_pair
    tm = _port(params, "int8_xla").double()  # cast: the int8 copies are stale
    with torch.no_grad(), pytest.raises(RuntimeError, match="prepare_gn_conv"):
        tm(torch.from_numpy(_nchw(x)), torch.from_numpy(t), torch.from_numpy(cond))


# -- the refusals ------------------------------------------------------------------------------


def test_int8_conv_gradient_raises():
    """JAX's custom VJP: a backward through the round and clip raises, it does
    not return zeros."""
    rng = np.random.default_rng(9)
    y, w, bias = _inputs(rng, 1, 32, 32, 8)
    yt = torch.from_numpy(y).requires_grad_()
    with pytest.raises(NotImplementedError, match="sampling-only"):
        out = Q.int8_conv(yt, *Q.quantize_weight(torch.from_numpy(w)), torch.from_numpy(bias))
        out.sum().backward()
    with pytest.raises(NotImplementedError, match="sampling-only"):
        jax.grad(lambda k: jnp.sum(JQ.int8_conv(jnp.asarray(_nhwc(y)), k)))(jnp.asarray(_hwio(w)))


def test_unet_int8_xla_backward_raises(unet_pair):
    _, params, (x, t, cond) = unet_pair
    out = _port(params, "int8_xla")(torch.from_numpy(_nchw(x)), torch.from_numpy(t),
                                    torch.from_numpy(cond))
    with pytest.raises(NotImplementedError, match="sampling-only"):
        out.sum().backward()


def test_train_step_refuses_int8_xla():
    with pytest.raises(ValueError, match="sampling-only"):
        SDFTask(Params(SDF), device="cpu", training=True, gn_conv="int8_xla")
    task = SDFTask(Params(SDF), device="cpu", gn_conv="int8_xla")
    with pytest.raises(ValueError, match="int8_xla.*sampling-only"):
        make_train_step(task)


def test_tp_refuses_int8_xla():
    """ROADMAP item 21's class: the row-parallel out conv would quantize with
    an amax over its channel shard."""
    task = SDFTask(Params(SDF), device="cpu", gn_conv="int8_xla")
    with pytest.raises(NotImplementedError, match="item 21.*amax over a channel shard"):
        shard_state(task.unet, _Mesh(dp=2, tp=2))


# -- the CLI ------------------------------------------------------------------------------------


def test_cli_int8_xla(cli_work, tmp_path):  # noqa: F811
    """``--gn_conv int8_xla``, with and without ``--cfg_fork``: finite rolls
    close to the unfused route's."""
    (q,) = cli(cli_work, tmp_path / "q", "--gn_conv", "int8_xla")
    (qf,) = cli(cli_work, tmp_path / "qf", "--gn_conv", "int8_xla", "--cfg_fork")
    (plain,) = cli(cli_work, tmp_path / "plain")
    assert q.shape == qf.shape == plain.shape == (1, 2, 128, 128)
    assert np.isfinite(q).all() and np.isfinite(qf).all()
    # the fork moves the float layers by ulps (another batch), and codes flip:
    # both int8 rolls are held to the float one by the int8 bound
    for roll in (q, qf):
        assert np.abs(roll - plain).mean() / np.abs(plain).mean() < INT8_EPS_REL
