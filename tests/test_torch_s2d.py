"""The space-to-depth level 0 (``gn_conv="s2d"``) against the JAX package's
``POLYFF_S2D=1`` branch, fp32 on the CPU: ``ops/s2d.py``'s nine functions
against JAX's after the NHWC -> NCHW and HWIO -> OIHW transposes (the layout
and kernel maps exactly, the conv identities at JAX's 1e-5); the folded
GroupNorm against JAX's; the tiny UNet of ``tests/test_s2d_unet.py`` on JAX's
weights against JAX's folded UNet and the port's unfused one; an
``SDFTask`` loss and its gradients against ``jax.grad``; the fork; the state
dict; and the refusals (level-0 attention, a width the folds do not divide,
tensor parallelism: ROADMAP item 22)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.models.unet import FP32GroupNorm as JaxGroupNorm
from polyffusion_tpu.models.unet import UNetModel as JaxUNet
from polyffusion_tpu.ops import s2d as J
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.models.unet import FoldedGroupNorm32, GroupNorm32, UNetModel
from polyffusion_tpu_torch.ops import s2d as T
from polyffusion_tpu_torch.parallel import shard_state
from polyffusion_tpu_torch.parallel.fsdp import infer_fsdp_sharding
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.tasks.sdf import StepNoise

from test_torch_parallel import _Mesh

CONV_ATOL, CONV_RTOL = 1e-5, 1e-5  # tests/test_s2d.py
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4  # tests/test_s2d_unet.py:51, tests/test_unet_parity.py:68
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # tests/test_torch_train.py
FORK_ATOL = 1e-5  # tests/test_torch_cfg_fork.py
# the tiny UNet of tests/test_s2d_unet.py:20-31, at its 32 x 32 input
TINY = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1, attention_levels=(2, 3),
            channel_multipliers=(1, 2, 4, 4), n_heads=4, tf_layers=1, d_cond=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    """NHWC NumPy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _w(a):
    """HWIO NumPy -> OIHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1)))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _oihw(a):
    return np.asarray(a).transpose(3, 2, 0, 1)


# -- ops/s2d.py ---------------------------------------------------------------------------------


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_layout_maps_match_jax(rng):
    """``to_s2d``, ``from_s2d``, the NumPy round trip, ``upsample2x_s2d``,
    ``fold_channel_vec`` and ``unfold_channel_sums``, exactly."""
    x = rng.standard_normal((2, 8, 16, 6)).astype(np.float32)
    folded = T.to_s2d(_t(x))
    assert folded.shape == (2, 12, 8, 8)
    np.testing.assert_array_equal(folded.numpy(), _nchw(J.to_s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(T.from_s2d(folded).numpy(), _t(x).numpy())
    np.testing.assert_array_equal(
        T.np_reference_s2d_roundtrip(_t(x).numpy()),
        _nchw(J.np_reference_s2d_roundtrip(x)))
    np.testing.assert_array_equal(T.upsample2x_s2d(folded).numpy(),
                                  _nchw(J.upsample2x_s2d(J.to_s2d(jnp.asarray(x)))))
    v = rng.standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_array_equal(T.fold_channel_vec(torch.from_numpy(v)).numpy(),
                                  np.asarray(J.fold_channel_vec(jnp.asarray(v))))
    sums = rng.standard_normal((3, 12)).astype(np.float32)
    np.testing.assert_array_equal(T.unfold_channel_sums(torch.from_numpy(sums)).numpy(),
                                  np.asarray(J.unfold_channel_sums(jnp.asarray(sums))))


KERNELS = [("s2d", 3, 6, 4), ("s2d", 3, 4, 4), ("s2d", 3, 2, 6), ("s2d", 1, 6, 4),
           ("entry", 3, 5, 4), ("exit", 3, 6, 7)]


@pytest.mark.parametrize("kind,k,ci,co", KERNELS)
def test_kernel_maps_match_jax(rng, kind, k, ci, co):
    w = rng.standard_normal((k, k, ci, co)).astype(np.float32)
    port, jax_fn = {"s2d": (T.s2d_kernel, J.s2d_kernel),
                    "entry": (T.s2d_entry_kernel, J.s2d_entry_kernel),
                    "exit": (T.s2d_exit_stride2_kernel, J.s2d_exit_stride2_kernel)}[kind]
    np.testing.assert_array_equal(port(_w(w)).numpy(), _oihw(jax_fn(jnp.asarray(w))))


def _folded_conv(kind, x, w):
    """The port's folded form of a plain conv of x by w, and the plain conv."""
    k = w.shape[-1]
    if kind == "s2d":
        return (T.from_s2d(F.conv2d(T.to_s2d(x), T.s2d_kernel(w), padding=k // 2)),
                F.conv2d(x, w, padding=k // 2))
    if kind == "entry":
        return (F.conv2d(x, T.s2d_entry_kernel(w), stride=(1, 2), padding=1),
                T.to_s2d(F.conv2d(x, w, padding=1)))
    return (F.conv2d(F.pad(T.to_s2d(x), (1, 0, 1, 1)), T.s2d_exit_stride2_kernel(w), stride=(2, 1)),
            F.conv2d(x, w, stride=2, padding=1))


@pytest.mark.parametrize("kind,k,ci,co", KERNELS)
def test_conv_identities_and_their_gradients(rng, kind, k, ci, co):
    """Each folded conv is the plain conv (JAX's ``tests/test_s2d.py``
    identities at its 1e-5), and the gradient through the kernel map reaches
    the plain weight: the same as the plain conv's."""
    x = torch.from_numpy(rng.standard_normal((2, ci, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((co, ci, k, k)).astype(np.float32))
    w_a, w_b = w.clone().requires_grad_(), w.clone().requires_grad_()
    got, _ = _folded_conv(kind, x, w_a)
    _, want = _folded_conv(kind, x, w_b)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=CONV_ATOL,
                               rtol=CONV_RTOL)
    dy = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32))
    (got * dy).sum().backward()
    (want * dy).sum().backward()
    np.testing.assert_allclose(w_a.grad.numpy(), w_b.grad.numpy(), atol=1e-4, rtol=CONV_RTOL)


def test_kernel_maps_need_their_widths():
    with pytest.raises(ValueError, match="width 15"):
        T.to_s2d(torch.zeros(1, 2, 4, 15))
    with pytest.raises(ValueError, match="1- or 3-wide"):
        T.s2d_kernel(torch.zeros(2, 2, 5, 5))


# -- the folded GroupNorm -----------------------------------------------------------------------


@pytest.mark.parametrize("two", [False, True], ids=["one_input", "virtual_concat"])
def test_folded_groupnorm_matches_jax_and_the_plain_norm(rng, two):
    """JAX's ``FP32GroupNorm(folded=True)`` on the folded inputs (one, or
    the virtual concat of two), and the port's unfolded ``GroupNorm32`` of the
    (concatenated) unfolded input, with the same scale and bias."""
    c1, c2 = 64, 32
    x = rng.standard_normal((2, 4, 8, c1)).astype(np.float32) * 3 + 1
    x2 = rng.standard_normal((2, 4, 8, c2)).astype(np.float32) if two else None
    c = c1 + (c2 if two else 0)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    folded = [J.to_s2d(jnp.asarray(x))] + ([J.to_s2d(jnp.asarray(x2))] if two else [])
    want = JaxGroupNorm(folded=True).apply({"params": {"scale": scale, "bias": bias}}, *folded)
    want = [_nchw(w) for w in (want if two else (want,))]
    norm = FoldedGroupNorm32(c)
    plain = GroupNorm32(c)
    with torch.no_grad():
        for m in (norm, plain):
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        got = norm(*[T.to_s2d(_t(a)) for a in ([x, x2] if two else [x])])
        got = list(got) if two else [got]
        unfolded = plain(torch.cat([_t(a) for a in ([x, x2] if two else [x])], dim=1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(torch.cat([T.from_s2d(g) for g in got], dim=1).numpy(),
                               unfolded.numpy(), atol=1e-5, rtol=1e-5)


# -- the UNet -----------------------------------------------------------------------------------


def _unet_inputs(b=2, seed=0, hw=32, d_cond=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, hw, hw)).astype(np.float32)
    t = np.array([3, 500, 77, 999][:b], np.int32)
    cond = rng.standard_normal((b, 1, d_cond)).astype(np.float32)
    return x, t, cond


def _jax_apply(model, params, env, *args, **kwargs):
    """``model.apply`` under the environment switches ``env`` (JAX reads
    ``POLYFF_S2D`` at trace time), jitted through a fresh function so that no
    trace made under another setting is reused."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("POLYFF_S2D", raising=False)
        for name, value in env.items():
            mp.setenv(name, value)
        fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, **kwargs))
        return np.asarray(fn(params, *args))


@pytest.fixture(scope="module")
def jax_tiny():
    """The tiny UNet's JAX weights and its forward under ``POLYFF_S2D=1``
    and without it, and the forked forward under the switch."""
    jm = JaxUNet(**TINY)
    x, t, cond = _unet_inputs()
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jx, jnp.asarray(t), jnp.asarray(cond))["params"])
    c_in = np.concatenate([-np.ones_like(cond), cond])
    return dict(
        params=params, inputs=(x, t, cond), c_in=c_in,
        s2d=_nchw(_jax_apply(jm, params, {"POLYFF_S2D": "1"}, jx, t, cond)),
        plain=_nchw(_jax_apply(jm, params, {}, jx, t, cond)),
        fork=_nchw(_jax_apply(jm, params, {"POLYFF_S2D": "1"}, jx, t, c_in, cfg_fork=True)),
    )


def _port_unet(params, gn_conv, cfg=TINY):
    tm = UNetModel(**cfg, gn_conv=gn_conv)
    tm.load_state_dict(unet_state_from_jax(params), strict=True)
    return tm.eval()


def test_unet_matches_jax_s2d_and_the_unfused_route(jax_tiny):
    x, t, cond = map(torch.from_numpy, jax_tiny["inputs"])
    with torch.no_grad():
        got = _port_unet(jax_tiny["params"], "s2d")(x, t, cond).numpy()
        unfused = _port_unet(jax_tiny["params"], "unfused")(x, t, cond).numpy()
    assert got.shape == (2, 2, 32, 32)
    np.testing.assert_allclose(got, jax_tiny["s2d"], atol=UNET_ATOL, rtol=UNET_RTOL)
    np.testing.assert_allclose(got, unfused, atol=UNET_ATOL, rtol=UNET_RTOL)
    np.testing.assert_allclose(unfused, jax_tiny["plain"], atol=UNET_ATOL, rtol=UNET_RTOL)


def test_unet_fork_matches_jax_and_the_double_batch(jax_tiny):
    """``cfg_fork`` under "s2d" tiles the folded level-0 skips: JAX's fork
    under ``POLYFF_S2D=1``, and the port's double batch."""
    x, t, _ = map(torch.from_numpy, jax_tiny["inputs"])
    c_in = torch.from_numpy(jax_tiny["c_in"])
    tm = _port_unet(jax_tiny["params"], "s2d")
    with torch.no_grad():
        forked = tm(x, t, c_in, cfg_fork=True).numpy()
        double = tm(torch.cat([x, x]), torch.cat([t, t]), c_in).numpy()
    np.testing.assert_allclose(forked, jax_tiny["fork"], atol=FORK_ATOL, rtol=0)
    np.testing.assert_allclose(forked, double, atol=FORK_ATOL, rtol=0)


@pytest.mark.parametrize("cfg", [TINY, dict(TINY, channels=64, n_res_blocks=2)],
                         ids=["tiny", "full_width"])
def test_state_dict_is_the_unfused_one(cfg):
    """Key for key and shape for shape (the flagship's widths too), so either
    mode loads the other's weights strictly; the same fsdp plan."""
    if cfg is not TINY:
        p = load_params("sdf_chd8bar")
        cfg = dict(cfg, attention_levels=tuple(p.attention_levels), d_cond=p.d_cond)
    a, b = UNetModel(**cfg, gn_conv="s2d"), UNetModel(**cfg)
    shapes = {k: v.shape for k, v in a.state_dict().items()}
    assert shapes == {k: v.shape for k, v in b.state_dict().items()}
    a.load_state_dict(b.state_dict(), strict=True)
    mesh = _Mesh(dp=2)
    assert infer_fsdp_sharding(a, mesh) == infer_fsdp_sharding(b, mesh)


def test_level0_modules_fold():
    """Exactly level 0 folds: its ResBlocks (both halves), the entry and the
    head, its DownSample and the UpSample that leaves level 1."""
    tm = UNetModel(**TINY, gn_conv="s2d")
    folded = [n for n, m in tm.named_modules() if getattr(m, "folded", False)]
    assert folded == ["input_blocks.1.0", "output_blocks.6.0", "output_blocks.7.0"]
    kinds = {n: type(m).__name__ for n, m in tm.named_modules()
             if type(m).__name__.startswith(("S2d", "Folded"))}
    assert kinds["input_blocks.0.0"] == "S2dEntryConv"
    assert kinds["input_blocks.2.0.op"] == "S2dExitConv"
    assert kinds["output_blocks.5.1.conv"] == "S2dConv"  # the upsample into level 0
    assert kinds["output_blocks.6.0.in_layers.2"] == "S2dConcatConv"
    assert kinds["out.0"] == "FoldedGroupNorm32" and kinds["out.2"] == "S2dConv"
    assert sum(k == "FoldedGroupNorm32" for k in kinds.values()) == 2 * 3 + 1


def test_refusals():
    with pytest.raises(ValueError, match="level 0, which must not attend"):
        UNetModel(**dict(TINY, attention_levels=(0, 2)), gn_conv="s2d")
    tm = UNetModel(**TINY, gn_conv="s2d")
    x, t, cond = map(torch.from_numpy, _unet_inputs(b=1, hw=32))
    with pytest.raises(ValueError, match="width divisible by 4"):
        tm(x[..., :31], t, cond)
    with pytest.raises(ValueError, match="width divisible by 4"):
        tm(x[..., :30], t, cond)
    with pytest.raises(NotImplementedError, match="item 22"):
        shard_state(tm, _Mesh(dp=2, tp=2))


# -- the loss and its gradients -----------------------------------------------------------------

# tests/test_torch_unet_gn_conv.py's tiny chord preset: level 0 does not attend
CFG = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-4, max_grad_norm=10,
    bf16=False, in_channels=2, out_channels=2, channels=32, attention_levels=[1],
    n_res_blocks=1, channel_multipliers=[1, 2], n_heads=2, tf_layers=1, d_cond=32 * 36,
    linear_start=0.00085, linear_end=0.012, n_steps=40, img_h=16, img_w=16,
    cond_type="chord", cond_mode="cond", use_enc=False,
)


def _rel_norm(got, want):
    num = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    return (num / den) ** 0.5


def _port_grads(params, batch, noise, gn_conv):
    task = SDFTask(Params(CFG), device="cpu", training=True, gn_conv=gn_conv)
    task.load_unet_state(unet_state_from_jax(params))
    loss, _ = task.loss_fn(batch, noise)
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in task.unet.named_parameters()}


def test_loss_gradients_match_jax_grad():
    """JAX's ``loss_fn`` under ``POLYFF_S2D=1`` draws t and the noise from its
    key; the port's loss under "s2d" takes the same draws. The loss at rel
    1e-5, the gradients at rel 1e-4 in norm; and the port's unfused route's."""
    jtask = JaxSDFTask(JaxParams(CFG))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jtask.init_params)(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    x0 = (rng.random((2, 2, 16, 16)) > 0.9).astype(np.float32)
    chord = (rng.random((2, 32, 36)) > 0.8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jbatch = (jnp.asarray(x0), None, jnp.asarray(chord), None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POLYFF_S2D", "1")
        loss_fn = jax.jit(lambda p: jtask.loss_fn(p, jbatch, key, {})[0])
        want_loss, want_g = jax.value_and_grad(loss_fn)(params)
    # the draws of JAX's loss_fn: (cond, loss) keys, then (t, eps) keys
    _, loss_key = jax.random.split(key)
    t_key, eps_key = jax.random.split(loss_key)
    t = np.asarray(jax.random.randint(t_key, (2,), 0, CFG["n_steps"]))
    noise = np.asarray(jax.random.normal(eps_key, (2, 16, 16, 2))).transpose(0, 3, 1, 2)
    batch = (torch.from_numpy(x0), None, torch.from_numpy(chord), None)
    step_noise = StepNoise(torch.from_numpy(t.copy()), torch.from_numpy(noise.copy()),
                           torch.tensor(False))
    loss, grads = _port_grads(params, batch, step_noise, "s2d")
    want = unet_state_from_jax(jax.tree_util.tree_map(np.asarray, want_g))
    assert set(grads) == set(want)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert _rel_norm(grads, want) <= GRAD_RTOL
    loss_u, grads_u = _port_grads(params, batch, step_noise, "unfused")
    np.testing.assert_allclose(loss, loss_u, rtol=LOSS_RTOL)
    assert _rel_norm(grads, grads_u) <= GRAD_RTOL
