"""The port's parallelism (``polyffusion_tpu_torch/parallel``) against the JAX
package's, fp32 on the CPU: the fsdp and tp policies against JAX's
``infer_fsdp_sharding`` / ``infer_tp_sharding``; the 4-rank dp, fsdp, 2 x 2
dp x tp and 1 x 4 tp (heads that tp does not divide) train steps of the tiny
UNet of ``tests/test_tp.py`` against JAX's single-device step and the port's
one-process step; a dp step of the autoencoder with its discriminator on;
dp and fsdp distillation steps; dp and fsdp-params sampling against the
one-process session and JAX's dp paint; the refusals.

The ranks are gloo processes on the CPU, one intra-op thread each, spawned
once for the module (``tests/torch_parallel_worker.py``, torch only); they
write their results to a temporary directory that the tests read.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.diffusion.gaussian import q_sample as jax_q_sample
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.parallel import make_mesh as jax_make_mesh
from polyffusion_tpu.parallel.fsdp import infer_fsdp_sharding as jax_infer_fsdp
from polyffusion_tpu.parallel.tp import infer_tp_sharding as jax_infer_tp
from polyffusion_tpu.parallel.tp import make_tp_mesh as jax_make_tp_mesh
from polyffusion_tpu.tasks.sdf import SDFTask as JaxSDFTask
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.parallel import (
    MIN_SHARD_ELEMS,
    infer_fsdp_sharding,
    infer_tp_sharding,
    shard_state,
)
from polyffusion_tpu_torch.parallel.mesh import RowShard, free_port, global_view, keep_rows
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.tasks.distill import DistillTask
from polyffusion_tpu_torch.tasks.pnotree_vae import PianoTreeNoise
from polyffusion_tpu_torch.tasks.sdf import StepNoise, make_unet
from polyffusion_tpu_torch.train import Trainer, make_train_step

import torch_parallel_worker as W
from test_torch_autoencoder import _assert_grads_close

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4

# tests/test_tp.py's UNet with 64 channels (two in each of level 0's GroupNorm
# groups: with one, a GroupNorm cancels the bias before it, whose gradient is
# then rounding noise that Adam scales up to a full step, as in
# tests/test_torch_train.py); the clip is active (grad norm about 3 > 1)
SDF = dict(model_name="tp_test", batch_size=8, max_epoch=1, learning_rate=1e-3, max_grad_norm=1.0,
           bf16=False, in_channels=2, out_channels=2, channels=64, attention_levels=[1],
           n_res_blocks=1, channel_multipliers=[1, 2], n_heads=2, tf_layers=1, d_cond=1152,
           linear_start=0.00085, linear_end=0.012, n_steps=50, img_h=32, img_w=32,
           cond_type="chord", cond_mode="cond", use_enc=False, ema_decay=0.9)
# tests/test_inference_utils.py::test_dp_sharded_paint_bit_exact's session
PAINT = dict(SDF, channels=32, n_steps=8, cond_mode="mix", learning_rate=1e-4, max_grad_norm=10)
# tests/test_torch_autoencoder.py's widths at batch 8, the discriminator on from step 0
AE = dict(model_name="autoencoder", batch_size=8, max_epoch=1, learning_rate=5e-5,
          max_grad_norm=10, bf16=False, in_channels=3, out_channels=3, z_channels=4, channels=64,
          n_res_blocks=1, channel_multipliers=[1, 2], emb_channels=4, disc_start=0,
          kl_weight=1e-6, disc_weight=0.5, img_h=32)
B, HW = 8, 32
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # tests/test_torch_train.py
ROUTES = ["dp", "fsdp", "tp2x2", "tp1x4"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _jax_params(cfg, seed):
    task = JaxSDFTask(JaxParams(cfg))
    params = jax.jit(task.init_params)(jax.random.PRNGKey(seed))
    return task, jax.tree_util.tree_map(np.asarray, params)


class Ranks:
    """Worker processes of one gloo group; ``results`` waits for them."""

    def __init__(self, out_dir, world, *args):
        self.out_dir = out_dir
        env = dict(os.environ, OMP_NUM_THREADS="1")
        port = str(free_port())
        self.logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"), *args, str(out_dir),
             str(r), str(world), port], stdout=open(log, "w"), stderr=subprocess.STDOUT, env=env)
            for r, log in enumerate(self.logs)]
        self._results = None

    def wait(self, timeout=600):
        try:
            for p in self.procs:
                p.wait(timeout=timeout)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in self.procs):
            tails = "\n".join(open(log).read()[-3000:] for log in self.logs)
            pytest.fail(f"a rank failed:\n{tails}")

    @property
    def results(self):
        if self._results is None:
            self.wait()
            self._results = torch.load(os.path.join(self.out_dir, "results.pt"), weights_only=False)
        return self._results


@pytest.fixture(scope="module")
def inputs():
    """The tests' numpy inputs and JAX-initialised weights, as the ranks read them."""
    rng = np.random.default_rng(3)
    _, params = _jax_params(SDF, 0)
    _, paint_params = _jax_params(PAINT, 0)
    state = unet_state_from_jax(params)
    teacher = {k: v + 0.01 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
               for k, v in state.items()}
    mask = np.zeros((B, 2, HW, HW), np.float32)
    mask[:, :, :16] = 1.0
    return dict(
        jax_params=params, jax_paint_params=paint_params,
        sdf_cfg=SDF, sdf_state=state, teacher_state=teacher, ae_cfg=AE,
        paint_cfg=PAINT, paint_state=unet_state_from_jax(paint_params),
        x0=torch.from_numpy((rng.random((B, 2, HW, HW)) > 0.9).astype(np.float32)),
        chord=torch.from_numpy((rng.random((B, 32, 36)) > 0.8).astype(np.float32)),
        t=torch.from_numpy(rng.integers(0, SDF["n_steps"], B)),
        noise=torch.from_numpy(rng.standard_normal((B, 2, HW, HW)).astype(np.float32)),
        d_index=torch.from_numpy(rng.integers(0, SDF["n_steps"], B)),
        roll=torch.from_numpy((rng.random((B, 2, HW, HW)) > 0.85).astype(np.float32)),
        ae_eps=torch.from_numpy(rng.standard_normal((B, 4, HW // 2, HW // 2)).astype(np.float32)),
        # JAX's dp paint: its draws, in its order
        **dict(zip(("p_cond", "p_orig", "p_noise"), _paint_draws())), p_mask=mask,
    )


def _paint_draws():
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((B, 1, PAINT["d_cond"])).astype(np.float32)
    orig = rng.random((B, 2, HW, HW)).astype(np.float32)
    noise = rng.standard_normal((B, HW, HW, 2)).astype(np.float32)
    return cond, orig, noise


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Starts the 4 ranks; their results are read when a test first asks."""
    d = tmp_path_factory.mktemp("ranks")
    torch.save({k: v for k, v in inputs.items() if not k.startswith("jax_")}, d / "inputs.pt")
    r = Ranks(str(d), WORLD, "steps")
    yield r
    r.wait()


@pytest.fixture(scope="module")
def jax_step(inputs, ranks):
    """JAX's single-device step (make_optimizer + value_and_grad, EMA as
    ``train/step.py``) on the same inputs; computed while the ranks run."""
    jtask = JaxSDFTask(JaxParams(SDF))
    params = inputs["jax_params"]
    opt = jax_make_optimizer(SDF["learning_rate"], SDF["max_grad_norm"])

    def loss_of(p, x0, chord, t, noise):
        cond = jtask.encode_cond((None, None, chord, None), None)
        xt = jax_q_sample(jtask.schedule, x0, t, noise)
        return jnp.mean((noise - jtask.apply_eps(p, xt, t, cond)) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(
        params, jnp.asarray(_nhwc(inputs["x0"].numpy())), jnp.asarray(inputs["chord"].numpy()),
        jnp.asarray(inputs["t"].numpy()), jnp.asarray(_nhwc(inputs["noise"].numpy())))
    updates, _ = opt.update(grads, opt.init(params), params)
    new = jax.tree_util.tree_map(lambda a, u: np.asarray(a + u), params, updates)
    d = np.float32(SDF["ema_decay"])
    ema = jax.tree_util.tree_map(lambda e, a: e * d + a * (1 - d), params, new)
    gnorm = float(jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads))))
    return float(loss), gnorm, unet_state_from_jax(new), unet_state_from_jax(ema)


@pytest.fixture(scope="module")
def one_process(inputs, ranks):
    """The port's own one-process steps and session on the same inputs."""
    return {"sdf": W.sdf_step(inputs, None)[0], "ae": W.ae_step(inputs, None),
            "distill": W.distill_step(inputs, None), "paint": W.paint(inputs, None)}


def _assert_adam_close(got, want, lr, bound=0.1):
    """Parameters after one Adam step of ``lr`` (tests/test_torch_train.py:188):
    every element within ``bound`` lr (Adam divides by sqrt(v) + 1e-8, so a
    gradient within a few 1e-8 of zero moves by a fraction of lr), and all
    but 0.1 % of them to fp32 rounding (2e-6)."""
    assert set(got) == set(want)
    err = np.concatenate([np.abs(np.asarray(got[k]) - np.asarray(want[k])).ravel() for k in want])
    assert err.max() <= bound * lr, err.max()
    assert (err > 2e-6).mean() < 1e-3, (err > 2e-6).mean()


# -- the policies -----------------------------------------------------------------------


class _Mesh:
    """The mesh attributes the port's policies read."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim=None):
        return self._sizes[dim]


def _logical_axes(jax_tree, jax_specs):
    """Port name -> the torch dimension that JAX's spec'd dimension of the
    same leaf becomes (None: JAX replicates it), matched through
    ``unet_state_from_jax``: each JAX leaf k is filled with k * 4096 + its
    coordinate along the spec'd axis, then converted."""
    leaves, treedef = jax.tree_util.tree_flatten(jax_tree)
    specs = jax.tree_util.tree_leaves(jax_specs, is_leaf=lambda x: hasattr(x, "spec"))
    axes, marked = [], []
    for k, (leaf, sh) in enumerate(zip(leaves, specs)):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        sharded = [j for j, a in enumerate(spec) if a is not None]
        assert len(sharded) <= 1
        axes.append(sharded[0] if sharded else None)
        coord = np.zeros(leaf.shape, np.float32)
        if sharded:
            j = sharded[0]
            coord = coord + np.arange(leaf.shape[j], dtype=np.float32).reshape(
                [-1 if i == j else 1 for i in range(len(leaf.shape))])
        marked.append(coord + np.float32(k * 4096))
    out = {}
    for name, t in unet_state_from_jax(jax.tree_util.tree_unflatten(treedef, marked)).items():
        t = t.numpy()
        k = int(t.min()) // 4096
        if axes[k] is None:
            assert (t == k * 4096).all(), name
            out[name] = None
            continue
        varies = [d for d in range(t.ndim) if t.shape[d] > 1 and
                  not (np.diff(t, axis=d) == 0).all()]
        assert len(varies) == 1, (name, varies)
        out[name] = varies[0]
    return out


def test_fsdp_policy_matches_jax(inputs):
    """The leaves JAX's ``infer_fsdp_sharding`` shards on a 4-device dp mesh,
    each along the same logical axis; the rest replicated."""
    want = _logical_axes(inputs["jax_params"],
                         jax_infer_fsdp(inputs["jax_params"], jax_make_mesh(jax.devices()[:WORLD])))
    task = SDFTask(Params(SDF), device="cpu", training=True)
    got = infer_fsdp_sharding(task.unet, _Mesh(dp=WORLD))
    assert got == want
    assert sum(d is not None for d in got.values()) > 10
    # one rank: JAX's replicates everything; here the same large leaves get
    # one-way shards, each the whole leaf (the replicated layout)
    one = infer_fsdp_sharding(task.unet, _Mesh(dp=1))
    assert set(_logical_axes(inputs["jax_params"], jax_infer_fsdp(
        inputs["jax_params"], jax_make_mesh(jax.devices()[:1]))).values()) == {None}
    sizes = dict(task.unet.named_parameters())
    assert {n for n, d in one.items() if d is not None} == {
        n for n, p in sizes.items() if p.numel() >= MIN_SHARD_ELEMS}
    assert all(d is None or sizes[n].shape[d] == max(sizes[n].shape) for n, d in one.items())


def test_tp_policy_matches_jax_at_flagship_sites():
    """``infer_tp_sharding`` of the full-width sdf_chd8bar UNet equals JAX's
    specs on a (2, 4) mesh at every parameter, so at every site of
    tests/test_tp.py:107-153 (ResBlock in/out convs and time projections,
    attention q/k/v/out, GeGLU in/out); the SpatialTransformer's 1x1
    proj_in/proj_out and the norms are replicated."""
    cfg = load_params("sdf_chd8bar")
    jtask = JaxSDFTask(JaxParams({**cfg, "bf16": False}))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(jtask.init_params, jax.random.PRNGKey(0)))
    want = _logical_axes(params, jax_infer_tp(params, jax_make_tp_mesh(2, 4)))
    unet = make_unet(Params(cfg))
    got = infer_tp_sharding(unet, _Mesh(dp=2, tp=4))
    assert got == want
    # 22 ResBlocks x (in conv + bias, time projection + bias, out conv),
    # 11 SpatialTransformers x (2 x q, k, v, out; GeGLU in + bias, out) and
    # the last conv (JAX's out_conv, row-parallel by the name rule)
    assert sum(d is not None for d in got.values()) == 22 * 5 + 11 * 11 + 1
    assert got["out.2.weight"] == 1
    assert sum(n.endswith("in_layers.2.weight") and d == 0 for n, d in got.items()) == 22
    assert sum(n.endswith("to_q.weight") and d == 0 for n, d in got.items()) == 22
    assert got["middle_block.1.proj_out.weight"] is None
    assert got["output_blocks.5.1.transformer_blocks.0.ff.net.2.weight"] == 1
    # a mesh without tp replicates everything
    assert set(infer_tp_sharding(unet, _Mesh(dp=8)).values()) == {None}


# -- train steps --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_jax(route, ranks, jax_step):
    """The 4-rank step equals JAX's single-device step on the same batch and
    StepNoise: the loss of the global batch, the clip's norm counting each
    element once, the parameters and EMA after Adam."""
    loss, gnorm, params, ema = jax_step
    got = ranks.results[route]
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], gnorm, rtol=GRAD_RTOL)
    _assert_adam_close(got["params"], params, SDF["learning_rate"])
    _assert_adam_close(got["ema"], ema, SDF["learning_rate"])


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_one_process(route, ranks, one_process):
    one, got = one_process["sdf"], ranks.results[route]
    np.testing.assert_allclose(got["metrics"]["loss"], one["metrics"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], one["metrics"]["grad_norm"],
                               rtol=GRAD_RTOL)
    _assert_adam_close(got["params"], one["params"], SDF["learning_rate"])
    # the checkpoint format: the one-process optimizer state, whole
    a, b = got["opt_state"], one["opt_state"]
    assert a["param_groups"] == b["param_groups"] and set(a["state"]) == set(b["state"])
    for i, entry in b["state"].items():
        assert {k: tuple(v.shape) for k, v in a["state"][i].items()} == {
            k: tuple(v.shape) for k, v in entry.items()}


def test_fsdp_shards_the_policy_leaves_a_quarter_each(ranks, inputs):
    """Each leaf the policy shards is a DTensor along the policy's dimension,
    and a rank holds 1/4 of it, of both Adam moments and of its EMA; every
    other leaf is whole on every rank."""
    shards = ranks.results["fsdp_shards"]
    task = SDFTask(Params(SDF), device="cpu", training=True)
    plan = infer_fsdp_sharding(task.unet, _Mesh(dp=WORLD))
    assert {n: s["dim"] for n, s in shards.items()} == plan
    for name, s in shards.items():
        held = s["full"] // WORLD if s["dim"] is not None else s["full"]
        assert (s["master"], s["exp_avg"], s["exp_avg_sq"], s["ema"]) == (held,) * 4, name


def test_autoencoder_dp_step_matches_one_process(ranks, one_process):
    """The discriminator's batch norms and the adaptive weight take the global
    batch's statistics: every metric, the norm and the parameters of the
    4-rank step equal the one-process step of the whole batch."""
    one, got = one_process["ae"], ranks.results["ae_dp"]
    assert one["metrics"]["disc_factor"] == 1.0
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=GRAD_RTOL if k == "grad_norm"
                                   else LOSS_RTOL, atol=1e-6, err_msg=k)
    # the gradients as tests/test_torch_autoencoder.py holds them (per tensor,
    # rel 1e-4 in norm), clipped alike
    _assert_grads_close({k: v.numpy() for k, v in got["grads"].items()},
                        {k: v.numpy() for k, v in one["grads"].items()})


@pytest.mark.parametrize("route", ["distill_dp", "distill_fsdp"])
def test_distill_step_matches_one_process(route, ranks, one_process):
    """A guided distillation step, the frozen teacher replicated; parameters
    within tests/test_torch_distill.py's 2 lr an element."""
    one, got = one_process["distill"], ranks.results[route]
    np.testing.assert_allclose(got["metrics"]["loss"], one["metrics"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], one["metrics"]["grad_norm"],
                               rtol=GRAD_RTOL)
    _assert_adam_close(got["params"], one["params"], SDF["learning_rate"], bound=2.0)


# -- sampling -------------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["paint_dp", "paint_fsdp"])
def test_sampling_matches_one_process(route, ranks, one_process):
    """Every rank returns the whole batch; it equals the one-process
    session's up to the rounding of the net at a quarter of the batch (the
    tolerance of tests/test_torch_inference.py's batched-vs-solo check)."""
    np.testing.assert_allclose(ranks.results[route], one_process["paint"], atol=1e-5, rtol=1e-5)


def test_dp_paint_matches_jax_dp_paint(inputs, ranks):
    """tests/test_inference_utils.py:173-211's request: JAX's dp paint over 8
    devices against the port's over 4 ranks (tests/test_torch_slice.py's
    tolerance)."""
    jtask = JaxSDFTask(JaxParams(PAINT))
    session = JaxSession(jtask, inputs["jax_paint_params"], use_ddim=True, ddim_steps=3, seed=0,
                         mesh=jax_make_mesh())
    want = np.asarray(session.predict(inputs["p_cond"], uncond_scale=5.0, orig=inputs["p_orig"],
                                      mask=inputs["p_mask"], noise=inputs["p_noise"]))
    np.testing.assert_allclose(ranks.results["paint_dp"], want, atol=2e-3, rtol=1e-3)


# -- refusals and helpers ---------------------------------------------------------------


def test_refusals_on_a_tp_mesh(inputs):
    """JAX's two ValueErrors (train/step.py:79-90), and fsdp without a mesh."""
    tp = _Mesh(dp=2, tp=2)
    task = SDFTask(Params(SDF), device="cpu", training=True)
    with pytest.raises(ValueError, match="fsdp=True is not supported on a tp mesh"):
        make_train_step(task, mesh=tp, fsdp=True)
    distill = DistillTask(task, inputs["sdf_state"], 5.0, "guided")
    with pytest.raises(ValueError, match="distillation .* on a tp mesh is unimplemented"):
        make_train_step(distill, mesh=tp)
    with pytest.raises(ValueError, match="needs a dp mesh"):
        make_train_step(task, fsdp=True)


def test_tp_refuses_the_fused_gn_conv_route():
    """ROADMAP item 21: the fused GroupNorm-SiLU-conv kernels take whole
    channels; under tp the route is refused, not run whole on every rank."""
    task = SDFTask(Params(SDF), device="cpu", training=True, gn_conv="fused")
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        shard_state(task.unet, _Mesh(dp=2, tp=2))


def test_fsdp_key_is_never_ignored(tmp_path):
    """The config key ``fsdp: true`` without a mesh is refused, not dropped."""
    task = SDFTask(Params(SDF), device="cpu", training=True)
    with pytest.raises(ValueError, match="fsdp: true needs a dp mesh"):
        Trainer(task, Params({**SDF, "fsdp": True}), str(tmp_path / "run"))


def test_noise_rows_follow_the_global_draw():
    """A rank draws the global batch's noise and keeps its rows: per-row
    fields split, per-step coins shared, PianoTree's segment-major z split
    by batch row."""
    batch = (torch.zeros(2, 2, 8, 8), torch.zeros(2, 128, 20, 6))
    view = global_view(batch, 4)
    assert view[0].shape == (8, 2, 8, 8) and view[0].device.type == "meta"
    noise = StepNoise(torch.arange(8), torch.arange(8.0)[:, None], torch.tensor(True))
    kept = keep_rows(noise, RowShard(2, 4))
    assert kept.t.tolist() == [4, 5] and kept.noise[:, 0].tolist() == [4.0, 5.0] and kept.drop
    z = torch.arange(32.0)[:, None]  # 8 rows x 4 segments
    pt = keep_rows(PianoTreeNoise(z, torch.ones(3), torch.ones(3, 2)), RowShard(1, 4))
    assert pt.z[:, 0].tolist() == list(range(8, 16)) and pt.tf1.shape == (3,)
    with pytest.raises(ValueError, match="do not divide"):
        RowShard(0, 3).rows(8)
