"""Data-parallel steps of the tasks whose losses are means over the batch,
fp32 on the CPU: ``pnotree_vae``, ``chd_8bar`` and ``ddpm`` at tiny widths,
each a 2-rank gloo step against the port's one-process step of the whole
batch and against JAX's single-device step (``value_and_grad`` of its
``loss_fn``, then ``make_optimizer``) on that batch.

The PianoTree loss is a masked mean: JAX divides the summed log-likelihood by
the global batch's count of unpadded notes. Here the two ranks hold
different note counts (rank 1's song is sparse, with time steps that are all
padding past their first slot), so a loss divided by each rank's own count
and then averaged over dp is not the global batch's.

The ranks are gloo processes (``tests/torch_parallel_worker.py losses``, torch
only), spawned once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.models.encoders import PianoTreeEncoder as JaxPianoTreeEncoder
from polyffusion_tpu.models.pianotree_dec import PianoTreeDecoder as JaxPianoTreeDecoder
from polyffusion_tpu.tasks.chd_8bar import Chd8BarTask as JaxChd8BarTask
from polyffusion_tpu.tasks.ddpm import DDPMTask as JaxDDPMTask
from polyffusion_tpu.tasks.pnotree_vae import PnoTreeVAETask as JaxPnoTreeVAETask
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.convert import ddpm_unet_state_from_jax

import test_torch_chd8bar as CHD
import test_torch_pnotree_vae as PNO
import torch_parallel_worker as W
from test_torch_parallel import Ranks, _assert_adam_close

WORLD = 2
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # tests/test_torch_parallel.py's step limits
STEP_RTOL = 1e-4  # the loss and the clip's norm of a dp step against the one-process step
TASKS = ("pnotree_vae", "chd_8bar", "ddpm")
PNO_CFG = dict(PNO.CFG, batch_size=2)
CHD_CFG = dict(CHD.CFG, batch_size=4)
# tests/test_torch_ddpm_unet.py's task at batch 4
DDPM_CFG = dict(model_name="ddpm", batch_size=4, max_epoch=1, learning_rate=1e-3,
                max_grad_norm=1.0, bf16=False, image_channels=2, image_size_h=16,
                image_size_w=16, n_channels=64, channel_multipliers=[1, 2],
                is_attention=[False, True], n_steps=20)
PNO_SCHED = {"tfr_pnt1": 0.6, "tfr_pnt2": 0.4}
CHD_TFR = 0.5
# parameters after Adam, per element in lr: its first step moves an element by
# lr g / (|g| + 1e-8), so a gradient within rounding of zero moves anywhere in
# (-lr, lr); the DDPM UNet has such gradients (tests/test_torch_ddpm_unet.py's
# bound of 2 lr), the VAEs do not (tests/test_torch_parallel.py's 0.1 lr)
ADAM_BOUND = {"pnotree_vae": 0.1, "chd_8bar": 0.1, "ddpm": 2.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _uneven_pnotree(rng):
    """Two 8-bar songs, one a rank: song 0 with 0 to 8 notes a step (as
    tests/test_torch_pnotree_vae.py draws), song 1 with at most one, so that
    its time steps are all padding past the first slot or hold only an eos
    there; song 1 has no duration label at all."""
    dense = PNO._pnotree(rng, 1, steps=128)
    sparse = np.zeros((1, 128, 20, 6), np.int64)
    sparse[..., 0] = 130
    sparse[..., 1:] = 2
    for t in range(128):
        n = int(rng.integers(0, 2))
        sparse[0, t, :n, 0] = rng.integers(0, 128, n)
        sparse[0, t, :n, 1:] = rng.integers(0, 2, (n, 5))
        sparse[0, t, n, 0] = 129
    sparse[0, 5, :, 0] = 130  # a step of padding alone
    return np.concatenate([dense, sparse])


def _jax_pnotree(rng, key):
    """JAX's task at the tiny widths, its params, the global batch and what
    its loss draws from ``key`` (tests/test_torch_pnotree_vae.py's order)."""
    jtask = JaxPnoTreeVAETask(JaxParams(PNO_CFG))
    jtask.enc = JaxPianoTreeEncoder(**PNO.ENC)
    jtask.dec = JaxPianoTreeDecoder(**PNO.DEC)
    params = _np_tree(jtask.init_params(jax.random.PRNGKey(0)))
    pt = _uneven_pnotree(rng)
    k_sample, k_dec = jax.random.split(key)
    k1, k2 = jax.random.split(k_dec)
    noise = (torch.from_numpy(np.array(jax.random.normal(k_sample, (8, PNO.DEC["z_size"])))),
             torch.from_numpy(np.array(jax.random.uniform(k1, (32,)) < PNO_SCHED["tfr_pnt1"])),
             torch.from_numpy(np.array(jax.random.uniform(k2, (32, 19)) < PNO_SCHED["tfr_pnt2"])))
    batch = (None, torch.from_numpy(pt).to(torch.int16), None, None)
    return dict(jtask=jtask, params=params, sched=PNO_SCHED, jax_batch=(
        None, jnp.asarray(pt, jnp.int32), None, None), batch=batch, noise=noise,
        state=PNO._port_state(params), to_port=PNO._port_state, cfg=PNO_CFG)


def _jax_chd(rng, key):
    jtask = JaxChd8BarTask(JaxParams(CHD_CFG))
    params = _np_tree(jtask.init_params(jax.random.PRNGKey(0)))
    chord = CHD._chords(rng, CHD_CFG["batch_size"])
    z, tf = CHD._jax_noise(key, CHD_CFG["batch_size"], CHD_TFR)
    return dict(jtask=jtask, params=params, sched={"tfr_chd": CHD_TFR},
                jax_batch=(None, None, jnp.asarray(chord), None),
                batch=(None, None, torch.from_numpy(chord), None), noise=(z, tf),
                state=CHD._port_state(params), to_port=CHD._port_state, cfg=CHD_CFG)


def _jax_ddpm(rng, key):
    jtask = JaxDDPMTask(JaxParams(DDPM_CFG))
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    b, hw = DDPM_CFG["batch_size"], DDPM_CFG["image_size_h"]
    x0 = (rng.random((b, 2, hw, hw)) > 0.85).astype(np.float32)
    t_key, eps_key = jax.random.split(key)  # what JAX's DDPMTask.loss_fn draws (:56-58)
    t = np.asarray(jax.random.randint(t_key, (b,), 0, DDPM_CFG["n_steps"]))
    noise = np.asarray(jax.random.normal(eps_key, (b, hw, hw, 2)))
    return dict(jtask=jtask, params=params, sched={},
                jax_batch=(jnp.asarray(x0), None, None, None),
                batch=(torch.from_numpy(x0), None, None, None),
                noise=(torch.from_numpy(t.copy()),
                       torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2)))),
                state=ddpm_unet_state_from_jax(params), to_port=ddpm_unet_state_from_jax,
                cfg=DDPM_CFG)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(11)
    return {"pnotree_vae": _jax_pnotree(rng, jax.random.PRNGKey(7)),
            "chd_8bar": _jax_chd(rng, jax.random.PRNGKey(8)),
            "ddpm": _jax_ddpm(rng, jax.random.PRNGKey(9))}


def _inputs(cases):
    inp = {"pno_enc": PNO.ENC, "pno_dec": PNO.DEC}
    for name, c in cases.items():
        inp.update({f"{name}_cfg": c["cfg"], f"{name}_state": c["state"],
                    f"{name}_batch": c["batch"], f"{name}_noise": c["noise"]})
    return inp


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    d = tmp_path_factory.mktemp("loss_ranks")
    torch.save(_inputs(cases), d / "inputs.pt")
    r = Ranks(str(d), WORLD, "losses")
    yield r
    r.wait()


@pytest.fixture(scope="module")
def one_process(cases, ranks):
    """The port's one-process steps of the whole batch, run while the ranks run."""
    inp = _inputs(cases)
    return {name: W.pretrain_step(inp, name, None) for name in TASKS}


@pytest.fixture(scope="module")
def jax_steps(cases, ranks):
    """JAX's step of each task on the global batch: loss, the clip's norm and
    the parameters after ``make_optimizer`` (clip, then Adam)."""
    out = {}
    for name, c in cases.items():
        cfg = c["cfg"]
        opt = jax_make_optimizer(cfg["learning_rate"], cfg["max_grad_norm"])
        key = {"pnotree_vae": 7, "chd_8bar": 8, "ddpm": 9}[name]
        (loss, _), grads = jax.jit(jax.value_and_grad(c["jtask"].loss_fn, has_aux=True))(
            c["params"], c["jax_batch"], jax.random.PRNGKey(key), c["sched"])
        updates, _ = opt.update(grads, opt.init(c["params"]), c["params"])
        new = jax.tree_util.tree_map(lambda a, u: np.asarray(a + u), c["params"], updates)
        gnorm = float(jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads))))
        out[name] = (float(loss), gnorm, c["to_port"](new))
    return out


def test_the_ranks_hold_unequal_note_counts(cases):
    """The case the fault needs: rank 1's song has fewer pitch labels than
    rank 0's and no duration label."""
    pt = cases["pnotree_vae"]["batch"][1].numpy()
    pitch = (pt[:, :, 1:, 0] != 130).sum(axis=(1, 2))
    dur = (pt[:, :, 1:, 1:] != 2).sum(axis=(1, 2, 3))
    assert pitch[1] < pitch[0] / 4 and dur[0] > 0 and dur[1] == 0, (pitch, dur)
    assert ((pt[1, :, 1:, 0] == 130).all(axis=-1)).mean() > 0.3


@pytest.mark.parametrize("name", TASKS)
def test_dp_step_matches_one_process(name, ranks, one_process, cases):
    """The 2-rank step equals the one-process step of the whole batch: the
    loss and every metric, the global-norm gradient, and the parameters
    after Adam."""
    one, got = one_process[name], ranks.results[name]
    assert set(got["metrics"]) == set(one["metrics"])
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=STEP_RTOL, err_msg=k)
    _assert_adam_close(got["params"], one["params"], cases[name]["cfg"]["learning_rate"],
                       bound=ADAM_BOUND[name])


@pytest.mark.parametrize("name", TASKS)
def test_dp_step_matches_jax_on_the_global_batch(name, ranks, jax_steps, cases):
    loss, gnorm, params = jax_steps[name]
    got = ranks.results[name]
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], gnorm, rtol=GRAD_RTOL)
    _assert_adam_close(got["params"], params,
                       cases[name]["cfg"]["learning_rate"], bound=ADAM_BOUND[name])
