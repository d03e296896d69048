"""PolyDis (``models/polydis.py``) and its converter, the port against the JAX
package on the CPU in fp32 at the reference's widths (PolyDis has no width
arguments): JAX init -> ``polydis_state_from_jax`` -> strict load, then both
packages on the same inputs and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.models.polydis import PolyDis as JaxPolyDis
from polyffusion_tpu.models.polydis import slerp_interp as jax_slerp_interp
from polyffusion_tpu.models.polydis import slerp_path as jax_slerp_path
from polyffusion_tpu.utils.reprs import chd_to_onehot, nmat_to_pianotree_repr, nmat_to_prmat
from polyffusion_tpu_torch.convert import polydis_state_from_jax, reference_state
from polyffusion_tpu_torch.models.polydis import (
    PolyDis,
    PolydisAftertouch,
    PolyDisNoise,
    slerp_interp,
    slerp_path,
)

ENC_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_ATOL = 1e-4  # the JAX package's decoder parity (tests/test_pianotree_dec_parity.py:66)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # tests/test_torch_train.py's step limits
B = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jm = JaxPolyDis()
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = PolyDis(device="cpu")
    tm.load_state_dict(polydis_state_from_jax(params), strict=True)
    return jm, params, tm


def make_inputs(seed=0):
    """(pnotree (B, 32, 32, 6), chord one-hots (B, 8, 36), prmat (B, 32, 128))
    of two 2-bar windows."""
    rng = np.random.default_rng(seed)
    pts, chds, prs = [], [], []
    for _ in range(B):
        n = 48
        nmat = np.stack([np.sort(rng.integers(0, 32, n)), rng.integers(36, 96, n),
                         rng.integers(1, 9, n)], 1)
        pts.append(nmat_to_pianotree_repr(nmat, n_step=32, max_note_count=32))
        prs.append(nmat_to_prmat(nmat, 32).astype(np.float32))
        chd = np.zeros((8, 14), np.int64)
        chd[:, 0] = rng.integers(0, 12, 8)
        chd[:, 1:13] = rng.integers(0, 2, (8, 12))
        chd[:, 13] = rng.integers(0, 12, 8)
        chds.append(chd_to_onehot(chd))
    return np.stack(pts), np.stack(chds), np.stack(prs)


def test_converted_weights_load_strictly(pair):
    _, params, tm = pair
    state = polydis_state_from_jax(params)
    assert set(state) == set(tm.state_dict())
    assert {k.split(".")[0] for k in state} == {"chd_encoder", "rhy_encoder", "decoder",
                                               "chd_decoder"}


def test_encode_matches_jax(pair):
    jm, params, tm = pair
    _, c, pr = make_inputs()
    (mu_c, std_c), (mu_r, std_r) = jm.encode(params, jnp.asarray(pr), jnp.asarray(c))
    with torch.no_grad():
        (tmu_c, tstd_c), (tmu_r, tstd_r) = tm.encode(pr, c)
    for got, want in ((tmu_c, mu_c), (tstd_c, std_c), (tmu_r, mu_r), (tstd_r, std_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


def test_decode_matches_jax(pair):
    jm, params, tm = pair
    _, c, pr = make_inputs()
    (mu_c, _), (mu_r, _) = jm.encode(params, jnp.asarray(pr), jnp.asarray(c))
    z = jnp.concatenate([mu_c, mu_r], axis=-1)
    pitch, dur = jm.decoder.apply({"params": params["decoder"]}, z, True, None, None, 0.0, 0.0)
    with torch.no_grad():
        tpitch, tdur = tm.decode_logits(np.asarray(mu_c), np.asarray(mu_r))
    assert tpitch.shape == (B, 32, 31, 130) and tdur.shape == (B, 32, 31, 5, 2)
    np.testing.assert_allclose(tpitch.numpy(), np.asarray(pitch), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tdur.numpy(), np.asarray(dur), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tm.decode(np.asarray(mu_c), np.asarray(mu_r)),
                                  jm.decode(params, mu_c, mu_r))


def _jax_run_noise(rng, b, tfr):
    """The draws of JAX ``PolyDis.run`` (:122-126) and its decoders' coins."""
    k_chd, k_rhy, k_dec, k_cdec = jax.random.split(rng, 4)
    k1, k2 = jax.random.split(k_dec)
    return PolyDisNoise(
        torch.from_numpy(np.array(jax.random.normal(k_chd, (b, 256)))),
        torch.from_numpy(np.array(jax.random.normal(k_rhy, (b, 256)))),
        torch.from_numpy(np.array(jax.random.uniform(k1, (32,)) < tfr)),
        torch.from_numpy(np.array(jax.random.uniform(k2, (32, 31)) < tfr)),
        torch.from_numpy(np.array(jax.random.uniform(k_cdec, (8,)) < tfr)))


def test_loss_and_gradients_match_jax(pair):
    """Teacher-forced at 0.5 on every level, so both coin values occur."""
    jm, params, tm = pair
    x, c, pr = make_inputs(1)
    rng = jax.random.PRNGKey(1)
    (_, terms), grads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(x), jnp.asarray(c), jnp.asarray(pr), rng, 0.5, 0.5, 0.5),
        has_aux=True)(params)
    noise = _jax_run_noise(rng, B, 0.5)
    assert 0 < int(noise.tf2.sum()) < noise.tf2.numel()
    tm.zero_grad()
    total, got = tm.loss(x, c, pr, noise)
    total.backward()
    assert sorted(got) == sorted(terms)
    for k, w in terms.items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=LOSS_RTOL, err_msg=k)
    want = polydis_state_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for k, p in tm.named_parameters():
        err = (p.grad - want[k]).norm().item()
        assert err <= GRAD_RTOL * want[k].norm().item() + 1e-9, (k, err)


def test_sampling_utilities_match_jax(pair):
    """inference (sample and chd_sample), posterior and prior samples, swap (an
    inference of the inputs it picks) and interp, each with JAX's draws handed
    to the port: the same grids."""
    jm, params, tm = pair
    _, c, pr = make_inputs(2)
    _, c2, pr2 = make_inputs(3)
    (mu_c, _), (mu_r, _) = jm.encode(params, jnp.asarray(pr), jnp.asarray(c))
    rng = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(rng, 3)
    noise3 = [np.asarray(jax.random.normal(k, m.shape)) for k, m in ((k1, mu_c), (k2, mu_r),
                                                                      (k3, mu_c))]
    np.testing.assert_array_equal(
        tm.inference(pr, c, sample=True, chd_sample=True, noise=noise3),
        jm.inference(params, pr, c, sample=True, chd_sample=True, rng=rng))
    np.testing.assert_array_equal(tm.inference(pr, c), jm.inference(params, pr, c))
    j1, j2 = jax.random.split(rng)
    noise2 = [np.asarray(jax.random.normal(j1, mu_c.shape)),
              np.asarray(jax.random.normal(j2, mu_r.shape))]
    np.testing.assert_array_equal(
        tm.posterior_sample(pr, c, scale=0.5, sample_txt=False, noise=noise2),
        jm.posterior_sample(params, pr, c, scale=0.5, sample_txt=False, rng=rng))
    np.testing.assert_array_equal(
        tm.prior_sample(pr, c, sample_chd=True, scale=0.7, noise=noise2),
        jm.prior_sample(params, pr, c, sample_chd=True, scale=0.7, rng=rng))
    np.testing.assert_array_equal(tm.swap(pr2, pr, c, c2, fix_rhy=False, fix_chd=True),
                                  jm.inference(params, pr, c))
    np.testing.assert_array_equal(
        tm.interp(pr, c, pr2, c2, interp_chd=True, interp_rhy=True, int_count=2),
        jm.interp(params, pr, c, pr2, c2, interp_chd=True, interp_rhy=True, int_count=2))


def test_slerp_matches_jax():
    rng = np.random.default_rng(4)
    z1, z2 = rng.standard_normal((3, 256)), rng.standard_normal((3, 256))
    np.testing.assert_allclose(slerp_path(z1[0], z2[0], 7), jax_slerp_path(z1[0], z2[0], 7),
                               atol=1e-6)
    np.testing.assert_allclose(slerp_interp(z1, z2), jax_slerp_interp(z1, z2), atol=1e-6)
    z32 = z1.astype(np.float32).reshape(3, 16, 16)
    np.testing.assert_allclose(slerp_interp(z32, z32[::-1]), jax_slerp_interp(z32, z32[::-1]),
                               atol=1e-6)


def test_reference_checkpoint_loads_strictly(pair, tmp_path):
    """The reference layout: ``{"model": ...}`` with DataParallel's ``module.``
    prefixes, as ``model_master_final.pt``; the JAX package reads the same
    file into the same parameters."""
    jm, params, tm = pair
    path = str(tmp_path / "model_master_final.pt")
    torch.save({"model": {f"module.{k}": v for k, v in tm.state_dict().items()}}, path)
    loaded = PolyDis(device="cpu")
    loaded.load_state_dict(reference_state(path), strict=True)
    for k, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    after = PolydisAftertouch(model_path=path, device="cpu")
    assert all(torch.equal(after.model.state_dict()[k], v) for k, v in tm.state_dict().items())
    back = jm.params_from_torch_file(path)
    jax.tree_util.tree_map(np.testing.assert_array_equal, jax.tree_util.tree_map(np.asarray, back),
                           params)


def test_random_weights_are_seeded():
    """Without a checkpoint the aftertouch's PolyDis is random, seeded 0 (the
    learned inputs U(0, 1), as the reference's ``torch.rand``)."""
    a = PolydisAftertouch(device="cpu").model.state_dict()
    b = PolydisAftertouch(device="cpu").model.state_dict()
    c = PolyDis(device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    d = PolyDis(device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]) for k in a)
    assert not torch.equal(a["decoder.dur_sos_token"], d["decoder.dur_sos_token"])
    assert 0 <= a["decoder.dec_init_input"].min() and a["decoder.dec_init_input"].max() <= 1
