"""The slice as a whole: chord one-hots -> chord encoder -> DDIM + CFG
``predict``, the port against the JAX package on the CPU in fp32, with the
same JAX-initialised weights, the same chords and the same starting noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.inference import get_mask as jax_get_mask
from polyffusion_tpu.models.encoders import ChordEncoder as JaxChordEncoder
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import chord_encoder_state_from_jax, unet_state_from_jax
from polyffusion_tpu_torch.inference import InferenceSession, get_mask
from polyffusion_tpu_torch.models.encoders import ChordEncoder
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.utils.reprs import nmat_to_prmat2c

# built like tests/test_inference_utils.py:70-79, with the chord encoder on;
# one head of 64 at level 1 (256 tokens) takes the packed-attention path
CFG = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-4,
    max_grad_norm=10, bf16=False, in_channels=2, out_channels=2, channels=32,
    attention_levels=[1], n_res_blocks=1, channel_multipliers=[1, 2],
    n_heads=1, tf_layers=1, d_cond=32, linear_start=0.00085,
    linear_end=0.012, n_steps=40, img_h=32, img_w=32, cond_type="chord",
    cond_mode="mix", use_enc=True,
)
B, DDIM_STEPS = 2, 4


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    chords = np.zeros((B, 32, 36), np.float32)
    chords[:, np.arange(32), rng.integers(0, 12, 32)] = 1.0
    chords[:, :, 12:24] = rng.integers(0, 2, (B, 32, 12))
    chords[:, np.arange(32), 24 + rng.integers(0, 12, 32)] = 1.0

    jenc = JaxChordEncoder(hidden_dim=16, z_dim=32)
    enc_params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jenc.init)(jax.random.PRNGKey(1), jnp.asarray(chords))["params"]
    )
    jtask = JaxSDFTask(JaxParams(CFG), chord_enc=jenc, chord_enc_params=enc_params)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    jcond = np.asarray(jtask.encode_chord(jnp.asarray(chords)))

    tenc = ChordEncoder(36, 16, 32)
    tenc.load_state_dict(chord_encoder_state_from_jax(enc_params), strict=True)
    task = SDFTask(Params(CFG), tenc, device="cpu")
    task.load_unet_state(unet_state_from_jax(params))
    cond = task.encode_chord(torch.from_numpy(chords)).numpy()
    np.testing.assert_allclose(cond, jcond, atol=2e-5)
    noise = rng.standard_normal((B, 32, 32, 2)).astype(np.float32)
    return (
        JaxSession(jtask, params, use_ddim=True, ddim_steps=DDIM_STEPS, seed=0),
        InferenceSession(task, sampler="ddim", ddim_steps=DDIM_STEPS, device="cpu"),
        jcond,
        cond,
        noise,
    )


# the DDIM tolerance of tests/test_sampler_parity.py:129
ATOL, RTOL = 2e-3, 1e-3


@pytest.mark.parametrize("scale", [0.0, 1.0, 5.0])
def test_predict_matches_jax(pair, scale):
    jsess, sess, jcond, cond, noise = pair
    want = jsess.predict(jcond, uncond_scale=scale, noise=noise)
    got = sess.predict(cond, uncond_scale=scale, noise=noise)
    assert got.shape == (B, 2, 32, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_masked_predict_matches_jax(pair):
    jsess, sess, jcond, cond, noise = pair
    nmat = np.array([[t, 60 + (t % 7), 2] for t in range(0, 32, 2)], np.int64)
    orig = np.stack([nmat_to_prmat2c(nmat, 32)[:, :, 48:80]] * B)  # (B, 2, 32, 32)
    mask = get_mask(orig, "below")
    np.testing.assert_array_equal(mask, jax_get_mask(orig, "below"))
    assert 0 < mask.mean() < 1
    want = jsess.predict(jcond, uncond_scale=5.0, orig=orig, mask=mask, noise=noise)
    got = sess.predict(cond, uncond_scale=5.0, orig=orig, mask=mask, noise=noise)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_ddim_sample_with_noise_matches_jax(pair):
    """eta > 0: the per-step noise path, replayed from the same noises."""
    from polyffusion_tpu.diffusion import make_ddim_schedule as jax_make_ddim
    from polyffusion_tpu.diffusion import sampler as jax_sampler
    from polyffusion_tpu_torch.diffusion import make_ddim_schedule
    from polyffusion_tpu_torch.diffusion.sampler import ddim_sample

    jsess, sess, jcond, cond, noise = pair
    rng = np.random.default_rng(9)
    steps = rng.standard_normal((DDIM_STEPS, B, 32, 32, 2)).astype(np.float32)
    jdd = jax_make_ddim(jsess.schedule, DDIM_STEPS, "uniform", 0.5)
    uncond = -np.ones((B, 1, CFG["d_cond"]), np.float32)
    want = jax_sampler.ddim_sample(
        jsess.task.apply_eps, jsess.params, jdd, jnp.asarray(noise), jnp.asarray(jcond),
        jax.random.PRNGKey(0), uncond_scale=5.0, uncond_cond=jnp.asarray(uncond),
        noise_override=jnp.asarray(steps),
    )
    dd = make_ddim_schedule(sess.schedule, DDIM_STEPS, "uniform", 0.5)
    assert (dd.sigma > 0).any()
    got = ddim_sample(
        sess.task.apply_eps, dd, torch.from_numpy(noise), torch.from_numpy(cond),
        uncond_scale=5.0, uncond_cond=torch.from_numpy(uncond),
        noise_override=torch.from_numpy(steps),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_encode_cond_dropout():
    task = SDFTask(Params({**CFG, "use_enc": False, "d_cond": 32 * 36}), device="cpu")
    chords = torch.rand(3, 32, 36)
    batch = (None, None, chords, None)
    torch.testing.assert_close(task.encode_cond(batch), chords.reshape(3, 1, -1))
    g = torch.Generator().manual_seed(0)
    dropped = [bool((task.encode_cond(batch, g) == -1).all()) for _ in range(100)]
    assert 5 < sum(dropped) < 40  # one coin per batch, p = 0.2
    task.cond_mode = "uncond"
    assert bool((task.encode_cond(batch) == -1).all())


@pytest.mark.parametrize("with_mask", [False, True])
def test_midi_writer_matches_jax(tmp_path, with_mask):
    """``generate``/``inpaint`` write the same .mid bytes as the JAX package."""
    from polyffusion_tpu.utils.midi_io import prmat2c_to_midi_file as jax_write
    from polyffusion_tpu_torch.utils.midi_io import prmat2c_to_midi_file

    rng = np.random.default_rng(4)
    rolls = (rng.random((3, 2, 128, 128)) > 0.97).astype(np.float32)
    mask = (rng.random(rolls.shape) > 0.5).astype(np.float32) if with_mask else None
    jax_write(rolls, str(tmp_path / "jax.mid"), inp_mask=mask)
    prmat2c_to_midi_file(rolls, str(tmp_path / "port.mid"), inp_mask=mask)
    assert (tmp_path / "port.mid").read_bytes() == (tmp_path / "jax.mid").read_bytes()
