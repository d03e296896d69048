"""The PianoTree-VAE pretraining slice (``pnotree_vae``), the port against the
JAX package on the CPU in fp32: ``PianoTreeDecoder`` and its converter,
``emb_x``, ``pianotree_recon_loss``, ``output_to_pnotree``,
``kl_with_standard_normal``, the task's loss, metrics and gradients (tiny
widths), and the training CLI end to end at the preset's widths: ``pnotree_vae``
(batch 1: four 2-bar segments), then ``sdf_pnotree`` with that run directory
as its frozen PianoTree encoder, then the inference CLI."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.convert.torch_import import pianotree_decoder_params_from_torch
from polyffusion_tpu.models.encoders import PianoTreeEncoder as JaxPianoTreeEncoder
from polyffusion_tpu.models.pianotree_dec import PianoTreeDecoder as JaxPianoTreeDecoder
from polyffusion_tpu.models.pianotree_dec import output_to_pnotree as jax_output_to_pnotree
from polyffusion_tpu.models.pianotree_dec import pianotree_recon_loss as jax_recon_loss
from polyffusion_tpu.models.polydis import kl_with_standard_normal as jax_kl
from polyffusion_tpu.tasks.pnotree_vae import PnoTreeVAETask as JaxPnoTreeVAETask
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import (
    pianotree_decoder_state_from_jax,
    pianotree_encoder_state_from_jax,
)
from polyffusion_tpu_torch.data import write_song_npz
from polyffusion_tpu_torch.models import PianoTreeDecoder, PianoTreeEncoder, init_weights_
from polyffusion_tpu_torch.models.encoders import build_frozen_encoders
from polyffusion_tpu_torch.models.pianotree_dec import output_to_pnotree, pianotree_recon_loss
from polyffusion_tpu_torch.models.polydis import kl_with_standard_normal
from polyffusion_tpu_torch.tasks import PnoTreeVAETask, SDFTask
from polyffusion_tpu_torch.tasks.pnotree_vae import PianoTreeNoise
from polyffusion_tpu_torch.tasks.vae import VAE

LOGIT_ATOL = 1e-4  # the JAX package's decoder parity (tests/test_pianotree_dec_parity.py:66)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # tests/test_torch_train.py's step limits
# tiny decoder widths (the data's 32 steps x 20 note slots stay)
DEC = dict(note_emb_size=8, z_size=8, dec_emb_hid_size=6, dec_time_hid_size=16,
           dec_notes_hid_size=12, dec_z_in_size=10, dec_dur_hid_size=4)
ENC = dict(note_emb_size=16, enc_notes_hid_size=8, enc_time_hid_size=12, z_size=8)
CFG = dict(model_name="pnotree_vae", batch_size=1, max_epoch=1, learning_rate=1e-3,
           max_grad_norm=10, bf16=False, beta=0.1, pnt_z_dim=8, tfr_pnt1=[0.8, 0],
           tfr_pnt2=[0.8, 0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pnotree(rng, b, steps=32):
    """(B, steps, 20, 6) PianoTree steps: 0 to 8 notes (pitch, 5 duration
    bits), an eos after the last where there is room, pads (130, 2s) after;
    the first step is empty and the second full."""
    pt = np.zeros((b, steps, 20, 6), np.int64)
    pt[..., 0] = 130
    pt[..., 1:] = 2
    for i in range(b):
        for t in range(steps):
            n = {0: 0, 1: 20}.get(t, int(rng.integers(0, 9)))
            pt[i, t, :n, 0] = rng.integers(0, 128, n)
            pt[i, t, :n, 1:] = rng.integers(0, 2, (n, 5))
            if n < 20:
                pt[i, t, n, 0] = 129
    return pt


# -- the decoder ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder():
    jm = JaxPianoTreeDecoder(**DEC)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, DEC["z_size"])).astype(np.float32)
    params = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(z), True)["params"])
    tm = PianoTreeDecoder(**DEC)
    tm.load_state_dict(pianotree_decoder_state_from_jax(params), strict=True)
    apply = jax.jit(jm.apply, static_argnums=(2,))
    return jm, params, tm, apply, z, _pnotree(rng, 2)


def test_pianotree_decoder_converter_inverts_the_jax_import(decoder):
    """The reference ``PtvaeDecoder`` names: JAX's importer maps the port's
    state dict back onto the JAX tree."""
    _, params, tm, _, _, _ = decoder
    back = pianotree_decoder_params_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))
    assert {k.split(".")[0] for k in tm.state_dict()} == {
        "note_embedding", "z2dec_hid_linear", "z2dec_in_linear", "dec_notes_emb_gru",
        "dec_time_gru", "dec_time_to_notes_hid", "dec_notes_gru", "pitch_out_linear",
        "dec_dur_gru", "dur_hid_linear", "dur_out_linear", "dec_init_input", "dur_sos_token"}
    assert "dec_notes_emb_gru.weight_ih_l0_reverse" in tm.state_dict()


def test_emb_x_matches_jax(decoder):
    jm, params, tm, _, _, pt = decoder
    want_emb, want_len = jm.emb_x(params, jnp.asarray(pt))
    got_emb, got_len = tm.emb_x(torch.from_numpy(pt))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got_emb.detach().numpy(), np.asarray(want_emb), atol=1e-6)


@pytest.mark.parametrize("mode", ["mixed", "all_true", "free"])
def test_pianotree_decoder_logits_match_jax(decoder, mode):
    """Training mode at JAX's own coins (``split`` then ``uniform < tfr`` at
    both levels, drawn with JAX and handed to the port), at all coins true,
    and free-running."""
    jm, params, tm, apply, z, pt = decoder
    if mode == "free":
        want = apply({"params": params}, jnp.asarray(z), True)
        got = tm(torch.from_numpy(z))
    else:
        tfr = 0.5 if mode == "mixed" else 1.0
        key = jax.random.PRNGKey(9)
        k1, k2 = jax.random.split(key)
        tf1 = np.array(jax.random.uniform(k1, (32,)) < tfr)
        tf2 = np.array(jax.random.uniform(k2, (32, 19)) < tfr)
        assert (tf1.all() and tf2.all()) if mode == "all_true" else (0 < tf1.sum() < 32)
        emb, lens = jm.emb_x(params, jnp.asarray(pt))
        want = apply({"params": params}, jnp.asarray(z), False, emb, lens, tfr, tfr, key)
        t_emb, t_lens = tm.emb_x(torch.from_numpy(pt))
        got = tm(torch.from_numpy(z), t_emb, t_lens, torch.from_numpy(tf1), torch.from_numpy(tf2))
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape
        # the fed-back tokens first: every pitch and duration-bit argmax
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(output_to_pnotree(*got).numpy(),
                                  np.asarray(jax_output_to_pnotree(*want)))


def test_recon_loss_and_kl_match_jax():
    rng = np.random.default_rng(1)
    pt = _pnotree(rng, 3)
    pitch = rng.standard_normal((3, 32, 19, 130)).astype(np.float32)
    dur = rng.standard_normal((3, 32, 19, 5, 2)).astype(np.float32)
    got = pianotree_recon_loss(torch.from_numpy(pt), torch.from_numpy(pitch), torch.from_numpy(dur))
    want = jax_recon_loss(jnp.asarray(pt), jnp.asarray(pitch), jnp.asarray(dur))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=LOSS_RTOL)
    mu = rng.standard_normal((4, 8)).astype(np.float32)
    std = np.exp(rng.standard_normal((4, 8))).astype(np.float32)
    np.testing.assert_allclose(kl_with_standard_normal(torch.from_numpy(mu), torch.from_numpy(std))
                               .item(), float(jax_kl(jnp.asarray(mu), jnp.asarray(std))),
                               rtol=LOSS_RTOL)


# -- the task --------------------------------------------------------------------------


def _port_state(tree):
    out = {f"pnotree_enc.{k}": v
           for k, v in pianotree_encoder_state_from_jax(tree["pnotree_enc"]).items()}
    out.update({f"pnotree_dec.{k}": v
                for k, v in pianotree_decoder_state_from_jax(tree["pnotree_dec"]).items()})
    return out


def test_task_loss_metrics_and_gradients_match_jax():
    """JAX's ``PnoTreeVAETask.loss_fn`` with its encoder and decoder at tiny
    widths against the port's task holding the same modules: two 8-bar items,
    eight 2-bar segments."""
    jtask = JaxPnoTreeVAETask(JaxParams(CFG))
    jtask.enc = JaxPianoTreeEncoder(**ENC)
    jtask.dec = JaxPianoTreeDecoder(**DEC)
    params = _np_tree(jtask.init_params(jax.random.PRNGKey(0)))
    pt = _pnotree(np.random.default_rng(2), 2, steps=128)
    key = jax.random.PRNGKey(7)
    sched = {"tfr_pnt1": 0.6, "tfr_pnt2": 0.4}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jtask.loss_fn, has_aux=True))(
        params, (None, jnp.asarray(pt, jnp.int32), None, None), key, sched)

    # JAX's draws (:64-67 and the decoder's :143-150), handed to the port
    k_sample, k_dec = jax.random.split(key)
    k1, k2 = jax.random.split(k_dec)
    noise = PianoTreeNoise(
        torch.from_numpy(np.array(jax.random.normal(k_sample, (8, DEC["z_size"])))),
        torch.from_numpy(np.array(jax.random.uniform(k1, (32,)) < 0.6)),
        torch.from_numpy(np.array(jax.random.uniform(k2, (32, 19)) < 0.4)))
    task = PnoTreeVAETask(Params(CFG), device="cpu")
    task.model = VAE("pnotree_enc", PianoTreeEncoder(**ENC), "pnotree_dec", PianoTreeDecoder(**DEC))
    task.model.load_state_dict(_port_state(params), strict=True)
    batch = (None, torch.from_numpy(pt).to(torch.int16), None, None)  # as the feeder sends it
    drawn = task.draw_noise(batch, torch.Generator().manual_seed(0), sched)
    assert [tuple(t.shape) for t in drawn] == [(8, 8), (32,), (32, 19)]
    got_loss, got = task.loss_fn(batch, noise)
    got_loss.backward()
    assert set(got) == set(metrics) == {"loss", "recon", "pitch", "dur", "kl"}
    for k, w in metrics.items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=LOSS_RTOL, err_msg=k)
    want = _port_state(_np_tree(grads))
    for k, p in task.model.named_parameters():
        err = (p.grad - want[k]).norm().item()
        assert err <= GRAD_RTOL * want[k].norm().item() + 1e-9, (k, err)


def test_task_holds_the_reference_vae_at_preset_width():
    """``pnotree_enc`` at the widths ``sdf_pnotree`` freezes, its keys the ones
    the frozen-encoder loader picks out; fp32 under any preset."""
    from polyffusion_tpu_torch.main import build_task

    task = build_task(load_params("pnotree_vae"), device="cpu")
    assert isinstance(task, PnoTreeVAETask) and task.bf16 is False
    enc_keys = {k[len("pnotree_enc."):] for k in task.model.state_dict()
                if k.startswith("pnotree_enc.")}
    assert enc_keys == set(PianoTreeEncoder().state_dict())
    assert {k.split(".")[0] for k in task.model.state_dict()} == {"pnotree_enc", "pnotree_dec"}


# -- the CLIs ------------------------------------------------------------------------------


def _write_song(path, seed, n_bars):
    """A synthetic three-track song (the idea of tests/synth.py)."""
    rng = np.random.default_rng(seed)
    n_beats = n_bars * 4
    n_bins = n_beats * 4
    tracks = []
    for t in range(3):
        n = rng.integers(3 * n_bars, 6 * n_bars)
        onsets = np.sort(rng.integers(0, n_bins - 8, n))
        tracks.append(np.stack([onsets, rng.integers(36 + 12 * t, 72 + 12 * t, n),
                                rng.integers(1, 8, n), rng.integers(60, 100, n),
                                np.zeros(n, np.int64)], 1))
    chord = np.zeros((n_beats, 14), np.int32)
    chord[:, 0] = rng.integers(0, 12, n_beats)
    chord[:, 1:13] = rng.integers(0, 2, (n_beats, 12))
    chord[:, 13] = chord[:, 0]
    db_pos = np.arange(0, n_bins, 16)
    write_song_npz(path, tracks, chord, db_pos, db_pos + 128 <= n_bins, n_beats=n_beats)


def test_pnotree_vae_run_feeds_sdf_pnotree_through_the_clis(tmp_path, capsys):
    """At the preset's widths (the PianoTree VAE takes no width keys, and
    ``sdf_pnotree`` freezes its encoder at them): 8-bar songs, one segment
    each, so a step is one item of four 2-bar segments and the validation one
    batch; then a tiny ``sdf_pnotree`` UNet on 16-bar songs."""
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main

    short, songs = tmp_path / "short", tmp_path / "songs"
    os.makedirs(short)
    os.makedirs(songs)
    for i in range(4):
        _write_song(str(short / f"s{i}.npz"), seed=i, n_bars=8)
        _write_song(str(songs / f"song{i}.npz"), seed=10 + i, n_bars=17)
    run = str(tmp_path / "pno")
    args = ["--model", "pnotree_vae", "--output_dir", run, "--data_dir", str(short),
            "--device", "cpu", "--batch_size", "1", "--log_every", "1"]
    assert train_main(args + ["--max_steps", "1"]).step == 1
    assert train_main(args + ["--max_steps", "2", "--resume"]).step == 2
    assert "[resume] restored checkpoint at step 1" in capsys.readouterr().out

    pre = tmp_path / "pre"
    os.makedirs(pre)
    os.symlink(run, pre / "pnotree")
    sdf_run = str(tmp_path / "sdf")
    sets = ["channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]",
            "n_res_blocks=1", "bf16=false", "n_steps=10"]
    assert train_main(["--model", "sdf_pnotree", "--output_dir", sdf_run, "--data_dir", str(songs),
                       "--pretrained_dir", str(pre), "--device", "cpu", "--batch_size", "2",
                       "--max_steps", "1", "--log_every", "1"]
                      + [a for kv in sets for a in ("--set", kv)]).step == 1

    # the condition is the trained PianoTree encoder's means, not a random one's
    cfg = load_params(os.path.join(sdf_run, "params.yaml"))
    trained = torch.load(os.path.join(run, "chkpts", "last.pt"), weights_only=True)["params"]
    enc = PianoTreeEncoder()
    enc.load_state_dict({k[len("pnotree_enc."):]: v for k, v in trained.items()
                         if k.startswith("pnotree_enc.")}, strict=True)
    task = SDFTask(cfg, **build_frozen_encoders(cfg, str(pre)), device="cpu")
    pt = torch.from_numpy(_pnotree(np.random.default_rng(3), 1, steps=128))
    cond = task.encode_cond((None, pt, None, None))
    want = torch.cat([enc(seg)[0] for seg in pt.split(32, dim=1)], dim=-1)
    torch.testing.assert_close(cond[:, 0], want, rtol=0, atol=0)
    random_enc = init_weights_(PianoTreeEncoder(), torch.Generator().manual_seed(1))
    other = torch.cat([random_enc(seg)[0] for seg in pt.split(32, dim=1)], dim=-1)
    assert (cond[:, 0] - other).abs().max() > 1e-2

    out = tmp_path / "gen"
    (gen,) = infer_main(["--chkpt_path", sdf_run, "--data_dir", str(songs), "--song_fn",
                         "song1.npz", "--pretrained_dir", str(pre), "--output_dir", str(out),
                         "--device", "cpu", "--ddim", "--ddim_steps", "5", "--length", "2",
                         "--uncond_scale", "5"])
    assert gen.shape == (2, 2, 128, 128) and np.isfinite(gen).all()

    # a run directory of another model is refused, naming both
    wrong = tmp_path / "wrong"
    os.makedirs(wrong)
    os.symlink(sdf_run, wrong / "pnotree")
    with pytest.raises(ValueError, match="'sdf_pnotree' run, not a 'pnotree_vae' run"):
        build_frozen_encoders(cfg, str(wrong))
