"""The texture and PianoTree conditions (``sdf_txt``, ``sdf_txtvnl``,
``sdf_chd8bar_txt``, ``sdf_chd8bar_txt_mix2``, ``sdf_pnotree``), the port
against the JAX package on the CPU in fp32: the masked bi-GRU, the texture and
PianoTree encoders with weights carried by the port's converters, the
reference-layout checkpoints, ``encode_cond`` in every mode, one train step
of ``mix2``, DDIM-4 CFG-5 sessions, whole-song conditions, the presets, and
both CLIs on tiny run directories."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.diffusion import make_ddim_schedule as jax_make_ddim
from polyffusion_tpu.diffusion import sampler as jax_sampler
from polyffusion_tpu.diffusion.gaussian import q_sample as jax_q_sample
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.inference import song_conditions as jax_song_conditions
from polyffusion_tpu.models.encoders import ChordEncoder as JaxChordEncoder
from polyffusion_tpu.models.encoders import PianoTreeEncoder as JaxPianoTreeEncoder
from polyffusion_tpu.models.encoders import TextureEncoder as JaxTextureEncoder
from polyffusion_tpu.models.gru import BiGRU as JaxBiGRU
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.config import PARAMS_DIR, Params, load_params
from polyffusion_tpu_torch.convert import (
    _bigru,
    chord_encoder_state_from_jax,
    pianotree_encoder_state_from_jax,
    texture_encoder_state_from_jax,
    unet_state_from_jax,
)
from polyffusion_tpu_torch.data import DeviceFeeder, SegmentDataset, SongNpz, write_song_npz
from polyffusion_tpu_torch.data.loader import BatchLoader
from polyffusion_tpu_torch.inference import InferenceSession, song_conditions
from polyffusion_tpu_torch.inference import main as infer_main
from polyffusion_tpu_torch.models import (
    ChordEncoder,
    PianoTreeEncoder,
    TextureEncoder,
    init_weights_,
)
from polyffusion_tpu_torch.models.encoders import build_frozen_encoders
from polyffusion_tpu_torch.models.gru import BiGRU
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.tasks.sdf import StepNoise
from polyffusion_tpu_torch.train import create_state, make_train_step

PRESETS = ["sdf_txt", "sdf_txtvnl", "sdf_chd8bar_txt", "sdf_chd8bar_txt_mix2", "sdf_pnotree"]
RAW_CHORD = ["sdf", "sdf_chdvnl", "sdf_concat"]  # the raw chord one-hots, use_enc: false
ENC_ATOL = 3e-5  # the texture and PianoTree bounds of tests/test_encoder_parity.py:109, :136
ATOL, RTOL = 2e-3, 1e-3  # the DDIM tolerance of tests/test_torch_slice.py
CHD_Z, TXT_Z, PNO_Z = 16, 8, 8  # tiny encoder widths: z of one 2-bar segment
TINY = dict(batch_size=2, max_epoch=1, learning_rate=1e-3, max_grad_norm=1.0, bf16=False,
            channels=32, attention_levels=[1], n_res_blocks=1, channel_multipliers=[1, 2],
            n_heads=1, tf_layers=1, n_steps=40, img_h=32, img_w=32,
            chd_hidden_dim=16, chd_z_dim=CHD_Z, txt_emb_size=16, txt_hidden_dim=16,
            txt_z_dim=TXT_Z)
D_COND = {"sdf_txt": 4 * TXT_Z, "sdf_txtvnl": 128, "sdf_chd8bar_txt": CHD_Z + 4 * TXT_Z,
          "sdf_chd8bar_txt_mix2": CHD_Z + 4 * TXT_Z, "sdf_pnotree": 4 * PNO_Z,
          **{name: 32 * 36 for name in RAW_CHORD}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps test workers that share the cores from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_song(path, seed, n_bars=24):
    """A synthetic three-track song (the idea of tests/synth.py)."""
    rng = np.random.default_rng(seed)
    n_beats = n_bars * 4
    n_bins = n_beats * 4
    tracks = []
    for t in range(3):
        n = rng.integers(40, 80)
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


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("songs")
    for i in range(4):
        _write_song(str(d / f"song{i}.npz"), seed=i)
    return str(d)


@pytest.fixture(scope="module")
def song(data_dir):
    """(prmat2c, pnotree, chord, prmat) of a whole song: 3 segments."""
    return SongNpz("song0.npz", data_dir).get_whole_song_data()


def _pnotree_steps(rng, b):
    """(B, 32, 20, 6) PianoTree steps with 0 to 20 notes, pad pitch 130 after
    the last note; the first step is empty and the second full."""
    pt = np.zeros((b, 32, 20, 6), np.int64)
    pt[..., 0] = 130
    for i in range(b):
        for t in range(32):
            n = {0: 0, 1: 20}.get(t, int(rng.integers(0, 21)))
            pt[i, t, :n, 0] = rng.integers(0, 128, n)
            pt[i, t, :n, 1:] = rng.integers(0, 2, (n, 5))
    return pt


# -- the masked bi-GRU -----------------------------------------------------------------


def _gru_pair(in_dim, hidden, seed):
    jm = JaxBiGRU(hidden)
    xs = np.zeros((1, 4, in_dim), np.float32)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(xs))["params"])
    state = {}
    _bigru(state, "gru", params)
    tm = BiGRU(in_dim, hidden)
    tm.load_state_dict({k[len("gru."):]: v for k, v in state.items()}, strict=True)
    return jm, params, tm


@pytest.mark.parametrize("lengths", [[0, 3, 7, 1, 5], [7, 7, 7, 7, 7], [0, 0, 0, 0, 0]])
def test_bigru_with_lengths_matches_jax_masked_scan(lengths):
    """Steps at or past a length leave the state as it was, in both
    directions; length 0 keeps the zero initial state (where
    ``pack_padded_sequence`` raises)."""
    jm, params, tm = _gru_pair(6, 8, seed=1)
    xs = np.random.default_rng(2).standard_normal((5, 7, 6)).astype(np.float32)
    ln = np.array(lengths)
    outs_j, final_j = jm.apply({"params": params}, jnp.asarray(xs), lengths=jnp.asarray(ln))
    with torch.no_grad():
        outs, final = tm(torch.from_numpy(xs), torch.from_numpy(ln))
    np.testing.assert_allclose(outs.numpy(), np.asarray(outs_j), atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(final_j), atol=1e-5)
    assert not final[ln == 0].any()


def test_bigru_at_full_length_equals_nn_gru():
    """The masked scan at full length is the fused ``nn.GRU`` of the same
    weights, which the layer runs without lengths (JAX's unmasked scan)."""
    jm, params, tm = _gru_pair(6, 8, seed=3)
    xs = np.random.default_rng(4).standard_normal((3, 9, 6)).astype(np.float32)
    with torch.no_grad():
        outs, final = tm(torch.from_numpy(xs))
        outs_l, final_l = tm(torch.from_numpy(xs), torch.full((3,), 9))
    outs_j, final_j = jm.apply({"params": params}, jnp.asarray(xs))
    np.testing.assert_allclose(outs.numpy(), np.asarray(outs_j), atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(final_j), atol=1e-5)
    np.testing.assert_allclose(outs_l.numpy(), outs.numpy(), atol=1e-6)
    np.testing.assert_allclose(final_l.numpy(), final.numpy(), atol=1e-6)
    assert set(tm.state_dict()) == {f"{w}_l0{s}" for w in ("weight_ih", "weight_hh", "bias_ih",
                                                           "bias_hh") for s in ("", "_reverse")}


# -- the encoders ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """Tiny JAX encoders (seeded init), their params as NumPy, and the port's
    encoders loaded strictly through the port's converters."""
    rng = np.random.default_rng(0)
    chd = JaxChordEncoder(hidden_dim=16, z_dim=CHD_Z)
    txt = JaxTextureEncoder(emb_size=16, hidden_dim=16, z_dim=TXT_Z)
    pno = JaxPianoTreeEncoder(note_emb_size=16, enc_notes_hid_size=8, enc_time_hid_size=12,
                              z_size=PNO_Z)
    p_chd = _np_tree(chd.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 36)))["params"])
    p_txt = _np_tree(txt.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 128)))["params"])
    p_pno = _np_tree(pno.init(jax.random.PRNGKey(3),
                              jnp.asarray(_pnotree_steps(rng, 1)))["params"])
    t_chd, t_txt, t_pno = ChordEncoder(36, 16, CHD_Z), TextureEncoder(16, 16, TXT_Z), \
        PianoTreeEncoder(16, 8, 12, PNO_Z)
    t_chd.load_state_dict(chord_encoder_state_from_jax(p_chd), strict=True)
    t_txt.load_state_dict(texture_encoder_state_from_jax(p_txt), strict=True)
    t_pno.load_state_dict(pianotree_encoder_state_from_jax(p_pno), strict=True)
    return {
        "jax": dict(chord_enc=chd, chord_enc_params=p_chd, txt_enc=txt, txt_enc_params=p_txt,
                    pnotree_enc=pno, pnotree_enc_params=p_pno),
        "port": dict(chord_enc=t_chd, txt_enc=t_txt, pnotree_enc=t_pno),
    }


def test_texture_encoder_matches_jax(encoders, song):
    prmat = song[3][:, :32]  # (3, 32, 128): the first 2-bar segment of each 8-bar one
    jm, params = encoders["jax"]["txt_enc"], encoders["jax"]["txt_enc_params"]
    mu_j, std_j = jm.apply({"params": params}, jnp.asarray(prmat))
    with torch.no_grad():
        mu, std = encoders["port"]["txt_enc"](torch.from_numpy(prmat))
    assert mu.shape == (3, TXT_Z)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=ENC_ATOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(std_j), atol=ENC_ATOL, rtol=1e-5)


@pytest.mark.parametrize("source", ["synthetic", "song"])
def test_pianotree_encoder_matches_jax(encoders, song, source):
    """Steps of 0 to 20 notes (synthetic), and a song's 2-bar segments."""
    pt = _pnotree_steps(np.random.default_rng(5), 3) if source == "synthetic" else song[1][:, 32:64]
    jm, params = encoders["jax"]["pnotree_enc"], encoders["jax"]["pnotree_enc_params"]
    mu_j, std_j = jm.apply({"params": params}, jnp.asarray(pt))
    with torch.no_grad():
        mu, std = encoders["port"]["pnotree_enc"](torch.from_numpy(pt))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=ENC_ATOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(std_j), atol=ENC_ATOL, rtol=1e-5)


def test_converters_invert_the_jax_package_importers():
    """The JAX package's importers (reference .pt -> JAX tree) and the port's
    converters (JAX tree -> the port's state dict) compose to the identity on
    the reference names."""
    from polyffusion_tpu.convert.torch_import import (
        pianotree_encoder_params_from_torch,
        texture_encoder_params_from_torch,
    )

    g = torch.Generator().manual_seed(6)
    for enc, to_tree, to_state in (
        (TextureEncoder(16, 16, TXT_Z), texture_encoder_params_from_torch,
         texture_encoder_state_from_jax),
        (PianoTreeEncoder(16, 8, 12, PNO_Z), pianotree_encoder_params_from_torch,
         pianotree_encoder_state_from_jax),
    ):
        sd = init_weights_(enc, g).state_dict()
        back = to_state(to_tree({k: v.numpy() for k, v in sd.items()}))
        assert set(back) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def _random_encoder_files(pretrained, fmt, seed):
    """Random encoders written in the reference's layouts (``chd8bar.pt``:
    ``chord_enc.*``; ``polydis.pt``: ``{"model": {"rhy_encoder.*"}}``;
    ``pnotree.pt``: the whole PianoTree VAE, decoder keys too) or as the JAX
    package's converter writes them (``.npz``); returns the source modules."""
    from polyffusion_tpu.convert.__main__ import save_params_npz
    from polyffusion_tpu.convert.torch_import import (
        chord_encoder_params_from_torch,
        pianotree_encoder_params_from_torch,
        texture_encoder_params_from_torch,
    )

    g = torch.Generator().manual_seed(seed)
    chd = init_weights_(ChordEncoder(36, 16, 512), g)
    txt = init_weights_(TextureEncoder(16, 16, 256), g)
    pno = init_weights_(PianoTreeEncoder(), g)
    os.makedirs(pretrained, exist_ok=True)
    if fmt == "pt":
        torch.save({"model": {f"chord_enc.{k}": v for k, v in chd.state_dict().items()}},
                   os.path.join(pretrained, "chd8bar.pt"))
        torch.save({"model": {f"rhy_encoder.{k}": v for k, v in txt.state_dict().items()}},
                   os.path.join(pretrained, "polydis.pt"))
        vae = dict(pno.state_dict(), **{"dec_time_gru.weight_ih_l0": torch.zeros(3, 2)})
        torch.save(vae, os.path.join(pretrained, "pnotree.pt"))
    else:
        def np_sd(m):
            return {k: v.numpy() for k, v in m.state_dict().items()}

        save_params_npz({"chord_enc": chord_encoder_params_from_torch(np_sd(chd))},
                        os.path.join(pretrained, "chd8bar.npz"))
        save_params_npz({"rhy_encoder": texture_encoder_params_from_torch(np_sd(txt))},
                        os.path.join(pretrained, "polydis.npz"))
        save_params_npz(pianotree_encoder_params_from_torch(np_sd(pno)),
                        os.path.join(pretrained, "pnotree.npz"))
    return {"chord_enc": chd, "txt_enc": txt, "pnotree_enc": pno}


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_frozen_encoders_load_from_reference_layouts(tmp_path, fmt):
    src = _random_encoder_files(str(tmp_path), fmt, seed=7)
    enc_set = dict(txt_emb_size=16, txt_hidden_dim=16, chd_hidden_dim=16)
    got = {}
    for name in ("sdf_chd8bar_txt", "sdf_pnotree", "sdf_txtvnl"):
        got[name] = build_frozen_encoders(Params(load_params(name), **enc_set), str(tmp_path))
    assert set(got["sdf_chd8bar_txt"]) == {"chord_enc", "txt_enc"}
    assert set(got["sdf_pnotree"]) == {"pnotree_enc"}
    assert got["sdf_txtvnl"] == {}
    for name, enc in {**got["sdf_chd8bar_txt"], **got["sdf_pnotree"]}.items():
        for k, v in src[name].state_dict().items():
            np.testing.assert_array_equal(enc.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(FileNotFoundError, match=r"polydis\.npz or .*polydis\.pt"):
        build_frozen_encoders(Params(load_params("sdf_txt"), **enc_set), str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="pnotree"):
        build_frozen_encoders(load_params("sdf_pnotree"), None)


# -- tasks -----------------------------------------------------------------------------


def _cfg(name, **over):
    return {**load_params(name), **TINY, "d_cond": D_COND[name], "model_name": "sdf_test", **over}


def _tasks(name, encoders, mode=None, **port_kw):
    cfg = _cfg(name) if mode is None else _cfg(name, cond_mode=mode)
    jtask = JaxSDFTask(JaxParams(cfg), **encoders["jax"])
    task = SDFTask(Params(cfg), **encoders["port"], device="cpu", **port_kw)
    return jtask, task


def _batch(song):
    return tuple(torch.from_numpy(a) for a in song)


@pytest.mark.parametrize("mode", ["cond", "uncond", "mix", "mix2"])
@pytest.mark.parametrize("name", PRESETS + RAW_CHORD)
def test_encode_cond_matches_jax(encoders, song, name, mode):
    jtask, task = _tasks(name, encoders, mode)
    want = np.asarray(jtask.encode_cond(tuple(map(jnp.asarray, song)), rng=None))
    got = task.encode_cond(_batch(song)).numpy()
    assert got.shape == want.shape == ((3, 128, 128) if name == "sdf_txtvnl" else
                                        (3, 1, D_COND[name]))
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)


@pytest.mark.parametrize("coins", [(1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1)])
def test_mix2_coins_drop_each_part(encoders, song, coins):
    """mix2's chord coin, texture coin and whole-condition coin, forced in the
    port, against JAX's undropped condition with the same parts set to -1
    (``tasks/sdf.py:136-150``)."""
    jtask, task = _tasks("sdf_chd8bar_txt_mix2", encoders)
    want = np.asarray(jtask.encode_cond(tuple(map(jnp.asarray, song)), rng=None)).copy()
    drop_chd, drop_txt, drop = coins
    if drop_chd:
        want[..., :CHD_Z] = -1
    if drop_txt:
        want[..., CHD_Z:] = -1
    if drop:
        want[:] = -1
    got = task.encode_cond(_batch(song), drop=torch.tensor(bool(drop)),
                           drop_chd=torch.tensor(bool(drop_chd)),
                           drop_txt=torch.tensor(bool(drop_txt))).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)
    # mix (one coin) ignores the part coins
    _, mix = _tasks("sdf_chd8bar_txt", encoders)
    kept = mix.encode_cond(_batch(song), drop=torch.tensor(False), drop_chd=torch.tensor(True))
    assert not bool((kept[..., :CHD_Z] == -1).all())


def test_mix2_draws_three_coins(encoders, song):
    _, task = _tasks("sdf_chd8bar_txt_mix2", encoders)
    batch = _batch(song)
    g = torch.Generator().manual_seed(0)
    seen = {"chd": 0, "txt": 0, "all": 0}
    for _ in range(60):
        c = task.encode_cond(batch, g)
        chd, txt = bool((c[..., :CHD_Z] == -1).all()), bool((c[..., CHD_Z:] == -1).all())
        seen["all"] += chd and txt
        seen["chd"] += chd and not txt
        seen["txt"] += txt and not chd
    assert all(v > 0 for v in seen.values()), seen
    noise = task.draw_noise((torch.zeros(2, 2, 32, 32),), torch.Generator().manual_seed(1))
    assert all(x.dtype == torch.bool and x.dim() == 0
               for x in (noise.drop, noise.drop_chd, noise.drop_txt))


@pytest.mark.parametrize("name", PRESETS + ["sdf_chd8bar"])
def test_used_batch_fields_match_jax(encoders, name):
    if name == "sdf_chd8bar":
        cfg = {**load_params(name), **TINY}
        enc = dict(chord_enc=ChordEncoder(36, 16, CHD_Z))
        jtask, task = JaxSDFTask(JaxParams(cfg)), SDFTask(Params(cfg), **enc, device="cpu")
    else:
        jtask, task = _tasks(name, encoders)
    assert task.used_batch_fields == jtask.used_batch_fields
    assert task.use_enc == jtask.use_enc


def test_feeder_ships_the_fields_the_task_reads(encoders, data_dir):
    from polyffusion_tpu_torch.data import decompress_batch

    loader = BatchLoader(SegmentDataset.from_dir(data_dir), 2)
    want = next(iter(loader))
    for name, field in (("sdf_txt", "prmat"), ("sdf_pnotree", "pnotree")):
        _, task = _tasks(name, encoders)
        got = decompress_batch(next(iter(DeviceFeeder(loader, "cpu",
                                                      used_fields=task.used_batch_fields))))
        np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(want, field))
        assert got.chord.shape == (2, 1)  # a placeholder: neither task reads it


def test_refuses_what_is_not_ported(encoders):
    concat = SDFTask(Params(_cfg("sdf_concat")), device="cpu")
    assert concat.concat_blurry and concat.unet.input_blocks[0][0].weight.shape[1] == 4
    with pytest.raises(ValueError, match="txt_enc"):
        SDFTask(Params(_cfg("sdf_txt")), device="cpu")
    with pytest.raises(ValueError, match="pnotree_enc"):
        SDFTask(Params(_cfg("sdf_pnotree")), device="cpu")


# -- one train step of mix2 against the JAX step -------------------------------------------


def test_mix2_train_step_matches_jax(encoders, song):
    """One fp32 step of a tiny ``sdf_chd8bar_txt_mix2``, the chord part
    dropped by its coin: loss, gradient norm and the parameters after Adam."""
    name = "sdf_chd8bar_txt_mix2"
    cfg = _cfg(name, channels=64, attention_levels=[0], channel_multipliers=[1], img_h=16,
               img_w=16, n_steps=1000)
    jtask = JaxSDFTask(JaxParams(cfg), **encoders["jax"])
    params = _np_tree(jtask.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    b = 3
    x0 = (rng.random((b, 2, 16, 16)) > 0.9).astype(np.float32)
    t = rng.integers(0, 1000, b)
    noise = rng.standard_normal(x0.shape).astype(np.float32)

    jbatch = (jnp.asarray(x0),) + tuple(map(jnp.asarray, song[1:]))
    cond = np.asarray(jtask.encode_cond(jbatch, rng=None)).copy()
    cond[..., :CHD_Z] = -1  # the chord coin
    opt = jax_make_optimizer(cfg["learning_rate"], cfg["max_grad_norm"])

    def loss_of(p):
        xt = jax_q_sample(jtask.schedule, jnp.asarray(x0.transpose(0, 2, 3, 1)), jnp.asarray(t),
                          jnp.asarray(noise.transpose(0, 2, 3, 1)))
        eps = jtask.apply_eps(p, xt, jnp.asarray(t), jnp.asarray(cond))
        return jnp.mean((jnp.asarray(noise.transpose(0, 2, 3, 1)) - eps) ** 2)

    loss, grads = jax.value_and_grad(loss_of)(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = unet_state_from_jax(_np_tree(optax.apply_updates(params, updates)))
    gnorm = float(optax.global_norm(grads))

    task = SDFTask(Params(cfg), **encoders["port"], device="cpu", training=True)
    task.load_unet_state(unet_state_from_jax(params))
    state = create_state(task.unet, cfg["learning_rate"], cfg["max_grad_norm"])
    batch = (torch.from_numpy(x0),) + _batch(song)[1:]
    metrics = make_train_step(task)(state, batch, seed=0, noise=StepNoise(
        torch.from_numpy(t), torch.from_numpy(noise), torch.tensor(False),
        drop_chd=torch.tensor(True), drop_txt=torch.tensor(False)))
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm, rtol=1e-4)
    assert gnorm > cfg["max_grad_norm"]  # the clip is active
    # one Adam step of lr 1e-3: within 0.1 lr everywhere (a gradient within a
    # few 1e-8 of zero lets rounding decide the update), fp32 rounding in all
    # but 0.1 % of the elements (the bound of tests/test_torch_train.py)
    got = {k: v.detach().numpy() for k, v in state.params().items()}
    err = np.concatenate([np.abs(got[k] - w.numpy()).ravel() for k, w in want.items()])
    assert err.max() <= 0.1 * cfg["learning_rate"], err.max()
    assert (err > 2e-6).mean() < 1e-3, (err > 2e-6).mean()
    for p in encoders["port"]["txt_enc"].parameters():
        assert p.grad is None


# -- DDIM-4 CFG-5 sessions ----------------------------------------------------------------


@pytest.fixture(scope="module")
def sessions(encoders, song):
    """For each sampled preset: the JAX task and params, the port's session
    on the same weights, both conditions and a starting noise."""
    out = {}
    for name in ("sdf_txt", "sdf_txtvnl", "sdf_pnotree", "sdf", "sdf_chdvnl"):
        jtask, task = _tasks(name, encoders)
        params = _np_tree(jtask.init_params(jax.random.PRNGKey(1)))
        task.load_unet_state(unet_state_from_jax(params))
        jcond = np.asarray(jtask.encode_cond(tuple(map(jnp.asarray, song)), rng=None))[:2]
        cond = task.encode_cond(_batch(song)).numpy()[:2]
        noise = np.random.default_rng(4).standard_normal((2, 32, 32, 2)).astype(np.float32)
        sess = InferenceSession(task, sampler="ddim", ddim_steps=4, device="cpu")
        out[name] = (jtask, params, sess, jcond, cond, noise)
    return out


@pytest.mark.parametrize("name", ["sdf_txt", "sdf_pnotree", "sdf", "sdf_chdvnl"])
def test_session_matches_jax(sessions, name):
    jtask, params, sess, jcond, cond, noise = sessions[name]
    jsess = JaxSession(jtask, params, use_ddim=True, ddim_steps=4, seed=0)
    want = jsess.predict(jcond, uncond_scale=5.0, noise=noise)
    got = sess.predict(cond, uncond_scale=5.0, noise=noise)
    assert got.shape == (2, 2, 32, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_txtvnl_session_matches_jax_sampler(sessions):
    """128 condition tokens: the unconditional condition is -1s of the
    condition's shape. JAX's session builds it (B, 1, d_cond) and cannot
    sample this preset with CFG (a fault of the reference, ROADMAP.md §3), so
    the port's session is held against JAX's DDIM sampler given the right
    unconditional condition."""
    jtask, params, sess, jcond, cond, noise = sessions["sdf_txtvnl"]
    assert cond.shape == (2, 128, 128)
    # the session's generation: q_sample of an empty roll at the last tau,
    # then a mask-0 paint (JAX inference.py:295-301, 349-364)
    jdd = jax_make_ddim(jtask.schedule, 4, "uniform", 0.0)
    zeros = jnp.zeros(noise.shape)
    x = jax_sampler.ddim_q_sample(jdd, zeros, 3, jnp.asarray(noise))
    want = jax_sampler.ddim_paint(
        jtask.apply_eps, params, jdd, x, jnp.asarray(jcond), 3, jax.random.PRNGKey(0),
        orig=zeros, mask=zeros, orig_noise=jnp.asarray(noise), uncond_scale=5.0,
        uncond_cond=-jnp.ones_like(jnp.asarray(jcond)))
    got = sess.predict(cond, uncond_scale=5.0, noise=noise)
    np.testing.assert_allclose(got, np.transpose(np.asarray(want), (0, 3, 1, 2)), atol=ATOL,
                               rtol=RTOL)
    jsess = JaxSession(jtask, params, use_ddim=True, ddim_steps=4, seed=0)
    with pytest.raises(TypeError, match="concatenate"):
        jsess.predict(jcond, uncond_scale=5.0, noise=noise)


@pytest.mark.parametrize("name", ["sdf_txt", "sdf_txtvnl", "sdf_chd8bar_txt", "sdf_pnotree"])
def test_song_conditions_match_jax(encoders, song, name):
    """Whole-song conditions and the autoregressive mid windows' (the chord,
    pnotree and prmat shifted by 4 bars)."""
    jtask, task = _tasks(name, encoders)
    for length in (0, 2):
        cond, cond_mid, prmat2c = song_conditions(task, song, length, autoreg=True)
        jcond, jcond_mid, jprmat2c = jax_song_conditions(jtask, song, length, autoreg=True)
        np.testing.assert_allclose(cond, jcond, atol=ENC_ATOL)
        np.testing.assert_allclose(cond_mid, jcond_mid, atol=ENC_ATOL)
        np.testing.assert_array_equal(prmat2c, jprmat2c)


def test_autoreg_session_takes_token_conditions(sessions, song):
    """Long-form generation with 128-token conditions: the windows' uncond is
    -1s of their shape."""
    _, _, sess, _, _, _ = sessions["sdf_txtvnl"]
    cond, cond_mid, _ = song_conditions(sess.task, song, 2, autoreg=True)
    gen = sess.predict(cond, cond_mid, uncond_scale=5.0, autoreg=True)
    assert gen.shape == (4, 2, 16, 32) and np.isfinite(gen).all()


# -- the presets and the CLIs -----------------------------------------------------------------


@pytest.mark.parametrize("name", RAW_CHORD + PRESETS)
def test_presets_equal_the_jax_package(name):
    from polyffusion_tpu.config import PARAMS_DIR as JAX_PARAMS_DIR

    with open(os.path.join(PARAMS_DIR, f"{name}.yaml"), "rb") as f:
        got = f.read()
    with open(os.path.join(JAX_PARAMS_DIR, f"{name}.yaml"), "rb") as f:
        assert got == f.read()


# four levels put the middle block at 16 x 16 of the 128 x 128 roll; no attention
TINY_SET = ["channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]",
            "n_res_blocks=1", "chd_hidden_dim=16", "txt_emb_size=16", "txt_hidden_dim=16",
            "bf16=false", "n_steps=10"]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pretrained"))
    _random_encoder_files(d, "pt", seed=8)
    return d


@pytest.mark.parametrize("name", ["sdf_chd8bar_txt_mix2", "sdf_txtvnl", "sdf_pnotree"])
def test_train_then_sample_through_the_clis(name, data_dir, pretrained, tmp_path):
    from polyffusion_tpu_torch.main import main as train_main

    run = str(tmp_path / "run")
    args = ["--model", name, "--output_dir", run, "--data_dir", data_dir, "--pretrained_dir",
            pretrained, "--device", "cpu", "--batch_size", "2", "--max_steps", "2",
            "--log_every", "1"]
    for kv in TINY_SET:
        args += ["--set", kv]
    state = train_main(args)
    assert state.step == 2
    assert os.path.getsize(os.path.join(run, "chkpts", "last.pt"))
    out = tmp_path / "gen"
    (gen,) = infer_main(["--chkpt_path", run, "--data_dir", data_dir, "--song_fn", "song1.npz",
                         "--pretrained_dir", pretrained, "--output_dir", str(out), "--device",
                         "cpu", "--ddim", "--ddim_steps", "5", "--length", "2",
                         "--uncond_scale", "5"])
    assert gen.shape == (2, 2, 128, 128) and np.isfinite(gen).all()
    (mid,) = [f for f in os.listdir(out) if f.endswith(".mid")]
    assert mid.startswith(f"{name}[scale=5.0,ddim5_eta0.0_uniform]_")
