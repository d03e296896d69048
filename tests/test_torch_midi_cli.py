"""The inference CLI's MIDI input and PolyDis output (``--from_midi``,
``--from_midi2``, ``--inpaint_from_midi``, ``--polydis_recon``) on the CPU
with a tiny config: the port's conditions, truncations and re-rendering
against the JAX package's on the same MIDI files and weights."""

import os

import numpy as np
import pytest
import torch
import yaml

from midi_cases import write_song
from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.data.midi_to_data import song_from_midi as jax_song_from_midi
from polyffusion_tpu.inference import build_task_for_inference as jax_build_task
from polyffusion_tpu.inference import song_conditions as jax_song_conditions
from polyffusion_tpu.models.polydis import PolydisAftertouch as JaxAftertouch
from polyffusion_tpu.utils.midi import load_midi as jax_load_midi
from polyffusion_tpu.utils.reprs import prmat2c_to_prmat as jax_prmat2c_to_prmat
from polyffusion_tpu_torch import inference as port_inference
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.data.midi_to_data import song_from_midi
from polyffusion_tpu_torch.inference import (
    build_task_for_inference,
    half_segments,
    main,
    polydis_recon,
)
from polyffusion_tpu_torch.models import ChordEncoder, TextureEncoder, init_weights_
from polyffusion_tpu_torch.models.polydis import PolyDis, PolydisAftertouch
from polyffusion_tpu_torch.utils import midi
from polyffusion_tpu_torch.utils.midi_io import prmat2c_to_midi_file

COND_ATOL = 2e-5
# the tiny UNet of tests/test_torch_inference.py's CLI runs
TINY = dict(channels=32, channel_multipliers=[1, 1, 1, 1], attention_levels=[], n_res_blocks=1,
            chd_hidden_dim=16, txt_emb_size=16, txt_hidden_dim=16, bf16=False, n_steps=10)
SONGS = {"long.mid": (28, 0, False), "short.mid": (17, 1, False), "tempo.mid": (20, 2, True)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """MIDI songs written with the port's writer, random chord and texture
    encoders in the reference's layouts, and for ``sdf_chd8bar`` and
    ``sdf_chd8bar_txt`` a tiny preset yaml and a reference-layout UNet
    checkpoint of seeded random weights."""
    root = tmp_path_factory.mktemp("midi_cli")
    for name, (bars, seed, tempo_change) in SONGS.items():
        write_song(midi, str(root / name), n_bars=bars, seed=seed, tempo_change=tempo_change)
    pre = root / "pretrained"
    pre.mkdir()
    g = torch.Generator().manual_seed(3)
    chd = init_weights_(ChordEncoder(36, 16, 512), g)
    txt = init_weights_(TextureEncoder(16, 16, 256), g)
    torch.save({"model": {f"chord_enc.{k}": v for k, v in chd.state_dict().items()}},
               pre / "chd8bar.pt")
    torch.save({"model": {f"rhy_encoder.{k}": v for k, v in txt.state_dict().items()}},
               pre / "polydis.pt")
    for preset in ("sdf_chd8bar", "sdf_chd8bar_txt"):
        cfg = dict(load_params(preset), **TINY)
        with open(root / f"{preset}.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        task = build_task_for_inference(Params(cfg), str(pre), device="cpu")
        init_weights_(task.unet, torch.Generator().manual_seed(4))
        torch.save({"model": {f"eps_model.{k}": v for k, v in task.unet.state_dict().items()}},
                   root / f"{preset}.pt")
    # PolyDis in the reference layout (model_master_final.pt), seeded random weights
    polydis = PolyDis(device="cpu", generator=torch.Generator().manual_seed(5))
    torch.save({f"module.{k}": v for k, v in polydis.state_dict().items()}, root / "polydis_vae.pt")
    return root


def _tasks(work, preset):
    cfg = dict(load_params(preset), **TINY)
    return (build_task_for_inference(Params(cfg), str(work / "pretrained"), device="cpu"),
            jax_build_task(JaxParams(cfg), str(work / "pretrained")))


def _cli(work, preset, out, *extra):
    return main(["--model", str(work / f"{preset}.yaml"),
                 "--chkpt_path", str(work / f"{preset}.pt"),
                 "--pretrained_dir", str(work / "pretrained"), "--device", "cpu",
                 "--output_dir", str(out), "--ddim", "--ddim_steps", "5", *extra])


@pytest.fixture
def recorded(monkeypatch):
    """What the CLI hands ``song_conditions`` and gets back, and what it asks
    the session to inpaint."""
    calls = {"song_data": [], "conditions": [], "inpaint": []}

    def song_conditions(task, song_data, length=0, autoreg=False):
        out = real_conditions(task, song_data, length, autoreg)
        calls["song_data"].append(song_data)
        calls["conditions"].append(out)
        return out

    def inpaint(self, orig, inpaint_type, cond, cond_mid=None, **kw):
        calls["inpaint"].append((orig, cond, cond_mid))
        return real_inpaint(self, orig, inpaint_type, cond, cond_mid, **kw)

    real_conditions = port_inference.song_conditions
    real_inpaint = port_inference.InferenceSession.inpaint
    monkeypatch.setattr(port_inference, "song_conditions", song_conditions)
    monkeypatch.setattr(port_inference.InferenceSession, "inpaint", inpaint)
    return calls


def _mids(out):
    files = sorted(f for f in os.listdir(out) if f.endswith(".mid"))
    for f in files:
        midi.load_midi(os.path.join(out, f))
    return files


@pytest.mark.parametrize("preset", ["sdf_chd8bar", "sdf_chd8bar_txt"])
def test_from_midi_conditions_match_jax(work, tmp_path, recorded, preset):
    """``--from_midi`` with no ``--data_dir``: the conditions the CLI encodes
    are JAX's ``song_conditions`` on JAX's ``song_from_midi`` of the file."""
    path = str(work / "tempo.mid")
    (gen,) = _cli(work, preset, tmp_path, "--from_midi", path, "--length", "2", "--autoreg",
                  "--uncond_scale", "5")
    assert gen.shape == (4, 2, 64, 128) and np.isfinite(gen).all()
    assert len(_mids(tmp_path)) == 1
    _, jtask = _tasks(work, preset)
    want = jax_song_conditions(jtask, jax_song_from_midi(path).get_whole_song_data(), 2, True)
    (got,) = recorded["conditions"]
    for a, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, np.asarray(w), atol=COND_ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])


def test_from_midi2_takes_the_texture_as_jax(work, tmp_path, recorded, capsys):
    """chord+txt: the texture (prmat) of a second MIDI, both songs cut to the
    shorter, as JAX's :880-885; other condition types ignore the flag."""
    a, b = str(work / "long.mid"), str(work / "short.mid")
    _cli(work, "sdf_chd8bar_txt", tmp_path / "mix", "--from_midi", a, "--from_midi2", b)
    song, song2 = (jax_song_from_midi(p).get_whole_song_data() for p in (a, b))
    n = min(song[0].shape[0], song2[0].shape[0])
    assert 0 < n < song[0].shape[0]
    want = (song[0][:n], song[1][:n], song[2][:n], song2[3][:n])
    got = recorded["song_data"][0]
    for u, w in zip(got, want):
        np.testing.assert_array_equal(u, w)
    _, jtask = _tasks(work, "sdf_chd8bar_txt")
    np.testing.assert_allclose(recorded["conditions"][0][0],
                               np.asarray(jax_song_conditions(jtask, want)[0]), atol=COND_ATOL,
                               rtol=0)
    _cli(work, "sdf_chd8bar", tmp_path / "chord", "--from_midi", a, "--from_midi2", b,
         "--length", "1")
    assert "--from_midi2 ignored" in capsys.readouterr().out
    for u, w in zip(recorded["song_data"][1], song):
        np.testing.assert_array_equal(u, w)


def test_inpaint_from_midi_truncates_as_jax(work, tmp_path, recorded):
    """The inpainting source from a second, shorter MIDI: cond cut to its
    segments, cond_mid to one fewer (JAX :892-902)."""
    a, b = str(work / "long.mid"), str(work / "short.mid")
    ((gen, mask),) = _cli(work, "sdf_chd8bar", tmp_path, "--from_midi", a, "--inpaint_from_midi", b,
                          "--inpaint_type", "below", "--autoreg")
    task, jtask = _tasks(work, "sdf_chd8bar")
    full = jax_song_conditions(jtask, jax_song_from_midi(a).get_whole_song_data(), 0, True)
    src = jax_song_from_midi(b).get_whole_song_data()[0]
    n = min(len(full[0]), src.shape[0])
    assert 0 < n < len(full[0])
    ((orig, cond, cond_mid),) = recorded["inpaint"]
    np.testing.assert_array_equal(orig, src[:n])
    np.testing.assert_allclose(cond, np.asarray(full[0])[:n], atol=COND_ATOL, rtol=0)
    np.testing.assert_allclose(cond_mid, np.asarray(full[1])[: n - 1], atol=COND_ATOL, rtol=0)
    assert gen.shape == (2 * n, 2, 64, 128) and mask.shape == src[:n].shape
    # fault 6: the .mid of a long-form inpainting splits its notes by the mask
    # in half segments (JAX raises here, inference.py:646-648)
    (name,) = _mids(tmp_path)
    assert len(midi.load_midi(os.path.join(tmp_path, name)).instruments) == 2
    prmat2c_to_midi_file(gen, str(tmp_path / "want.mid"), inp_mask=half_segments(mask))
    assert open(tmp_path / name, "rb").read() == open(tmp_path / "want.mid", "rb").read()


def test_half_segments_are_the_long_form_layout():
    a = np.random.default_rng(8).random((3, 2, 128, 16))
    got = half_segments(a)
    assert got.shape == (6, 2, 64, 16)
    for i in range(3):
        for j in range(2):
            np.testing.assert_array_equal(got[2 * i + j], a[i, :, 64 * j: 64 * (j + 1)])


def test_cli_needs_a_song(work, tmp_path):
    with pytest.raises(SystemExit, match="--data_dir"):
        _cli(work, "sdf_chd8bar", tmp_path)


def test_polydis_recon_matches_jax(work, tmp_path):
    """The re-rendering of a fixed generated roll through ``polydis_recon``
    (the CLI's code) and through JAX's lines :995-1007 with the same weights:
    the same est_x grid and the same .mid bytes."""
    song = song_from_midi(str(work / "long.mid")).get_whole_song_data()
    gen = np.clip(song[0][:2] + np.random.default_rng(6).normal(0, 0.2, song[0][:2].shape),
                  -1, 1).astype(np.float32)
    path = str(work / "polydis_vae.pt")
    est = polydis_recon(PolydisAftertouch(model_path=path, device="cpu"), gen, song[2],
                        str(tmp_path / "port.mid"))
    # JAX inference.py:995-1007, as written there
    jax_after = JaxAftertouch(params=JaxAftertouch(model_path=path).params)
    prmat = jax_prmat2c_to_prmat(gen)
    chd = np.asarray(song[2])[: prmat.shape[0]]
    chd8 = chd.reshape(-1, 4, 8, 36)[: prmat.shape[0] // 4].reshape(-1, 8, 36)
    n = min(prmat.shape[0], chd8.shape[0])
    want = jax_after.reconstruct(prmat[:n].astype(np.float32), chd8[:n].astype(np.float32),
                                 str(tmp_path / "jax.mid"))
    assert est.shape == (8, 32, 31, 6)
    np.testing.assert_array_equal(est, want)
    assert open(tmp_path / "port.mid", "rb").read() == open(tmp_path / "jax.mid", "rb").read()
    assert jax_load_midi(str(tmp_path / "port.mid")).instruments


def test_cli_polydis_recon(work, tmp_path):
    """``--polydis_recon`` writes ``polydis_recon_<i>.mid`` beside each piece,
    from a reference checkpoint or (as JAX) from random weights."""
    _cli(work, "sdf_chd8bar", tmp_path / "pt", "--from_midi", str(work / "long.mid"), "--length",
         "1", "--polydis_recon", "--polydis_path", str(work / "polydis_vae.pt"))
    files = _mids(tmp_path / "pt")
    assert len(files) == 2 and "polydis_recon_0.mid" in files
    _cli(work, "sdf_chd8bar", tmp_path / "rand", "--from_midi", str(work / "long.mid"), "--length",
         "1", "--polydis_recon", "--polydis_chd_resample", "--num_generate", "2", "--autoreg")
    files = _mids(tmp_path / "rand")
    assert {"polydis_recon_0.mid", "polydis_recon_1.mid"} <= set(files) and len(files) == 4
