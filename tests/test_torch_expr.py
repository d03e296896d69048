"""The evaluation harness (``polyffusion_tpu_torch/expr.py``) and the chord
scoring it stands on (``chord/labels.py``, ``chord/eval.py``), on the CPU
against the JAX package: each metric function on seeded inputs, the chord
labels and mir_eval comparisons on random label sets and the gamut of
tests/test_chord_eval.py, all nine experiments on identical generations, and
one sweep through the real sampler of each package."""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from polyffusion_tpu import expr as JX
from polyffusion_tpu.chord import eval as jce
from polyffusion_tpu.chord import labels as jlabels
from polyffusion_tpu.chord.encode import encode_to_absolute_row
from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.models.encoders import ChordEncoder as JaxChordEncoder
from polyffusion_tpu.models.encoders import PianoTreeEncoder as JaxPianoTreeEncoder
from polyffusion_tpu.models.encoders import TextureEncoder as JaxTextureEncoder
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch import expr as X
from polyffusion_tpu_torch.chord import eval as ce
from polyffusion_tpu_torch.chord import labels
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import (
    chord_encoder_state_from_jax,
    pianotree_encoder_state_from_jax,
    texture_encoder_state_from_jax,
    unet_state_from_jax,
)
from polyffusion_tpu_torch.data import write_song_npz
from polyffusion_tpu_torch.inference import InferenceSession
from polyffusion_tpu_torch.models import ChordEncoder, PianoTreeEncoder, TextureEncoder
from polyffusion_tpu_torch.tasks import SDFTask

REL = 1e-12  # float64 metrics: equal up to the last bits
COND_ATOL = 2e-5  # the encoders' conditions
ATOL, RTOL = 2e-3, 1e-3  # the DDIM tolerance of tests/test_torch_slice.py
CHD_Z, TXT_Z, PNO_Z = 16, 8, 8
TINY = dict(
    model_name="sdf_tiny", batch_size=4, learning_rate=1e-4, bf16=False, in_channels=2,
    out_channels=2, channels=32, attention_levels=[2], n_res_blocks=1,
    channel_multipliers=[1, 2, 4], n_heads=2, tf_layers=1, linear_start=0.00085,
    linear_end=0.012, n_steps=20, img_h=128, img_w=128, cond_mode="mix", use_enc=True,
    chd_hidden_dim=16, chd_z_dim=CHD_Z, txt_emb_size=16, txt_hidden_dim=16, txt_z_dim=TXT_Z,
)
D_COND = {"chord": CHD_Z, "txt": 4 * TXT_Z, "chord+txt": CHD_Z + 4 * TXT_Z, "pnotree": 4 * PNO_Z}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _roll(rng, n=None, density=0.03):
    shape = (2, 128, 128) if n is None else (n, 2, 128, 128)
    x = (rng.random(shape) < density).astype(np.float32)
    x[..., 1, :, :] = (rng.random(x[..., 1, :, :].shape) < 0.1)
    return x + rng.normal(0, 0.1, shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=REL, atol=0, err_msg=f"beyond rel {REL}")


# -- the metric functions ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["onset_step_f1", "density_corr", "note_cell_f1",
                                  "_onset_steps", "_banded_onsets"])
def test_roll_metric_matches_jax(name):
    rng = np.random.default_rng(0)
    cases = [(_roll(rng), _roll(rng)) for _ in range(6)]
    empty = np.zeros((2, 128, 128), np.float32)
    cases += [(empty, empty), (empty, _roll(rng)), (cases[0][0], cases[0][0])]
    for a, b in cases:
        args = (a,) if name.startswith("_") else (a, b)
        _close(getattr(X, name)(*args), getattr(JX, name)(*args))


@pytest.mark.parametrize("name", ["_cosine_rows", "_psd_sqrtm", "_gaussian_stats",
                                  "feature_stats", "_knn_radii", "precision_recall",
                                  "frechet_distance"])
def test_set_metric_matches_jax(name):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(12, 5)), rng.normal(size=(9, 5)) + 0.3
    cov = a.T @ a / 12
    args = {
        "_cosine_rows": (a, rng.normal(size=(12, 5))),
        "_psd_sqrtm": (cov,),
        "_gaussian_stats": (a,),
        "feature_stats": (_roll(rng, 5),),
        "_knn_radii": (a, 3),
        "precision_recall": (a, b),
        "frechet_distance": (*JX._gaussian_stats(a), *JX._gaussian_stats(b)),
    }[name]
    got, want = getattr(X, name)(*args), getattr(JX, name)(*args)
    for g, w in zip(np.atleast_1d(got) if not isinstance(got, tuple) else got,
                    np.atleast_1d(want) if not isinstance(want, tuple) else want):
        _close(g, w)
    assert JX._F1_BANDS == X._F1_BANDS


# -- chord labels and scoring -------------------------------------------------------------

# the gamut of tests/test_chord_eval.py: triads, sevenths, extended, inversions,
# degree lists, omissions, N and X
LABELS = [
    "N", "X", "C", "C:maj", "A:min", "G:7", "E:maj7", "D:min7", "F#:dim",
    "Bb:aug", "C#:sus4", "Ab:sus2", "B:hdim7", "Db:dim7", "Eb:minmaj7",
    "G:maj6", "C:min6", "A:9", "E:maj9", "F:min9", "D:11", "B:13", "Gb:min11",
    "C:maj13", "D:min13", "C/5", "A:min/b3", "G:7/3", "E:maj7/7", "F:maj(9)",
    "C:maj(*3)", "D:min(*5,b7)", "G:(1,4,5)", "Bb:5", "C:1", "Cb:maj",
    "B#:min", "Fbb:maj7",
]


def _pairs():
    rng = np.random.default_rng(0)
    n = len(LABELS)
    ref = [LABELS[i] for i in rng.integers(0, n, 400)] + LABELS + LABELS
    est = [LABELS[i] for i in rng.integers(0, n, 400)] + LABELS + LABELS[1:] + LABELS[:1]
    return ref, est


def _intervals(rng, n, jitter):
    bounds = np.cumsum(rng.uniform(0.2, 2.0, n + 1)) + jitter
    return np.stack([bounds[:-1], bounds[1:]], axis=1)


@pytest.mark.parametrize("name", ["thirds", "thirds_inv", "triads", "triads_inv", "tetrads",
                                  "tetrads_inv", "root", "mirex", "majmin", "majmin_inv",
                                  "sevenths", "sevenths_inv"])
def test_comparison_matches_jax(name):
    ref, est = _pairs()
    np.testing.assert_array_equal(getattr(ce, name)(ref, est), getattr(jce, name)(ref, est))


@pytest.mark.parametrize("wrap", [False, True])
def test_encode_many_and_rotate_match_jax(wrap):
    got, want = ce.encode_many(LABELS, wrap), jce.encode_many(LABELS, wrap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ce.rotate_bitmaps_to_roots(got[1], got[0]),
                                  jce.rotate_bitmaps_to_roots(want[1], want[0]))


def test_weighting_and_segmentation_match_jax():
    rng = np.random.default_rng(2)
    ref, est = _pairs()
    comps = ce.triads(ref, est)
    w = np.abs(rng.standard_normal(len(comps))) + 0.01
    _close(ce.weighted_accuracy(comps, w), jce.weighted_accuracy(comps, w))
    a, b = _intervals(rng, 20, 0.0), _intervals(rng, 25, 0.0)
    for name in ("directional_hamming_distance", "overseg", "underseg", "seg"):
        _close(getattr(ce, name)(a, b), getattr(jce, name)(a, b))
    iv = _intervals(rng, 12, 0.0)
    labs = ["C", "C:maj", "A:min", "A:min", "N", "N", "A:9", "A:9", "X", "C/5", "C/5", "G:13"]
    np.testing.assert_array_equal(ce.merge_chord_intervals(iv, labs),
                                  jce.merge_chord_intervals(iv, labs))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_evaluate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_ref, n_est = 30, 26
    ref_iv, est_iv = _intervals(rng, n_ref, 0.0), _intervals(rng, n_est, 0.3)
    ref_lab = [LABELS[i] for i in rng.integers(0, len(LABELS), n_ref)]
    est_lab = [LABELS[i] for i in rng.integers(0, len(LABELS), n_est)]
    got = ce.evaluate(ref_iv, ref_lab, est_iv, est_lab)
    want = jce.evaluate(ref_iv, ref_lab, est_iv, est_lab)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k])


def test_labels_match_jax():
    rng = np.random.default_rng(6)
    rows = [encode_to_absolute_row(lab) for lab in LABELS if lab not in ("N", "X")]
    rand = np.zeros((200, 14))
    rand[:, 0] = rng.integers(0, 12, 200)
    rand[:, 1:13] = rng.integers(0, 2, (200, 12))
    rand[:, 13] = rng.integers(0, 12, 200)
    mat = np.concatenate([np.asarray(rows, float), rand, np.zeros((3, 14))])
    got, want = labels.labels_from_chord_matrix(mat), jlabels.labels_from_chord_matrix(mat)
    assert got == want
    assert [labels.label_from_chd_row(r) for r in mat[:20]] == want[:20]
    iv, merged = labels.beat_labels_to_intervals(got[:40] + got[:1] * 5)
    jiv, jmerged = jlabels.beat_labels_to_intervals(want[:40] + want[:1] * 5)
    assert merged == jmerged
    np.testing.assert_array_equal(iv, jiv)


def test_recognized_oracle_scores_as_jax():
    """A roll that plays its conditioning chords: the full chd_acc path (MIDI,
    recognizer, scoring) scores near 1, and as JAX's does."""
    tones = {"C:maj": [48, 60, 64, 67], "F:maj": [53, 65, 69, 72],
             "G:maj": [55, 67, 71, 74], "A:min": [45, 57, 60, 64]}
    prog = ["C:maj"] * 8 + ["F:maj"] * 8 + ["G:maj"] * 8 + ["A:min"] * 8
    roll = np.zeros((2, 128, 128), np.float32)
    for beat, lab in enumerate(prog):
        for p in tones[lab]:
            roll[0, beat * 4, p] = 1.0
            roll[1, beat * 4 : beat * 4 + 4, p] = 1.0
    got, want = X._recognize_segment(roll), JX._recognize_segment(roll)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    ref_iv, ref_lab = labels.beat_labels_to_intervals(prog)
    res = ce.evaluate(ref_iv, ref_lab, *got)
    assert res["majmin"] > 0.95 and res["root"] > 0.95 and res["seg"] > 0.8, res
    empty = np.zeros_like(roll)
    assert X._recognize_segment(empty)[1] == JX._recognize_segment(empty)[1] == ["N"]


# -- the experiments ------------------------------------------------------------------------


def _write_song(path, seed, n_bars=24):
    rng = np.random.default_rng(seed)
    n_beats, n_bins = n_bars * 4, n_bars * 16
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
    for i in range(4):  # three train songs, one val song of 17 segments
        _write_song(str(d / f"song{i}.npz"), seed=i)
    return str(d)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def encoders():
    chd = JaxChordEncoder(hidden_dim=16, z_dim=CHD_Z)
    txt = JaxTextureEncoder(emb_size=16, hidden_dim=16, z_dim=TXT_Z)
    pno = JaxPianoTreeEncoder(note_emb_size=16, enc_notes_hid_size=8, enc_time_hid_size=12,
                              z_size=PNO_Z)
    p_chd = _np_tree(chd.init(jax.random.PRNGKey(1), np.zeros((1, 32, 36), np.float32))["params"])
    p_txt = _np_tree(txt.init(jax.random.PRNGKey(2), np.zeros((1, 32, 128), np.float32))["params"])
    p_pno = _np_tree(pno.init(jax.random.PRNGKey(3),
                              np.full((1, 32, 20, 6), 130, np.int32))["params"])
    t_chd, t_txt, t_pno = ChordEncoder(36, 16, CHD_Z), TextureEncoder(16, 16, TXT_Z), \
        PianoTreeEncoder(16, 8, 12, PNO_Z)
    t_chd.load_state_dict(chord_encoder_state_from_jax(p_chd), strict=True)
    t_txt.load_state_dict(texture_encoder_state_from_jax(p_txt), strict=True)
    t_pno.load_state_dict(pianotree_encoder_state_from_jax(p_pno), strict=True)
    return (dict(chord_enc=chd, chord_enc_params=p_chd, txt_enc=txt, txt_enc_params=p_txt,
                 pnotree_enc=pno, pnotree_enc_params=p_pno),
            dict(chord_enc=t_chd, txt_enc=t_txt, pnotree_enc=t_pno))


def _tasks(encoders, cond_type):
    cfg = dict(TINY, cond_type=cond_type, d_cond=D_COND[cond_type])
    jax_enc, port_enc = encoders
    keep = {"chord": ["chord_enc"], "txt": ["txt_enc"], "chord+txt": ["chord_enc", "txt_enc"],
            "pnotree": ["pnotree_enc"]}[cond_type]
    jtask = JaxSDFTask(JaxParams(cfg), **{k: v for k, v in jax_enc.items()
                                         if k.replace("_params", "") in keep})
    task = SDFTask(Params(cfg), **{k: port_enc[k] for k in keep}, device="cpu")
    return jtask, task


class FakeGenerations:
    """``session.predict`` replaced by one deterministic function of the call
    index and batch size; records the conditions and scales it is given."""

    def __init__(self):
        self.calls = []

    def __call__(self, cond, cond_mid=None, uncond_scale=1.0, autoreg=False, orig=None,
                 mask=None, noise=None):
        self.calls.append((np.asarray(cond, np.float32), float(uncond_scale),
                           None if mask is None else np.asarray(mask)))
        return _roll(np.random.default_rng(1000 + len(self.calls)), len(cond))


def _args(data_dir, out, **kw):
    return SimpleNamespace(**{**dict(data_dir=data_dir, split_file=None, batch_size=4,
                                     batch_num=2, output_dir=str(out), uncond_scale=1.0,
                                     scales="0,3", seed=0), **kw})


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("kind, cond_type", [
    ("uncond", "chord"), ("inp_below", "chord"), ("inp_bars", "chord"), ("chd", "chord"),
    ("txt", "txt"), ("chd_acc", "chord"), ("chd_acc", "chord+txt"), ("txt_acc", "txt"),
    ("txt_acc", "chord+txt"), ("pnt_acc", "pnotree"), ("fd", "chord"), ("fd", "txt"),
    ("fd", "chord+txt"),
])
def test_experiment_matches_jax(encoders, data_dir, tmp_path, kind, cond_type):
    """Identical generations -> identical tables, arrays and files; the
    conditions each package fed its sampler agree within COND_ATOL."""
    jtask, task = _tasks(encoders, cond_type)
    jsess = JaxSession(jtask, None, use_ddim=True, ddim_steps=2)
    sess = InferenceSession(task, sampler="ddim", ddim_steps=2, device="cpu")
    jsess.predict, sess.predict = FakeGenerations(), FakeGenerations()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = JX.EXPERIMENTS[kind](jsess, jtask, _args(data_dir, tmp_path / "jax"))
    got = X.EXPERIMENTS[kind](sess, task, _args(data_dir, tmp_path / "port"))
    if isinstance(want, dict):
        assert got == want
        assert all(np.isfinite(v) for row in got.values() for v in row.values())
    else:
        np.testing.assert_array_equal(got, want)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert len(sess.predict.calls) == len(jsess.predict.calls) > 0
    for (c, s, m), (jc, js, jm) in zip(sess.predict.calls, jsess.predict.calls):
        assert s == js
        np.testing.assert_allclose(c, jc, atol=COND_ATOL, rtol=0,
                                   err_msg=f"conditions beyond atol {COND_ATOL}")
        assert (m is None) == (jm is None) and (m is None or (m == jm).all())


def test_pnt_acc_refuses_other_conditions(encoders, data_dir, tmp_path):
    _, task = _tasks(encoders, "chord")
    with pytest.raises(ValueError, match="pnotree"):
        X.pnt_acc(InferenceSession(task, device="cpu"), task, _args(data_dir, tmp_path))


def test_sweep_through_the_samplers_matches_jax(encoders, data_dir, tmp_path):
    """fd at scales 0 and 1 through each package's own DDIM-2 sampler, fed the
    same starting noise. JAX traces the scale (the CFG double batch at every
    scale); the port runs one pass at 0 and 1: the same guidance up to float
    rounding, held at the port's DDIM tolerance (atol 2e-3, rtol 1e-3)."""
    jtask, task = _tasks(encoders, "chord")
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    task.load_unet_state(unet_state_from_jax(params))
    jsess = JaxSession(jtask, params, use_ddim=True, ddim_steps=2, traced_cfg_scale=True)
    sess = InferenceSession(task, sampler="ddim", ddim_steps=2, device="cpu")
    gens = {"jax": [], "port": []}

    def with_noise(name, predict):
        def run(cond, uncond_scale=1.0):
            rng = np.random.default_rng(len(gens[name]))
            noise = rng.standard_normal((len(cond), 128, 128, 2)).astype(np.float32)
            gens[name].append(np.asarray(predict(cond, uncond_scale=uncond_scale, noise=noise)))
            return gens[name][-1]
        return run

    jsess.predict = with_noise("jax", jsess.predict)
    sess.predict = with_noise("port", sess.predict)
    args = dict(batch_num=1, scales="0,1")
    want = JX.fd(jsess, jtask, _args(data_dir, tmp_path, **args))
    got = X.fd(sess, task, _args(data_dir, tmp_path, **args))
    assert len(gens["port"]) == len(gens["jax"]) == 2
    for g, w in zip(gens["port"], gens["jax"]):
        assert g.shape == w.shape == (4, 2, 128, 128)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"beyond atol {ATOL}, rtol {RTOL}")
    assert got.keys() == want.keys() and got["real_split"] == want["real_split"]
    assert all(np.isfinite(v) for row in got.values() for v in row.values())
