"""The maintenance tools and helpers against the JAX package's: ``tools.py``
(``synth_corpus``, ``pop909_import``, ``remove_from_split``,
``cleanup_checkpoints``, the CLI), ``dirs.py`` (arguments in place of
environment variables) and ``config.py``'s ``available_presets`` and
``convert_json_to_yaml``."""

import importlib
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
import yaml

import polyffusion_tpu.dirs as jax_dirs_module
from polyffusion_tpu import tools as jax_tools
from polyffusion_tpu.config import available_presets as jax_available_presets
from polyffusion_tpu.config import convert_json_to_yaml as jax_convert_json_to_yaml
from polyffusion_tpu_torch import dirs as port_dirs
from polyffusion_tpu_torch import tools
from polyffusion_tpu_torch.config import available_presets, convert_json_to_yaml
from polyffusion_tpu_torch.data import SegmentDataset


def _songs(d):
    """Every array of every song file in ``d``, by file; object arrays (per
    track) by element."""
    out = {}
    for fn in sorted(os.listdir(d)):
        with np.load(os.path.join(d, fn), allow_pickle=True) as f:
            out[fn] = {k: f[k] for k in f.files}
    return out


def _assert_same_songs(got_dir, want_dir):
    got, want = _songs(got_dir), _songs(want_dir)
    assert list(got) == list(want) and want
    for fn, arrays in want.items():
        assert list(got[fn]) == list(arrays), fn
        for k, w in arrays.items():
            g = got[fn][k]
            assert g.dtype == w.dtype and g.shape == w.shape, (fn, k)
            if w.dtype == object:
                for gi, wi in zip(g, w):
                    if isinstance(wi, dict):
                        assert gi == wi, (fn, k)
                    else:
                        assert np.asarray(gi).dtype == np.asarray(wi).dtype, (fn, k)
                        np.testing.assert_array_equal(gi, wi, err_msg=f"{fn} {k}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{fn} {k}")


@pytest.mark.parametrize("vary_texture", [False, True])
def test_synth_corpus_equals_jax(tmp_path, vary_texture):
    args = dict(n_songs=4, n_bars=12, seed=3, vary_texture=vary_texture)
    assert tools.synth_corpus(str(tmp_path / "port"), **args) == 4
    jax_tools.synth_corpus(str(tmp_path / "jax"), **args)
    _assert_same_songs(str(tmp_path / "port"), str(tmp_path / "jax"))
    ds = SegmentDataset.from_dir(str(tmp_path / "port"))
    p2c, _, chd, _ = ds[0]
    assert p2c.shape == (2, 128, 128) and p2c.sum() > 0 and chd.shape == (32, 14)


def _pop909_origin(origin, n_pieces=2):
    """POP909's piano-roll release: per track (onset beat, bin, 4, offset beat,
    bin, 4, pitch, velocity) rows, a beat table, a chord table (the pattern of
    JAX ``tests/test_expr_tools.py::test_pop909_import_and_dict_start_tables``)."""
    rng = np.random.default_rng(0)
    origin.mkdir()
    n_beats = 64
    beat = np.zeros((n_beats, 6), np.int64)
    beat[:, 3] = np.arange(n_beats) % 4

    def track(n):
        rows = []
        for _ in range(n):
            ob = rng.integers(0, n_beats - 2)
            rows.append([ob, rng.integers(0, 4), 4, ob + 1, rng.integers(0, 4), 4,
                         rng.integers(40, 90), 80])
        return np.array(sorted(rows, key=lambda r: (r[0], r[1])))

    for i in range(n_pieces):
        np.savez(str(origin / f"{i + 1:03d}.npz"), melody=track(30), bridge=track(20),
                 piano=track(50), beat=beat, chord=np.zeros((n_beats, 14), np.int64))
    (origin / "README.txt").write_text("not a piece")


def test_pop909_import_equals_jax(tmp_path, capsys):
    _pop909_origin(tmp_path / "origin")
    assert tools.pop909_import(str(tmp_path / "origin"), str(tmp_path / "port")) == 2
    jax_tools.pop909_import(str(tmp_path / "origin"), str(tmp_path / "jax"))
    _assert_same_songs(str(tmp_path / "port"), str(tmp_path / "jax"))
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("/port", "/jax") == out[1]
    ds = SegmentDataset.from_dir(str(tmp_path / "port"))  # dict start tables load
    assert len(ds) > 0 and ds[0][0].sum() > 0


def test_remove_from_split_equals_jax(tmp_path):
    split = (["a.npz", "b.npz", "c.npz"], ["d.npz", "e.npz"])
    for side in ("port", "jax"):
        with open(tmp_path / f"{side}.pkl", "wb") as f:
            pickle.dump(split, f)
    for song in ("b.npz", "e.npz"):
        tools.remove_from_split(str(tmp_path / "port.pkl"), song)
        jax_tools.remove_from_split(str(tmp_path / "jax.pkl"), song)
    got, want = (pickle.load(open(tmp_path / f"{s}.pkl", "rb")) for s in ("port", "jax"))
    assert got == want == (["a.npz", "c.npz"], ["d.npz"])
    with pytest.raises(AssertionError, match="not in split"):
        tools.remove_from_split(str(tmp_path / "port.pkl"), "b.npz")


def _result_tree(root):
    """Run directories of both trainers, with and without checkpoints."""
    runs = {
        "jax_step": ["chkpts/100/"], "jax_last": ["chkpts/last/"], "jax_none": ["chkpts/"],
        "port_last": ["chkpts/last.pt", "chkpts/best.json"], "port_step": ["chkpts/step_40.pt"],
        "port_none": ["chkpts/best.json", "params.yaml"], "no_chkpts": ["params.yaml"],
        "port_tmp": ["chkpts/last.pt.tmp"],
    }
    for name, entries in runs.items():
        for e in entries:
            path = os.path.join(root, "group", name, e)
            if e.endswith("/"):
                os.makedirs(path, exist_ok=True)
            else:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                open(path, "w").close()
    open(os.path.join(root, "stray.txt"), "w").close()  # not a group


def test_cleanup_checkpoints(tmp_path):
    """The JAX tool on the same tree removes the same JAX runs; the port's
    also keeps the port's runs with ``last.pt`` or ``step_<n>.pt``, which
    JAX's would remove."""
    for side in ("port", "jax"):
        _result_tree(str(tmp_path / side))
    got = tools.cleanup_checkpoints(str(tmp_path / "port"), assume_yes=True)
    want = jax_tools.cleanup_checkpoints(str(tmp_path / "jax"), assume_yes=True)
    names = lambda paths: sorted(os.path.basename(p) for p in paths)  # noqa: E731
    assert names(got) == ["jax_none", "no_chkpts", "port_none", "port_tmp"]
    assert names(want) == sorted(names(got) + ["port_last", "port_step"])
    assert sorted(os.listdir(tmp_path / "port" / "group")) == ["jax_last", "jax_step",
                                                               "port_last", "port_step"]


def test_cleanup_asks_without_yes(tmp_path, monkeypatch):
    _result_tree(str(tmp_path))
    answers = iter(["y", "n", "n", "n"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    removed = tools.cleanup_checkpoints(str(tmp_path))
    assert [os.path.basename(p) for p in removed] == ["jax_none"]


def test_cli_subcommands(tmp_path):
    tools.main(["synth_corpus", "--out", str(tmp_path / "songs"), "--n_songs", "2",
                "--n_bars", "10", "--seed", "5", "--vary_texture"])
    jax_tools.main(["synth_corpus", "--out", str(tmp_path / "jax"), "--n_songs", "2",
                    "--n_bars", "10", "--seed", "5", "--vary_texture"])
    _assert_same_songs(str(tmp_path / "songs"), str(tmp_path / "jax"))
    _pop909_origin(tmp_path / "origin", n_pieces=1)
    tools.main(["pop909_import", "--origin", str(tmp_path / "origin"), "--out",
                str(tmp_path / "pop")])
    assert os.listdir(tmp_path / "pop") == ["001.npz"]
    with open(tmp_path / "split.pkl", "wb") as f:
        pickle.dump((["synth_000.npz"], ["synth_001.npz"]), f)
    tools.main(["remove_from_split", "--split", str(tmp_path / "split.pkl"), "--song",
                "synth_001.npz"])
    assert pickle.load(open(tmp_path / "split.pkl", "rb")) == (["synth_000.npz"], [])
    (tmp_path / "result" / "g" / "run" / "chkpts").mkdir(parents=True)
    torch.save({}, tmp_path / "result" / "g" / "run" / "chkpts" / "last.pt")
    (tmp_path / "result" / "g" / "empty").mkdir()
    tools.main(["cleanup_checkpoints", "--result_dir", str(tmp_path / "result"), "--yes"])
    assert os.listdir(tmp_path / "result" / "g") == ["run"]


# -- dirs and config ------------------------------------------------------------------------

ENV = ("POLYFFUSION_ROOT", "POLYFFUSION_DATA_DIR", "POP909_DATA_DIR", "MUSICALION_DATA_DIR",
       "TRAIN_SPLIT_DIR", "PRETRAINED_DIR", "POLYFFUSION_RESULT_DIR")
# the port's argument for each of JAX's variables
ARGS = dict(zip(ENV, ("root", "data_dir", "pop909_data_dir", "musicalion_data_dir",
                      "train_split_dir", "pretrained_dir", "result_dir")))


def _jax_dirs(monkeypatch, env):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mod = importlib.reload(jax_dirs_module)
    return {f.lower(): getattr(mod, f) for f in dir(mod) if f.isupper()}


@pytest.mark.parametrize("env", [
    {}, {"POLYFFUSION_ROOT": "/x/top"}, {"POLYFFUSION_DATA_DIR": "/x/data"},
    {"POLYFFUSION_ROOT": "/x/top", "PRETRAINED_DIR": "/x/pre", "TRAIN_SPLIT_DIR": "/x/split"},
    {"POP909_DATA_DIR": "/x/pop", "MUSICALION_DATA_DIR": "/x/mus",
     "POLYFFUSION_RESULT_DIR": "/x/res"},
], ids=["defaults", "root", "data", "root_pre_split", "pop_mus_result"])
def test_dirs_equal_jax(monkeypatch, env):
    """With JAX's variables unset the paths are JAX's defaults; each argument
    does what its variable does in JAX (whose module is reloaded, unchanged,
    under each environment; the port reads none)."""
    try:
        want = _jax_dirs(monkeypatch, env)
        for name in ENV:  # the port's paths do not move with the environment
            monkeypatch.setenv(name, "/elsewhere")
        got = port_dirs.dirs(**{ARGS[k]: v for k, v in env.items()})._asdict()
    finally:
        monkeypatch.undo()
        importlib.reload(jax_dirs_module)
    assert got == want


def test_ensure_dirs(tmp_path):
    d = port_dirs.dirs(str(tmp_path))
    assert not os.path.exists(d.data_dir)  # nothing is made until asked
    port_dirs.ensure_dirs(d)
    assert sorted(os.listdir(tmp_path)) == ["data", "result"]
    assert os.listdir(tmp_path / "data") == ["train_split_pnt"]


# presets of the port alone: models the JAX package never had
PORT_ONLY_PRESETS = ("sdxl_base",)


def test_available_presets_equal_jax():
    assert [p for p in available_presets() if p not in PORT_ONLY_PRESETS] == \
        jax_available_presets()
    assert "sdf_chd8bar" in available_presets()
    assert set(PORT_ONLY_PRESETS) <= set(available_presets())


@pytest.mark.parametrize("delete_old", [False, True])
def test_convert_json_to_yaml_equals_jax(tmp_path, delete_old):
    params = {"model_name": "sdf_chd8bar", "channels": 64, "attention_levels": [2, 3],
              "linear_end": 0.012, "bf16": True, "note": None}
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "params.json").write_text(json.dumps(params))
    got = convert_json_to_yaml(str(tmp_path / "port" / "params.json"), delete_old)
    want = jax_convert_json_to_yaml(str(tmp_path / "jax" / "params.json"), delete_old)
    assert got == want.replace("/jax/", "/port/") and got.endswith("params.yaml")
    text = open(got).read()
    assert text == open(want).read() and yaml.safe_load(text) == params
    assert os.path.exists(tmp_path / "port" / "params.json") is not delete_old
    assert convert_json_to_yaml(got) == got  # a yaml path is returned as it is
    shutil.rmtree(tmp_path / "port")
