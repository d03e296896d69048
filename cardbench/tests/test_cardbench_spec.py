"""BENCHMARK.json keeps to the contract's characters and ties, the traffic
is a function of the seed, and a cell, configuration, mix and metric added
as files alone are found by name."""

import json
import os
import re
import shutil

import numpy as np
import pytest

from cardbench import inputs
from cardbench import spec as specs
from cardbench.drivers import serve, train

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = specs.benchmark()


def test_names_units_and_keys_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        names += c["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for name in names:
        assert NAME.match(name), name
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("held", [False, True])
def test_every_per_layer_metric_moves_a_metric_its_cells_report(held):
    bench = specs.benchmark(held=held)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            assert cell in cells
            e2e, per_layer = specs.metrics_of(bench, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)
            assert m in per_layer
    for cell in cells:
        e2e, per_layer = specs.metrics_of(bench, cell)
        assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("held", [False, True])
def test_every_cell_has_its_files(held):
    for w in specs.benchmark(held=held)["workloads"]:
        s = specs.load(w["name"], held=held)
        assert s.traffic["driver"] and s.config["family"] and s.limits
        for m in s.per_layer:
            assert callable(specs.reader(m["name"]).read)


def test_a_held_cell_is_not_in_the_benchmark_and_loads_only_when_asked():
    held = specs._json(os.path.join(specs.ROOT, "cardbench", "held.json"))
    names = {w["name"] for w in BENCH["workloads"]}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert not {x["name"] for x in held[key]} & {x["name"] for x in BENCH[key]}, key
    for w in held["workloads"]:
        assert w["name"] not in names
        with pytest.raises(KeyError):
            specs.load(w["name"])
        assert specs.load(w["name"], held=True).cell == w


def test_a_seed_gives_the_same_traffic_and_another_seed_other_traffic():
    big = 2 ** 31 + 12345
    assert np.array_equal(inputs.chords(big, 3, 4), inputs.chords(big, 3, 4))
    assert not np.array_equal(inputs.chords(big, 3, 4), inputs.chords(big + 1, 3, 4))
    assert np.array_equal(inputs.rolls(big, 0, 2), inputs.rolls(big, 0, 2))
    assert not np.array_equal(inputs.rolls(big, 0, 2), inputs.rolls(big + 1, 0, 2))
    a, b = serve.schedule(big, 4.5, 45.0), serve.schedule(big + 1, 4.5, 45.0)
    assert serve.schedule(big, 4.5, 45.0) == a and a != b
    # the same arrivals and sizes for every seed, in another order
    assert sorted(a[1]) == sorted(b[1])
    assert sorted(np.diff(a[0] + [45.0])) == pytest.approx(sorted(np.diff(b[0] + [45.0])))
    d1, d2 = (train.step_draws({"n_steps": 1000, "in_channels": 2, "img_h": 8, "img_w": 8},
                               s, 0, 4, "cpu") for s in (big, big))
    assert all(bool((d1[k] == d2[k]).all()) for k in d1)


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    root = tmp_path
    shutil.copytree(os.path.join(specs.ROOT, "cardbench"), root / "cardbench")
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(specs.ROOT, "cardbench/configs/sdf_chd8bar.json")))
    cfg["channels"] = 128
    (root / "cardbench/configs/sdf_wide.json").write_text(json.dumps(cfg))
    (root / "cardbench/traffic/gen-b16.json").write_text(json.dumps(
        {"driver": "generate", "batch": 16, "ddim_steps": 50, "cfg_scale": 5.0,
         "check_rows": 16}))
    (root / "cardbench/limits/wide.gen-b16.json").write_text(
        json.dumps({"limits": {"sample_gap": 0.5}}))
    (root / "cardbench/metrics/evals.gen.py").write_text("def read(ctx):\n    return 1.0\n")
    bench["configs"].append({"name": "sdf_wide", "source": "x", "file":
                             "cardbench/configs/sdf_wide.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wide.gen-b16", "config": "sdf_wide",
                               "traffic": "gen-b16", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("wide.gen-b16")
    bench["per_layer"].append({"name": "evals.gen", "unit": "n", "better": "higher",
                               "source": "program_counter", "layer": "the card",
                               "moves": "gen_samples_per_s", "workloads": ["wide.gen-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    s = specs.load("wide.gen-b16", root=str(root))
    assert s.config["channels"] == 128 and s.traffic["batch"] == 16
    assert s.limits == {"sample_gap": 0.5} and s.driver.__name__ == "cardbench.drivers.generate"
    assert [m["name"] for m in s.per_layer] == ["evals.gen"]
    assert specs.reader("evals.gen", root=str(root)).read({}) == 1.0
