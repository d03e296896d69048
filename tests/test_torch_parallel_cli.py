"""The training CLI across ranks: ``python -m polyffusion_tpu_torch.main
--fsdp --nproc 2 --device cpu`` spawns two gloo ranks (the route that spawns
one process per card on CUDA) for 3 steps, then with ``--resume`` for 2, and
writes the run directory of a one-process run (the same files, the same
tensor names and shapes, the same losses: every rank reads the same
batches), which the one-process inference CLI reads unchanged."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from polyffusion_tpu_torch.inference import main as infer_main
from polyffusion_tpu_torch.main import main as train_main
from polyffusion_tpu_torch.parallel.mesh import launch

from test_torch_train import _write_song

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]", "n_res_blocks=1",
        "bf16=false", "n_steps=10"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(data, run):
    args = ["--model", "sdf_chdvnl", "--output_dir", run, "--data_dir", data, "--device", "cpu",
            "--batch_size", "4", "--log_every", "1"]
    for kv in TINY:
        args += ["--set", kv]
    return args


def _files(run):
    return sorted(os.path.relpath(os.path.join(d, f), run) for d, _, fs in os.walk(run) for f in fs)


def _layout(obj):
    """Names and shapes of every tensor in a checkpoint, its other values as they are."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype)
    if isinstance(obj, dict):
        return {k: _layout(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_layout(v) for v in obj]
    return obj


def test_fsdp_cli_run_directory_is_a_one_process_one(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i in range(4):
        _write_song(str(data / f"song{i}.npz"), seed=i, n_bars=12)
    run2, run1 = str(tmp_path / "run2"), str(tmp_path / "run1")
    cli = [sys.executable, "-m", "polyffusion_tpu_torch.main", *_args(str(data), run2), "--fsdp",
           "--nproc", "2"]
    log_path = tmp_path / "ranks.log"
    with open(log_path, "w") as log:
        ranks = subprocess.Popen(
            ["sh", "-c", '"$@" --max_steps 3 && "$@" --max_steps 5 --resume', "sh", *cli],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    # the one-process run meanwhile
    assert train_main(_args(str(data), run1) + ["--max_steps", "3"]).step == 3
    assert train_main(_args(str(data), run1) + ["--max_steps", "5", "--resume"]).step == 5
    try:
        rc = ranks.wait(timeout=600)
    finally:
        if ranks.poll() is None:
            ranks.kill()
            ranks.wait()
    log = open(log_path).read()
    assert rc == 0, log[-3000:]
    assert log.count("[train]") == 2 and log.count("devices=2") == 2 and "fsdp=True" in log
    assert "[resume] restored checkpoint at step 3" in log
    assert log.count("[resume]") == 1  # rank 0 speaks for the run

    assert _files(run2) == _files(run1)
    cfg2, cfg1 = (yaml.safe_load(open(os.path.join(r, "params.yaml"))) for r in (run2, run1))
    assert cfg2.pop("fsdp") is True and cfg2 == cfg1
    for name in os.listdir(os.path.join(run1, "chkpts")):
        if name.endswith(".pt"):
            a, b = (torch.load(os.path.join(r, "chkpts", name), weights_only=True)
                    for r in (run2, run1))
            assert _layout({k: v for k, v in a.items() if k != "val_loss"}) == _layout(
                {k: v for k, v in b.items() if k != "val_loss"}), name
    rec2, rec1 = ([json.loads(line) for line in open(os.path.join(r, "metrics.jsonl"))]
                  for r in (run2, run1))
    assert [sorted(r) for r in rec2] == [sorted(r) for r in rec1]
    for a, b in zip(rec2, rec1):
        for k in a:
            if k.startswith(("train/loss", "val/loss")):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)

    out = tmp_path / "gen"
    (gen,) = infer_main(["--chkpt_path", run2, "--data_dir", str(data), "--song_fn", "song3.npz",
                         "--output_dir", str(out), "--device", "cpu", "--ddim", "--ddim_steps",
                         "5", "--length", "1", "--uncond_scale", "5"])
    assert gen.shape == (1, 2, 128, 128) and np.isfinite(gen).all()
    assert len([f for f in os.listdir(out) if f.endswith(".mid")]) == 1


def test_fsdp_on_one_rank_makes_its_group(tmp_path):
    """``--fsdp`` in one process (one card) makes a one-rank group for the
    run, shards the large leaves one way, and leaves no group behind; the
    distill CLI honours the teacher run's ``fsdp: true`` the same way (a new
    student each stage) and writes a run directory the inference CLI reads."""
    import torch.distributed as dist

    from polyffusion_tpu_torch.distill import main as distill_main

    data = tmp_path / "data"
    data.mkdir()
    for i in range(4):
        _write_song(str(data / f"song{i}.npz"), seed=i, n_bars=12)
    run = str(tmp_path / "run")
    state = train_main(_args(str(data), run) + ["--fsdp", "--max_steps", "2"])
    assert state.step == 2 and not dist.is_initialized()
    assert yaml.safe_load(open(os.path.join(run, "params.yaml")))["fsdp"] is True
    ckpt = torch.load(os.path.join(run, "chkpts", "last.pt"), weights_only=True)
    assert all(type(v) is torch.Tensor for v in ckpt["params"].values())

    out = str(tmp_path / "dist")
    cfg = distill_main(["--teacher", run, "--data_dir", str(data), "--output_dir", out,
                        "--device", "cpu", "--batch_size", "4", "--base_steps", "4",
                        "--end_steps", "2", "--stage_a_steps", "1", "--phase_steps", "1",
                        "--log_every", "1"])
    assert cfg["fsdp"] is True and len(cfg["distill_grid"]) == 2 and not dist.is_initialized()
    (gen,) = infer_main(["--chkpt_path", out, "--data_dir", str(data), "--song_fn", "song3.npz",
                         "--output_dir", str(tmp_path / "gen"), "--device", "cpu", "--ddim",
                         "--length", "1"])
    assert gen.shape == (1, 2, 128, 128) and np.isfinite(gen).all()


def test_launch_refuses_ranks_without_a_card_each():
    """NCCL takes one rank a card: several processes on one named card, or
    more than the visible cards, are refused before anything is spawned."""
    for device in ("cuda:0", "cuda"):
        with pytest.raises(ValueError, match="one each"):
            launch(print, [], device, 4, nproc=2)
    with pytest.raises(ValueError, match="does not divide"):
        launch(print, [], "cpu", 4, nproc=3)
