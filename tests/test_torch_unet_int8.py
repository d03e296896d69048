"""The port's UNet with ``gn_conv="int8"`` against the JAX package's UNet under
``POLYFF_INT8_CONV=1`` (its Pallas kernel in interpret mode), fp32 on the CPU
with the same weights; and how ``SDFTask`` keeps the int8 weights current."""

import os

import numpy as np
import pytest
import torch

from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.tasks import SDFTask
from test_torch_unet_gn_conv import CFG, jax_unet_pair

# Port against JAX, both int8, same weights: their per-site arithmetic agrees
# (tests/test_torch_gn_conv.py), but the two frameworks sum the GroupNorm
# statistics and the convolutions in other orders, and a SiLU value an ulp
# apart that lies near a rounding boundary (x 127 / amax) moves its int8
# operand by one step; each such flip moves the next sites' statistics and
# quantization, so through 16 sites the two int8 UNets drift apart by a share
# of one quantization step. Read over seeds 0-2 (CPU): mean |port - JAX| /
# mean |JAX| 0.0012-0.0064 and max |port - JAX| 0.0056-0.030, against the int8
# route's own error of 0.021-0.026 (mean, relative) against the fused fp32 one.
# Limits: 3 x the worst reading of each.
INT8_REL_MEAN, INT8_MAX_ABS = 0.02, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_int8_unet_matches_jax(monkeypatch):
    want, tm, inputs = jax_unet_pair(monkeypatch, "int8", {"POLYFF_INT8_CONV": "1"}, seed=1)
    with torch.no_grad():
        got = tm(*inputs)
    err = np.abs(got.numpy() - want)
    assert err.mean() / np.abs(want).mean() < INT8_REL_MEAN, err.mean() / np.abs(want).mean()
    assert err.max() < INT8_MAX_ABS, err.max()


def test_int8_task_prepares_its_weights_and_refuses_stale_ones():
    task = SDFTask(Params(CFG), device="cpu", gn_conv="int8",
                   generator=torch.Generator().manual_seed(0))
    block = task.unet.input_blocks[1][0]
    x, t = torch.randn(2, 2, 16, 16), torch.tensor([3, 9])
    cond = -torch.ones(2, 1, CFG["d_cond"])
    with torch.no_grad():
        first = task.apply_eps(x, t, cond)
        # a new weight (as load_unet_state gives) is re-quantized by _place
        state = {k: v.clone() for k, v in task.unet.state_dict().items()}
        state["input_blocks.1.0.in_layers.2.weight"] *= 2
        task.load_unet_state(state)
        assert torch.equal(block._int8[0][1], torch.round(torch.clamp(
            block.in_layers[2].weight / block._int8[0][2][:, None, None, None], -127, 127)).to(
            torch.int8))
        assert not torch.equal(task.apply_eps(x, t, cond), first)
        # a weight replaced behind the task's back is refused, not used stale
        block.in_layers[2].weight.data = block.in_layers[2].weight.data.clone()
        with pytest.raises(RuntimeError, match="prepare_gn_conv"):
            task.apply_eps(x, t, cond)


def test_int8_is_refused_for_training():
    with pytest.raises(ValueError, match="sampling-only"):
        SDFTask(Params(CFG), device="cpu", gn_conv="int8", training=True)


def _song(path, seed):
    """A synthetic three-track 24-bar song (the idea of tests/synth.py)."""
    from polyffusion_tpu_torch.data import write_song_npz

    rng = np.random.default_rng(seed)
    n_beats, tracks = 96, []
    for t in range(3):
        n = int(rng.integers(40, 80))
        onsets = np.sort(rng.integers(0, n_beats * 4 - 8, n))
        tracks.append(np.stack([onsets, rng.integers(36 + 12 * t, 72 + 12 * t, n),
                                rng.integers(1, 8, n), rng.integers(60, 100, n),
                                np.zeros(n, np.int64)], 1))
    chord = np.zeros((n_beats, 14), np.int32)
    chord[:, 0] = rng.integers(0, 12, n_beats)
    chord[:, 1:13] = rng.integers(0, 2, (n_beats, 12))
    chord[:, 13] = chord[:, 0]
    db_pos = np.arange(0, n_beats * 4, 16)
    write_song_npz(path, tracks, chord, db_pos, db_pos + 128 <= n_beats * 4, n_beats=n_beats)


def test_clis_take_gn_conv(tmp_path):
    """The training CLI trains through the fused route and refuses int8; the
    inference CLI samples a tiny run directory with ``--gn_conv fused`` as it
    does unfused (fp32, within the DDIM tolerance), and with ``int8``."""
    from polyffusion_tpu_torch.inference import main as infer_main
    from polyffusion_tpu_torch.main import main as train_main
    from polyffusion_tpu_torch.models import ChordEncoder, init_weights_

    data, pre, run = tmp_path / "songs", tmp_path / "pre", str(tmp_path / "run")
    data.mkdir(), pre.mkdir()
    for i in range(3):
        _song(str(data / f"song{i}.npz"), i)
    enc = init_weights_(ChordEncoder(36, 16, 512), torch.Generator().manual_seed(3))
    torch.save({"model": {f"chord_enc.{k}": v for k, v in enc.state_dict().items()}},
               str(pre / "chd8bar.pt"))
    args = ["--model", "sdf_chd8bar", "--output_dir", run, "--data_dir", str(data),
            "--pretrained_dir", str(pre), "--device", "cpu", "--batch_size", "2", "--max_steps",
            "1", "--log_every", "1"]
    for kv in ("channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]",
               "n_res_blocks=1", "chd_hidden_dim=16", "bf16=false", "n_steps=10"):
        args += ["--set", kv]
    with pytest.raises(SystemExit):
        train_main(args + ["--gn_conv", "int8"])
    state = train_main(args + ["--gn_conv", "fused"])
    assert state.step == 1

    def sample(mode):
        out = tmp_path / mode
        (gen,) = infer_main(["--chkpt_path", run, "--data_dir", str(data), "--song_fn",
                             "song1.npz", "--pretrained_dir", str(pre), "--output_dir", str(out),
                             "--device", "cpu", "--uncond_scale", "5", "--ddim", "--ddim_steps",
                             "5", "--length", "1", "--gn_conv", mode])
        assert gen.shape == (1, 2, 128, 128) and np.isfinite(gen).all()
        assert len([f for f in os.listdir(out) if f.endswith(".mid")]) == 1
        return gen

    unfused, fused = sample("unfused"), sample("fused")
    np.testing.assert_allclose(fused, unfused, atol=2e-3, rtol=1e-3)
    sample("int8")
