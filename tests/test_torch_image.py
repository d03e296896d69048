"""Piano-roll PNGs (``polyffusion_tpu_torch/utils/image.py``) and the inference
CLI's ``--dump_images`` and ``--bf16_params``, on the CPU against the JAX
package and matplotlib."""

import os

import jax
import matplotlib
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu.utils.image import prmat2c_to_rgb as jax_prmat2c_to_rgb
from polyffusion_tpu.utils.image import show_image as jax_show_image
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.data import SongNpz, write_song_npz
from polyffusion_tpu_torch.diffusion.gaussian import q_sample_step
from polyffusion_tpu_torch.diffusion.schedule import make_schedule
from polyffusion_tpu_torch.inference import build_task_for_inference, main
from polyffusion_tpu_torch.models.unet import GroupNorm32
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.utils.image import png_bytes, prmat2c_to_rgb, show_image

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# the raw chord one-hots (no encoder file), attention at level 1
TINY = dict(
    model_name="sdf_img", batch_size=2, max_epoch=1, learning_rate=1e-4, max_grad_norm=10,
    bf16=False, in_channels=2, out_channels=2, channels=32, attention_levels=[1],
    n_res_blocks=1, channel_multipliers=[1, 2], n_heads=2, tf_layers=1, d_cond=32 * 36,
    linear_start=0.00085, linear_end=0.012, n_steps=20, img_h=128, img_w=128,
    cond_type="chord", cond_mode="mix", use_enc=False,
)
# bf16 weights and activations against fp32: the bound of
# tests/test_torch_unet.py::test_sampling_precision_policy, max |got - want|
# < BF16_REL max |want| + BF16_ATOL
BF16_REL, BF16_ATOL = 0.1, 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoded(path):
    return np.asarray(Image.open(path))


def _rolls(rng, *shape):
    return (rng.random(shape) * 1.3 - 0.15).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 2, 128, 128), (3, 2, 32, 128), (2, 64, 128)])
def test_rgb_matches_jax(shape):
    img = _rolls(np.random.default_rng(0), *shape)
    got, want = prmat2c_to_rgb(img), jax_prmat2c_to_rgb(img)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask", [False, True])
def test_png_decodes_as_matplotlibs(tmp_path, mask):
    """The stdlib PNG against matplotlib's imsave of the same array: the
    same 8-bit RGBA pixels; and against JAX's show_image (matplotlib here)."""
    img = _rolls(np.random.default_rng(1), 2, 2, 32, 128)
    rgb = prmat2c_to_rgb(img)
    if mask:
        rgb = np.concatenate([rgb, rgb[:, :, :1]], axis=2)
    plt.imsave(tmp_path / "mpl.png", rgb)
    show_image(img, str(tmp_path / "port.png"), mask=mask)
    jax_show_image(img, str(tmp_path / "jax.png"), mask=mask)
    got = _decoded(tmp_path / "port.png")
    assert got.shape == (128, 64, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _decoded(tmp_path / "mpl.png"))
    np.testing.assert_array_equal(got, _decoded(tmp_path / "jax.png"))
    want = np.full(got.shape, 255, np.uint8)
    want[:, :, : rgb.shape[2]] = (rgb * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_png_refuses_what_it_cannot_write():
    with pytest.raises(ValueError):
        png_bytes(np.zeros((4, 4, 2)))
    with pytest.raises(ValueError):
        png_bytes(np.full((4, 4, 3), 1.5))
    assert png_bytes(np.zeros((1, 1, 3)))[:8] == b"\x89PNG\r\n\x1a\n"


# -- the inference CLI -------------------------------------------------------------------


def _write_song(path, seed, n_bars=16):
    rng = np.random.default_rng(seed)
    n_beats, n_bins = n_bars * 4, n_bars * 16
    tracks = []
    for t in range(3):
        n = rng.integers(30, 60)
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
def pair():
    jtask = JaxSDFTask(JaxParams(TINY))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    return jtask, params


@pytest.fixture(scope="module")
def work(pair, tmp_path_factory):
    """A song, a tiny preset yaml and a reference-layout UNet checkpoint."""
    root = tmp_path_factory.mktemp("image_cli")
    (root / "songs").mkdir()
    _write_song(str(root / "songs" / "song0.npz"), seed=0)
    with open(root / "tiny.yaml", "w") as f:
        yaml.safe_dump(dict(TINY), f)
    state = unet_state_from_jax(pair[1])
    torch.save({"model": {f"eps_model.{k}": torch.as_tensor(v) for k, v in state.items()}},
               root / "tiny.pt")
    return root


def _cli(work, out, *extra):
    return main(["--model", str(work / "tiny.yaml"), "--chkpt_path", str(work / "tiny.pt"),
                 "--data_dir", str(work / "songs"), "--song_fn", "song0.npz", "--device", "cpu",
                 "--ddim", "--ddim_steps", "2", "--length", "1", "--output_dir", str(out),
                 *extra])


def test_dump_images_writes_the_noising_sequence(work, tmp_path):
    """q0.png and q{step+1}.png every n_steps // 10 steps (JAX's names and
    count), each the song's first segment noised with a CPU generator seeded
    by --seed; q0 decodes as JAX's show_image of the same segment."""
    _cli(work, tmp_path, "--dump_images", "--seed", "3")
    img_dir = tmp_path / "img"
    n_steps = TINY["n_steps"]
    steps = list(range(0, n_steps, max(n_steps // 10, 1)))
    names = ["q0.png"] + [f"q{s + 1}.png" for s in steps]
    assert len(names) == 11 and sorted(os.listdir(img_dir)) == sorted(names)
    first = SongNpz("song0.npz", str(work / "songs")).get_whole_song_data()[0][:1]
    jax_show_image(first, str(tmp_path / "jax_q0.png"))
    np.testing.assert_array_equal(_decoded(img_dir / "q0.png"), _decoded(tmp_path / "jax_q0.png"))
    schedule = make_schedule(n_steps, TINY["linear_start"], TINY["linear_end"])
    src = torch.from_numpy(first).permute(0, 2, 3, 1)
    g = torch.Generator().manual_seed(3)
    for s in steps:
        noised = q_sample_step(schedule, src, s, torch.randn(src.shape, generator=g))
        show_image(noised.permute(0, 3, 1, 2).numpy(), str(tmp_path / "want.png"))
        got = _decoded(img_dir / f"q{s + 1}.png")
        assert os.path.getsize(img_dir / f"q{s + 1}.png") > 0 and got.shape == (128, 128, 4)
        np.testing.assert_array_equal(got, _decoded(tmp_path / "want.png"))
    assert any(f.endswith(".mid") for f in os.listdir(tmp_path))


def test_ddpm_family_refuses_the_new_flags(tmp_path):
    for flag in ("--dump_images", "--bf16_params"):
        with pytest.raises(SystemExit, match=flag):
            main(["--model", "ddpm", "--chkpt_path", str(tmp_path / "none.pt"), "--device",
                  "cpu", "--output_dir", str(tmp_path), flag])


def test_bf16_params_eps_matches_jax(pair):
    """JAX's InferenceSession(bf16_params=True) and the port's
    build_task_for_inference(bf16_params=True) on the same fp32 preset, at the
    port's bf16 sampling bound; the port's weights are bf16 but its norms."""
    jtask, params = pair
    jparams = JaxSession(jtask, params, bf16_params=True).params
    task = build_task_for_inference(Params(TINY), device="cpu", bf16_params=True)
    task.load_unet_state(unet_state_from_jax(params))
    for mod in task.unet.modules():
        norm = isinstance(mod, (GroupNorm32, torch.nn.LayerNorm))
        for p in mod.parameters(recurse=False):
            assert p.dtype == (torch.float32 if norm else torch.bfloat16)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2, 128, 128)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    cond = rng.standard_normal((2, 1, 32 * 36)).astype(np.float32)
    want = np.asarray(jax.jit(jtask.apply_eps)(jparams, x.transpose(0, 2, 3, 1), t, cond),
                      np.float32).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = task.apply_eps(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    assert got.dtype == torch.float32
    err, bound = np.abs(got.numpy() - want).max(), BF16_REL * np.abs(want).max() + BF16_ATOL
    assert err < bound, f"max |err| {err} beyond the bf16 bound {bound}"
    fp32 = build_task_for_inference(Params(TINY), device="cpu")
    assert {p.dtype for p in fp32.unet.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="sampling-only"):
        SDFTask(Params(TINY), device="cpu", training=True, bf16_params=True)


def test_cli_takes_bf16_params(work, tmp_path, monkeypatch):
    import polyffusion_tpu_torch.inference as inf

    built = []
    real = inf.build_task_for_inference

    def record(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(inf, "build_task_for_inference", record)
    (gen,) = _cli(work, tmp_path, "--bf16_params")
    assert gen.shape == (1, 2, 128, 128) and np.isfinite(gen).all()
    assert torch.bfloat16 in {p.dtype for p in built[0].unet.parameters()}
    assert any(f.endswith(".mid") for f in os.listdir(tmp_path))
