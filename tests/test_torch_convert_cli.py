"""``python -m polyffusion_tpu_torch.convert`` against the JAX package's
converter CLI (``polyffusion_tpu/convert/__main__.py``): for each of the 8
kinds, a reference-layout ``.pt`` written from seeded port modules (which
carry the reference's names) becomes the same ``.npz``, array for array;
``--reverse`` writes the tensors of JAX's ``save_reference_checkpoint`` from a
UNet ``.npz`` and from a run directory of the port's trainer; ``--init``
writes the keys and shapes of JAX's ``--init`` (its ``init_txt_enc`` and
``init_pnotree_enc``), the same per seed, and the port's
``build_frozen_encoders`` loads them."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.convert.__main__ import flatten_tree as jax_flatten_tree
from polyffusion_tpu.convert.__main__ import init_pnotree_enc as jax_init_pnotree_enc
from polyffusion_tpu.convert.__main__ import init_txt_enc as jax_init_txt_enc
from polyffusion_tpu.convert.__main__ import main as jax_convert_main
from polyffusion_tpu.convert.torch_export import (
    save_reference_checkpoint as jax_save_reference_checkpoint,
)
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert.__main__ import (
    flatten_tree,
    init_pnotree_enc,
    init_txt_enc,
    load_params_npz,
    save_params_npz,
    unflatten_tree,
)
from polyffusion_tpu_torch.convert.__main__ import main as convert_main
from polyffusion_tpu_torch.convert.torch_import import unet_params_from_torch
from polyffusion_tpu_torch.models import (
    ChordDecoder,
    ChordEncoder,
    PianoTreeDecoder,
    PianoTreeEncoder,
    TextureEncoder,
    UNetModel,
)
from polyffusion_tpu_torch.models.autoencoder import Autoencoder
from polyffusion_tpu_torch.models.ddpm_unet import DDPMUNet
from polyffusion_tpu_torch.models.encoders import build_frozen_encoders
from polyffusion_tpu_torch.models.unet import init_vae_weights_

# the UNet of tests/test_torch_legacy_checkpoint.py: every block kind
UNET = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1, attention_levels=(1,),
            channel_multipliers=(1, 2), n_heads=2, tf_layers=1, d_cond=24)


def _seeded(module, seed):
    return init_vae_weights_(module, torch.Generator().manual_seed(seed))


def _prefixed(prefix, module):
    return {f"{prefix}{k}": v for k, v in module.state_dict().items()}


def _tiny_pianotree_decoder():
    return PianoTreeDecoder(note_emb_size=16, z_size=16, dec_emb_hid_size=16,
                            dec_time_hid_size=32, dec_notes_hid_size=16, dec_z_in_size=16,
                            dec_dur_hid_size=8)


def _reference_checkpoint(kind, seed):
    """A reference-layout checkpoint of ``kind``: what the reference's
    learner, Lightning or DataParallel saves, from the port's modules."""
    if kind == "unet":
        return {"model": _prefixed("ldm.eps_model.", _seeded(UNetModel(**UNET), seed))}
    if kind == "ddpm_unet":
        unet = DDPMUNet(n_channels=32, ch_mults=(1, 2), is_attn=(False, True), n_blocks=1)
        return {"state_dict": _prefixed("model.ddpm.eps_model.", _seeded(unet, seed))}
    if kind == "chd8bar":
        return {"model": {**_prefixed("chord_enc.", _seeded(ChordEncoder(36, 16, 8), seed)),
                          **_prefixed("chord_dec.", _seeded(ChordDecoder(36, 8, 16, 8), seed + 1))}}
    if kind == "txt_enc":
        return {"model": _prefixed("rhy_encoder.", _seeded(TextureEncoder(16, 16, 8), seed))}
    if kind == "pnotree_enc":  # a whole PianoTree VAE: the converter takes the encoder's keys
        return {**_seeded(PianoTreeEncoder(16, 16, 16, 8), seed).state_dict(),
                **_seeded(_tiny_pianotree_decoder(), seed + 1).state_dict()}
    if kind == "pianotree_dec":
        return _seeded(_tiny_pianotree_decoder(), seed).state_dict()
    if kind == "polydis":  # DataParallel's module. prefixes, as model_master_final.pt
        return {**_prefixed("module.chd_encoder.", _seeded(ChordEncoder(36, 16, 8), seed)),
                **_prefixed("module.rhy_encoder.", _seeded(TextureEncoder(16, 16, 8), seed + 1)),
                **_prefixed("module.decoder.", _seeded(_tiny_pianotree_decoder(), seed + 2)),
                **_prefixed("module.chd_decoder.", _seeded(ChordDecoder(36, 8, 16, 8), seed + 3))}
    if kind == "autoencoder":
        ae = Autoencoder(channels=32, channel_multipliers=(1, 2), n_resnet_blocks=1,
                         in_channels=2, out_channels=2)
        return _seeded(ae, seed).state_dict()
    raise KeyError(kind)


KINDS = ["unet", "ddpm_unet", "chd8bar", "txt_enc", "pnotree_enc", "pianotree_dec", "polydis",
         "autoencoder"]


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_same_npz(got_path, want_path):
    got, want = _npz(got_path), _npz(want_path)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_cli_npz_equals_jax(kind, tmp_path, capsys):
    src = str(tmp_path / f"{kind}.pt")
    torch.save(_reference_checkpoint(kind, seed=KINDS.index(kind)), src)
    jax_convert_main(["--kind", kind, "--input", src, "--output", str(tmp_path / "jax.npz")])
    convert_main(["--kind", kind, "--input", src, "--output", str(tmp_path / "port.npz")])
    out = capsys.readouterr().out.splitlines()
    assert out[1].replace("port.npz", "jax.npz") == out[0]  # "converted <kind>: N tensors"
    _assert_same_npz(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))


def test_npz_tree_round_trip(tmp_path):
    tree = {"a": {"b": np.arange(3.0), "c": {"d": np.ones((2, 2), np.float32)}}, "e": np.int32(4)}
    assert list(flatten_tree(tree)) == ["a/b", "a/c/d", "e"]
    save_params_npz(tree, str(tmp_path / "t.npz"))
    back = load_params_npz(str(tmp_path / "t.npz"))
    assert list(flatten_tree(back)) == list(flatten_tree(tree))
    assert all(np.array_equal(flatten_tree(back)[k], v) for k, v in flatten_tree(tree).items())
    assert unflatten_tree(flatten_tree(tree)).keys() == tree.keys()


# -- --reverse -----------------------------------------------------------------------------

def _load_model(path):
    return torch.load(path, weights_only=True)["model"]


def _assert_same_model(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_reverse_from_npz_equals_jax(tmp_path):
    src = str(tmp_path / "unet.pt")
    torch.save(_reference_checkpoint("unet", seed=11), src)
    npz = str(tmp_path / "unet.npz")
    convert_main(["--kind", "unet", "--input", src, "--output", npz])
    convert_main(["--kind", "unet", "--reverse", "--input", npz, "--output",
                  str(tmp_path / "port.pt")])
    jax_save_reference_checkpoint(load_params_npz(npz), str(tmp_path / "jax.pt"))
    got = _load_model(str(tmp_path / "port.pt"))
    _assert_same_model(got, _load_model(str(tmp_path / "jax.pt")))
    # and back to the weights it came from
    _assert_same_model(got, torch.load(src, weights_only=True)["model"])


RUN_CFG = dict(model_name="sdf_tiny", in_channels=2, out_channels=2, channels=32,
               n_res_blocks=1, attention_levels=[1], channel_multipliers=[1, 2], n_heads=2,
               tf_layers=1, d_cond=24)


def _port_run_dir(path, seed, with_params=True):
    """A run directory as the port's trainer leaves it: ``params.yaml`` and
    ``chkpts/last.pt`` with the fp32 weights under ``params``."""
    unet = _seeded(UNetModel(**UNET), seed)
    os.makedirs(os.path.join(path, "chkpts"))
    torch.save({"step": 3, "params": unet.state_dict(), "opt_state": {}, "ema": None,
                "val_loss": 1.0}, os.path.join(path, "chkpts", "last.pt"))
    if with_params:
        with open(os.path.join(path, "params.yaml"), "w") as f:
            yaml.safe_dump(RUN_CFG, f)
    return unet.state_dict()


@pytest.mark.parametrize("with_params", [True, False])
def test_reverse_from_run_dir_equals_jax(tmp_path, with_params):
    """From the run's ``params.yaml``, or, without one, from ``--model``."""
    run = str(tmp_path / "run")
    state = _port_run_dir(run, seed=12, with_params=with_params)
    args = ["--kind", "unet", "--reverse", "--input", run, "--output", str(tmp_path / "port.pt")]
    if not with_params:
        with pytest.raises(SystemExit, match="--model"):
            convert_main(args)
        model = tmp_path / "tiny.yaml"
        model.write_text(yaml.safe_dump(RUN_CFG))
        args += ["--model", str(model)]
    convert_main(args)
    tree = unet_params_from_torch({k: v.numpy() for k, v in state.items()})
    jax_save_reference_checkpoint(tree, str(tmp_path / "jax.pt"))
    _assert_same_model(_load_model(str(tmp_path / "port.pt")),
                       _load_model(str(tmp_path / "jax.pt")))


def test_reverse_refuses_what_is_not_an_sdf_unet(tmp_path):
    run = str(tmp_path / "run")
    _port_run_dir(run, seed=13)
    with open(os.path.join(run, "params.yaml"), "w") as f:
        yaml.safe_dump({**RUN_CFG, "channels": 64}, f)  # weights of another width
    with pytest.raises(RuntimeError, match="size mismatch"):
        convert_main(["--kind", "unet", "--reverse", "--input", run, "--output",
                      str(tmp_path / "x.pt")])
    with open(os.path.join(run, "params.yaml"), "w") as f:
        yaml.safe_dump({"model_name": "chd_8bar"}, f)
    with pytest.raises(SystemExit, match="chd_8bar"):
        convert_main(["--kind", "unet", "--reverse", "--input", run, "--output",
                      str(tmp_path / "x.pt")])
    with pytest.raises(SystemExit, match="kind=unet"):
        convert_main(["--kind", "ddpm_unet", "--reverse", "--input", run, "--output",
                      str(tmp_path / "x.pt")])


# -- --init ----------------------------------------------------------------------------------

def _shapes(path):
    return {k: v.shape for k, v in _npz(path).items()}


@pytest.fixture(scope="module")
def jax_init():
    """The shapes JAX's ``--init`` writes, by kind (its functions, without the
    compressed file)."""
    return {kind: {k: v.shape for k, v in jax_flatten_tree(fn(0)).items()}
            for kind, fn in (("txt_enc", jax_init_txt_enc), ("pnotree_enc", jax_init_pnotree_enc))}


@pytest.mark.parametrize("kind, base, preset, init", [
    ("txt_enc", "polydis", "sdf_txt", init_txt_enc),
    ("pnotree_enc", "pnotree", "sdf_pnotree", init_pnotree_enc)])
def test_init_matches_jax_layout_and_loads(kind, base, preset, init, jax_init, tmp_path):
    pre = tmp_path / "pre"
    pre.mkdir()
    path = str(pre / f"{base}.npz")
    convert_main(["--kind", kind, "--init", "--seed", "0", "--output", path])
    got = _npz(path)
    assert {k: v.shape for k, v in got.items()} == jax_init[kind]
    again, other = flatten_tree(init(0)), flatten_tree(init(1))
    assert all(np.array_equal(got[k], again[k]) for k in got)  # the same per seed
    assert not any(np.array_equal(got[k], other[k]) for k in got if got[k].size > 1)
    (module,) = build_frozen_encoders(Params(load_params(preset)), str(pre)).values()
    tree = unflatten_tree(got)
    tree = tree.get("rhy_encoder", tree)
    w = tree["linear_mu"]["kernel"]
    assert torch.equal(module.state_dict()["linear_mu.weight"],
                       torch.from_numpy(np.ascontiguousarray(w.T)))


def test_init_refuses_other_kinds(tmp_path):
    with pytest.raises(SystemExit, match="txt_enc or pnotree_enc"):
        convert_main(["--kind", "unet", "--init", "--output", str(tmp_path / "x.npz")])


def test_cli_unet_npz_loads_into_the_jax_task(tmp_path):
    """The ``unet`` kind's ``.npz`` is the JAX ``UNetModel``'s tree: its keys
    and shapes are those of JAX's own init of the same config."""
    src = str(tmp_path / "unet.pt")
    torch.save(_reference_checkpoint("unet", seed=14), src)
    convert_main(["--kind", "unet", "--input", src, "--output", str(tmp_path / "u.npz")])
    cfg = JaxParams(model_name="sdf_tiny", n_steps=10, linear_start=0.00085, linear_end=0.012,
                    img_h=16, img_w=16, cond_type="chord", cond_mode="cond", use_enc=False,
                    bf16=False, **{k: list(v) if isinstance(v, tuple) else v
                                   for k, v in UNET.items()})
    want = jax.eval_shape(JaxSDFTask(cfg).init_params, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), want)).items()}
    assert _shapes(str(tmp_path / "u.npz")) == want
