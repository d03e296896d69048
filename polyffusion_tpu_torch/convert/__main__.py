"""Checkpoint conversion CLI: reference torch checkpoints -> .npz parameter
trees, and back (JAX ``convert/__main__.py``).

    python -m polyffusion_tpu_torch.convert --kind unet --input weights.pt --output unet.npz
    python -m polyffusion_tpu_torch.convert --kind polydis --input model_master_final.pt \\
        --output polydis.npz
    python -m polyffusion_tpu_torch.convert --kind txt_enc --init --seed 0 --output polydis.npz
    python -m polyffusion_tpu_torch.convert --kind unet --reverse --input <run dir or .npz> \\
        --output weights.pt

Kinds: unet (sdf eps-model from legacy .pt / lightning .ckpt), ddpm_unet,
chd8bar (chord enc+dec), txt_enc, pnotree_enc, pianotree_dec, polydis, autoencoder.

The .npz holds the JAX package's parameter tree flattened ("a/b/c" -> array),
the files its own converter writes; ``load_params_npz`` reads one back, and
the port's ``build_frozen_encoders`` reads ``chd8bar.npz``, ``polydis.npz``
and ``pnotree.npz``. ``--reverse`` writes a reference ``.pt`` (the UNet under
``ldm.eps_model.``) from a UNet tree or from a run directory of the port's
trainer; the port's inference CLI and the reference's both load it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import torch_import as T


def flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(tree, path):
    np.savez_compressed(path, **flatten_tree(tree))


def load_params_npz(path):
    with np.load(path) as f:
        return unflatten_tree({k: f[k] for k in f.files})


def convert(kind: str, input_path: str):
    """The JAX tree of ``kind`` from a reference checkpoint file."""
    sd = T.strip_dataparallel(T.torch_file_to_numpy(input_path))

    def strip_first(prefixes):
        for p in prefixes:
            hit = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
            if hit:
                return hit
        return sd

    if kind == "unet":
        return T.unet_params_from_torch(
            strip_first(("model.ldm.eps_model.", "ldm.eps_model.", "eps_model."))
        )
    if kind == "ddpm_unet":
        return T.ddpm_unet_params_from_torch(
            strip_first(("model.ddpm.eps_model.", "ddpm.eps_model.", "eps_model."))
        )
    if kind == "chd8bar":
        return {
            "chord_enc": T.chord_encoder_params_from_torch(T.split_by_prefix(sd, "chord_enc")),
            "chord_dec": T.chord_decoder_params_from_torch(T.split_by_prefix(sd, "chord_dec")),
        }
    if kind == "txt_enc":
        return T.texture_encoder_params_from_torch(T.split_by_prefix(sd, "rhy_encoder"))
    if kind == "pnotree_enc":
        return T.pianotree_encoder_params_from_torch(sd)
    if kind == "pianotree_dec":
        return T.pianotree_decoder_params_from_torch(sd)
    if kind == "polydis":
        return T.polydis_params_from_torch_file(input_path)
    if kind == "autoencoder":
        return T.autoencoder_params_from_torch(sd)
    raise ValueError(f"unknown kind: {kind}")


def _numpy_state(module: torch.nn.Module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def init_txt_enc(seed: int, emb_size=256, hidden_dim=1024, z_dim=256, num_channel=10):
    """A random ``TextureEncoder`` in polydis.npz layout: a frozen random
    texture encoder where the reference's pretrained PolyDis is not at hand
    (JAX ``init_txt_enc``). Its weights are torch's default init drawn from
    ``seed`` (``models.init_weights_``), so they differ from the JAX
    package's; the keys and shapes are the same."""
    from ..models import TextureEncoder, init_weights_

    enc = init_weights_(TextureEncoder(emb_size, hidden_dim, z_dim, num_channel),
                        torch.Generator().manual_seed(seed))
    return {"rhy_encoder": T.texture_encoder_params_from_torch(_numpy_state(enc))}


def init_pnotree_enc(seed: int):
    """A random ``PianoTreeEncoder`` in pnotree.npz layout (JAX
    ``init_pnotree_enc``; weights drawn as in ``init_txt_enc``)."""
    from ..models import PianoTreeEncoder, init_weights_

    enc = init_weights_(PianoTreeEncoder(), torch.Generator().manual_seed(seed))
    return T.pianotree_encoder_params_from_torch(_numpy_state(enc))


def unet_tree_of_run(run_dir: str, model=None):
    """The JAX ``UNetModel`` tree of a run directory of the port's trainer:
    its fp32 ``params``, loaded strictly into a UNet of the run's config
    (``params.yaml``, or the preset or yaml ``model`` where the directory
    has none)."""
    from ..config import load_params
    from ..inference import load_unet_params
    from ..tasks.sdf import make_unet

    cfg_path = os.path.join(run_dir, "params.yaml")
    if not os.path.exists(cfg_path) and model is None:
        raise SystemExit(f"{run_dir} has no params.yaml: pass --model")
    cfg = load_params(cfg_path if os.path.exists(cfg_path) else model)
    if not str(cfg.get("model_name", "")).startswith("sdf"):
        raise SystemExit(f"--reverse exports the sdf UNet; {run_dir} is a "
                         f"{cfg.get('model_name')!r} run")
    state = load_unet_params(run_dir)
    make_unet(cfg).load_state_dict(state, strict=True)
    return T.unet_params_from_torch({k: v.detach().numpy() for k, v in state.items()})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", required=True)
    p.add_argument("--input", default=None)
    p.add_argument("--output", required=True)
    p.add_argument(
        "--init",
        action="store_true",
        help="write RANDOM-INIT params instead of converting (kind=txt_enc or "
        "pnotree_enc): a frozen random encoder for environments without the "
        "reference's pretrained weights",
    )
    p.add_argument("--seed", type=int, default=0, help="--init generator seed")
    p.add_argument(
        "--reverse",
        action="store_true",
        help="export BACK to a reference torch checkpoint (kind=unet only): input is "
        "a params .npz or a run directory of the port's trainer (with --model when it "
        "has no params.yaml), output a legacy .pt the reference's inference_sdf.py "
        "and this port's inference CLI load directly",
    )
    p.add_argument("--model", default=None, help="params preset for --reverse run dirs")
    args = p.parse_args(argv)

    if args.init:
        if args.kind == "txt_enc":
            tree = init_txt_enc(args.seed)
            label = "texture"
        elif args.kind == "pnotree_enc":
            tree = init_pnotree_enc(args.seed)
            label = "pnotree"
        else:
            raise SystemExit("--init supports kind=txt_enc or pnotree_enc")
        save_params_npz(tree, args.output)
        print(f"wrote random-init (seed {args.seed}) {label} encoder -> {args.output}")
        return
    if args.input is None:
        p.error("--input is required unless --init")

    if args.reverse:
        if args.kind != "unet":
            raise SystemExit("--reverse currently supports kind=unet")
        from .torch_export import save_reference_checkpoint

        if os.path.isdir(args.input):
            params = unet_tree_of_run(args.input, args.model)
        else:
            params = load_params_npz(args.input)
        save_reference_checkpoint(params, args.output)
        print(f"exported reference checkpoint -> {args.output}")
        return

    tree = convert(args.kind, args.input)
    save_params_npz(tree, args.output)
    n = len(flatten_tree(tree))
    print(f"converted {args.kind}: {n} tensors -> {args.output}")


if __name__ == "__main__":
    main()
