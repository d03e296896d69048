"""Reference PyTorch checkpoints -> the JAX package's parameter trees, as NumPy
(the port's own copy of ``polyffusion_tpu/convert/torch_import.py``).

The trees are what the JAX package's converter CLI writes into its ``.npz``
files (``a/b/c`` keys), so ``python -m polyffusion_tpu_torch.convert`` writes
the same files. The converters take plain NumPy state dicts (key -> array):

    torch Linear (out, in)        -> flax Dense kernel (in, out)
    torch Conv2d (O, I, kH, kW)   -> flax Conv kernel (kH, kW, I, O)
    torch GroupNorm/LayerNorm     -> scale/bias
    torch GRU (3H, in) gate order r,z,n -> per-layer wi (in, 3H), wh (H, 3H), bi, bh
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

Array = np.ndarray
StateDict = Mapping[str, Array]


def _set(tree: Dict, path, value: Array) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _linear(tree, path, sd, tk) -> None:
    _set(tree, path + ("kernel",), np.ascontiguousarray(sd[tk + ".weight"].T))
    if tk + ".bias" in sd:
        _set(tree, path + ("bias",), sd[tk + ".bias"])


def _conv(tree, path, sd, tk) -> None:
    _set(
        tree,
        path + ("kernel",),
        np.ascontiguousarray(np.transpose(sd[tk + ".weight"], (2, 3, 1, 0))),
    )
    _set(tree, path + ("bias",), sd[tk + ".bias"])


def _norm(tree, path, sd, tk, wrapped: bool = False) -> None:
    # ``wrapped`` is retained for call-site clarity: GroupNorms (wrapped=True) and
    # LayerNorms both map to direct scale/bias params in the JAX modules.
    del wrapped
    _set(tree, path + ("scale",), sd[tk + ".weight"])
    _set(tree, path + ("bias",), sd[tk + ".bias"])


# ---------------------------------------------------------------------------
# UNetModel
# ---------------------------------------------------------------------------


def _convert_resblock(tree, prefix, sd, tk) -> None:
    _norm(tree, (prefix, "in_norm"), sd, tk + ".in_layers.0", wrapped=True)
    _conv(tree, (prefix, "in_conv"), sd, tk + ".in_layers.2")
    _linear(tree, (prefix, "emb_proj"), sd, tk + ".emb_layers.1")
    _norm(tree, (prefix, "out_norm"), sd, tk + ".out_layers.0", wrapped=True)
    _conv(tree, (prefix, "out_conv"), sd, tk + ".out_layers.3")
    if tk + ".skip_connection.weight" in sd:
        _conv(tree, (prefix, "skip"), sd, tk + ".skip_connection")


def _convert_spatial_transformer(tree, prefix, sd, tk) -> None:
    _norm(tree, (prefix, "norm"), sd, tk + ".norm", wrapped=True)
    _conv(tree, (prefix, "proj_in"), sd, tk + ".proj_in")
    _conv(tree, (prefix, "proj_out"), sd, tk + ".proj_out")
    k = 0
    while f"{tk}.transformer_blocks.{k}.norm1.weight" in sd:
        bt = f"{tk}.transformer_blocks.{k}"
        bp = (prefix, f"block_{k}")
        for n in ("norm1", "norm2", "norm3"):
            _norm(tree, bp + (n,), sd, f"{bt}.{n}")
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear(tree, bp + (attn, proj), sd, f"{bt}.{attn}.{proj}")
            _linear(tree, bp + (attn, "to_out"), sd, f"{bt}.{attn}.to_out.0")
        _linear(tree, bp + ("ff", "geglu_proj"), sd, f"{bt}.ff.net.0.proj")
        _linear(tree, bp + ("ff", "proj_out"), sd, f"{bt}.ff.net.2")
        k += 1


def unet_params_from_torch(sd: StateDict) -> Dict:
    """Reference ``UNetModel`` state dict -> flax params for ``models.unet.UNetModel``."""
    tree: Dict = {}
    _linear(tree, ("time_embed_0",), sd, "time_embed.0")
    _linear(tree, ("time_embed_2",), sd, "time_embed.2")
    _conv(tree, ("input_blocks_0_0",), sd, "input_blocks.0.0")

    # remaining input/output blocks: classify by key signature
    seen = set()
    for key in sd:
        parts = key.split(".")
        if (parts[0] in ("input_blocks", "output_blocks")
                and (parts[0], parts[1], parts[2]) not in seen):
            if parts[0] == "input_blocks" and parts[1] == "0":
                continue
            seen.add((parts[0], parts[1], parts[2]))
            tk = ".".join(parts[:3])
            prefix = f"{parts[0]}_{parts[1]}_{parts[2]}"
            if f"{tk}.in_layers.0.weight" in sd:
                _convert_resblock(tree, prefix, sd, tk)
            elif f"{tk}.norm.weight" in sd:
                _convert_spatial_transformer(tree, prefix, sd, tk)
            elif f"{tk}.op.weight" in sd:  # DownSample
                _conv(tree, (prefix, "conv"), sd, tk + ".op")
            elif f"{tk}.conv.weight" in sd:  # UpSample
                _conv(tree, (prefix, "conv"), sd, tk + ".conv")
            else:
                raise KeyError(f"unrecognized block at {tk}")

    _convert_resblock(tree, "middle_block_0", sd, "middle_block.0")
    _convert_spatial_transformer(tree, "middle_block_1", sd, "middle_block.1")
    _convert_resblock(tree, "middle_block_2", sd, "middle_block.2")

    _norm(tree, ("out_norm",), sd, "out.0", wrapped=True)
    _conv(tree, ("out_conv",), sd, "out.2")
    return tree


def _conv_transpose(tree, path, sd, tk) -> None:
    # torch ConvTranspose2d weight (in, out, kH, kW) -> flax ConvTranspose
    # (transpose_kernel=True) kernel (kH, kW, out, in)
    _set(
        tree,
        path + ("kernel",),
        np.ascontiguousarray(np.transpose(sd[tk + ".weight"], (2, 3, 1, 0))),
    )
    _set(tree, path + ("bias",), sd[tk + ".bias"])


def ddpm_unet_params_from_torch(sd: StateDict) -> Dict:
    """Reference plain ``ddpm.unet.UNet`` state dict -> flax ``DDPMUNet`` params."""
    tree: Dict = {}
    _conv(tree, ("image_proj",), sd, "image_proj")
    _linear(tree, ("time_emb", "lin1"), sd, "time_emb.lin1")
    _linear(tree, ("time_emb", "lin2"), sd, "time_emb.lin2")

    def res_block(prefix, tk):
        _norm(tree, (prefix, "norm1"), sd, tk + ".norm1", wrapped=True)
        _conv(tree, (prefix, "conv1"), sd, tk + ".conv1")
        _norm(tree, (prefix, "norm2"), sd, tk + ".norm2", wrapped=True)
        _conv(tree, (prefix, "conv2"), sd, tk + ".conv2")
        _linear(tree, (prefix, "time_emb"), sd, tk + ".time_emb")
        if tk + ".shortcut.weight" in sd:
            _conv(tree, (prefix, "shortcut"), sd, tk + ".shortcut")

    def attn_block(prefix, tk):
        # NOTE: tk+".norm" exists in the torch state dict but is never applied in
        # the reference forward (ddpm/unet.py:180-214) — intentionally dropped.
        _linear(tree, (prefix, "projection"), sd, tk + ".projection")
        _linear(tree, (prefix, "output"), sd, tk + ".output")

    for side in ("down", "up"):
        k = 0
        while True:
            tk = f"{side}.{k}"
            if f"{tk}.res.norm1.weight" in sd:
                res_block(f"{side}_{k}_res", tk + ".res")
                if f"{tk}.attn.projection.weight" in sd:
                    attn_block(f"{side}_{k}_attn", tk + ".attn")
            elif f"{tk}.conv.weight" in sd:
                if side == "down":
                    _conv(tree, (f"down_{k}_ds", "conv"), sd, tk + ".conv")
                else:
                    _conv_transpose(tree, (f"up_{k}_us", "conv"), sd, tk + ".conv")
            else:
                break
            k += 1

    res_block("middle_res1", "middle.res1")
    attn_block("middle_attn", "middle.attn")
    res_block("middle_res2", "middle.res2")
    _norm(tree, ("norm",), sd, "norm", wrapped=True)
    _conv(tree, ("final",), sd, "final")
    return tree


def _ae_resblock(tree, prefix, sd, tk):
    _norm(tree, (prefix, "norm1"), sd, tk + ".norm1", wrapped=True)
    _conv(tree, (prefix, "conv1"), sd, tk + ".conv1")
    _norm(tree, (prefix, "norm2"), sd, tk + ".norm2", wrapped=True)
    _conv(tree, (prefix, "conv2"), sd, tk + ".conv2")
    if tk + ".nin_shortcut.weight" in sd:
        _conv(tree, (prefix, "nin_shortcut"), sd, tk + ".nin_shortcut")


def _ae_attnblock(tree, prefix, sd, tk):
    _norm(tree, (prefix, "norm"), sd, tk + ".norm", wrapped=True)
    for name in ("q", "k", "v", "proj_out"):
        _conv(tree, (prefix, name), sd, f"{tk}.{name}")


def autoencoder_encoder_params_from_torch(sd: StateDict) -> Dict:
    """Reference KL-autoencoder ``Encoder`` -> flax params (autoencoder.py:112-204)."""
    tree: Dict = {}
    _conv(tree, ("conv_in",), sd, "conv_in")
    i = 0
    while f"down.{i}.block.0.norm1.weight" in sd:
        j = 0
        while f"down.{i}.block.{j}.norm1.weight" in sd:
            _ae_resblock(tree, f"down_{i}_block_{j}", sd, f"down.{i}.block.{j}")
            j += 1
        if f"down.{i}.downsample.conv.weight" in sd:
            _conv(tree, (f"down_{i}_downsample",), sd, f"down.{i}.downsample.conv")
        i += 1
    _ae_resblock(tree, "mid_block_1", sd, "mid.block_1")
    _ae_attnblock(tree, "mid_attn_1", sd, "mid.attn_1")
    _ae_resblock(tree, "mid_block_2", sd, "mid.block_2")
    _norm(tree, ("norm_out",), sd, "norm_out", wrapped=True)
    _conv(tree, ("conv_out",), sd, "conv_out")
    return tree


def autoencoder_decoder_params_from_torch(sd: StateDict) -> Dict:
    """Reference KL-autoencoder ``Decoder`` -> flax params (autoencoder.py:207-302)."""
    tree: Dict = {}
    _conv(tree, ("conv_in",), sd, "conv_in")
    _ae_resblock(tree, "mid_block_1", sd, "mid.block_1")
    _ae_attnblock(tree, "mid_attn_1", sd, "mid.attn_1")
    _ae_resblock(tree, "mid_block_2", sd, "mid.block_2")
    i = 0
    while f"up.{i}.block.0.norm1.weight" in sd:
        j = 0
        while f"up.{i}.block.{j}.norm1.weight" in sd:
            _ae_resblock(tree, f"up_{i}_block_{j}", sd, f"up.{i}.block.{j}")
            j += 1
        if f"up.{i}.upsample.conv.weight" in sd:
            _conv(tree, (f"up_{i}_upsample",), sd, f"up.{i}.upsample.conv")
        i += 1
    _norm(tree, ("norm_out",), sd, "norm_out", wrapped=True)
    _conv(tree, ("conv_out",), sd, "conv_out")
    return tree


def autoencoder_params_from_torch(sd: StateDict) -> Dict:
    """Full reference ``Autoencoder`` (encoder/decoder/quant convs)."""
    tree: Dict = {
        "encoder": autoencoder_encoder_params_from_torch(split_by_prefix(sd, "encoder")),
        "decoder": autoencoder_decoder_params_from_torch(split_by_prefix(sd, "decoder")),
    }
    _conv(tree, ("quant_conv",), sd, "quant_conv")
    _conv(tree, ("post_quant_conv",), sd, "post_quant_conv")
    return tree


# ---------------------------------------------------------------------------
# GRU-based conditioning encoders/decoders
# ---------------------------------------------------------------------------


def gru_params_from_torch(sd: StateDict, tk: str, reverse: bool = False) -> Dict:
    """torch nn.GRU layer-0 weights -> the JAX ``models.gru.GRUCellParams`` layout.

    torch packs gates as rows [r | z | n] in ``weight_ih_l0`` (3H, in) and
    ``weight_hh_l0`` (3H, H).  The JAX GRU keeps the same packing but column-major
    kernels: ``wi`` (in, 3H), ``wh`` (H, 3H), plus separate input/hidden biases
    (torch applies bias_hh inside the reset gate product, which the JAX GRU replicates).
    """
    sfx = "_reverse" if reverse else ""
    return {
        "wi": np.ascontiguousarray(sd[f"{tk}.weight_ih_l0{sfx}"].T),
        "wh": np.ascontiguousarray(sd[f"{tk}.weight_hh_l0{sfx}"].T),
        "bi": sd[f"{tk}.bias_ih_l0{sfx}"],
        "bh": sd[f"{tk}.bias_hh_l0{sfx}"],
    }


def bigru_params_from_torch(sd: StateDict, tk: str) -> Dict:
    return {
        "fwd": gru_params_from_torch(sd, tk, reverse=False),
        "bwd": gru_params_from_torch(sd, tk, reverse=True),
    }


def chord_encoder_params_from_torch(sd: StateDict) -> Dict:
    """Reference ``RnnEncoder`` (dl_modules/chord_enc.py:5-22) -> flax params."""
    tree: Dict = {"gru": bigru_params_from_torch(sd, "gru")}
    _linear(tree, ("linear_mu",), sd, "linear_mu")
    _linear(tree, ("linear_var",), sd, "linear_var")
    return tree


def chord_decoder_params_from_torch(sd: StateDict) -> Dict:
    """Reference ``ChordDecoder`` (dl_modules/chord_dec.py:7-85) -> flax params."""
    tree: Dict = {"gru": gru_params_from_torch(sd, "gru")}
    for name in ("z2dec_hid", "z2dec_in", "root_out", "chroma_out", "bass_out"):
        _linear(tree, (name,), sd, name)
    tree["init_input"] = sd["init_input"]
    return tree


def texture_encoder_params_from_torch(sd: StateDict) -> Dict:
    """Reference ``TextureEncoder`` (dl_modules/txt_enc.py:5-35) -> flax params."""
    tree: Dict = {"gru": bigru_params_from_torch(sd, "gru")}
    _conv(tree, ("cnn",), sd, "cnn.0")
    for name in ("fc1", "fc2", "linear_mu", "linear_var"):
        _linear(tree, (name,), sd, name)
    return tree


def pianotree_decoder_params_from_torch(sd: StateDict) -> Dict:
    """Reference ``PianoTreeDecoder``/``PtvaeDecoder`` state dict -> flax params
    (dl_modules/pianotree_dec.py:10-99, polydis/ptvae.py:238-).
    """
    tree: Dict = {
        "dec_notes_emb_gru_fwd": gru_params_from_torch(sd, "dec_notes_emb_gru"),
        "dec_notes_emb_gru_bwd": gru_params_from_torch(sd, "dec_notes_emb_gru", reverse=True),
        "dec_time_gru": gru_params_from_torch(sd, "dec_time_gru"),
        "dec_notes_gru": gru_params_from_torch(sd, "dec_notes_gru"),
        "dec_dur_gru": gru_params_from_torch(sd, "dec_dur_gru"),
        "dec_init_input": sd["dec_init_input"],
        "dur_sos_token": sd["dur_sos_token"],
    }
    for name in (
        "note_embedding",
        "z2dec_hid_linear",
        "z2dec_in_linear",
        "dec_time_to_notes_hid",
        "pitch_out_linear",
        "dur_hid_linear",
        "dur_out_linear",
    ):
        _linear(tree, (name,), sd, name)
    return tree


def pianotree_encoder_params_from_torch(sd: StateDict) -> Dict:
    """Reference ``PianoTreeEncoder`` (dl_modules/pianotree_enc.py:7-121) -> flax params."""
    tree: Dict = {
        "notes_gru": bigru_params_from_torch(sd, "enc_notes_gru"),
        "time_gru": bigru_params_from_torch(sd, "enc_time_gru"),
    }
    _linear(tree, ("note_embedding",), sd, "note_embedding")
    _linear(tree, ("linear_mu",), sd, "linear_mu")
    _linear(tree, ("linear_std",), sd, "linear_std")
    return tree


# ---------------------------------------------------------------------------
# checkpoint-level helpers (prefix surgery, reference utils.py:19-86)
# ---------------------------------------------------------------------------


def split_by_prefix(sd: StateDict, prefix: str) -> Dict[str, Array]:
    """Select keys under ``prefix.`` and strip it (cf. utils.py:60-66)."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def strip_dataparallel(sd: StateDict) -> Dict[str, Array]:
    """Strip leading ``module.`` (cf. polydis/model.py:321-325)."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def torch_file_to_numpy(path: str) -> Dict[str, Array]:
    """A torch checkpoint file as a plain NumPy dict: a bare state dict, or the
    one under ``model`` (a learner ``.pt``) or ``state_dict`` (a Lightning
    ``.ckpt``)."""
    from . import _checkpoint_dict

    return {k: v.detach().numpy() for k, v in _checkpoint_dict(path).items()
            if hasattr(v, "numpy")}


def polydis_params_from_torch_file(path: str) -> Dict:
    """A reference PolyDis checkpoint (``model_master_final.pt``, DataParallel's
    ``module.`` stripped) -> the JAX ``PolyDis`` tree (JAX
    ``models/polydis.py:PolyDis.params_from_torch_file``)."""
    sd = strip_dataparallel(torch_file_to_numpy(path))
    return {
        "chd_encoder": chord_encoder_params_from_torch(split_by_prefix(sd, "chd_encoder")),
        "rhy_encoder": texture_encoder_params_from_torch(split_by_prefix(sd, "rhy_encoder")),
        "decoder": pianotree_decoder_params_from_torch(split_by_prefix(sd, "decoder")),
        "chd_decoder": chord_decoder_params_from_torch(split_by_prefix(sd, "chd_decoder")),
    }
