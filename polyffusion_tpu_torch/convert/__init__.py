"""Weights into the port: JAX parameter trees (as NumPy arrays) and reference
``.pt`` checkpoints -> the port's ``state_dict``s.

The port's module names are the reference torch names, so a JAX tree maps the
way ``polyffusion_tpu/convert/torch_export.py`` maps it:

    flax Dense kernel (in, out)          -> Linear weight (out, in)
    flax Conv kernel (kH, kW, I, O)      -> Conv2d weight (O, I, kH, kW)
    flax ConvTranspose kernel (kH, kW, O, I), transpose_kernel=True
                                         -> ConvTranspose2d weight (I, O, kH, kW)
    norm scale / bias                    -> weight / bias
    GRU wi (in, 3H), wh (H, 3H), bi, bh  -> weight_ih_l0 (3H, in), weight_hh_l0, bias_*

The submodules are the port's copies of JAX's ``convert/``: ``torch_import``
(reference ``.pt`` -> the JAX package's parameter trees, as NumPy),
``torch_export`` (trees and the port's training state -> reference ``.pt``
checkpoints) and the CLI, ``python -m polyffusion_tpu_torch.convert``
(``__main__``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

#: prefixes under which reference and JAX-exported checkpoints keep the UNet
REFERENCE_PREFIXES = ("model.ldm.eps_model.", "ldm.eps_model.", "eps_model.")
#: the same for the plain DDPM family's UNet (JAX ``inference.py:722``)
DDPM_PREFIXES = ("model.ddpm.eps_model.", "ddpm.eps_model.", "eps_model.")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _linear(out: StateDict, tk: str, sub: Mapping) -> None:
    out[tk + ".weight"] = _t(np.asarray(sub["kernel"]).T)
    if "bias" in sub:
        out[tk + ".bias"] = _t(sub["bias"])


def _conv(out: StateDict, tk: str, sub: Mapping) -> None:
    """A Conv2d; also a ConvTranspose2d, whose flax kernel (transpose_kernel=True)
    is (kH, kW, O, I) against torch's (I, O, kH, kW): the same permutation."""
    out[tk + ".weight"] = _t(np.transpose(np.asarray(sub["kernel"]), (3, 2, 0, 1)))
    if "bias" in sub:
        out[tk + ".bias"] = _t(sub["bias"])


def _norm(out: StateDict, tk: str, sub: Mapping) -> None:
    out[tk + ".weight"] = _t(sub["scale"])
    out[tk + ".bias"] = _t(sub["bias"])


def _resblock(out: StateDict, tk: str, sub: Mapping) -> None:
    _norm(out, tk + ".in_layers.0", sub["in_norm"])
    _conv(out, tk + ".in_layers.2", sub["in_conv"])
    _linear(out, tk + ".emb_layers.1", sub["emb_proj"])
    _norm(out, tk + ".out_layers.0", sub["out_norm"])
    _conv(out, tk + ".out_layers.3", sub["out_conv"])
    if "skip" in sub:
        _conv(out, tk + ".skip_connection", sub["skip"])


def _spatial_transformer(out: StateDict, tk: str, sub: Mapping) -> None:
    _norm(out, tk + ".norm", sub["norm"])
    _conv(out, tk + ".proj_in", sub["proj_in"])
    _conv(out, tk + ".proj_out", sub["proj_out"])
    k = 0
    while f"block_{k}" in sub:
        b = sub[f"block_{k}"]
        bt = f"{tk}.transformer_blocks.{k}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(out, f"{bt}.{n}", b[n])
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear(out, f"{bt}.{attn}.{proj}", b[attn][proj])
            _linear(out, f"{bt}.{attn}.to_out.0", b[attn]["to_out"])
        _linear(out, f"{bt}.ff.net.0.proj", b["ff"]["geglu_proj"])
        _linear(out, f"{bt}.ff.net.2", b["ff"]["proj_out"])
        k += 1


def unet_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``UNetModel`` params (NumPy leaves) -> the port's ``UNetModel`` state dict."""
    out: StateDict = {}
    _linear(out, "time_embed.0", params["time_embed_0"])
    _linear(out, "time_embed.2", params["time_embed_2"])
    _conv(out, "input_blocks.0.0", params["input_blocks_0_0"])
    for name, sub in params.items():
        if not name.startswith(("input_blocks_", "output_blocks_")) or name == "input_blocks_0_0":
            continue
        side, i, j = name.rsplit("_", 2)
        tk = f"{side}.{i}.{j}"
        if "in_norm" in sub:
            _resblock(out, tk, sub)
        elif "proj_in" in sub:
            _spatial_transformer(out, tk, sub)
        elif "conv" in sub:
            # DownSample keeps its conv as "op", UpSample as "conv"
            _conv(out, tk + (".op" if side == "input_blocks" else ".conv"), sub["conv"])
        else:
            raise KeyError(f"unrecognized block {name}")
    _resblock(out, "middle_block.0", params["middle_block_0"])
    _spatial_transformer(out, "middle_block.1", params["middle_block_1"])
    _resblock(out, "middle_block.2", params["middle_block_2"])
    _norm(out, "out.0", params["out_norm"])
    _conv(out, "out.2", params["out_conv"])
    return out


def _gru(out: StateDict, tk: str, g: Mapping, sfx: str = "") -> None:
    """A JAX GRU cell's wi, wh, bi, bh -> ``nn.GRU`` layer 0 (``sfx``
    "_reverse": its backward direction)."""
    out[f"{tk}.weight_ih_l0{sfx}"] = _t(np.asarray(g["wi"]).T)
    out[f"{tk}.weight_hh_l0{sfx}"] = _t(np.asarray(g["wh"]).T)
    out[f"{tk}.bias_ih_l0{sfx}"] = _t(g["bi"])
    out[f"{tk}.bias_hh_l0{sfx}"] = _t(g["bh"])


def _bigru(out: StateDict, tk: str, sub: Mapping) -> None:
    """A JAX ``BiGRU`` (``fwd``/``bwd`` of wi, wh, bi, bh; gates r | z | n in
    column blocks) -> ``nn.GRU`` layer 0 and its ``_reverse`` (rows r | z | n)."""
    _gru(out, tk, sub["fwd"])
    _gru(out, tk, sub["bwd"], "_reverse")


def chord_encoder_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``ChordEncoder`` params -> the port's ``ChordEncoder`` state dict."""
    out: StateDict = {}
    _bigru(out, "gru", params["gru"])
    _linear(out, "linear_mu", params["linear_mu"])
    _linear(out, "linear_var", params["linear_var"])
    return out


def texture_encoder_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``TextureEncoder`` params -> the port's ``TextureEncoder`` state
    dict (the reference names: the conv is ``cnn.0``)."""
    out: StateDict = {}
    _conv(out, "cnn.0", params["cnn"])
    for name in ("fc1", "fc2", "linear_mu", "linear_var"):
        _linear(out, name, params[name])
    _bigru(out, "gru", params["gru"])
    return out


def pianotree_encoder_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``PianoTreeEncoder`` params -> the port's ``PianoTreeEncoder``
    state dict (the reference names: ``enc_notes_gru``, ``enc_time_gru``)."""
    out: StateDict = {}
    for name in ("note_embedding", "linear_mu", "linear_std"):
        _linear(out, name, params[name])
    _bigru(out, "enc_notes_gru", params["notes_gru"])
    _bigru(out, "enc_time_gru", params["time_gru"])
    return out


def chord_decoder_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``ChordDecoder`` params -> the port's ``ChordDecoder`` state dict
    (the reference ``chord_dec.py`` names; inverse of JAX
    ``convert/torch_import.py:chord_decoder_params_from_torch``)."""
    out: StateDict = {}
    for name in ("z2dec_hid", "z2dec_in", "root_out", "chroma_out", "bass_out"):
        _linear(out, name, params[name])
    _gru(out, "gru", params["gru"])
    out["init_input"] = _t(params["init_input"])
    return out


PIANOTREE_DECODER_LINEARS = ("note_embedding", "z2dec_hid_linear", "z2dec_in_linear",
                             "dec_time_to_notes_hid", "pitch_out_linear", "dur_hid_linear",
                             "dur_out_linear")


def pianotree_decoder_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``PianoTreeDecoder`` params -> the port's ``PianoTreeDecoder`` state
    dict (the reference ``PtvaeDecoder`` names; inverse of JAX
    ``convert/torch_import.py:pianotree_decoder_params_from_torch``)."""
    out: StateDict = {}
    for name in PIANOTREE_DECODER_LINEARS:
        _linear(out, name, params[name])
    _gru(out, "dec_notes_emb_gru", params["dec_notes_emb_gru_fwd"])
    _gru(out, "dec_notes_emb_gru", params["dec_notes_emb_gru_bwd"], "_reverse")
    for name in ("dec_time_gru", "dec_notes_gru", "dec_dur_gru"):
        _gru(out, name, params[name])
    for name in ("dec_init_input", "dur_sos_token"):
        out[name] = _t(params[name])
    return out


def polydis_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``PolyDis`` params (``chd_encoder``, ``rhy_encoder``, ``decoder``,
    ``chd_decoder``) -> the port's ``PolyDis`` state dict, the reference
    ``DisentangleVAE`` names (its ``model_master_final.pt``)."""
    parts = (("chd_encoder", chord_encoder_state_from_jax),
             ("rhy_encoder", texture_encoder_state_from_jax),
             ("decoder", pianotree_decoder_state_from_jax),
             ("chd_decoder", chord_decoder_state_from_jax))
    return {f"{name}.{k}": v for name, convert in parts for k, v in convert(params[name]).items()}


def ddpm_unet_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``DDPMUNet`` params -> the port's ``DDPMUNet`` state dict, the
    reference ``ddpm.unet.UNet`` names (inverse of JAX
    ``convert/torch_import.py:ddpm_unet_params_from_torch``). Each attention
    block's ``norm``, which JAX does not hold and no forward applies, gets
    its initial ones and zeros, so the state dict loads strictly."""
    out: StateDict = {}
    _conv(out, "image_proj", params["image_proj"])
    _linear(out, "time_emb.lin1", params["time_emb"]["lin1"])
    _linear(out, "time_emb.lin2", params["time_emb"]["lin2"])

    def res_block(tk, sub):
        for n in ("norm1", "norm2"):
            _norm(out, f"{tk}.{n}", sub[n])
        for n in ("conv1", "conv2", "shortcut"):
            if n in sub:
                _conv(out, f"{tk}.{n}", sub[n])
        _linear(out, tk + ".time_emb", sub["time_emb"])

    def attn_block(tk, sub):
        c = np.asarray(sub["projection"]["kernel"]).shape[0]
        out[tk + ".norm.weight"], out[tk + ".norm.bias"] = torch.ones(c), torch.zeros(c)
        _linear(out, tk + ".projection", sub["projection"])
        _linear(out, tk + ".output", sub["output"])

    for side in ("down", "up"):
        k = 0
        while True:
            name = f"{side}_{k}"
            if name + "_res" in params:
                res_block(f"{side}.{k}.res", params[name + "_res"])
                if name + "_attn" in params:
                    attn_block(f"{side}.{k}.attn", params[name + "_attn"])
            elif name + "_ds" in params or name + "_us" in params:
                sub = params.get(name + "_ds") or params[name + "_us"]
                _conv(out, f"{side}.{k}.conv", sub["conv"])
            else:
                break
            k += 1
    res_block("middle.res1", params["middle_res1"])
    attn_block("middle.attn", params["middle_attn"])
    res_block("middle.res2", params["middle_res2"])
    _norm(out, "norm", params["norm"])
    _conv(out, "final", params["final"])
    return out


def _ae_resblock(out: StateDict, tk: str, sub: Mapping) -> None:
    _norm(out, tk + ".norm1", sub["norm1"])
    _conv(out, tk + ".conv1", sub["conv1"])
    _norm(out, tk + ".norm2", sub["norm2"])
    _conv(out, tk + ".conv2", sub["conv2"])
    if "nin_shortcut" in sub:
        _conv(out, tk + ".nin_shortcut", sub["nin_shortcut"])


def _ae_mid(out: StateDict, tk: str, params: Mapping) -> None:
    _ae_resblock(out, tk + ".mid.block_1", params["mid_block_1"])
    attn = params["mid_attn_1"]
    _norm(out, tk + ".mid.attn_1.norm", attn["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _conv(out, f"{tk}.mid.attn_1.{n}", attn[n])
    _ae_resblock(out, tk + ".mid.block_2", params["mid_block_2"])


def _ae_half(out: StateDict, tk: str, params: Mapping, side: str, sample: str) -> None:
    """An ``Encoder`` (``side`` "down") or ``Decoder`` ("up"): its levels'
    blocks and re-sampling convs, the mid blocks and the ends."""
    _conv(out, tk + ".conv_in", params["conv_in"])
    i = 0
    while f"{side}_{i}_block_0" in params:
        j = 0
        while f"{side}_{i}_block_{j}" in params:
            _ae_resblock(out, f"{tk}.{side}.{i}.block.{j}", params[f"{side}_{i}_block_{j}"])
            j += 1
        if f"{side}_{i}_{sample}" in params:
            _conv(out, f"{tk}.{side}.{i}.{sample}.conv", params[f"{side}_{i}_{sample}"])
        i += 1
    _ae_mid(out, tk, params)
    _norm(out, tk + ".norm_out", params["norm_out"])
    _conv(out, tk + ".conv_out", params["conv_out"])


def autoencoder_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``Autoencoder`` params -> the port's ``Autoencoder`` state dict, the
    reference names (inverse of JAX ``convert/torch_import.py:
    autoencoder_params_from_torch``)."""
    out: StateDict = {}
    _ae_half(out, "encoder", params["encoder"], "down", "downsample")
    _ae_half(out, "decoder", params["decoder"], "up", "upsample")
    _conv(out, "quant_conv", params["quant_conv"])
    _conv(out, "post_quant_conv", params["post_quant_conv"])
    return out


def nlayer_discriminator_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``NLayerDiscriminator`` params (``conv_0`` .. ``conv_<n>``,
    ``bn_1`` .. ``bn_<n>``, ``conv_out``) -> the port's, the reference's
    ``main.<index>`` names: conv n at 3n - 1, its batch norm at 3n."""
    out: StateDict = {}
    _conv(out, "main.0", params["conv_0"])
    n = 1
    while f"conv_{n}" in params:
        _conv(out, f"main.{3 * n - 1}", params[f"conv_{n}"])
        _norm(out, f"main.{3 * n}", params[f"bn_{n}"])
        n += 1
    _conv(out, f"main.{3 * n - 1}", params["conv_out"])
    return out


def lpips_state_from_jax(params: Mapping) -> StateDict:
    """JAX ``LPIPS`` params (``vgg.conv<idx>``, ``lin<k>`` of shape (1, 1, C,
    1)) -> the port's ``LPIPS`` state dict (the reference's
    ``net.slice<s>.<idx>``, ``lin<k>.model.1``)."""
    from ..models.lpips import SLICE_BOUNDS

    out: StateDict = {}
    for name, sub in params["vgg"].items():
        idx = int(name[len("conv"):])
        s = next(s for s in range(5) if SLICE_BOUNDS[s] <= idx < SLICE_BOUNDS[s + 1])
        _conv(out, f"net.slice{s + 1}.{idx}", sub)
    k = 0
    while f"lin{k}" in params:
        _conv(out, f"lin{k}.model.1", {"kernel": params[f"lin{k}"]})
        k += 1
    return out


def _checkpoint_dict(path: str) -> StateDict:
    """A reference checkpoint's dict of tensors: a bare one, or the one under
    ``model`` (a learner ``.pt``) or ``state_dict`` (a Lightning ``.ckpt``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return obj


def reference_state(path: str) -> StateDict:
    """A reference checkpoint's state dict with DataParallel's ``module.``
    stripped (a PolyDis ``model_master_final.pt`` loads strictly into the
    port's ``PolyDis``)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in _checkpoint_dict(path).items()}


def reference_unet_state(path: str, prefixes=REFERENCE_PREFIXES) -> StateDict:
    """The UNet state dict of a reference-format checkpoint (legacy learner
    ``.pt`` with a ``model`` dict, Lightning ``.ckpt`` with a ``state_dict``,
    or a bare state dict), the first of ``prefixes`` that matches stripped
    (``DDPM_PREFIXES`` for the plain DDPM family's)."""
    obj = _checkpoint_dict(path)
    for prefix in prefixes:
        hit = {k[len(prefix):]: v for k, v in obj.items() if k.startswith(prefix)}
        if hit:
            return hit
    return obj


def load_reference_checkpoint(path: str, unet: nn.Module) -> nn.Module:
    """Load a reference-format UNet checkpoint into ``unet`` strictly."""
    unet.load_state_dict(reference_unet_state(path), strict=True)
    return unet
