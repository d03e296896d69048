"""Conditioning VAEs (counterpart of ``polyffusion_tpu/models/encoders.py``):
the chord, texture and PianoTree VAE encoders, the chord VAE's decoder and
loss, and the loader of the encoders' pretrained weights. Parameter names are
the reference modules', so the reference checkpoints load strictly."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import load_params
from ..convert import (
    chord_encoder_state_from_jax,
    pianotree_encoder_state_from_jax,
    reference_state,
    texture_encoder_state_from_jax,
)
from .gru import BiGRU, gru_cell


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot`` by a comparison: ``F.one_hot`` checks the range of
    its indices, which waits for the card."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class ChordEncoder(nn.Module):
    """bi-GRU VAE encoder over chord one-hots (B, 32, 36) -> N(mu, sigma).
    Returns (mean, std); parameter names are the reference ``RnnEncoder``'s."""

    def __init__(self, input_dim: int = 36, hidden_dim: int = 512, z_dim: int = 512):
        super().__init__()
        self.gru = BiGRU(input_dim, hidden_dim)
        self.linear_mu = nn.Linear(hidden_dim * 2, z_dim)
        self.linear_var = nn.Linear(hidden_dim * 2, z_dim)

    def forward(self, chord: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, final = self.gru(chord)
        return self.linear_mu(final), torch.exp(self.linear_var(final))


class ChordDecoder(nn.Module):
    """Autoregressive GRU chord decoder (JAX ``ChordDecoder`` :38-136, reference
    ``dl_modules/chord_dec.py:7-85``): per step root (12), chroma (12 x 2) and
    bass (12) logits. The next step's input is the one-hot argmax triple, or
    the ground truth of this step where its teacher-forcing coin is true (one
    coin a step, shared by the batch).

    As JAX's, the feedback one-hot is built per sample: the reference's
    (``chord_dec.py:57-63``) writes every sample's argmax into every other's
    at batch > 1."""

    def __init__(self, input_dim: int = 36, z_input_dim: int = 512, hidden_dim: int = 512,
                 z_dim: int = 512, n_step: int = 32):
        super().__init__()
        self.n_step = n_step
        self.z2dec_hid = nn.Linear(z_dim, hidden_dim)
        self.z2dec_in = nn.Linear(z_dim, z_input_dim)
        self.gru = nn.GRU(input_dim + z_input_dim, hidden_dim, batch_first=True)
        self.init_input = nn.Parameter(torch.rand(input_dim))
        self.root_out = nn.Linear(hidden_dim, 12)
        self.chroma_out = nn.Linear(hidden_dim, 24)
        self.bass_out = nn.Linear(hidden_dim, 12)

    def forward(self, z: torch.Tensor, coins: Optional[torch.Tensor] = None,
                gt_chd: Optional[torch.Tensor] = None):
        """z (B, z_dim) -> logits root (B, T, 12), chroma (B, T, 12, 2), bass
        (B, T, 12). ``coins``: (T,) bool, true where step t feeds ``gt_chd[:, t]``
        (B, T, 36) on; None decodes free-running (inference). The coins are
        explicit: JAX draws them as ``uniform(rng, (T,)) < tfr`` (:97-104)."""
        b = z.shape[0]
        h = self.z2dec_hid(z)
        z_in = self.z2dec_in(z)
        token = self.init_input.expand(b, -1)
        roots, chromas, basses = [], [], []
        for t in range(self.n_step):
            h = gru_cell(self.gru, torch.cat([token, z_in], dim=-1), h)
            r_root, r_bass = self.root_out(h), self.bass_out(h)
            r_chroma = self.chroma_out(h).reshape(b, 12, 2)
            pred = torch.cat([one_hot(r_root.argmax(-1), 12, h.dtype),
                              r_chroma.argmax(-1).to(h.dtype),
                              one_hot(r_bass.argmax(-1), 12, h.dtype)], dim=-1)
            token = pred if coins is None else torch.where(coins[t], gt_chd[:, t], pred)
            roots.append(r_root)
            chromas.append(r_chroma)
            basses.append(r_bass)
        return torch.stack(roots, 1), torch.stack(chromas, 1), torch.stack(basses, 1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits`` (last axis)."""
    return -F.log_softmax(logits, dim=-1).gather(-1, labels[..., None]).mean()


def chord_recon_loss(chord: torch.Tensor, r_root: torch.Tensor, r_chroma: torch.Tensor,
                     r_bass: torch.Tensor):
    """CE losses of a (B, T, 36) chord one-hot (JAX ``chord_recon_loss`` :139-152,
    reference ``chord_dec.py:71-85``): (total, root, chroma, bass)."""
    root = cross_entropy(r_root, chord[..., :12].argmax(-1))
    chroma = cross_entropy(r_chroma, chord[..., 12:24].long())
    bass = cross_entropy(r_bass, chord[..., 24:].argmax(-1))
    return root + chroma + bass, root, chroma, bass


class TextureEncoder(nn.Module):
    """CNN + bi-GRU texture VAE encoder over a 2-bar prmat (B, 32, 128) ->
    N(mu, sigma) (JAX ``TextureEncoder`` :155-189, reference
    ``dl_modules/txt_enc.py``). Returns (mean, std).

    The conv output is already NCHW (B, C, 8, 29); the reference views it as
    (B, 8, C * 29), which mixes channels into time, and so does this."""

    def __init__(self, emb_size: int = 256, hidden_dim: int = 1024, z_dim: int = 256,
                 num_channel: int = 10):
        super().__init__()
        self.cnn = nn.Sequential(
            nn.Conv2d(1, num_channel, kernel_size=(4, 12), stride=(4, 1)),
            nn.ReLU(),
            nn.MaxPool2d(kernel_size=(1, 4), stride=(1, 4)),
        )
        self.fc1 = nn.Linear(num_channel * 29, 1000)
        self.fc2 = nn.Linear(1000, emb_size)
        self.gru = BiGRU(emb_size, hidden_dim)
        self.linear_mu = nn.Linear(hidden_dim * 2, z_dim)
        self.linear_var = nn.Linear(hidden_dim * 2, z_dim)

    def forward(self, pr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = pr.shape[0]
        x = self.cnn(pr[:, None]).reshape(b, 8, -1)  # (B, C, 8, 29) -> (B, 8, C * 29)
        _, final = self.gru(self.fc2(self.fc1(x)))
        return self.linear_mu(final), torch.exp(self.linear_var(final))


class PianoTreeEncoder(nn.Module):
    """Note-GRU then time-GRU VAE encoder over a 2-bar pnotree (B, 32, 20, 6)
    -> N(mu, sigma) (JAX ``PianoTreeEncoder`` :192-243, reference
    ``dl_modules/pianotree_enc.py``). Returns (mean, std).

    A step's notes are (pitch, 5 duration bits); its length is 20 minus its
    pad-pitch (130) slots, and the notes GRU stops there. The pitch one-hot
    spans 131 buckets with the pad bucket dropped, as in the reference."""

    max_simu_note = 20
    pitch_pad = 130
    pitch_range = 130  # pitches 0-127, sos, eos
    num_step = 32

    def __init__(self, note_emb_size: int = 128, enc_notes_hid_size: int = 256,
                 enc_time_hid_size: int = 512, z_size: int = 512, dur_width: int = 5):
        super().__init__()
        self.note_embedding = nn.Linear(self.pitch_range + dur_width, note_emb_size)
        self.enc_notes_gru = BiGRU(note_emb_size, enc_notes_hid_size)
        self.enc_time_gru = BiGRU(2 * enc_notes_hid_size, enc_time_hid_size)
        self.linear_mu = nn.Linear(2 * enc_time_hid_size, z_size)
        self.linear_std = nn.Linear(2 * enc_time_hid_size, z_size)

    def forward(self, pnotree: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = pnotree.shape[0]
        pitch = pnotree[..., 0]
        lengths = self.max_simu_note - (pitch == self.pitch_pad).sum(dim=-1)
        # a comparison, not F.one_hot: the same zeros as jax.nn.one_hot for an
        # out-of-range value, and no range check that waits for the card
        buckets = torch.arange(self.pitch_range, device=pnotree.device)
        pitch_oh = (pitch[..., None] == buckets).float()
        x = torch.cat([pitch_oh, pnotree[..., 1:].float()], dim=-1)  # (B, 32, 20, 135)
        notes = self.note_embedding(x).reshape(b * self.num_step, self.max_simu_note, -1)
        _, notes_final = self.enc_notes_gru(notes, lengths.reshape(-1))
        _, time_final = self.enc_time_gru(notes_final.reshape(b, self.num_step, -1))
        return self.linear_mu(time_final), torch.exp(self.linear_std(time_final))


# -- pretrained weights ------------------------------------------------------------


def _load_npz_tree(path: str) -> Dict:
    """A JAX parameter tree written flat with "a/b/c" keys (the JAX package's
    converter), as nested dicts of NumPy arrays."""
    tree: Dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parts, leaf = key.split("/")
            node = tree
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
    return tree


def _under(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The keys under ``prefix.``, stripped, or ``sd`` when there are none."""
    hit = {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
    return hit or sd


# the run directories build_frozen_encoders reads: base -> (the run's model_name,
# the prefix of the encoder in its trained weights)
RUN_DIRS = {"chd8bar": ("chd_8bar", "chord_enc"), "pnotree": ("pnotree_vae", "pnotree_enc")}


def run_encoder_state(run_dir: str, model_name: str, prefix: str) -> Dict[str, torch.Tensor]:
    """The ``prefix`` part (stripped) of the trained weights of a run directory
    of the port's trainer (``params.yaml``, ``chkpts/last.pt``) whose
    ``model_name`` is ``model_name`` (JAX ``load_chord_encoder_from_run`` :246,
    ``load_pnotree_encoder_from_run`` :266, for its orbax runs)."""
    params_path = os.path.join(run_dir, "params.yaml")
    last = os.path.join(run_dir, "chkpts", "last.pt")
    if not (os.path.exists(params_path) and os.path.exists(last)):
        raise NotImplementedError(
            f"{run_dir} has no params.yaml and chkpts/last.pt: it is not a run directory of "
            "the port's trainer. A JAX orbax run directory is read by the JAX package only: "
            "its converter (polyffusion_tpu/convert/__main__.py, run where JAX is installed) "
            "exports a UNet run with --kind unet --reverse, and an encoder's run not at all "
            "(ROADMAP.md item 15)")
    got = load_params(params_path).get("model_name")
    if got != model_name:
        raise ValueError(f"{run_dir} is a {got!r} run, not a {model_name!r} run")
    params = torch.load(last, map_location="cpu", weights_only=True)["params"]
    return {k[len(prefix) + 1:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _encoder_state(pretrained_dir: Optional[str], base: str,
                   from_tree: Callable[[Dict], Dict[str, torch.Tensor]],
                   from_pt: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]):
    """An encoder's state dict from, in this order (JAX's): ``<pretrained_dir>/<base>/``,
    a run directory of the port's trainer (a ``chd_8bar`` run for ``chd8bar``,
    a ``pnotree_vae`` run for ``pnotree``); ``<base>.npz`` (the JAX package's
    conversion); ``<base>.pt`` (the reference's checkpoint)."""
    run = f"{base}/ (a {RUN_DIRS[base][0]} run directory), " if base in RUN_DIRS else ""
    if not pretrained_dir:
        raise FileNotFoundError(
            f"this config needs the pretrained '{base}' encoder: pass --pretrained_dir "
            f"with {run}{base}.pt or {base}.npz"
        )
    run_dir = os.path.join(pretrained_dir, base)
    if base in RUN_DIRS and os.path.isdir(run_dir):
        return from_pt(run_encoder_state(run_dir, *RUN_DIRS[base]))
    npz_path = os.path.join(pretrained_dir, f"{base}.npz")
    if os.path.exists(npz_path):
        return from_tree(_load_npz_tree(npz_path))
    pt_path = os.path.join(pretrained_dir, f"{base}.pt")
    if not os.path.exists(pt_path):
        raise FileNotFoundError(
            f"pretrained checkpoint not found in {pretrained_dir}: {run}{base}.npz or "
            f"{base}.pt (the reference's pretrained/ checkpoint, or its conversion by the "
            "JAX package)"
        )
    return from_pt(reference_state(pt_path))


def _pianotree_encoder_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The encoder's part of a whole PianoTree VAE state dict."""
    names = ("note_embedding.", "enc_notes_gru.", "enc_time_gru.", "linear_mu.", "linear_std.")
    return {k: v for k, v in sd.items() if k.startswith(names)}


def build_frozen_encoders(cfg, pretrained_dir: Optional[str] = None) -> Dict[str, nn.Module]:
    """The frozen encoders ``cfg`` needs (``cond_type``/``use_enc``), weights
    loaded strictly from ``pretrained_dir`` (JAX ``build_frozen_encoders``
    :285-370):

    - ``chord_enc`` for a chord condition with ``use_enc``, from ``chd8bar/``
      (a ``chd_8bar`` run directory of the port's trainer: its ``chord_enc.``
      weights), ``chd8bar.npz`` (the tree, or its ``chord_enc`` subtree) or
      ``chd8bar.pt`` (the reference chord VAE, encoder under ``chord_enc.``);
    - ``txt_enc`` for a texture condition with ``use_enc``, from
      ``polydis.npz`` (the tree, or its ``rhy_encoder`` subtree) or
      ``polydis.pt`` (the reference PolyDis, encoder under ``rhy_encoder.``);
    - ``pnotree_enc`` for ``cond_type: pnotree``, from ``pnotree/`` (a
      ``pnotree_vae`` run directory: its ``pnotree_enc.`` weights),
      ``pnotree.npz`` or ``pnotree.pt`` (the reference PianoTree VAE).

    A run directory's ``params.yaml`` must name its model (``chd_8bar``,
    ``pnotree_vae``). A JAX orbax run directory is not read (``ROADMAP.md``
    item 15): the JAX package's converter (``polyffusion_tpu/convert/__main__.py``)
    exports only a UNet run (``--kind unet --reverse``)."""
    cond_type = cfg.get("cond_type", "chord")
    use_enc = bool(cfg.get("use_enc", cond_type == "pnotree"))
    encoders: Dict[str, nn.Module] = {}
    if "chord" in cond_type and use_enc:
        enc = ChordEncoder(cfg.get("chd_input_dim", 36), cfg.get("chd_hidden_dim", 512),
                           cfg.get("chd_z_dim", 512))
        enc.load_state_dict(_encoder_state(
            pretrained_dir, "chd8bar",
            lambda tree: chord_encoder_state_from_jax(tree.get("chord_enc", tree)),
            lambda sd: _under(sd, "chord_enc")), strict=True)
        encoders["chord_enc"] = enc
    if "txt" in cond_type and use_enc:
        enc = TextureEncoder(cfg.get("txt_emb_size", 256), cfg.get("txt_hidden_dim", 1024),
                             cfg.get("txt_z_dim", 256), cfg.get("txt_num_channel", 10))
        enc.load_state_dict(_encoder_state(
            pretrained_dir, "polydis",
            lambda tree: texture_encoder_state_from_jax(tree.get("rhy_encoder", tree)),
            lambda sd: _under(sd, "rhy_encoder")), strict=True)
        encoders["txt_enc"] = enc
    if cond_type == "pnotree":
        enc = PianoTreeEncoder()
        enc.load_state_dict(_encoder_state(
            pretrained_dir, "pnotree", pianotree_encoder_state_from_jax,
            _pianotree_encoder_keys), strict=True)
        encoders["pnotree_enc"] = enc
    return encoders
