"""PianoTree hierarchical decoder: time GRU -> notes GRU -> duration GRU
(counterpart of ``polyffusion_tpu/models/pianotree_dec.py``; reference
``dl_modules/pianotree_dec.py``, the same as ``polydis/ptvae.py:PtvaeDecoder``).
An autoregressive decoder of 32 time steps x 19 note slots x 5 duration bits,
emitting pitch (130-way) and per-bit duration (5 x 2-way) logits. Parameter
names are the reference's, so its state dicts load strictly.

What JAX writes as nested ``lax.scan``s is a Python loop here, one small
kernel at a time; the reference's quirks are kept:
- the duration feedback is a 5-wide one-hot of the 2-way argmax (only slots
  0 and 1 are ever hot);
- a step's length is its first predicted eos, or ``n_note - 1`` where none
  was predicted;
- between time steps the predicted notes are re-embedded by a bi-GRU masked
  to those lengths (``models/gru.py:BiGRU``'s masked scan, as JAX's);
- the first note token is the ground truth's slot 0 in training and the sos
  embedding in inference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum
from .encoders import one_hot
from .gru import BiGRU, gru_cell


class PianoTreeDecoder(nn.Module):
    # under data parallelism the reconstruction loss is the global batch's
    # masked mean (``parallel.mesh.set_batch_group``; ``pianotree_recon_loss``)
    batch_group = None

    def __init__(self, max_simu_note: int = 20, max_pitch: int = 127, min_pitch: int = 0,
                 pitch_sos: int = 128, pitch_eos: int = 129, pitch_pad: int = 130,
                 dur_width: int = 5, num_step: int = 32,
                 note_emb_size: int = 128, z_size: int = 512, dec_emb_hid_size: int = 128,
                 dec_time_hid_size: int = 1024, dec_notes_hid_size: int = 512,
                 dec_z_in_size: int = 256, dec_dur_hid_size: int = 16):
        super().__init__()
        self.max_simu_note, self.num_step = max_simu_note, num_step
        self.pitch_sos, self.pitch_eos, self.pitch_pad = pitch_sos, pitch_eos, pitch_pad
        self.dur_width = dur_width
        self.pitch_range = max_pitch - min_pitch + 3
        self.note_size = self.pitch_range + dur_width
        self.note_emb_size, self.dec_emb_hid_size = note_emb_size, dec_emb_hid_size
        self.note_embedding = nn.Linear(self.note_size, note_emb_size)
        self.z2dec_hid_linear = nn.Linear(z_size, dec_time_hid_size)
        self.z2dec_in_linear = nn.Linear(z_size, dec_z_in_size)
        self.dec_notes_emb_gru = BiGRU(note_emb_size, dec_emb_hid_size)
        self.dec_time_gru = nn.GRU(dec_z_in_size + 2 * dec_emb_hid_size, dec_time_hid_size,
                                   batch_first=True)
        self.dec_time_to_notes_hid = nn.Linear(dec_time_hid_size, dec_notes_hid_size)
        self.dec_notes_gru = nn.GRU(dec_time_hid_size + note_emb_size, dec_notes_hid_size,
                                    batch_first=True)
        self.pitch_out_linear = nn.Linear(dec_notes_hid_size, self.pitch_range)
        self.dec_dur_gru = nn.GRU(dur_width, dec_dur_hid_size, batch_first=True)
        self.dur_hid_linear = nn.Linear(self.pitch_range + dec_notes_hid_size, dec_dur_hid_size)
        self.dur_out_linear = nn.Linear(dec_dur_hid_size, 2)
        self.dec_init_input = nn.Parameter(torch.rand(2 * dec_emb_hid_size))
        self.dur_sos_token = nn.Parameter(torch.rand(dur_width))

    # -- the ground truth's embedding (reference :369-373) ---------------------------

    def get_len_index(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, n_note, 6) pnotree -> notes per step (B, T): slots not pad."""
        return self.max_simu_note - (x[..., 0] == self.pitch_pad).sum(dim=-1)

    def to_multihot(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, n_note, 6) -> (B, T, n_note, 135): pitch one-hot (the pad
        bucket dropped) | duration bits."""
        return torch.cat([one_hot(x[..., 0], self.pitch_range), x[..., 1:].float()], dim=-1)

    def emb_x(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The embedded ground truth (B, T, n_note, emb) and its lengths (B, T)."""
        return self.note_embedding(self.to_multihot(x)), self.get_len_index(x)

    # -- decoding -----------------------------------------------------------------------

    def _embed_bigru(self, seq: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(N, n_note, emb) masked to ``lengths`` -> (N, 2 emb_hid) final states."""
        return self.dec_notes_emb_gru(seq, lengths)[1]

    def _decode_note(self, hid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, notes_hid) -> pitch logits (B, 130), duration logits (B, 5, 2)."""
        est_pitch = self.pitch_out_linear(hid)
        dur_hid = self.dur_hid_linear(torch.cat([hid, est_pitch], dim=-1))
        token = self.dur_sos_token.expand(hid.shape[0], -1)
        durs = []
        for _ in range(self.dur_width):
            dur_hid = gru_cell(self.dec_dur_gru, token, dur_hid)
            est = self.dur_out_linear(dur_hid)
            token = one_hot(est.argmax(-1), self.dur_width, est.dtype)
            durs.append(est)
        return est_pitch, torch.stack(durs, dim=1)

    def _decode_notes(self, summary, gt_step, tf_step, sos_emb):
        """One time step's notes from the time GRU's state ``summary`` (B,
        time_hid). ``gt_step`` (B, n_note, emb): the embedded ground truth
        (None in inference); ``tf_step`` (n_note - 1,) bool coins. Returns pitch
        (B, 19, 130) and duration (B, 19, 5, 2) logits, the predicted notes
        embedded (B, n_note, emb) and their lengths (B,)."""
        n_note = self.max_simu_note
        b = summary.shape[0]
        hid = self.dec_time_to_notes_hid(summary)
        token = sos_emb.expand(b, -1) if gt_step is None else gt_step[:, 0]
        pred = [token]
        lengths = torch.zeros(b, dtype=torch.long, device=summary.device)
        pitches, durs = [], []
        for t in range(1, n_note):
            hid = gru_cell(self.dec_notes_gru, torch.cat([summary, token], dim=-1), hid)
            est_pitch, est_durs = self._decode_note(hid)
            pitch_inds = est_pitch.argmax(-1)
            predicted = self.note_embedding(torch.cat(
                [one_hot(pitch_inds, self.pitch_range, hid.dtype),
                 est_durs.argmax(-1).to(hid.dtype)], dim=-1))
            pred.append(predicted)
            lengths = torch.where((pitch_inds == self.pitch_eos) & (lengths == 0), t, lengths)
            token = predicted if gt_step is None else torch.where(tf_step[t - 1], gt_step[:, t],
                                                                  predicted)
            pitches.append(est_pitch)
            durs.append(est_durs)
        lengths = torch.where(lengths == 0, n_note - 1, lengths)
        return torch.stack(pitches, 1), torch.stack(durs, 1), torch.stack(pred, 1), lengths

    def forward(self, z: torch.Tensor, x: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None, tf1: Optional[torch.Tensor] = None,
                tf2: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode z (B, z_size) -> pitch logits (B, 32, 19, 130), duration
        logits (B, 32, 19, 5, 2).

        Training: ``x`` is the embedded ground truth (B, 32, n_note, emb) with
        its ``lengths`` (B, 32) (``emb_x``), and the teacher-forcing coins are
        ``tf1`` (32,) for the time level and ``tf2`` (32, n_note - 1) for the
        note level, bool, shared by the batch (JAX draws them as
        ``uniform < tfr`` at :143-150). With ``x`` None the decoder runs
        free (inference)."""
        b = z.shape[0]
        z_hid = self.z2dec_hid_linear(z)
        z_in = self.z2dec_in_linear(z)
        sos = torch.zeros(self.note_size, device=z.device, dtype=z.dtype)
        sos[self.pitch_sos] = 1.0
        sos[self.pitch_range:] = 2.0
        sos_emb = self.note_embedding(sos)
        if x is not None:
            x_summarized = self._embed_bigru(
                x.reshape(-1, self.max_simu_note, self.note_emb_size), lengths.reshape(-1)
            ).reshape(b, self.num_step, 2 * self.dec_emb_hid_size)
        token = self.dec_init_input.expand(b, -1)
        pitch_outs, dur_outs = [], []
        for t in range(self.num_step):
            z_hid = gru_cell(self.dec_time_gru, torch.cat([token, z_in], dim=-1), z_hid)
            pitch, dur, pred, pred_lens = self._decode_notes(
                z_hid, None if x is None else x[:, t], None if x is None else tf2[t], sos_emb)
            token = self._embed_bigru(pred, pred_lens)
            if x is not None:
                token = torch.where(tf1[t], x_summarized[:, t], token)
            pitch_outs.append(pitch)
            dur_outs.append(dur)
        return torch.stack(pitch_outs, 1), torch.stack(dur_outs, 1)


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, ignore: int, group=None) -> torch.Tensor:
    """Mean CE over the labels that are not ``ignore`` (JAX's ``masked_ce``;
    the ignored labels are gathered at 0, then masked out). ``group``: a dp
    group over whose ranks the sum and the count are summed first, so that
    every rank holds the global batch's mean, as GSPMD divides by the global
    count (the identity without one)."""
    mask = labels != ignore
    ll = F.log_softmax(logits, dim=-1).gather(
        -1, torch.where(mask, labels, 0).long()[..., None])[..., 0]
    total, count = all_reduce_sum(torch.stack([-(ll * mask).sum(), mask.sum().to(ll.dtype)]),
                                  group)
    return total / count.clamp(min=1)


def pianotree_recon_loss(x: torch.Tensor, recon_pitch: torch.Tensor, recon_dur: torch.Tensor,
                         weights=(1.0, 0.5), pitch_pad: int = 130, dur_pad: int = 2, group=None):
    """CE losses with pad-index masking (JAX ``pianotree_recon_loss``, reference
    ``pianotree_dec.py:341-367``): (loss, pitch, dur). ``group``: the dp group
    of ``_masked_ce``."""
    pitch_loss = _masked_ce(recon_pitch, x[:, :, 1:, 0], pitch_pad, group)
    dur_loss = _masked_ce(recon_dur, x[:, :, 1:, 1:], dur_pad, group)
    return weights[0] * pitch_loss + weights[1] * dur_loss, pitch_loss, dur_loss


def output_to_pnotree(recon_pitch: torch.Tensor, recon_dur: torch.Tensor) -> torch.Tensor:
    """Logits -> (B, 32, 19, 6) index grid (reference ``utils.py:89-96``)."""
    return torch.cat([recon_pitch.argmax(-1)[..., None], recon_dur.argmax(-1)], dim=-1)
