"""PolyDis, the chord/texture disentangled VAE (counterpart of
``polyffusion_tpu/models/polydis.py``; reference ``polydis/model.py``).

Composes a chord encoder (1024 hidden, z=256), the CNN-GRU texture encoder
(z=256), the PianoTree decoder (z=512 = z_chd | z_rhy) and an 8-step chord
decoder. Used for "aftertouch" re-rendering of generated piano-rolls and for the
swap / posterior-sample / prior-sample / slerp-interpolation utilities. Its
state-dict names are the reference ``DisentangleVAE``'s, so the reference
checkpoint (``model_master_final.pt``, DataParallel prefixes stripped by
``convert.reference_state``) loads strictly.

Randomness is explicit: ``run`` and ``loss`` take a ``PolyDisNoise``
(``draw_noise`` draws one from a ``torch.Generator``); the sampling
utilities take ``noise`` (the standard normal draws, in the order JAX's keys
are split) or a ``generator``, which defaults to one seeded 0 as JAX's rng
defaults to ``PRNGKey(0)``. fp32, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..convert import reference_state
from ..device import DeviceLike, resolve_device
from ..utils.midi_io import estx_to_midi_file
from .encoders import ChordDecoder, ChordEncoder, TextureEncoder, chord_recon_loss
from .pianotree_dec import PianoTreeDecoder, output_to_pnotree, pianotree_recon_loss
from .unet import init_vae_weights_


def kl_with_standard_normal(mu: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """mean KL(N(mu, std) || N(0, 1)) (JAX :25-28, reference utils kl_with_normal)."""
    var = std**2
    return torch.mean(0.5 * (var + mu**2 - 1.0 - torch.log(var)))


class PolyDisNoise(NamedTuple):
    """One ``run``'s randomness (JAX splits its rng into these, :66): the
    reparameterisation noise of z_chd and z_rhy (B, 256) each; the PianoTree
    decoder's time-level (32,) and note-level (32, 31) teacher-forcing coins and
    the chord decoder's (8,), bool, shared by the batch."""

    z_chd: torch.Tensor
    z_rhy: torch.Tensor
    tf1: torch.Tensor
    tf2: torch.Tensor
    tf3: torch.Tensor


class PolyDis(nn.Module):
    """The four modules at the reference's widths, on ``device`` (the GPU by
    default); with ``generator`` (a CPU one), seeded random weights
    (``init_vae_weights_``), else torch's default init."""

    def __init__(self, chd_size: int = 256, txt_size: int = 256, num_channel: int = 10, *,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.chd_encoder = ChordEncoder(36, hidden_dim=1024, z_dim=chd_size)
        self.rhy_encoder = TextureEncoder(emb_size=256, hidden_dim=1024, z_dim=txt_size,
                                          num_channel=num_channel)
        # the reference's init_model() uses PtvaeDecoder(max_simu_note=32,
        # dec_dur_hid_size=64) (polydis/model.py:303-319, ptvae.py:238-259)
        self.decoder = PianoTreeDecoder(max_simu_note=32, dec_dur_hid_size=64,
                                        z_size=chd_size + txt_size)
        self.chd_decoder = ChordDecoder(input_dim=36, z_input_dim=256, hidden_dim=512,
                                        z_dim=chd_size, n_step=8)
        if generator is not None:
            init_vae_weights_(self, generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.decoder.dec_init_input.device

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = np.array(a, dtype=np.float32)  # a writable copy (JAX arrays are read-only)
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _normals(self, like: Sequence[torch.Tensor], generator: Optional[torch.Generator],
                 noise) -> list:
        """Standard normal tensors shaped like each of ``like``: the caller's
        ``noise``, or drawn in order from ``generator`` (seeded 0 when None)."""
        if noise is not None:
            return [self._tensor(n) for n in noise]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return [torch.randn(t.shape, generator=generator, device=generator.device).to(self.device)
                for t in like]

    # -- core ----------------------------------------------------------------------------

    def encode(self, pr_mat, c):
        """prmat (B, 32, 128), chord one-hots (B, 8, 36) -> ((mu_chd, std_chd),
        (mu_rhy, std_rhy))."""
        return self.chd_encoder(self._tensor(c)), self.rhy_encoder(self._tensor(pr_mat))

    def decode_logits(self, z_chd: torch.Tensor, z_rhy: torch.Tensor):
        """Greedy decode of z_chd | z_rhy -> pitch (B, 32, 31, 130) and duration
        (B, 32, 31, 5, 2) logits."""
        return self.decoder(torch.cat([self._tensor(z_chd), self._tensor(z_rhy)], dim=-1))

    def decode(self, z_chd, z_rhy) -> np.ndarray:
        """-> estimated pnotree grid (B, 32, 31, 6), on the host as in JAX."""
        with torch.no_grad():
            return output_to_pnotree(*self.decode_logits(z_chd, z_rhy)).cpu().numpy()

    def draw_noise(self, b: int, generator: torch.Generator, tfr1: float = 0.0,
                   tfr2: float = 0.0, tfr3: float = 0.0) -> PolyDisNoise:
        """A ``run``'s noise and coins for a batch of ``b`` from ``generator``:
        each coin is true with its teacher-forcing ratio."""
        dev = generator.device
        z_c = torch.randn((b, self.chd_encoder.linear_mu.out_features), generator=generator,
                          device=dev)
        z_r = torch.randn((b, self.rhy_encoder.linear_mu.out_features), generator=generator,
                          device=dev)
        dec = self.decoder
        tf1 = torch.rand((dec.num_step,), generator=generator, device=dev) < tfr1
        tf2 = torch.rand((dec.num_step, dec.max_simu_note - 1), generator=generator,
                         device=dev) < tfr2
        tf3 = torch.rand((self.chd_decoder.n_step,), generator=generator, device=dev) < tfr3
        return PolyDisNoise(z_c, z_r, tf1, tf2, tf3)

    def run(self, x, c, pr_mat, noise: PolyDisNoise):
        """Training forward pass (JAX :111-139, reference model.py:56-77): pnotree
        ``x`` (B, 32, 32, 6), chord ``c`` (B, 8, 36), prmat (B, 32, 128)."""
        x = torch.as_tensor(x, device=self.device)
        c = self._tensor(c)
        embedded, lengths = self.decoder.emb_x(x)
        mu_c, std_c = self.chd_encoder(c)
        mu_r, std_r = self.rhy_encoder(self._tensor(pr_mat))
        z_chd = mu_c + std_c * noise.z_chd.to(self.device)
        z_rhy = mu_r + std_r * noise.z_rhy.to(self.device)
        pitch_outs, dur_outs = self.decoder(torch.cat([z_chd, z_rhy], dim=-1), embedded,
                                            lengths, noise.tf1.to(self.device),
                                            noise.tf2.to(self.device))
        recon_root, recon_chroma, recon_bass = self.chd_decoder(
            z_chd, noise.tf3.to(self.device), c)
        return (pitch_outs, dur_outs, (mu_c, std_c), (mu_r, std_r),
                recon_root, recon_chroma, recon_bass)

    def loss(self, x, c, pr_mat, noise: PolyDisNoise, beta: float = 0.1, weights=(1.0, 0.5)):
        """Full VAE loss (JAX :141-182, reference model.py:79-152): (total, terms)."""
        (pitch_outs, dur_outs, dist_chd, dist_rhy,
         recon_root, recon_chroma, recon_bass) = self.run(x, c, pr_mat, noise)
        x = torch.as_tensor(x, device=self.device)
        recon, pitch_l, dur_l = pianotree_recon_loss(x, pitch_outs, dur_outs, weights)
        kl_chd = kl_with_standard_normal(*dist_chd)
        kl_rhy = kl_with_standard_normal(*dist_rhy)
        kl = kl_chd + kl_rhy
        chord_l, root_l, chroma_l, bass_l = chord_recon_loss(
            self._tensor(c), recon_root, recon_chroma, recon_bass)
        total = recon + beta * kl + chord_l
        return total, {"loss": total, "recon": recon, "pitch": pitch_l, "dur": dur_l, "kl": kl,
                       "kl_chd": kl_chd, "kl_rhy": kl_rhy, "chord": chord_l, "root": root_l,
                       "chroma": chroma_l, "bass": bass_l}

    # -- inference utilities (JAX :186-263, reference model.py:173-301) -------------------

    def inference(self, pr_mat, c, sample: bool = False, chd_sample: bool = False,
                  generator: Optional[torch.Generator] = None, noise=None) -> np.ndarray:
        """``noise``: the (z_chd, z_rhy, chord prior) standard normal draws."""
        with torch.no_grad():
            (mu_c, std_c), (mu_r, std_r) = self.encode(pr_mat, c)
            n1, n2, n3 = self._normals((mu_c, mu_r, mu_c), generator, noise)
        z_chd = mu_c + std_c * n1 if sample else mu_c
        z_rhy = mu_r + std_r * n2 if sample else mu_r
        if chd_sample:
            z_chd = n3
        return self.decode(z_chd, z_rhy)

    def swap(self, pr_mat1, pr_mat2, c1, c2, fix_rhy: bool, fix_chd: bool) -> np.ndarray:
        pr_mat = pr_mat1 if fix_rhy else pr_mat2
        c = c1 if fix_chd else c2
        return self.inference(pr_mat, c, sample=False)

    def posterior_sample(self, pr_mat, c, scale: Optional[float] = None, sample_chd: bool = True,
                         sample_txt: bool = True, generator: Optional[torch.Generator] = None,
                         noise=None) -> np.ndarray:
        """``noise``: the (z_chd, z_rhy) standard normal draws."""
        with torch.no_grad():
            (mu_c, std_c), (mu_r, std_r) = self.encode(pr_mat, c)
            n1, n2 = self._normals((mu_c, mu_r), generator, noise)
        if scale is not None:
            std_c, std_r = std_c * scale, std_r * scale
        z_chd = mu_c + std_c * n1 if sample_chd else mu_c
        z_rhy = mu_r + std_r * n2 if sample_txt else mu_r
        return self.decode(z_chd, z_rhy)

    def prior_sample(self, x, c, sample_chd: bool = False, sample_rhy: bool = False,
                     scale: float = 1.0, generator: Optional[torch.Generator] = None,
                     noise=None) -> np.ndarray:
        """``noise``: the (z_chd, z_rhy) standard normal draws."""
        with torch.no_grad():
            (mu_c, std_c), (mu_r, std_r) = self.encode(x, c)
            n1, n2 = self._normals((mu_c, mu_r), generator, noise)
        z_chd = n1 * scale if sample_chd else mu_c + std_c * n1
        z_rhy = n2 * scale if sample_rhy else mu_r + std_r * n2
        return self.decode(z_chd, z_rhy)

    def interp(self, pr_mat1, c1, pr_mat2, c2, interp_chd: bool = False,
               interp_rhy: bool = False, int_count: int = 10) -> np.ndarray:
        """Spherical-interpolation morphs (reference model.py:245-301)."""
        with torch.no_grad():
            (mu_c1, _), (mu_r1, _) = self.encode(pr_mat1, c1)
            (mu_c2, _), (mu_r2, _) = self.encode(pr_mat2, c2)
        mu_c1, mu_r1, mu_c2, mu_r2 = (t.cpu().numpy() for t in (mu_c1, mu_r1, mu_c2, mu_r2))
        z_chds = (slerp_interp(mu_c1, mu_c2, int_count) if interp_chd
                  else np.repeat(mu_c1[:, None], int_count, axis=1))
        z_rhys = (slerp_interp(mu_r1, mu_r2, int_count) if interp_rhy
                  else np.repeat(mu_r1[:, None], int_count, axis=1))
        bs = z_chds.shape[0]
        est = self.decode(z_chds.reshape(bs * int_count, -1), z_rhys.reshape(bs * int_count, -1))
        return est.reshape(bs, int_count, *est.shape[1:])


def slerp_path(z1: np.ndarray, z2: np.ndarray, count: int = 10) -> np.ndarray:
    """Spherical interpolation with log-length blending (reference :275-301)."""
    shape = z1.shape
    z1, z2 = z1.reshape(-1), z2.reshape(-1)
    n1, n2 = np.linalg.norm(z1), np.linalg.norm(z2)
    p0, p1 = z1 / n1, z2 / n2
    omega = np.arccos(np.clip(np.dot(p0, p1), -1.0, 1.0))
    so = np.sin(omega)
    t = np.linspace(0.0, 1.0, count)
    dirs = (
        np.sin((1.0 - t) * omega)[:, None] / so * p0[None]
        + np.sin(t * omega)[:, None] / so * p1[None]
    )
    length = np.linspace(np.log(n1), np.log(n2), count)
    return (dirs * np.exp(length)[:, None]).reshape([count] + list(shape))


def slerp_interp(z1: np.ndarray, z2: np.ndarray, count: int = 10) -> np.ndarray:
    return np.stack([slerp_path(a, b, count) for a, b in zip(z1, z2)], axis=0)


class PolydisAftertouch:
    """Re-render a generated prmat + chord through PolyDis (reference
    ``polydis_aftertouch.py``). Weights: the reference checkpoint at
    ``model_path``, else, as in JAX, random ones, here from a generator seeded
    0. Runs on the GPU unless ``device`` says otherwise."""

    def __init__(self, model_path: Optional[str] = None, device: DeviceLike = None):
        self.model = PolyDis(device=device, generator=None if model_path is not None
                             else torch.Generator().manual_seed(0))
        if model_path is not None:
            self.model.load_state_dict(reference_state(model_path), strict=True)
        self.model.eval()

    def reconstruct(self, prmat, chd, fn: str, chd_sample: bool = False,
                    generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prmat (N, 32, 128), chord (N, 8, 36) -> est_x (N, 32, 31, 6), also
        written to ``fn`` as a .mid."""
        est_x = self.model.inference(prmat, chd, sample=False, chd_sample=chd_sample,
                                     generator=generator)
        estx_to_midi_file(est_x, fn)
        return est_x
