"""Generation, inpainting and long-form generation, and the inference CLI
(counterpart of ``polyffusion_tpu/inference.py``):

    python -m polyffusion_tpu_torch.inference --chkpt_path <run dir or .pt> \\
        (--data_dir <npz dir> --song_fn <song.npz> | --from_midi <song.mid>) \\
        [--inpaint_type below] [--autoreg] [--ddim | --dpmpp] [--uncond_scale 5] \\
        [--gn_conv int8 | int8_xla | s2d] [--cfg_fork] [--polydis_recon] --output_dir gen/

The sampler is DDPM (all of the schedule's steps, RePaint inpainting) unless
``--ddim`` or ``--dpmpp`` asks for a tau-grid one. ``predict`` keeps the JAX
package's layouts and argument order: conditions (B, N, d_cond) (N = 1, or the
128 prmat rows of ``sdf_txtvnl``), images (B, 2, H, W) in and out, optional
starting ``noise`` NHWC (B, H, W, C); with ``autoreg`` and a pieces axis,
conditions (P, B, N, d_cond) and output (P, 2B, C, H/2, W). The CFG
unconditional condition is the task's ``uncond_condition``: -1s of the
condition's own shape for an sdf task; for SDXL (``tasks/sdxl.py``), whose
condition is the pair (context, y) and whose images are latents, zeros of
the text parts. A
``concat_blurry`` task (``sdf_concat``) also sees the blurry image of each
request's original roll; a distilled student's run directory
(``polyffusion_tpu_torch.distill``) is sampled on its own tau grid. A MIDI file
stands in for the song with ``--from_midi`` (its chords recognized,
``data/midi_to_data.py``), and ``--polydis_recon`` re-renders each generated
piece through PolyDis; ``--dump_images`` writes PNGs of the song's forward
noising and ``--bf16_params`` samples with bf16 weights; ``--cfg_fork`` forks
CFG's double batch inside the UNet (``UNetModel``'s ``cfg_fork``). A ``ddpm``
run directory or preset takes the plain DDPM family's route
(``generate_ddpm``): unconditional DDPM-1000, or DDIM with ``--ddim``. Runs
on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from . import tracing
from .config import Params, load_params
from .convert import DDPM_PREFIXES, REFERENCE_PREFIXES, reference_unet_state
from .data.dataset import SongNpz
from .data.midi_to_data import song_from_midi
from .device import DeviceLike, resolve_device
from .diffusion import sampler as S
from .diffusion.gaussian import q_sample_step
from .diffusion.schedule import make_ddim_schedule
from .models.encoders import build_frozen_encoders
from .models.polydis import PolydisAftertouch
from .models.unet import GN_CONV_MODES
from .parallel.fsdp import shard_state_fsdp
from .parallel.mesh import batch_sharded, dp_size, replicated
from .tasks.ddpm import DDPMTask
from .tasks.sdf import SDFTask, blurry_image
from .utils.image import show_image
from .utils.midi_io import prmat2c_to_midi_file
from .utils.reprs import prmat2c_to_prmat

SAMPLERS = ("ddpm", "ddim", "dpmpp")


def _forward_fill(vals: np.ndarray, empty_marker: int) -> np.ndarray:
    """Replace ``empty_marker`` entries with the previous valid value; leading
    entries take the first valid value."""
    valid = vals != empty_marker
    if not valid.any():
        return vals.copy()
    idx = np.maximum.accumulate(np.where(valid, np.arange(len(vals)), -1))
    idx = np.where(idx < 0, np.argmax(valid), idx)
    return vals[idx]


def get_mask(orig: np.ndarray, inpaint_type: str, bar_list=None) -> np.ndarray:
    """Inpainting masks over (B, 2, 128, 128); mask == 1 marks the *kept* region."""
    b, _, n_step, n_pitch = orig.shape
    if inpaint_type == "remaining":
        return orig.copy()
    if inpaint_type in ("below", "above"):
        onset = orig[:, 0].reshape(b * n_step, n_pitch)
        cols = np.arange(n_pitch)[None, :]
        if inpaint_type == "below":
            pitch = _forward_fill(onset.argmax(axis=1), 0)  # lowest sounding pitch
            mask2d = (cols >= pitch[:, None]).astype(np.float32)
        else:
            pitch = _forward_fill(n_pitch - 1 - onset[:, ::-1].argmax(axis=1), n_pitch - 1)
            mask2d = (cols <= pitch[:, None]).astype(np.float32)
        return np.broadcast_to(mask2d.reshape(b, 1, n_step, n_pitch), orig.shape).copy()
    if inpaint_type == "bars":
        if bar_list is None:
            raise ValueError("bars inpainting needs a bar_list")
        mask = np.ones_like(orig)
        for bar in bar_list:
            mask[:, :, bar * 16 : bar * 16 + 16, :] = 0
        return mask
    raise NotImplementedError(inpaint_type)


def get_autoreg_data(data, axis: int, seg_axis: int = 0) -> torch.Tensor:
    """The 4-bar-overlap "mid" segments: (second half | next segment's first
    half) along ``axis`` (reference inference_sdf.py:121-129). ``seg_axis``
    is the 8-bar-segment axis (0 for per-piece arrays, 1 for piece-major
    (P, B, ...) stacks). Takes an array or a tensor, returns a tensor on the
    same device."""
    data = torch.as_tensor(data)
    half1, half2 = data.chunk(2, dim=axis)
    return torch.cat([half2, half1.roll(-1, seg_axis)], dim=axis)


def half_segments(a: np.ndarray) -> np.ndarray:
    """(B, C, H, W) segments -> (2B, C, H/2, W) half segments in time order,
    the layout of long-form (``autoreg``) output. JAX writes an autoreg
    inpainting's .mid with the whole-segment mask beside half-segment output
    (``inference.py:646-648``), which raises past its B-th half (fault 6)."""
    b, c, h, w = a.shape
    return a.reshape(b, c, 2, h // 2, w).transpose(0, 2, 1, 3, 4).reshape(2 * b, c, h // 2, w)


# -- checkpoints ------------------------------------------------------------------


def load_unet_params(chkpt_path: str, use_ema: bool = False, prefixes=REFERENCE_PREFIXES):
    """The fp32 UNet state dict of a checkpoint, for ``SDFTask.load_unet_state``
    (or ``DDPMTask``'s, with ``prefixes=DDPM_PREFIXES``):

    - a run directory of the port's trainer (``params.yaml``, ``chkpts/last.pt``):
      its ``params``, or with ``use_ema`` its EMA branch (raises when the run
      kept none);
    - a reference-format ``.pt`` / ``.ckpt`` (``convert.reference_unet_state``,
      which strips the first of ``prefixes`` that matches).

    A JAX orbax run directory is not read: the JAX package's converter
    (``polyffusion_tpu/convert/__main__.py --kind unet --reverse``), run where
    JAX is installed, writes its reference ``.pt`` (ROADMAP.md item 15).
    The port's own ``python -m polyffusion_tpu_torch.convert --kind unet
    --reverse`` writes one from a UNet ``.npz`` tree."""
    if os.path.isdir(chkpt_path):
        last = os.path.join(chkpt_path, "chkpts", "last.pt")
        if not os.path.exists(last):
            raise NotImplementedError(
                f"{chkpt_path} has no chkpts/last.pt: it is not a run directory of the "
                "port's trainer. For a JAX orbax run directory, run the JAX package's "
                "converter (polyffusion_tpu/convert/__main__.py) with --kind unet --reverse "
                "--input <run dir> --output weights.pt where JAX is installed, then pass that "
                ".pt (ROADMAP.md item 15)"
            )
        ckpt = torch.load(last, map_location="cpu", weights_only=True)
        if use_ema:
            if ckpt.get("ema") is None:
                raise ValueError("--use_ema: this run has no EMA branch (train with ema_decay)")
            return ckpt["ema"]
        return ckpt["params"]
    if use_ema:
        raise ValueError(
            "--use_ema needs a run directory (reference checkpoints carry no EMA branch)"
        )
    return reference_unet_state(chkpt_path, prefixes)


# -- the session --------------------------------------------------------------------


def _pull(t: torch.Tensor) -> np.ndarray:
    """A result to the host: on the card this waits for every launch before it."""
    with tracing.span("inference.pull"):
        return t.cpu().numpy()


def _outside_inference_mode(apply_fn):
    """``apply_fn`` under ``no_grad`` instead of the samplers'
    ``inference_mode``: FSDP2's gathered weights must stay ordinary tensors."""

    def apply(*args, **kwargs):
        with torch.inference_mode(False), torch.no_grad():
            return apply_fn(*args, **kwargs)

    apply.supports_cfg_fork = getattr(apply_fn, "supports_cfg_fork", False)
    return apply


class InferenceSession:
    """A task plus a sampler choice, answering generate / inpaint requests."""

    def __init__(
        self,
        task: SDFTask,
        *,
        use_ddim: bool = False,
        ddim_steps: Optional[int] = None,
        ddim_eta: float = 0.0,
        ddim_discretize: str = "uniform",
        sampler: Optional[str] = None,
        dpm_order: int = 2,
        repaint_n: int = 1,
        seed: int = 0,
        device: DeviceLike = None,
        mesh=None,
        fsdp_params: bool = False,
        cfg_fork: bool = False,
    ):
        """``sampler``: "ddpm" (ancestral, over all of the schedule's steps,
        with RePaint inpainting), "ddim" or "dpmpp" (DPM-Solver++ on the DDIM
        tau grid); by default "ddim" if ``use_ddim`` else "ddpm", as in the
        JAX package. ``ddim_steps``: the tau grid's size; None means the
        distilled checkpoint's own grid (``distill_grid``), on which the
        tau-grid samplers then run exactly, or else 50.

        ``mesh``: a dp mesh (``parallel.make_mesh``): the requests are
        batch-sharded over it. Every rank holds the same global inputs and
        noise (the same seed), runs the net on its rows of each evaluation's
        batch and gathers the rest, so ``predict`` returns the whole batch on
        every rank; the batch must divide the mesh size. ``fsdp_params``:
        with ``mesh``, the UNet's weights are ZeRO-3 sharded over dp
        (``parallel.fsdp.shard_state_fsdp``, each block gathered for its
        forward and freed after it) instead of replicated. ``cfg_fork``: every
        sampler forks CFG's double batch inside the UNet (JAX's
        ``POLYFF_CFG_FORK=1``; ``diffusion/sampler.py:make_eps_fn``), where
        the task's eps advertises it (a distilled student's does not); on a
        mesh each rank forks its own rows."""
        self.device = resolve_device(device)
        if self.device != task.device:
            raise ValueError(f"task lies on {task.device}, session asked for {self.device}")
        if fsdp_params and mesh is None:
            raise ValueError("fsdp_params=True needs a dp mesh (parallel.make_mesh)")
        self.mesh = mesh
        self.cfg_fork = cfg_fork
        self.apply_eps = task.apply_eps
        if mesh is not None:
            replicated(task.unet)
            if fsdp_params:
                shard_state_fsdp(task.unet, mesh)
                self.apply_eps = _outside_inference_mode(self.apply_eps)
            self.apply_eps = batch_sharded(self.apply_eps, mesh)
        if sampler is None:
            sampler = "ddim" if use_ddim else "ddpm"
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        self.task = task
        self.cfg = task.cfg
        self.schedule = task.schedule
        self.sampler_kind = sampler
        self.dpm_order = dpm_order
        self.use_ddim = sampler in ("ddim", "dpmpp")  # tau-grid samplers
        self.repaint_n = repaint_n
        # a distilled student (distill.py) carries its tau grid and the CFG
        # scale it bakes in; a stage-B student must be sampled on that grid
        # (a stage-A-only student has none and samples on any)
        grid = task.cfg.get("distill_grid")
        self.distilled_scale = (
            task.cfg.get("distilled_scale") if task.cfg.get("v_prediction") else None
        )
        self._scale_warned = False
        if grid is not None and not self.use_ddim:
            print(
                "[inference] WARNING: distilled (stage-B) checkpoint sampled with "
                f"the {self.schedule.n_steps}-step ancestral DDPM sampler — the "
                f"student was trained only on its {len(grid)}-step grid; use the "
                "ddim/dpmpp sampler"
            )
        if ddim_steps is None:
            ddim_steps = 50 if grid is None else len(grid)
            if grid is not None and self.use_ddim:
                print(f"[inference] distilled checkpoint: using its {ddim_steps}-step grid")
        on_grid = self.use_ddim and grid is not None and ddim_steps == len(grid)
        self.ddim = (
            make_ddim_schedule(self.schedule, ddim_steps, ddim_discretize, ddim_eta,
                               time_steps=np.asarray(grid) if on_grid else None)
            if self.use_ddim
            else None
        )
        if self.use_ddim and grid is not None and not on_grid:
            print(
                f"[inference] note: distilled grid has {len(grid)} steps; sampling "
                f"on a uniform {ddim_steps}-step grid instead (valid for stage-A "
                f"students, off-distribution for stage-B ones)"
            )
        self.ddim_label = (
            f"dpmpp{dpm_order}m_{ddim_steps}_{ddim_discretize}"
            if sampler == "dpmpp"
            else f"ddim{ddim_steps}_eta{ddim_eta}_"
            + ("distilled" if on_grid else ddim_discretize)
        )
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _check_batch(self, b: int) -> None:
        n = dp_size(self.mesh)
        if b % n:
            raise ValueError(f"batch {b} must divide over the mesh's {n} dp ranks")

    @property
    def t_idx(self) -> int:
        return (self.ddim.n_steps if self.use_ddim else self.schedule.n_steps) - 1

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _q_sample_start(self, orig_nhwc, noise):
        if self.use_ddim:
            return S.ddim_q_sample(self.ddim, orig_nhwc, self.t_idx, noise)
        return q_sample_step(self.schedule, orig_nhwc, self.t_idx, noise)

    def _cond_concat_of(self, orig_nhwc):
        """A ``concat_blurry`` task's extra input channels: the blurry image of
        ``orig`` (all zero for plain generation, whose blurry image is 0), NHWC."""
        if not self.task.concat_blurry:
            return None
        blurry = blurry_image(orig_nhwc.permute(0, 3, 1, 2), self.task.concat_ratio)
        return blurry.permute(0, 2, 3, 1)

    def _paint(self, x, cond, orig, mask, orig_noise, uncond_cond, uncond_scale: float):
        """The sampler from ``t_idx`` down, NHWC in and out. DDPM re-noises the
        known region with fresh noise at every step (it reads no
        ``orig_noise``); the tau-grid samplers with ``orig_noise``."""
        common = dict(orig=orig, mask=mask, uncond_scale=uncond_scale, uncond_cond=uncond_cond,
                      cond_concat=self._cond_concat_of(orig), cfg_fork=self.cfg_fork)
        if self.sampler_kind == "dpmpp":
            return S.dpmpp_paint(self.apply_eps, self.ddim, x, cond, self.t_idx,
                                 self.generator, orig_noise=orig_noise, order=self.dpm_order,
                                 **common)
        if self.sampler_kind == "ddim":
            return S.ddim_paint(self.apply_eps, self.ddim, x, cond, self.t_idx,
                                self.generator, orig_noise=orig_noise, **common)
        return S.ddpm_paint(self.apply_eps, self.schedule, x, cond, self.t_idx,
                            self.generator, repaint_n=self.repaint_n, **common)

    def predict(
        self,
        cond,
        cond_mid=None,
        uncond_scale: float = 1.0,
        autoreg: bool = False,
        orig: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        noise=None,
    ) -> np.ndarray:
        """Generate (or, with ``orig`` and ``mask``, inpaint) (B, C, H, W) images.
        ``cond``: (B, N, d_cond), or a tuple of parts with B rows each (the
        task's own form: SDXL's (context, y)).

        Starts from q_sample(orig, t_idx) and paints with ``mask`` (all zero
        for plain generation); the starting ``noise`` (NHWC, drawn from the
        session's generator when omitted) is also the tau-grid samplers'
        fixed ``orig_noise``. With ``autoreg``: 2B-1 sliding 8-bar windows,
        each forcing its first 4 bars to the previous window's last 4
        (``cond_mid`` holds the B-1 mid-window conditions); a leading pieces
        axis on ``cond`` runs P pieces at batch P (``_predict_autoreg``)."""
        with tracing.span("inference.predict"):
            if self.distilled_scale is not None and uncond_scale != 1.0 and not self._scale_warned:
                self._scale_warned = True
                print(
                    f"[inference] note: this student bakes in CFG scale "
                    f"{self.distilled_scale}; sample it at --uncond_scale 1 "
                    f"(got {uncond_scale}: that guidance applies ON TOP)"
                )
            if autoreg:
                if cond_mid is None:
                    raise ValueError("autoreg needs the mid-window conditions")
                if np.ndim(cond) == 4:  # (P, B, N, d): piece-batched
                    return self._predict_autoreg(cond, cond_mid, uncond_scale, orig, mask, noise)
                out = self._predict_autoreg(
                    self._tensor(cond)[None],
                    self._tensor(cond_mid)[None],
                    uncond_scale,
                    None if orig is None else np.asarray(orig)[None],
                    None if mask is None else np.asarray(mask)[None],
                    None if noise is None else self._tensor(noise)[None],
                )
                return out[0]

            cond = (tuple(self._tensor(part) for part in cond) if isinstance(cond, tuple)
                    else self._tensor(cond))
            b = (cond[0] if isinstance(cond, tuple) else cond).shape[0]
            self._check_batch(b)
            h, w, c = self.cfg.img_h, self.cfg.img_w, self.cfg.out_channels
            uncond_cond = self.task.uncond_condition(cond)
            if orig is None or mask is None:
                orig = np.zeros((b, c, h, w), np.float32)
                mask = np.zeros_like(orig)
            orig_nhwc = self._tensor(orig).permute(0, 2, 3, 1)
            mask_nhwc = self._tensor(mask).permute(0, 2, 3, 1)
            if noise is None:
                noise = torch.randn((b, h, w, c), generator=self.generator, device=self.device)
            noise = self._tensor(noise)
            xt = self._q_sample_start(orig_nhwc, noise)
            gen = self._paint(xt, cond, orig_nhwc, mask_nhwc, noise, uncond_cond, uncond_scale)
            return _pull(gen.permute(0, 3, 1, 2))

    def _predict_autoreg(self, conds, cond_mids, uncond_scale: float, origs=None, masks=None,
                         noise=None) -> np.ndarray:
        """Piece-batched sliding-window generation.

        ``conds``: (P, B, N, d_cond); ``cond_mids``: (P, B-1, N, d_cond);
        ``origs`` / ``masks``: optional (P, B, C, H, W); ``noise``: optional
        (P, B, H, W, C). The windows of a piece are sequential (each forces
        its first half to the previous window's output); the P pieces ride
        each window together at batch P. Everything stays on the device until
        the one pull at the end. Returns (P, 2B, C, H/2, W)."""
        conds, cond_mids = self._tensor(conds), self._tensor(cond_mids)
        p, b = conds.shape[:2]
        self._check_batch(p)
        h, w, c = self.cfg.img_h, self.cfg.img_w, self.cfg.out_channels
        half = h // 2
        if origs is None or masks is None:
            origs = np.zeros((p, b, c, h, w), np.float32)
            masks = np.zeros_like(origs)
        orig = self._tensor(origs).permute(0, 1, 3, 4, 2)  # (P, B, H, W, C)
        mask = self._tensor(masks).permute(0, 1, 3, 4, 2)
        if noise is None:
            noise = torch.randn((p, b, h, w, c), generator=self.generator, device=self.device)
        noise = self._tensor(noise)
        # mid windows: time axis 2, segment axis 1 (piece-major)
        orig_mid, mask_mid, noise_mid = (get_autoreg_data(v, axis=2, seg_axis=1)
                                         for v in (orig, mask, noise))
        uncond = -torch.ones_like(conds[:, 0])

        gen = []  # (P, half, W, C) tensors on the device
        prev_half = None
        for idx in range(2 * b - 1):
            j = idx // 2
            if idx % 2:
                cw, o, m, nz = cond_mids[:, j], orig_mid[:, j], mask_mid[:, j], noise_mid[:, j]
            else:
                cw, o, m, nz = conds[:, j], orig[:, j], mask[:, j], noise[:, j]
            if idx:
                # the stacks are read again by later windows: write into copies
                o, m = o.clone(), m.clone()
                o[:, :half] = prev_half
                m[:, :half] = 1.0
            xt = self._q_sample_start(o, nz)
            x0 = self._paint(xt, cw, o, m, nz, uncond, uncond_scale)
            if idx == 0:
                gen.append(x0[:, :half])
            prev_half = x0[:, half:]
            gen.append(prev_half)
        return _pull(torch.stack(gen, dim=1).permute(0, 1, 4, 2, 3))

    # -- user-facing ops --------------------------------------------------------

    def _stamp(self, head: str, uncond_scale: float, autoreg: bool) -> str:
        return (
            f"{head}[scale={uncond_scale}"
            f"{',autoreg' if autoreg else ''}"
            f"{',' + self.ddim_label if self.use_ddim else ''}]"
            f"_{datetime.now().strftime('%y-%m-%d_%H%M%S')}"
        )

    def generate(
        self,
        cond,
        cond_mid=None,
        uncond_scale: float = 1.0,
        autoreg: bool = False,
        output_dir: Optional[str] = None,
        model_label: str = "sdf",
        no_output: bool = False,
    ) -> np.ndarray:
        """Generated prmat2c images; with ``output_dir``, also one .mid per
        piece (5-D piece-batched output) or one for the batch."""
        gen = self.predict(cond, cond_mid, uncond_scale, autoreg)
        if not no_output and output_dir:
            stamp = self._stamp(model_label, uncond_scale, autoreg)
            os.makedirs(output_dir, exist_ok=True)
            if gen.ndim == 5:
                for p in range(gen.shape[0]):
                    prmat2c_to_midi_file(gen[p], os.path.join(output_dir, f"{stamp}_{p}.mid"))
            else:
                prmat2c_to_midi_file(gen, os.path.join(output_dir, f"{stamp}.mid"))
        return gen

    def inpaint(
        self,
        orig: np.ndarray,
        inpaint_type: str,
        cond,
        cond_mid=None,
        autoreg: bool = False,
        uncond_scale: float = 1.0,
        bar_list=None,
        output_dir: Optional[str] = None,
        model_label: str = "sdf",
        no_output: bool = False,
    ):
        """Regenerate the region ``get_mask`` leaves free; returns (gen, mask)."""
        mask = get_mask(orig, inpaint_type, bar_list)
        gen = self.predict(cond, cond_mid, uncond_scale, autoreg, orig, mask)
        if not no_output and output_dir:
            head = f"{model_label}_inp{self.repaint_n}_{inpaint_type}"
            os.makedirs(output_dir, exist_ok=True)
            path = os.path.join(output_dir, self._stamp(head, uncond_scale, autoreg) + ".mid")
            prmat2c_to_midi_file(gen, path, inp_mask=half_segments(mask) if autoreg else mask)
        return gen, mask


# -- conditions from data ------------------------------------------------------------


def song_conditions(task: SDFTask, song_data, length: int = 0, autoreg: bool = False):
    """Whole-song (prmat2c, pnotree, chord, prmat) -> (cond, cond_mid,
    prmat2c), the conditions as NumPy (N, n_cond, d) without CFG dropout;
    cond_mid (the mid windows' conditions, from the 4-bar-shifted chord,
    pnotree and prmat) only with ``autoreg`` (JAX ``song_conditions``
    :657-690)."""
    prmat2c, pnotree, chord, prmat = song_data
    if length and length > 0:
        prmat2c, pnotree, chord, prmat = (v[:length] for v in (prmat2c, pnotree, chord, prmat))

    def encode(pt, chd, pr):
        batch = (None, torch.as_tensor(pt), torch.as_tensor(chd), torch.as_tensor(pr))
        return task.encode_cond(batch).cpu().numpy()

    cond = encode(pnotree, chord, prmat)
    cond_mid = None
    if autoreg:
        cond_mid = encode(*(get_autoreg_data(v, axis=1) for v in (pnotree, chord, prmat)))
    return cond, cond_mid, np.asarray(prmat2c)


def build_task_for_inference(cfg: Params, pretrained_dir: Optional[str] = None,
                             device: DeviceLike = None, gn_conv: str = "unfused",
                             bf16_params: bool = False) -> SDFTask:
    """The ``sdf*`` task of ``cfg`` with its frozen encoders from
    ``pretrained_dir``; its UNet weights come from ``load_unet_params``.
    ``gn_conv``: the UNet's GroupNorm-SiLU-conv route ("unfused", "fused",
    "int8", "int8_xla" or "s2d"). ``bf16_params``: the UNet's weights cast to bf16 for sampling
    (``utils/precision.py:cast_sampling_params``) even for an fp32 preset.
    A ``ddpm`` config has its own route, ``generate_ddpm``."""
    if cfg.get("model_name") == "ddpm":
        raise ValueError("model_name ddpm is the plain DDPM family: sample it with "
                         "generate_ddpm (the CLI takes that route by itself)")
    return SDFTask(cfg, **build_frozen_encoders(cfg, pretrained_dir), device=device,
                   gn_conv=gn_conv, bf16_params=bf16_params)


# the CLI's flags that the unconditional DDPM family does not take, with their defaults
DDPM_UNUSED_FLAGS = {"uncond_scale": 1.0, "autoreg": False, "dpmpp": False,
                     "inpaint_type": None, "from_midi": None, "from_midi2": None,
                     "inpaint_from_midi": None, "inpaint_song_fn": None,
                     "polydis_recon": False, "split_inpaint": False, "gn_conv": "unfused",
                     "bf16_params": False, "dump_images": False, "cfg_fork": False}


def generate_ddpm(cfg: Params, args) -> list:
    """Unconditional generation with the plain DDPM family (JAX
    ``inference.py:_main_ddpm`` :707-746): ``--num_generate`` batches of
    ``max(--length, 1)`` images from N(0, I) (a generator on the device seeded
    by ``--seed``), each sampled by DDPM over all of the schedule's steps, or
    with ``--ddim`` by DDIM on ``--ddim_steps`` (default 50) of the tau grid,
    and written to ``ddpm_<stamp>_<i>.mid``. Returns the images, (B, C, H, W)
    each."""
    given = [f"--{k}" for k, default in DDPM_UNUSED_FLAGS.items() if getattr(args, k) != default]
    if given:
        raise SystemExit(f"{', '.join(given)}: not taken by the unconditional ddpm family")
    task = DDPMTask(cfg, device=args.device)
    task.load_unet_state(load_unet_params(args.chkpt_path, use_ema=args.use_ema,
                                          prefixes=DDPM_PREFIXES))
    generator = torch.Generator(device=task.device).manual_seed(args.seed)
    b = max(args.length, 1)
    shape = (b, cfg.get("image_size_h", 128), cfg.get("image_size_w", 128),
             cfg.get("image_channels", 2))
    cond = torch.zeros((b, 1, 1), device=task.device)  # read by no layer, as JAX's
    os.makedirs(args.output_dir, exist_ok=True)
    outputs = []
    for i in range(args.num_generate):
        x_last = torch.randn(shape, generator=generator, device=task.device)
        if args.ddim:
            dd = make_ddim_schedule(task.schedule, args.ddim_steps or 50, args.ddim_discretize,
                                    args.ddim_eta)
            gen = S.ddim_sample(task.apply_eps, dd, x_last, cond, generator)
        else:
            gen = S.ddpm_sample(task.apply_eps, task.schedule, x_last, cond, generator)
        out = gen.permute(0, 3, 1, 2).float().cpu().numpy()
        stamp = datetime.now().strftime("%y-%m-%d_%H%M%S")
        prmat2c_to_midi_file(out, os.path.join(args.output_dir, f"ddpm_{stamp}_{i}.mid"))
        outputs.append(out)
    print(f"wrote {args.num_generate} output(s) to {args.output_dir}")
    return outputs


def dump_q_images(schedule, prmat2c: np.ndarray, img_dir: str, seed: int) -> list:
    """The forward-noising sequence of the first segment as PNGs (JAX
    ``inference.py:919-941``, reference ``Experiments.show_q_imgs``):
    ``q0.png``, the segment itself, then ``q{step + 1}.png``, q_sample at every
    ``n_steps // 10``-th step, each with fresh noise from a CPU generator
    seeded by ``seed``. Returns the paths written."""
    os.makedirs(img_dir, exist_ok=True)
    first = np.asarray(prmat2c[:1], np.float32)
    paths = [os.path.join(img_dir, "q0.png")]
    show_image(first, paths[0])
    src = torch.from_numpy(first).permute(0, 2, 3, 1)
    generator = torch.Generator().manual_seed(seed)
    for step in range(0, schedule.n_steps, max(schedule.n_steps // 10, 1)):
        noised = q_sample_step(schedule, src, step,
                               torch.randn(src.shape, generator=generator))
        paths.append(os.path.join(img_dir, f"q{step + 1}.png"))
        show_image(noised.permute(0, 3, 1, 2).numpy(), paths[-1])
    return paths


def polydis_recon(aftertouch: PolydisAftertouch, gen: np.ndarray, chord: np.ndarray, fn: str,
                  chd_sample: bool = False) -> np.ndarray:
    """Re-render generated prmat2c images ``gen`` (N, 2, T, 128) through PolyDis
    on 2-bar windows, with the song's chord one-hots ``chord`` (S, 32, 36) in
    8-beat windows, into ``fn`` (JAX ``inference.py:987-1007``). Returns est_x."""
    prmat = prmat2c_to_prmat(gen)
    chd = np.asarray(chord)[: prmat.shape[0]]
    # PolyDis operates on 2-bar (32-step) windows with 8-beat chords
    chd8 = chd.reshape(-1, 4, 8, 36)[: prmat.shape[0] // 4].reshape(-1, 8, 36)
    n = min(prmat.shape[0], chd8.shape[0])
    return aftertouch.reconstruct(prmat[:n].astype(np.float32), chd8[:n].astype(np.float32), fn,
                                  chd_sample=chd_sample)


# -- CLI ------------------------------------------------------------------------------


def main(argv=None):
    """The CLI. Returns what it generated: a list with one entry per
    ``--num_generate`` (``generate``'s array, or ``inpaint``'s (gen, mask)),
    or one piece-batched array; ``None`` for ``--split_inpaint``."""
    p = argparse.ArgumentParser(description="polyffusion_tpu_torch generation / inpainting")
    p.add_argument("--model", default=None,
                   help="params preset name or yaml (default: the run dir's params.yaml, "
                   "else sdf_chd8bar)")
    p.add_argument("--chkpt_path", required=True,
                   help="run dir of the port's trainer, or a reference .pt/.ckpt")
    p.add_argument("--uncond_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--length", type=int, default=0, help="number of 8-bar segments (0 = whole song)")
    p.add_argument("--num_generate", type=int, default=1)
    p.add_argument("--autoreg", action="store_true")
    p.add_argument("--ddim", action="store_true")
    p.add_argument("--ddim_steps", type=int, default=None,
                   help="tau grid size (default: 50, or a distilled checkpoint's own grid)")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--ddim_discretize", default="uniform", choices=["uniform", "quad"])
    p.add_argument("--dpmpp", action="store_true",
                   help="DPM-Solver++ multistep ODE sampler on the tau grid (--ddim_steps)")
    p.add_argument("--dpm_order", type=int, default=2, choices=[1, 2])
    p.add_argument("--repaint_n", type=int, default=1)
    p.add_argument("--inpaint_type", default=None, choices=[None, "remaining", "below", "above", "bars"])
    p.add_argument("--bar_list", default=None, help="comma-separated bars for --inpaint_type bars")
    p.add_argument("--data_dir", default=None,
                   help="npz dir for conditioning/inpainting source (needed without --from_midi)")
    p.add_argument("--song_fn", default=None, help="song npz filename")
    p.add_argument("--split_file", default=None, help="pickled (train, val) split; choose from val")
    p.add_argument("--song_index", type=int, default=0, help="index into the val split")
    p.add_argument("--from_midi", default=None,
                   help="condition from an arbitrary MIDI file instead of --data_dir/--song_fn")
    p.add_argument("--from_midi2", default=None,
                   help="texture (prmat) source MIDI for chord+txt models, both songs cut to the "
                   "shorter; ignored (with a note) for other condition types, as in JAX")
    p.add_argument("--inpaint_from_midi", default=None,
                   help="MIDI supplying the song to be inpainted (default: the conditioning song)")
    p.add_argument("--inpaint_song_fn", default=None, help="npz song (in --data_dir) to be inpainted")
    p.add_argument("--pretrained_dir", default=None, help="dir with pretrained encoder checkpoints")
    p.add_argument("--output_dir", default="exp")
    p.add_argument("--polydis_recon", action="store_true",
                   help="also re-render each generated piece through PolyDis into "
                   "polydis_recon_<i>.mid (generation only: not after --inpaint_type)")
    p.add_argument("--polydis_path", default=None,
                   help="PolyDis checkpoint in the reference's layout (model_master_final.pt); "
                   "without it PolyDis has random weights from a generator seeded 0, as JAX's "
                   "random init")
    p.add_argument("--polydis_chd_resample", action="store_true",
                   help="resample the chord latent from the prior in the PolyDis re-rendering")
    p.add_argument("--split_inpaint", action="store_true",
                   help="only split the source prmat2c by the inpainting mask into a two-track "
                   "MIDI and exit")
    p.add_argument("--use_ema", action="store_true",
                   help="sample from the EMA parameter branch (runs trained with ema_decay)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--gn_conv", default="unfused", choices=list(GN_CONV_MODES),
                   help="the UNet's GroupNorm-SiLU-conv3x3 sites: as three modules, through "
                   "the fused kernel, through its int8 form, as three modules with the "
                   "convs as exact int8 products (int8_xla), or unfused with level 0 "
                   "space-to-depth folded (s2d)")
    p.add_argument("--cfg_fork", action="store_true",
                   help="fork CFG's double batch inside the UNet: the condition-free layers "
                   "before its first cross-attention run once at the request's batch")
    p.add_argument("--bf16_params", action="store_true",
                   help="cast the UNet's weights to bf16 for sampling (norms stay fp32), also "
                   "for an fp32 preset")
    p.add_argument("--dump_images", action="store_true",
                   help="write PNGs of the song's first segment and of its forward noising "
                   "(q0.png, then q<step+1>.png every n_steps // 10 steps) into <output_dir>/img")
    args = p.parse_args(argv)

    run_params = os.path.join(args.chkpt_path, "params.yaml")
    if args.model is None and os.path.isdir(args.chkpt_path) and os.path.exists(run_params):
        cfg = load_params(run_params)
    else:
        cfg = load_params(args.model or "sdf_chd8bar")
    if cfg.get("model_name") == "ddpm":
        return generate_ddpm(cfg, args)
    task = build_task_for_inference(cfg, args.pretrained_dir, device=args.device,
                                    gn_conv=args.gn_conv, bf16_params=args.bf16_params)
    task.load_unet_state(load_unet_params(args.chkpt_path, use_ema=args.use_ema))
    session = InferenceSession(
        task,
        use_ddim=args.ddim,
        ddim_steps=args.ddim_steps,
        ddim_eta=args.ddim_eta,
        ddim_discretize=args.ddim_discretize,
        sampler="dpmpp" if args.dpmpp else None,
        dpm_order=args.dpm_order,
        repaint_n=args.repaint_n,
        seed=args.seed,
        device=args.device,
        cfg_fork=args.cfg_fork,
    )

    if args.from_midi:
        song_data = song_from_midi(args.from_midi).get_whole_song_data()
    else:
        if not args.data_dir:
            raise SystemExit("--data_dir (or --from_midi) is required")
        song_fn = args.song_fn
        if song_fn is None and args.split_file:
            with open(args.split_file, "rb") as f:
                split = pickle.load(f)
            song_fn = split[1][args.song_index]
        if not song_fn:
            raise SystemExit("--song_fn or --split_file is required")
        song_data = SongNpz(song_fn, args.data_dir).get_whole_song_data()

    # chord+txt: optionally take the texture (prmat) from a second MIDI
    if args.from_midi2:
        if task.cond_type == "chord+txt":
            song2 = song_from_midi(args.from_midi2).get_whole_song_data()
            n = min(song_data[0].shape[0], song2[0].shape[0])
            song_data = (song_data[0][:n], song_data[1][:n], song_data[2][:n], song2[3][:n])
        else:
            print(f"[inference] note: --from_midi2 ignored: cond_type is {task.cond_type!r}, "
                  "not 'chord+txt'")
    cond, cond_mid, prmat2c = song_conditions(task, song_data, args.length, args.autoreg)

    # the inpainting source may come from another song or MIDI
    if args.inpaint_from_midi or args.inpaint_song_fn:
        if args.inpaint_from_midi:
            inp_song = song_from_midi(args.inpaint_from_midi)
        else:
            inp_song = SongNpz(args.inpaint_song_fn, args.data_dir)
        prmat2c_inp = inp_song.get_whole_song_data()[0]
        n = min(len(cond), prmat2c_inp.shape[0])
        cond, prmat2c = cond[:n], prmat2c_inp[:n]
        if cond_mid is not None:
            cond_mid = cond_mid[: max(n - 1, 0)]

    label = cfg.get("model_name", "sdf")
    bar_list = [int(x) for x in args.bar_list.split(",")] if args.bar_list else None

    if args.split_inpaint:
        if not args.inpaint_type:
            raise SystemExit("--split_inpaint requires --inpaint_type")
        mask = get_mask(prmat2c, args.inpaint_type, bar_list)
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir, f"{label}_split_{args.inpaint_type}.mid")
        prmat2c_to_midi_file(prmat2c, out, inp_mask=mask)
        print(f"split written to {out}")
        return None

    if args.dump_images:
        dump_q_images(session.schedule, prmat2c, os.path.join(args.output_dir, "img"), args.seed)

    aftertouch = (PolydisAftertouch(model_path=args.polydis_path, device=args.device)
                  if args.polydis_recon else None)

    # piece-batched long-form: N independent pieces ride the same 2B-1 windows
    # at batch N in one pass (the reference's --num_generate loop is serial);
    # the aftertouch path keeps the loop
    if args.autoreg and args.num_generate > 1 and not args.inpaint_type and aftertouch is None:
        conds = np.broadcast_to(cond[None], (args.num_generate,) + cond.shape).copy()
        cond_mids = np.broadcast_to(cond_mid[None], (args.num_generate,) + cond_mid.shape).copy()
        gen = session.generate(conds, cond_mids, uncond_scale=args.uncond_scale, autoreg=True,
                               output_dir=args.output_dir, model_label=label)
        print(f"wrote {args.num_generate} output(s) to {args.output_dir} (piece-batched)")
        return [gen]

    outputs = []
    for i in range(args.num_generate):
        if args.inpaint_type:
            outputs.append(session.inpaint(
                prmat2c, args.inpaint_type, cond, cond_mid, autoreg=args.autoreg,
                uncond_scale=args.uncond_scale, bar_list=bar_list,
                output_dir=args.output_dir, model_label=label,
            ))
        else:
            gen = session.generate(
                cond, cond_mid, uncond_scale=args.uncond_scale, autoreg=args.autoreg,
                output_dir=args.output_dir, model_label=label,
            )
            outputs.append(gen)
            if aftertouch is not None:
                polydis_recon(aftertouch, gen, song_data[2],
                              os.path.join(args.output_dir, f"polydis_recon_{i}.mid"),
                              chd_sample=args.polydis_chd_resample)
    print(f"wrote {args.num_generate} output(s) to {args.output_dir}")
    return outputs


if __name__ == "__main__":
    main()
