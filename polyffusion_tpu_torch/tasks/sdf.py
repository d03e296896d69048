"""The Polyffusion-SDF task (counterpart of ``polyffusion_tpu/tasks/sdf.py``):
the condition per ``cond_type`` (chord, txt, pnotree, chord+txt), each the mean
of a frozen VAE encoder or the raw feature, with classifier-free-guidance
dropout to -1s per ``cond_mode`` (cond, uncond, mix, mix2), optionally a
blurry low-resolution copy of the roll as extra input channels
(``concat_blurry``, ``sdf_concat``), and the eps-MSE diffusion loss. A
``v_prediction`` config (a distilled student, ``polyffusion_tpu_torch.distill``)
samples through the v->eps adapter and is not trained by this loss."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.loader import decompress_batch
from ..device import DeviceLike, resolve_device
from ..diffusion.gaussian import diffusion_loss, draw_t_noise
from ..diffusion.progressive import make_v_to_eps_apply
from ..diffusion.schedule import NoiseSchedule, make_schedule
from ..models.encoders import ChordEncoder, PianoTreeEncoder, TextureEncoder
from ..models.unet import UNetModel, init_weights_
from ..utils.precision import cast_sampling_params

CFG_DROP = 0.2  # the reference's random.random() < 0.2, one coin per batch
COND_TYPES = ("chord", "txt", "pnotree", "chord+txt")
SEG_STEPS = 32  # the encoders' 2-bar segment, in 16th-note steps


def refuse_unported_trainer_keys(cfg) -> None:
    """``remat`` (JAX ``tasks/sdf.py:218-221``) and ``legacy_checkpoints`` (JAX
    ``train/loop.py:128-160``) are not ported: a run that sets either would
    compute or write something other than what it asked for. A key set to
    false asks for nothing."""
    keys = [key for key in ("remat", "legacy_checkpoints") if cfg.get(key) not in (None, False)]
    if keys:
        raise NotImplementedError(
            f"{', '.join(keys)}: not ported yet (ROADMAP.md item 19)")


def blurry_image(x: torch.Tensor, ratio: float = 0.25) -> torch.Tensor:
    """NCHW ``x``: bicubic antialiased downsample by ``ratio``, nearest upsample
    back, clipped to [0, 1] (JAX ``blurry_image``, reference ``utils.py:552-567``;
    ``jax.image.resize`` antialiases a bicubic downsample)."""
    h, w = x.shape[-2:]
    small = F.interpolate(x, size=(int(h * ratio), int(w * ratio)), mode="bicubic",
                          align_corners=False, antialias=True)
    return F.interpolate(small, size=(h, w), mode="nearest").clamp(0.0, 1.0)


class StepNoise(NamedTuple):
    """The randomness of one loss evaluation: per-sample timesteps, the
    noise, the batch's CFG-dropout coin and ``mix2``'s two coins that drop
    the chord part and the texture part of a chord+txt condition (0-d bool
    tensors; a coin left None drops nothing)."""

    t: torch.Tensor
    noise: torch.Tensor
    drop: torch.Tensor
    drop_chd: Optional[torch.Tensor] = None
    drop_txt: Optional[torch.Tensor] = None


def _dropped(cond: torch.Tensor, coin: Optional[torch.Tensor]) -> torch.Tensor:
    """-1s where ``coin`` (a 0-d bool tensor) is true, chosen on the device."""
    if coin is None:
        return cond
    return torch.where(coin.to(cond.device), -torch.ones_like(cond), cond)


class SDFTask:
    def __init__(
        self,
        cfg,
        chord_enc: Optional[ChordEncoder] = None,
        txt_enc: Optional[TextureEncoder] = None,
        pnotree_enc: Optional[PianoTreeEncoder] = None,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
        training: bool = False,
        gn_conv: str = "unfused",
    ):
        """``generator``: a CPU generator from which the UNet's weights are
        drawn; without it they keep torch's default init. The encoders
        (``chord_enc``, ``txt_enc``, ``pnotree_enc``, as ``cond_type`` and
        ``use_enc`` need them) keep the weights they come with (they are
        frozen: pretrained, or random made by the caller).
        Weights are made in fp32 and, for a ``bf16`` preset, cast for sampling
        (``utils/precision.py``) after any ``load_unet_state``, unless
        ``training``: then they stay fp32, the trainer's master weights.
        ``gn_conv``: the UNet's GroupNorm-SiLU-conv route ("unfused", "fused",
        or for sampling "int8", whose int8 weights are made whenever the
        weights are placed)."""
        self.device = resolve_device(device)
        self.training = training
        self.cfg = cfg
        self.cond_type = cfg.get("cond_type", "chord")
        if self.cond_type not in COND_TYPES:
            raise NotImplementedError(f"cond_type {self.cond_type!r}")
        refuse_unported_trainer_keys(cfg)
        self.concat_blurry = bool(cfg.get("concat_blurry", False))
        self.concat_ratio = float(cfg.get("concat_ratio", 0.25))
        # a distilled student predicts v; only the session reads distill_grid
        # and distilled_scale
        self.v_prediction = bool(cfg.get("v_prediction", False))
        self.cond_mode = cfg.get("cond_mode", "cond")
        self.bf16 = bool(cfg.get("bf16", False))
        self.use_enc = bool(cfg.get("use_enc", self.cond_type == "pnotree"))
        needed = {
            "chord_enc": "chord" in self.cond_type and self.use_enc,
            "txt_enc": "txt" in self.cond_type and self.use_enc,
            "pnotree_enc": self.cond_type == "pnotree",
        }
        given = {"chord_enc": chord_enc, "txt_enc": txt_enc, "pnotree_enc": pnotree_enc}
        for name, need in needed.items():
            if need and given[name] is None:
                raise ValueError(f"cond_type {self.cond_type!r} with use_enc "
                                 f"{self.use_enc} needs {name}")
        if training and gn_conv == "int8":
            raise ValueError("gn_conv='int8' is sampling-only (no gradient): train with "
                             "'unfused' or 'fused'")
        self.gn_conv = gn_conv
        self.unet = self.make_unet()
        self.chord_enc, self.txt_enc, self.pnotree_enc = chord_enc, txt_enc, pnotree_enc
        if generator is not None:
            init_weights_(self.unet, generator)
        self.schedule = make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end)
        # the tables the loss indexes, on the device once
        self._schedule_dev = NoiseSchedule(
            *(torch.from_numpy(a).to(self.device) for a in self.schedule)
        )
        if self.v_prediction:
            # the instance's eps shadows the method, so every sampler keeps its
            # eps contract; apply_raw stays the net's own output
            self.apply_eps = make_v_to_eps_apply(self.apply_raw, self._schedule_dev)
        self._place()

    def make_unet(self) -> UNetModel:
        """A new UNet of this task's config and GroupNorm-SiLU-conv route, in
        fp32 with torch's default init, on the CPU."""
        cfg = self.cfg
        return UNetModel(
            in_channels=cfg.in_channels,
            out_channels=cfg.out_channels,
            channels=cfg.channels,
            n_res_blocks=cfg.n_res_blocks,
            attention_levels=tuple(cfg.attention_levels),
            channel_multipliers=tuple(cfg.channel_multipliers),
            n_heads=cfg.n_heads,
            tf_layers=cfg.tf_layers,
            d_cond=cfg.d_cond,
            gn_conv=self.gn_conv,
        )

    def _place(self) -> None:
        if self.bf16 and not self.training:
            cast_sampling_params(self.unet)
        self.unet.to(self.device).train(self.training)
        self.unet.prepare_gn_conv()
        for enc in (self.chord_enc, self.txt_enc, self.pnotree_enc):
            if enc is not None:
                enc.to(self.device).eval().requires_grad_(False)

    def load_unet_state(self, state_dict) -> None:
        """Strictly load fp32 UNet weights (e.g. from ``convert.unet_state_from_jax``)."""
        self.unet.float()
        self.unet.load_state_dict(state_dict, strict=True)
        self._place()

    # -- conditioning ---------------------------------------------------------

    @torch.no_grad()
    def encode_chord(self, chord: torch.Tensor) -> torch.Tensor:
        """(B, 32, 36) one-hot -> (B, 1, d). The encoder is frozen; no_grad
        (not inference_mode) keeps the result usable in a training graph."""
        chord = chord.to(self.device, torch.float32)
        if self.use_enc:
            mean, _ = self.chord_enc(chord)
            return mean[:, None, :]
        return chord.reshape(chord.shape[0], 1, -1)

    @torch.no_grad()
    def encode_txt(self, prmat: torch.Tensor) -> torch.Tensor:
        """(B, 128, 128) prmat -> the texture means of its four 2-bar segments,
        concatenated (B, 1, 4 z); or, without ``use_enc``, the prmat itself as
        128 condition tokens (JAX ``encode_txt`` :99-110)."""
        prmat = prmat.to(self.device, torch.float32)
        if not self.use_enc:
            return prmat
        zs = [self.txt_enc(seg)[0] for seg in prmat.split(SEG_STEPS, dim=1)]
        return torch.cat(zs, dim=-1)[:, None, :]

    @torch.no_grad()
    def encode_pnotree(self, pnotree: torch.Tensor) -> torch.Tensor:
        """(B, 128, 20, 6) pnotree -> the PianoTree means of its four 2-bar
        segments, concatenated (B, 1, 4 z) (JAX ``encode_pnotree`` :112-120)."""
        pnotree = pnotree.to(self.device)
        zs = [self.pnotree_enc(seg)[0] for seg in pnotree.split(SEG_STEPS, dim=1)]
        return torch.cat(zs, dim=-1)[:, None, :]

    def encode_cond(
        self,
        batch,
        generator: Optional[torch.Generator] = None,
        drop: Optional[torch.Tensor] = None,
        drop_chd: Optional[torch.Tensor] = None,
        drop_txt: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Condition per ``cond_type``, then CFG dropout per ``cond_mode`` (JAX
        ``encode_cond`` :122-156). ``batch`` is (prmat2c, pnotree, chord,
        prmat). In the mix modes the condition becomes -1s where ``drop`` (a
        0-d bool tensor) is true; ``mix2`` of chord+txt first drops the chord
        part where ``drop_chd`` is and the texture part where ``drop_txt`` is.
        A coin not given is drawn from ``generator`` (probability 0.2 each),
        or, without it, drops nothing. The choice is made on the device: it
        never waits for the card."""
        mix = self.cond_mode in ("mix", "mix2")
        parts = self.cond_type == "chord+txt" and self.cond_mode == "mix2"
        if generator is not None and mix:
            if parts:
                drop_chd = self.draw_drop(generator) if drop_chd is None else drop_chd
                drop_txt = self.draw_drop(generator) if drop_txt is None else drop_txt
            drop = self.draw_drop(generator) if drop is None else drop
        _, pnotree, chord, prmat = batch
        if self.cond_type == "chord":
            cond = self.encode_chord(chord)
        elif self.cond_type == "txt":
            cond = self.encode_txt(prmat)
        elif self.cond_type == "pnotree":
            cond = self.encode_pnotree(pnotree)
        else:
            zchd, ztxt = self.encode_chord(chord), self.encode_txt(prmat)
            if parts:
                zchd, ztxt = _dropped(zchd, drop_chd), _dropped(ztxt, drop_txt)
            cond = torch.cat([zchd, ztxt], dim=-1)
        if self.cond_mode == "uncond":
            return -torch.ones_like(cond)
        return _dropped(cond, drop) if mix else cond

    @staticmethod
    def draw_drop(generator: torch.Generator) -> torch.Tensor:
        return torch.rand((), generator=generator, device=generator.device) < CFG_DROP

    # -- training ---------------------------------------------------------------

    @property
    def model(self) -> UNetModel:
        """The trainable module: the UNet (the encoders are frozen)."""
        return self.unet

    @property
    def used_batch_fields(self):
        """Batch fields the loss reads: the feeder sends placeholders for the
        rest (``data/loader.py:DeviceFeeder``)."""
        fields = {"prmat2c"}
        if "chord" in self.cond_type:
            fields.add("chord")
        if "txt" in self.cond_type:
            fields.add("prmat")
        if self.cond_type == "pnotree":
            fields.add("pnotree")
        return fields

    def draw_noise(self, batch, generator: torch.Generator, sched=None) -> StepNoise:
        """The CFG coin, then t and the noise, then the two ``mix2`` coins,
        from ``generator`` on the device (``sched``, the trainer's scheduled
        values, steers nothing here)."""
        drop = self.draw_drop(generator)
        t, noise = draw_t_noise(self.schedule.n_steps, tuple(batch[0].shape), generator)
        return StepNoise(t, noise, drop, self.draw_drop(generator), self.draw_drop(generator))

    def loss_fn(self, batch, noise: StepNoise) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """eps-MSE loss of a (possibly compressed) batch for the given t, noise
        and coin; the UNet runs in the dtype of its weights. With
        ``concat_blurry`` the net also sees ``blurry_image(x0)``."""
        if self.v_prediction:
            raise ValueError("v-prediction checkpoints come from the distill CLI; direct "
                             "eps-objective training of a v model is unsupported")
        batch = decompress_batch(batch)
        cond = self.encode_cond(batch, drop=noise.drop, drop_chd=noise.drop_chd,
                                drop_txt=noise.drop_txt)
        x0 = batch[0].to(self.device, torch.float32)
        cond_concat = blurry_image(x0, self.concat_ratio) if self.concat_blurry else None
        loss = diffusion_loss(self.apply_eps, self._schedule_dev, x0, cond, noise.t, noise.noise,
                              cond_concat)
        return loss, {"loss": loss}

    # -- the net ----------------------------------------------------------------

    def apply_eps(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """eps prediction on NCHW ``x`` (fp32 out); a ``v_prediction`` task
        replaces it on the instance with the v->eps adapter."""
        return self.unet(x, t, cond)

    def apply_raw(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The net's own output (eps, or v for a distilled student), never
        adapted."""
        return self.unet(x, t, cond)
