"""The autoencoder's training losses: reconstruction + KL + PatchGAN
adversarial (counterpart of the JAX package's ``models/losses.py``; reference
``stable_diffusion/losses/``: ``LPIPSWithDiscriminator``,
``NLayerDiscriminator``). NCHW.

As in the JAX package: L1 plus the logvar-scaled NLL, with the per-sample
LPIPS distance broadcast into the reconstruction map when an LPIPS network is
given (``models/lpips.py``); the per-sample-summed KL; hinge or vanilla
discriminator losses gated at ``disc_start`` on the global step; and the
adaptive generator weight, the ratio of gradient norms at the decoder's last
layer (:func:`adaptive_disc_weight`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum

DiscFn = Callable[[torch.Tensor], torch.Tensor]


class TrainModeBatchNorm(nn.Module):
    """Batch-statistics normalisation with a learned scale and bias, in fp32:
    what ``nn.BatchNorm2d`` computes in training mode, without running
    averages (the discriminator only trains), so ``.eval()`` changes nothing.

    ``batch_group``: under data parallelism (``parallel.mesh.set_batch_group``)
    the statistics are those of the global batch, as GSPMD computes them on a
    dp-sharded batch: the sums are summed over the group, their gradients too
    (``SyncBatchNorm``'s scheme)."""

    keep_fp32 = True  # a bf16 model keeps the scale and bias fp32 (utils/precision.py)
    batch_group = None

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        dims = (0, 2, 3)
        group = self.batch_group
        count = xf.numel() // xf.shape[1] * (1 if group is None else dist.get_world_size(group))
        mean = all_reduce_sum(xf.sum(dims), group) / count
        centred = xf - mean[None, :, None, None]
        var = all_reduce_sum(centred.square().sum(dims), group) / count
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight.float()[None, :, None, None] + self.bias.float()[None, :, None, None]
        return y.to(x.dtype)


class LeakyReLU(nn.Module):
    """x where x >= 0, else 0.2 x: flax's ``leaky_relu``, whose gradient at 0
    is 1 (``nn.LeakyReLU``'s is the slope). Zeros are common here: a conv of
    a sparse roll's empty patches gives exactly its bias."""

    def __init__(self, slope: float = 0.2):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope * x)


class NLayerDiscriminator(nn.Module):
    """The PatchGAN discriminator (reference ``losses/discriminator.py:17``),
    its layers in the reference's ``main`` Sequential: convs of kernel 4 with
    padding 1 (stride 2, then 1 for the last two), LeakyReLU 0.2, a batch norm
    after each conv but the first and the last."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(in_channels, ndf, 4, 2, 1), LeakyReLU()]
        nf = 1
        for n in range(1, n_layers + 1):
            prev, nf = nf, min(2**n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(ndf * prev, ndf * nf, 4, stride, 1, bias=False),
                       TrainModeBatchNorm(ndf * nf), LeakyReLU()]
        layers.append(nn.Conv2d(ndf * nf, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x.to(self.main[0].weight.dtype))


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def kl_per_sample(mean: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """0.5 sum(mu^2 + var - 1 - logvar) per sample, averaged over the batch."""
    kl = 0.5 * torch.sum(mean**2 + torch.exp(log_var) - 1.0 - log_var,
                         dim=tuple(range(1, mean.dim())))
    return kl.mean()


def adaptive_disc_weight(nll_grad_last: torch.Tensor, g_grad_last: torch.Tensor,
                         disc_weight: float) -> torch.Tensor:
    """||d nll / d last|| / (||d g / d last|| + 1e-4), clipped to [0, 1e4] and
    detached, times ``disc_weight`` (reference ``calculate_adaptive_weight``)."""
    w = torch.linalg.vector_norm(nll_grad_last) / (torch.linalg.vector_norm(g_grad_last) + 1e-4)
    return w.clamp(0.0, 1e4).detach() * disc_weight


def _factor(global_step: float, disc_start: int, disc_factor: float) -> float:
    return disc_factor if global_step >= disc_start else 0.0


def ae_generator_loss(
    inputs: torch.Tensor,
    reconstructions: torch.Tensor,
    moments: Tuple[torch.Tensor, torch.Tensor],
    disc: DiscFn,
    global_step: float,
    *,
    logvar: torch.Tensor,
    disc_start: int = 50001,
    kl_weight: float = 1e-6,
    disc_weight=0.5,
    disc_factor: float = 1.0,
    p_loss: Optional[torch.Tensor] = None,
    perceptual_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The encoder / decoder side (reference ``contperceptual.py``,
    optimizer_idx 0). ``disc``: the discriminator with its parameters frozen;
    ``disc_weight``: a number or the adaptive weight (a 0-d tensor);
    ``p_loss``: per-sample LPIPS distances (B,), added to every element of the
    |x - x^| map before the NLL scaling (``contperceptual.py:72-76``)."""
    rec = torch.abs(inputs - reconstructions)
    if p_loss is not None:
        rec = rec + perceptual_weight * p_loss.reshape((-1,) + (1,) * (rec.dim() - 1))
    nll = rec / torch.exp(logvar) + logvar
    nll_loss = torch.sum(nll) / nll.shape[0]
    kl = kl_per_sample(*moments)
    g_loss = -torch.mean(disc(reconstructions))
    factor = _factor(global_step, disc_start, disc_factor)
    loss = nll_loss + kl_weight * kl + factor * disc_weight * g_loss
    return loss, {"nll_loss": nll_loss, "kl_loss": kl, "g_loss": g_loss,
                  "disc_factor": torch.tensor(factor, device=loss.device)}


def ae_discriminator_loss(
    inputs: torch.Tensor,
    reconstructions: torch.Tensor,
    disc: DiscFn,
    global_step: float,
    *,
    disc_start: int = 50001,
    disc_factor: float = 1.0,
    loss_type: str = "hinge",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The discriminator side (reference ``contperceptual.py``, optimizer_idx
    1): the discriminator on the detached inputs and reconstructions."""
    logits_real = disc(inputs.detach())
    logits_fake = disc(reconstructions.detach())
    d = hinge_d_loss if loss_type == "hinge" else vanilla_d_loss
    loss = _factor(global_step, disc_start, disc_factor) * d(logits_real, logits_fake)
    return loss, {"disc_loss": loss, "logits_real": logits_real.mean(),
                  "logits_fake": logits_fake.mean()}
