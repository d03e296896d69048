"""The LPIPS perceptual distance on VGG16 features (counterpart of the JAX
package's ``models/lpips.py``; reference ``stable_diffusion/losses/lpips.py:12``,
the stripped richzhang/PerceptualSimilarity metric): scale-shift the RGB
input, run the VGG16 ``features`` trunk, unit-normalise the channels of the
five relu taps (relu1_2, 2_2, 3_3, 4_3, 5_3), square the difference, a 1x1
"lin" conv per tap, average over the positions, sum. NCHW.

No pretrained weights are downloaded: the autoencoder task switches the term
on only where its config names a checkpoint (``lpips_path``), read by
:func:`lpips_state_from_torch`. The module keeps the reference's names
(``net.slice1.0.weight`` .. ``net.slice5.28.weight``, ``lin0.model.1.weight``
.. ``lin4``), so a reference LPIPS state dict maps onto it by name.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

# torchvision vgg16.features conv indices -> output channels; the reference's
# five slices end after the relu of convs 2, 7, 14, 21 and 28 (features [0:4),
# [4:9), [9:16), [16:23), [23:30)), each later one starting with a max pool
VGG_CONVS = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256,
             17: 512, 19: 512, 21: 512, 24: 512, 26: 512, 28: 512}
SLICE_BOUNDS = (0, 4, 9, 16, 23, 30)
CHNS = (64, 128, 256, 512, 512)

# ScalingLayer constants (reference lpips.py:70-77)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 ``features`` trunk as the reference's ``slice1`` .. ``slice5``,
    each layer under its torchvision index; returns the five relu taps."""

    def __init__(self):
        super().__init__()
        in_c = 3
        for s in range(5):
            block = nn.Sequential()
            for idx in range(SLICE_BOUNDS[s], SLICE_BOUNDS[s + 1]):
                if idx in VGG_CONVS:
                    layer = nn.Conv2d(in_c, VGG_CONVS[idx], 3, padding=1)
                    in_c = VGG_CONVS[idx]
                elif idx in SLICE_BOUNDS[1:-1]:
                    layer = nn.MaxPool2d(2, 2)
                else:
                    layer = nn.ReLU()
                block.add_module(str(idx), layer)
            setattr(self, f"slice{s + 1}", block)

    def forward(self, x: torch.Tensor):
        taps = []
        for s in range(5):
            x = getattr(self, f"slice{s + 1}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """The 1x1 "lin" conv of a tap; index 0 stands where the reference keeps
    its Dropout."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


def _unit_normalize(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(t.float() ** 2, dim=1, keepdim=True))
    return t / (norm + eps).to(t.dtype)


class LPIPS(nn.Module):
    """d(x, y) for each item, shape (B,); computes in the dtype of its weights."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for k, c in enumerate(CHNS):
            setattr(self, f"lin{k}", NetLinLayer(c))
        self.register_buffer("shift", torch.tensor(SHIFT)[None, :, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE)[None, :, None, None], persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dtype = self.net.slice1[0].weight.dtype

        def prep(t):
            return ((t.float() - self.shift) / self.scale).to(dtype)

        total = 0.0
        for k, (tx, ty) in enumerate(zip(self.net(prep(x)), self.net(prep(y)))):
            diff = (_unit_normalize(tx) - _unit_normalize(ty)) ** 2
            val = getattr(self, f"lin{k}").model(diff)
            total = total + val.mean(dim=(1, 2, 3))
        return total


def lpips_state_from_torch(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torch LPIPS state dict -> this module's, by name, for a strict load:
    the reference checkpoint's ``net.sliceN.<idx>.weight/bias`` and
    ``lin{k}.model.1.weight``, or torchvision's ``features.<idx>.weight/bias``
    for the trunk (as the JAX package's ``lpips_params_from_torch`` reads
    them); other keys (the reference's ``scaling_layer`` buffers, the
    classifier) are left out."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[0].startswith("lin") and key.endswith(".model.1.weight"):
            out[key] = val
        elif parts[0] in ("net", "features") and len(parts) >= 3:
            idx = int(parts[-2])
            if idx not in VGG_CONVS:
                continue
            s = next(s for s in range(5) if SLICE_BOUNDS[s] <= idx < SLICE_BOUNDS[s + 1])
            out[f"net.slice{s + 1}.{idx}.{parts[-1]}"] = val
    return out
