"""The port's networks: the conditional UNet and the condition encoders."""

from .encoders import ChordEncoder, PianoTreeEncoder, TextureEncoder  # noqa: F401
from .unet import UNetModel, init_weights_, timestep_embedding  # noqa: F401
