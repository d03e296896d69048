"""The port's networks: the conditional UNet and the chord encoder."""

from .encoders import ChordEncoder  # noqa: F401
from .unet import UNetModel, init_weights_, timestep_embedding  # noqa: F401
