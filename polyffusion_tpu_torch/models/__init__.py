"""The port's networks: the conditional UNet and the condition VAEs."""

from .encoders import ChordDecoder, ChordEncoder, PianoTreeEncoder, TextureEncoder  # noqa: F401
from .pianotree_dec import PianoTreeDecoder  # noqa: F401
from .unet import UNetModel, init_weights_, timestep_embedding  # noqa: F401
