"""Tasks: a trainable module (``task.model``), its loss and its randomness
(the contract: ``tasks/base.py``)."""

from .autoencoder import AutoencoderTask  # noqa: F401
from .chd_8bar import Chd8BarTask  # noqa: F401
from .ddpm import DDPMTask  # noqa: F401
from .pnotree_vae import PnoTreeVAETask  # noqa: F401
from .sdf import SDFTask  # noqa: F401
from .sdxl import SDXLTask  # noqa: F401
