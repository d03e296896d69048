"""Tasks: a trainable module (``task.model``), its loss and its randomness."""

from .chd_8bar import Chd8BarTask  # noqa: F401
from .pnotree_vae import PnoTreeVAETask  # noqa: F401
from .sdf import SDFTask  # noqa: F401
