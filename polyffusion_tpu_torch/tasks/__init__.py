"""Tasks: model + condition encoders + schedule."""

from .sdf import SDFTask  # noqa: F401
