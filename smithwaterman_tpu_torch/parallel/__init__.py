"""Parallelism over several devices: one giant pair's columns striped over
a mesh (``seq_tiled``)."""

from .data_parallel import Mesh, make_mesh
from .seq_tiled import striped_fill

__all__ = ["Mesh", "make_mesh", "striped_fill"]
