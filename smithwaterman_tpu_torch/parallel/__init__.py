"""Parallelism over several devices and processes: many pairs sharded over
a mesh (``DataParallel``), one giant pair's columns striped over it
(``seq_tiled``), and several processes dividing host-level work such as a
sweep's chunks (``multihost``)."""

from .data_parallel import DataParallel, Mesh, make_mesh
from .multihost import initialize as initialize_multihost
from .seq_tiled import striped_fill

__all__ = ["DataParallel", "make_mesh", "initialize_multihost", "striped_fill"]
