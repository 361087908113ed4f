"""smithwaterman_tpu_torch — the PyTorch + CUDA port of smithwaterman_tpu.

Smith-Waterman (local), Needleman-Wunsch (global) and end-gap-free
(glocal) affine alignment, string-exact with EMBOSS water/needle and with
the JAX package ``smithwaterman_tpu``, which stays the reference.  On an
NVIDIA card the batched main path runs two hand-written CUDA kernels: the
DP fill (``csrc/fill.cu``) and the traceback walk (``csrc/walk.cu``).  The
package imports torch and never jax.
"""

from .config import GLOBAL, GLOCAL, LOCAL, AlignConfig
from .aligner import Aligner, AlignResult
from .batch_aligner import BatchAligner
from .io.fasta import SeqData, load_fasta
from .matrices import PositionSpecificMatrix, SubstitutionMatrix

__version__ = "0.1.0"

__all__ = [
    "GLOBAL",
    "GLOCAL",
    "LOCAL",
    "AlignConfig",
    "Aligner",
    "AlignResult",
    "BatchAligner",
    "SeqData",
    "load_fasta",
    "SubstitutionMatrix",
    "PositionSpecificMatrix",
]
