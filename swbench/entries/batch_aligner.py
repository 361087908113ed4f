"""Entry: ``smithwaterman_tpu_torch.BatchAligner(...).align_pairs(pairs)``.

The engine is built with its defaults but for the configuration's mode,
table and gap penalties, on the device given (``cuda`` in every run on a
card; ``cpu`` only in the harness's own tests, where the program runs its
kernels' plain versions).  Each call returns the program's results, once
they are on the host.  :meth:`Entry.record` turns one result into the
reference's form (``references/gotoh.py``: the aligned strings, the score
and the spans), which the comparison splits into layers, and
:meth:`Entry.steps` counts its path's steps for the walk's roofline.
:meth:`Entry.phase` is the program's own host timing of the last call
(``BatchAligner.phase``), and :meth:`Entry.spans`
wraps the functions ``BatchAligner`` calls through their modules in
profiler ranges for the traced run; the program is not edited.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Sequence, Tuple

# the module functions the traced run wraps: (module, function)
SPANNED = (
    ("smithwaterman_tpu_torch.ops.fill_dp", "fill_many"),
    ("smithwaterman_tpu_torch.ops.device_walk", "walk_packed"),
    ("smithwaterman_tpu_torch.ops.longseq", "align_long_packed"),
    ("smithwaterman_tpu_torch.ops.reconstruct", "reconstruct_packed"),
)


class Entry:
    def __init__(self, config: dict, device: str):
        import smithwaterman_tpu_torch as swt

        tables = {
            "blosum62": swt.SubstitutionMatrix.blosum62,
            "mat_5_-4": lambda: swt.SubstitutionMatrix.match_mismatch(
                5.0, -4.0),
        }
        modes = {"local": swt.LOCAL, "glocal": swt.GLOCAL,
                 "global": swt.GLOBAL}
        self.engine = swt.BatchAligner(
            scoring_matrix=tables[config["entry_matrix"]](),
            gap_open=config["gap_open"], gap_extend=config["gap_extend"],
            mode=modes[config["mode"]], device=device)

    def __call__(self, pairs: Sequence[Tuple[str, str]]) -> List:
        return self.engine.align_pairs(pairs)

    @staticmethod
    def record(r) -> tuple:
        """(aligned1, aligned2, score, start1, end1, start2, end2): a
        tuple of plain values, which the garbage collector stops
        tracking, so the window can keep one a sampled pair and call."""
        return (r.aligned1, r.aligned2, float(r.score), r.start1, r.end1,
                r.start2, r.end2)

    @staticmethod
    def steps(pair: Tuple[str, str], rec: tuple) -> Optional[int]:
        """The path steps the walk took for ``rec`` (``record``'s form):
        the alignment's columns between its first and last aligned
        residues, every letter being retained; 0 when nothing aligned."""
        from swbench import roofline

        a1, _, _, s1, e1, s2, e2 = rec
        return roofline.path_steps(a1, len(pair[0]), len(pair[1]), s1, e1,
                                   s2, e2)

    def phase(self) -> Dict[str, float]:
        return dict(self.engine.phase)

    @contextlib.contextmanager
    def spans(self, prefix: str):
        """Wrap each of :data:`SPANNED` in ``record_function(prefix +
        name)`` while the block runs."""
        import importlib

        from torch.profiler import record_function

        def wrap(fn, name):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with record_function(prefix + name):
                    return fn(*args, **kwargs)
            return spanned

        saved = []
        try:
            for mod_name, name in SPANNED:
                mod = importlib.import_module(mod_name)
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, wrap(getattr(mod, name), name))
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def close(self) -> None:
        self.engine = None
