"""bucket_ms: the program's own host time of a call's encoding, bucketing
and flush planning (``BatchAligner.phase["bucket"]``), averaged over the
window's calls, in ms."""


def read(ctx):
    vals = [c.phase["bucket"] for c in ctx.calls if "bucket" in c.phase]
    return 1e3 * sum(vals) / len(vals) if vals else None
