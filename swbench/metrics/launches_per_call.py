"""launches_per_call: the program's kernel launches (its ``launch.K1`` ..
``launch.K13`` counters) a call, averaged over the traced window's calls.
Nothing when the program logged no calls or counted no launch (the CPU
runs its kernels' plain versions)."""

from swbench import progtrace


def read(ctx):
    calls = progtrace.window_calls(ctx)
    if not calls:
        return None
    by = {}
    for c in calls:
        for k, n in c.counts.items():
            if k.startswith("launch."):
                by[k[7:]] = by.get(k[7:], 0) + n
    total = sum(by.values())
    if total <= 0:
        return None
    ctx.notes["launches_per_call"] = ", ".join(
        f"{k} {n / len(calls):.3f}" for k, n in sorted(by.items()))
    return total / len(calls)
