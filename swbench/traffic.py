"""Traffic: a mix's data file into a pool of batches.

A mix is ``traffic/<name>.json`` (see README.md for every key).  From
``--seed`` it makes ``batches`` distinct batches of ``pairs_per_call``
pairs each; the window sends them in turn, one batch a call.  A mix whose
file names a ``generator`` is made by ``traffic/<generator>.py``'s
``pool(spec, seed)``; every other mix by :func:`homologs` here.

Every seed gets the same set of sizes: side a's lengths are the
``pairs_per_call`` midpoints of equal slices of ``a.length`` (each batch
holds all of them, in its own seeded order), and side b, a mutated copy of
a, pairs each insertion with a deletion of its length, so its length
stays within ``indel_max`` of a's (or, drawn apart from a, takes the
midpoints of ``b.length`` as a does).  The seed changes the letters, the
order, the substitutions and the indels' lengths, not how much work a
call is.  Letters are drawn uniformly, or by the mix's ``composition``
(each letter's share, in %).
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

Pair = Tuple[str, str]


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a salt."""
    return np.random.default_rng([seed % (1 << 64), *salt])


def lengths(lo: int, hi: int, count: int) -> np.ndarray:
    """The midpoints of ``count`` equal slices of [lo, hi], rounded."""
    return np.rint(lo + (hi - lo) * (np.arange(count) + 0.5) / count
                   ).astype(np.int64)


def letters(codes: np.ndarray, alphabet: str) -> str:
    lut = np.frombuffer(alphabet.encode("ascii"), np.uint8)
    return lut[codes].tobytes().decode("ascii")


def draw(rng: np.random.Generator, k: int, size: int,
         p: Optional[np.ndarray] = None) -> np.ndarray:
    """``size`` codes of ``k`` letters: uniform, or with shares ``p``."""
    if p is None:
        return rng.integers(0, k, size=size)
    return rng.choice(k, size=size, p=p)


def mutate(codes: np.ndarray, rng: np.random.Generator, k: int,
           sub_rate: float, indel_every: int, indel_max: int,
           p: Optional[np.ndarray] = None) -> np.ndarray:
    """A mutated copy of ``codes`` over ``k`` letters: each position
    replaced by a letter drawn as :func:`draw` draws (uniform, or with
    shares ``p``) with probability ``sub_rate`` (which may draw the same
    letter), and an indel of 1..``indel_max``
    letters at every multiple of ``indel_every``: insertions and
    deletions in turn from a seeded first kind, each pair of one length,
    so the copy's length stays within ``indel_max`` of the original's."""
    n = len(codes)
    out = codes.copy()
    hit = rng.random(n) < sub_rate
    out[hit] = draw(rng, k, int(hit.sum()), p)
    at = np.arange(indel_every, n, indel_every)
    size = np.repeat(rng.integers(1, indel_max + 1, size=(len(at) + 1) // 2),
                     2)[:len(at)]
    insert = (np.arange(len(at)) + int(rng.integers(0, 2))) % 2 == 0
    pieces, lo = [], 0
    for at_k, d, ins in zip(at.tolist(), size.tolist(), insert.tolist()):
        if at_k < lo:
            continue
        pieces.append(out[lo:at_k])
        if ins:
            pieces.append(draw(rng, k, d, p))
            lo = at_k
        else:
            lo = at_k + d
    pieces.append(out[lo:])
    return np.concatenate(pieces)


def pool(spec: dict, seed: int) -> List[List[Pair]]:
    """The mix's batches for ``seed``, by its generator."""
    name = spec.get("generator")
    if name is None:
        return homologs(spec, seed)
    found = importlib.util.spec_from_file_location(
        f"swbench_traffic_{name}".replace(".", "_").replace("-", "_"),
        os.path.join(HERE, "traffic", f"{name}.py"))
    mod = importlib.util.module_from_spec(found)
    found.loader.exec_module(mod)
    return mod.pool(spec, seed)


def shares(spec: dict) -> Optional[np.ndarray]:
    """The letters' shares of a mix with a ``composition``, else None."""
    comp = spec.get("composition")
    if comp is None:
        return None
    w = np.asarray([comp[c] for c in spec["alphabet"]], np.float64)
    return w / w.sum()


def homologs(spec: dict, seed: int) -> List[List[Pair]]:
    """The default generator: pairs whose side b is a mutated copy of
    side a, or drawn apart from it."""
    alphabet = spec["alphabet"]
    k = len(alphabet)
    p = shares(spec)
    P, nb = spec["pairs_per_call"], spec["batches"]
    a_spec, b_spec = spec["a"], spec["b"]
    la = lengths(*a_spec["length"], P)
    shared = None
    if a_spec.get("shared", False):
        shared = draw(rng_for(seed, 0), k, int(la[0]), p)
    out = []
    for t in range(nb):
        rng = rng_for(seed, 1, t)
        batch = []
        if "length" in b_spec:
            lb = iter(rng.permutation(lengths(*b_spec["length"], P)).tolist())
        for n in rng.permutation(la).tolist():
            a = shared if shared is not None else draw(rng, k, n, p)
            if "mutate" in b_spec:
                b = mutate(a, rng, k, p=p, **b_spec["mutate"])
            else:
                b = draw(rng, k, next(lb), p)
            batch.append((letters(a, alphabet), letters(b, alphabet)))
        out.append(batch)
    return out


def cells(batch: List[Pair]) -> int:
    """True DP cells of a batch: the sum of n * m."""
    return sum(len(a) * len(b) for a, b in batch)
