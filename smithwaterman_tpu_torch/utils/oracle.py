"""EMBOSS golden-fixture oracle.

A copy of ``smithwaterman_tpu/utils/oracle.py`` (:30-115): pure host code,
kept here so the port imports nothing of the JAX package.

Re-implements the reference test harness's comparison rules
(the reference test/check_results.pl) in Python so the fixture suite
(`test/inputs/`, `test/emboss_results/`, `test/file_list.txt`) can judge this
framework directly:

  * golden parsing: concatenate the sequence fields of lines matching
    ``^\\s*s1\\s+\\d+\\s*(\\S+)`` / same for s2 (check_results.pl:511-536);
  * ``# Score:`` lines provide the golden score (ignored by the Perl harness,
    checked here too);
  * local alignments compared after ``trimTerminal`` strips terminal
    all-gap columns (check_results.pl:486-508);
  * mismatches are tolerated when a sequence contains J/U/Z/B/O/X
    (check_results.pl:70 — EMBOSS and the implementations disagree on
    ambiguous letters).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

AMBIGUOUS = re.compile(r"[JUZBOX]")


@dataclass
class GoldenResult:
    seq1: str
    seq2: str
    score: Optional[float]


def parse_emboss_dat(path: str) -> GoldenResult:
    s1_parts: List[str] = []
    s2_parts: List[str] = []
    score: Optional[float] = None
    re1 = re.compile(r"^\s*s1\s+[0-9]+\s*(\S+)")
    re2 = re.compile(r"^\s*s2\s+[0-9]+\s*(\S+)")
    rsc = re.compile(r"^#\s*Score:\s*(-?[0-9.]+)")
    with open(path) as f:
        for line in f:
            m = re1.match(line)
            if m:
                s1_parts.append(m.group(1))
            m = re2.match(line)
            if m:
                s2_parts.append(m.group(1))
            m = rsc.match(line)
            if m:
                score = float(m.group(1))
    return GoldenResult("".join(s1_parts), "".join(s2_parts), score)


def trim_terminal(a1: str, a2: str) -> Tuple[str, str]:
    """Strip leading/trailing columns where either row is a gap
    (parity: check_results.pl:486-508)."""
    n = len(a1)
    lo = 0
    while lo < n and (a1[lo] == "-" or a2[lo] == "-"):
        lo += 1
    hi = n
    while hi > lo and (a1[hi - 1] == "-" or a2[hi - 1] == "-"):
        hi -= 1
    return a1[lo:hi], a2[lo:hi]


def is_tolerated(a1: str, a2: str) -> bool:
    """Ambiguous-letter tolerance rule (check_results.pl:70)."""
    return bool(AMBIGUOUS.search(a1)) or bool(AMBIGUOUS.search(a2))


@dataclass
class SuiteCase:
    tag: str          # e.g. "seq42"
    fasta1: str
    fasta2: str
    golden: dict      # mode name -> golden .dat path


def discover_suite(test_dir: str) -> List[SuiteCase]:
    """Enumerate the reference fixture suite from its test directory."""
    inputs = os.path.join(test_dir, "inputs")
    golden = os.path.join(test_dir, "emboss_results")
    cases = []
    for fn in sorted(
        os.listdir(inputs), key=lambda s: int(re.sub(r"\D", "", s) or 0)
    ):
        m = re.match(r"(seq\d+)\.1\.fas$", fn)
        if not m:
            continue
        tag = m.group(1)
        num = tag[3:]
        cases.append(
            SuiteCase(
                tag=tag,
                fasta1=os.path.join(inputs, f"{tag}.1.fas"),
                fasta2=os.path.join(inputs, f"{tag}.2.fas"),
                golden={
                    "local": os.path.join(golden, f"res{num}.dat"),
                    "global": os.path.join(golden, f"needle_res{num}.dat"),
                    "glocal": os.path.join(golden, f"needle_glocal_res{num}.dat"),
                },
            )
        )
    return cases


REFERENCE_TEST_DIR = "/root/reference/test"


def default_suite() -> List[SuiteCase]:
    return discover_suite(REFERENCE_TEST_DIR)
