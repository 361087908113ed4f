"""FASTA I/O with the reference's exact edge-case tolerance (a copy of
``smithwaterman_tpu.io.fasta``; the native loader is the shared
``csrc/fasta.cpp``, built by :mod:`..ops.native`).

Parity target: ``SeqData``/``load_fasta`` in
rust/sequence_alignment/src/sequence_alignment.rs:797-889,
validated by the reference's ``sw_fastaloadtest`` fixture
(rust/sequence_alignment/test/test1.fas):

  * a line containing ``>`` anywhere starts a new record (with a warning when
    the ``>`` is not at column 0);
  * the header line is trimmed; a leading ``>`` (after trim) is skipped; the
    name is the first whitespace-delimited token, the rest is the description;
  * a record with neither name nor sequence is dropped;
  * sequence lines keep letters verbatim (no uppercasing), whitespace removed.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Iterable, List

__all__ = ["SeqData", "load_fasta", "parse_fasta", "write_fasta"]


@dataclass
class SeqData:
    """One FASTA record. ``seq`` is the raw residue string (case preserved)."""

    name: str = ""
    desc: str = ""
    seq: str = ""

    def __len__(self) -> int:
        return len(self.seq)

    @classmethod
    def create(cls, name: str, desc: str, seq: str, retain_ws: bool = True) -> "SeqData":
        """Parity with reference ``SeqData::create`` (sequence_alignment.rs:808-821):
        with ``retain_ws`` only CR/LF are removed, otherwise all whitespace."""
        if retain_ws:
            cleaned = seq.replace("\r", "").replace("\n", "")
        else:
            cleaned = "".join(c for c in seq if not c.isspace())
        return cls(name=name, desc=desc, seq=cleaned)


def _parse_header(line: str) -> tuple:
    line = line.strip()
    name_chars: List[str] = []
    desc_chars: List[str] = []
    in_name = True
    for i, ch in enumerate(line):
        if in_name:
            if i == 0 and ch == ">":
                continue
            if ch.isspace():
                if name_chars:
                    in_name = False
                continue
            name_chars.append(ch)
        else:
            desc_chars.append(ch)
    return "".join(name_chars), "".join(desc_chars)


def parse_fasta(lines: Iterable[str], retain_ws: bool = False) -> List[SeqData]:
    records: List[SeqData] = []
    seq_parts: List[str] = []
    name = ""
    desc = ""

    def flush():
        # a record with neither name nor sequence is dropped (parity:
        # sequence_alignment.rs:869-874 via the reference's bare-`>` fixture)
        seq = "".join(seq_parts)
        if seq or name:
            records.append(SeqData(name=name, desc=desc, seq=seq))

    for raw in lines:
        line = raw.rstrip("\n").rstrip("\r")
        pos = line.find(">")
        if pos >= 0:
            flush()
            if pos > 0:
                sys.stderr.write(
                    f"> was found at {pos}. This line was used as header anyway.\n"
                )
            name, desc = _parse_header(line)
            seq_parts = []
        else:
            if retain_ws:
                seq_parts.append(line.replace("\r", "").replace("\n", ""))
            else:
                seq_parts.append("".join(c for c in line if not c.isspace()))
    flush()
    return records


def _load_fasta_native(lib, path: str, retain_ws: bool) -> List[SeqData]:
    import ctypes

    nrec = ctypes.c_int64()
    handle = lib.sw_fasta_parse(
        path.encode(), 1 if retain_ws else 0, ctypes.byref(nrec)
    )
    if not handle:
        raise FileNotFoundError(path)
    try:
        # warnings are emitted from Python so sys.stderr capture works
        for k in range(lib.sw_fasta_n_warnings(handle)):
            pos = lib.sw_fasta_warning_pos(handle, k)
            sys.stderr.write(
                f"> was found at {pos}. This line was used as header anyway.\n"
            )
        out: List[SeqData] = []
        name = ctypes.c_char_p()
        desc = ctypes.c_char_p()
        seq = ctypes.c_char_p()
        nl = ctypes.c_int64()
        dl = ctypes.c_int64()
        sl = ctypes.c_int64()
        for k in range(nrec.value):
            lib.sw_fasta_record(
                handle, k,
                ctypes.byref(name), ctypes.byref(nl),
                ctypes.byref(desc), ctypes.byref(dl),
                ctypes.byref(seq), ctypes.byref(sl),
            )
            out.append(
                SeqData(
                    name=ctypes.string_at(name, nl.value).decode("latin-1"),
                    desc=ctypes.string_at(desc, dl.value).decode("latin-1"),
                    seq=ctypes.string_at(seq, sl.value).decode("latin-1"),
                )
            )
        return out
    finally:
        lib.sw_fasta_free(handle)


def load_fasta(path: str, retain_ws: bool = False) -> List[SeqData]:
    """Native parse of a FASTA file (csrc/fasta.cpp); the same records and
    warnings as :func:`parse_fasta` over the file's lines."""
    from ..ops import native

    return _load_fasta_native(native.host_lib(), path, retain_ws)


def write_fasta(path: str, records: Iterable[SeqData], with_desc: bool = True) -> None:
    with open(path, "w") as f:
        for r in records:
            header = f">{r.name} {r.desc}" if with_desc else f">{r.name}"
            f.write(f"{header}\n{r.seq}\n")
