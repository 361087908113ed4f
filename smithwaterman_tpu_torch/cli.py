"""Command-line interface with the reference CLIs' exact surface.

Covers both reference binaries:
  * ``seqalign`` (rust/sequence_alignment/src/main.rs:6-47): mode flag +
    two FASTA files, all-vs-all, ``#score:``/``#type:``/``>name`` output.
  * ``sa_opencl`` (rust/sa_opencl/src/main.rs:21-319): adds ``-list`` batch
    mode, ``-cluster[ing]`` greedy clustering with ``-identity`` /
    ``-coverage_short`` / ``-coverage_long`` / ``-out``.

Usage:
  python -m smithwaterman_tpu_torch.cli [-local|-global|-glocal] f1.fas f2.fas
  python -m smithwaterman_tpu_torch.cli [-mode] -list pairs.txt [-out f]
  python -m smithwaterman_tpu_torch.cli -cluster [-mode] [-identity X] \
      [-coverage_short X] [-coverage_long X] -out out.fas in.fas

The port of ``smithwaterman_tpu.cli``: byte-identical output.  Alignment
batches run through BatchAligner, ``-band W`` pairs through
``Aligner.align_banded`` (the CUDA kernels on a card, their plain PyTorch
versions on the CPU).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import List, Optional, TextIO, Tuple

from .batch_aligner import BatchAligner
from .cluster import greedy_cluster, write_cluster_outputs
from .config import GLOBAL, GLOCAL, LOCAL, MODE_MESSAGES, bucket_len
from .io.fasta import load_fasta

USAGE = """usage: sa_opencl [(-global|-glocal|-local(default))] <infile1 (fasta file)>  <infile2 (fasta file)>
usage: sa_opencl [(-global|-glocal|-local(default))] [-list] <list file>
usage: sa_opencl -cluster[ing] [(-global|-glocal|-local(default))] [-identity 0.0-1.0] [-coverage_short 0.0-1.0] [-coverage_long 0.0-1.0] -out <output file> <fasta file>
The "list file" has a list of tab separated pairs as follows.
<infile1 (fasta file)>  <infile2 (fasta file)>
<infile3 (fasta file)>  <infile4 (fasta file)>
<infile5 (fasta file)>  <infile6 (fasta file)>
...
Then,
sequences in infile1 and infile2,
sequences in infile3 and infile4,
sequences in infile5 and infile6,
will be aligned."""


@dataclass
class AlignmentOptions:
    """Option parsing parity: sa_opencl/src/main.rs:35-112.

    Extensions beyond the reference surface (its engines accept these but
    its CLIs hardcode them; the JS UI exposes penalties in its form,
    SmithWaterman.html:396-397): ``-gapopen``, ``-gapextend``, ``-matrix
    blosum62|dna|<file>``, ``-match``/``-mismatch`` for the dna matrix
    (defaults 4/-1 per SmithWaterman.html:62-69), ``-stats`` (per-bucket
    observability report on stderr), ``-perl_compat`` (the Perl engine's
    input rewrite), and ``-band W`` (verified banded alignment of band W,
    ``Aligner.align_banded``)."""

    alignment_type: int = LOCAL
    file1: str = ""
    file2: str = ""
    outfilename: str = ""
    list: bool = False
    clustering: bool = False
    c_identity: Optional[float] = None
    c_coverage_short: Optional[float] = None
    c_coverage_long: Optional[float] = None
    gap_open: float = 10.0
    gap_extend: float = 0.5
    matrix: str = "blosum62"
    match: float = 4.0
    mismatch: float = -1.0
    # -stats: emit the per-bucket observability report (utils/metrics.py:
    # GCUPS, pairs/s, padding waste) as one JSON line on stderr after the
    # run.  Extension beyond the reference surface (SURVEY.md §5).
    stats: bool = False
    # -perl_compat: replicate the Perl engine's input rewrite (strip
    # non-letters, [BJOUXZa-z] -> X, smithwaterman.pl:94-99)
    perl_compat: bool = False
    # -band W: verified diagonal-banded alignment (Aligner.align_banded)
    band: int = 0

    @classmethod
    def parse(cls, args: List[str]) -> "AlignmentOptions":
        ret = cls()
        flag = [False] * len(args)
        file_candidates: List[str] = []

        def numeric(ii: int) -> float:
            try:
                return float(args[ii + 1])
            except (IndexError, ValueError) as e:
                raise SystemExit(f"parse error {args[ii + 1:ii + 2]} {e}")

        for ii, a in enumerate(args):
            if a in ("-glocal", "-global", "-local"):
                ret.alignment_type = {
                    "-glocal": GLOCAL,
                    "-global": GLOBAL,
                    "-local": LOCAL,
                }[a]
                flag[ii] = True
            elif a == "-list":
                ret.list = True
                flag[ii] = True
            elif a in ("-cluster", "-clustering"):
                ret.clustering = True
                flag[ii] = True
            elif a == "-stats":
                ret.stats = True
                flag[ii] = True
            elif a == "-perl_compat":
                ret.perl_compat = True
                flag[ii] = True
            elif a == "-band":
                ret.band = int(numeric(ii))
                flag[ii] = flag[ii + 1] = True
            elif a == "-coverage_short":
                ret.c_coverage_short = numeric(ii)
                flag[ii] = flag[ii + 1] = True
            elif a == "-coverage_long":
                ret.c_coverage_long = numeric(ii)
                flag[ii] = flag[ii + 1] = True
            elif a == "-identity":
                ret.c_identity = numeric(ii)
                flag[ii] = flag[ii + 1] = True
            elif a == "-out":
                ret.outfilename = args[ii + 1]
                flag[ii] = flag[ii + 1] = True
            elif a == "-gapopen":
                ret.gap_open = numeric(ii)
                flag[ii] = flag[ii + 1] = True
            elif a == "-gapextend":
                ret.gap_extend = numeric(ii)
                flag[ii] = flag[ii + 1] = True
            elif a == "-match":
                ret.match = numeric(ii)
                flag[ii] = flag[ii + 1] = True
            elif a == "-mismatch":
                ret.mismatch = numeric(ii)
                flag[ii] = flag[ii + 1] = True
            elif a == "-matrix":
                ret.matrix = args[ii + 1]
                flag[ii] = flag[ii + 1] = True
            elif not flag[ii]:
                if a.startswith("-"):
                    raise SystemExit(f"Unknown option {a}")
                file_candidates.append(a)

        if not ret.clustering and not ret.list:
            if len(file_candidates) != 2:
                raise SystemExit(f"2 files must be provided {file_candidates}.")
            ret.file1, ret.file2 = file_candidates
        else:
            if ret.clustering and ret.list:
                raise SystemExit("Incompatible option -list & -cluster(ing)")
            if len(file_candidates) != 1:
                raise SystemExit(f"1 file must be provided {file_candidates}.")
            ret.file1 = file_candidates[0]
            if ret.clustering and not ret.outfilename:
                raise SystemExit("Clustering must have -out.")
        return ret


def make_matrix(opts: AlignmentOptions):
    from .matrices import SubstitutionMatrix

    if opts.matrix == "blosum62":
        return SubstitutionMatrix.blosum62()
    if opts.matrix == "dna":
        return SubstitutionMatrix.match_mismatch(opts.match, opts.mismatch)
    return SubstitutionMatrix.from_file(opts.matrix)


def format_score(score: float) -> str:
    """Rust f32 Display parity: integral values print without a decimal."""
    return str(int(score)) if float(score) == int(score) else repr(float(score))


def read_pair_list(path: str) -> List[Tuple[str, str]]:
    """List-file parsing parity (main.rs:267-289): tab-separated, falling
    back to space; >2 columns reports (but, like the reference, skips) the
    line; <2 columns is ignored."""
    out: List[Tuple[str, str]] = []
    with open(path) as f:
        for line_ in f:
            line = line_.rstrip("\n").rstrip("\r")
            spp = line.split("\t")
            if len(spp) == 1:
                spp = line.split(" ")
            if len(spp) > 2:
                print(f"{line} \n^ Only {spp[0]} {spp[1]} are used.")
            elif len(spp) < 2:
                print(f"{line} \n is ignoed.")
            else:
                out.append((spp[0], spp[1]))
    return out


def _emit(f: Optional[TextIO], score, mess, name1, r1, name2, r2) -> None:
    if f is not None:
        # parity quirk: the reference's file path omits the newlines after
        # #score/#type (main.rs:303-306 write_all vs :309-312 println)
        f.write(f"#score:{format_score(score)}")
        f.write(f"#type:{mess}")
        f.write(f">{name1}\n{r1}\n")
        f.write(f">{name2}\n{r2}\n")
    else:
        print(f"#score:{format_score(score)}")
        print(f"#type:{mess}")
        print(f">{name1}\n{r1}\n")
        print(f">{name2}\n{r2}\n")


def _banded_pair(banded, s1, s2, band: int, engine: BatchAligner):
    """One ``-band`` pair through ``Aligner.align_banded``, recorded into the
    engine's ``-stats`` collector as the JAX CLI records it: one bucket of
    padded sizes, the full problem's n*m cells (the "effective GCUPS"
    convention for banded DP) and the pair's wall time."""
    t0 = time.time()
    r = banded.align_banded(s1, s2, band=band)
    if engine.stats is not None:
        dt = time.time() - t0
        ln, lm = len(s1.seq), len(s2.seq)
        bs = engine.stats.bucket(bucket_len(ln, engine.config.buckets),
                                 bucket_len(lm, engine.config.buckets))
        bs.pairs += 1
        bs.padded_pairs += 1
        bs.true_cells += ln * lm
        bs.padded_cells += ln * lm
        bs.inflight_seconds += dt
        engine.stats.run_seconds += dt
    return r


def run_pairfiles(opts: AlignmentOptions, engine: BatchAligner) -> None:
    mess = MODE_MESSAGES[opts.alignment_type]
    filelist = (
        read_pair_list(opts.file1) if opts.list else [(opts.file1, opts.file2)]
    )
    banded = None
    if opts.band > 0:
        from .aligner import Aligner

        banded = Aligner(
            scoring_matrix=engine.scoring_matrix,
            config=engine.config,
            perl_compat=opts.perl_compat,
            device=engine.device,
        )
    out = open(opts.outfilename, "w") if opts.outfilename else None
    try:
        for file1, file2 in filelist:
            seq1 = load_fasta(file1)
            seq2 = load_fasta(file2)
            pairs = [(s1, s2) for s1 in seq1 for s2 in seq2]
            if banded is not None:
                results = [_banded_pair(banded, s1, s2, opts.band, engine)
                           for s1, s2 in pairs]
            else:
                results = engine.align_pairs(pairs, retain_all=True)
            k = 0
            for s1 in seq1:
                for s2 in seq2:
                    r = results[k]
                    k += 1
                    _emit(out, r.score, mess, s1.name, r.aligned1, s2.name, r.aligned2)
    finally:
        if out is not None:
            out.close()


def main(argv: Optional[List[str]] = None, device: Optional[str] = None
         ) -> None:
    """Run the CLI on ``argv``; the engine runs on ``device`` (default: the
    card, see ``aligner.resolve_device``)."""
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 2:
        sys.stderr.write(USAGE + "\n")
        sys.exit(255)
    opts = AlignmentOptions.parse(args)
    engine = BatchAligner(
        scoring_matrix=make_matrix(opts),
        gap_open=opts.gap_open,
        gap_extend=opts.gap_extend,
        mode=opts.alignment_type,
        perl_compat=opts.perl_compat,
        device=device,
    )
    if opts.stats:
        from .utils.metrics import StatsCollector

        engine.stats = StatsCollector()
    if opts.clustering:
        seqs = load_fasta(opts.file1)
        cluster_of, members, order = greedy_cluster(
            seqs,
            engine,
            identity=opts.c_identity if opts.c_identity is not None else 0.8,
            coverage_short=(
                opts.c_coverage_short if opts.c_coverage_short is not None else 0.8
            ),
            coverage_long=(
                opts.c_coverage_long if opts.c_coverage_long is not None else 0.8
            ),
            progress=print,
        )
        write_cluster_outputs(opts.outfilename, order, cluster_of, members)
    else:
        run_pairfiles(opts, engine)
    if opts.stats:
        sys.stderr.write(engine.stats.report() + "\n")


if __name__ == "__main__":
    main()
