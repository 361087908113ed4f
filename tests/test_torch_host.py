"""The port's framework-free host layers against the JAX package's.

Config, scoring matrices, FASTA I/O, the host traceback walker and the
state converter must give identical outputs in both packages on the same
seeded inputs (tolerance: exact equality).  A subprocess check proves the
port never imports jax.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import smithwaterman_tpu.config as jcfg
from smithwaterman_tpu.io import fasta as jfasta
from smithwaterman_tpu.matrices import MatrixFormatError as JaxMFE
from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import traceback as jtb
from smithwaterman_tpu_torch import config as cfg
from smithwaterman_tpu_torch.io import fasta
from smithwaterman_tpu_torch.matrices import (MatrixFormatError,
                                              PositionSpecificMatrix,
                                              SubstitutionMatrix)
from smithwaterman_tpu_torch.ops import batch, scan_dp, traceback
from smithwaterman_tpu_torch.utils.convert import from_jax_state
from smithwaterman_tpu_torch.utils.metrics import StatsCollector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_constants_match():
    for name in ("GLOBAL", "GLOCAL", "LOCAL", "CELL_MATCH", "CELL_GAPINX",
                 "CELL_GAPINY", "CELL_STOP", "DEFAULT_BUCKETS", "MODE_NAMES",
                 "MODE_MESSAGES"):
        assert getattr(cfg, name) == getattr(jcfg, name), name


def test_bucket_len_matches():
    ladder = (64, 200, 1000)
    for n in list(range(0, 1200, 7)) + [8192, 8193, 9000, 20000]:
        assert cfg.bucket_len(n) == jcfg.bucket_len(n)
        assert cfg.bucket_len(n, ladder) == jcfg.bucket_len(n, ladder)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_for_lengths_matches(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 3000, size=int(rng.integers(1, 400)))
    for rungs in (4, 12):
        assert cfg.ladder_for_lengths(lens, max_rungs=rungs) == \
            jcfg.ladder_for_lengths(lens, max_rungs=rungs)
    assert cfg.ladder_for_lengths([]) == jcfg.ladder_for_lengths([])


def test_align_config_and_quarter_warning():
    c = cfg.AlignConfig(mode=cfg.GLOCAL, gap_open=12.0, gap_extend=1.25)
    j = jcfg.AlignConfig(mode=jcfg.GLOCAL, gap_open=12.0, gap_extend=1.25)
    assert (c.og, c.eg, c.mode_name) == (j.og, j.eg, j.mode_name)
    with pytest.warns(UserWarning, match="multiple of 0.25"):
        cfg.AlignConfig(gap_open=10.1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg.AlignConfig(gap_open=10.25, gap_extend=0.75)


def test_tables_match():
    for ours, theirs in ((SubstitutionMatrix.blosum62(), JaxSM.blosum62()),
                         (SubstitutionMatrix.match_mismatch(5.0, -4.0),
                          JaxSM.match_mismatch(5.0, -4.0))):
        assert ours.letters == theirs.letters
        np.testing.assert_array_equal(ours.table, theirs.table)
        assert ours.table.dtype == theirs.table.dtype == np.float32
    t = SubstitutionMatrix.blosum62().table
    assert batch.is_integer_table(t)
    assert not batch.is_integer_table(t * np.float32(0.5))


MATRIX_TEXT = """# a comment
   A  C  G  T  X
A  5 -4 -4 -4 -1
C -4  5 -4 -4 -1
G -4 -4  5 -4 -1
T -4 -4 -4  5 -1
X -1 -1 -1 -1 -1
"""


def test_from_lines_matches(tmp_path):
    lines = MATRIX_TEXT.splitlines()
    ours = SubstitutionMatrix.from_lines(lines)
    theirs = JaxSM.from_lines(lines)
    assert ours.letters == theirs.letters
    np.testing.assert_array_equal(ours.table, theirs.table)
    p = tmp_path / "m.txt"
    p.write_text(MATRIX_TEXT)
    np.testing.assert_array_equal(SubstitutionMatrix.from_file(str(p)).table,
                                  theirs.table)
    bad = lines[:-1]  # X row missing
    with pytest.raises(MatrixFormatError):
        SubstitutionMatrix.from_lines(bad)
    with pytest.raises(JaxMFE):
        JaxSM.from_lines(bad)


def test_seq_to_index_matches():
    rng = np.random.default_rng(3)
    alphabet = list("ARNDCQEGHILKMFPSTWYVBZX*jou-")
    for sm, jsm in ((SubstitutionMatrix.blosum62(), JaxSM.blosum62()),
                    (SubstitutionMatrix.from_lines(MATRIX_TEXT.splitlines()),
                     JaxSM.from_lines(MATRIX_TEXT.splitlines()))):
        for _ in range(20):
            s = "".join(rng.choice(alphabet, int(rng.integers(0, 60))))
            np.testing.assert_array_equal(sm.seq_to_index(s),
                                          jsm.seq_to_index(s))
            np.testing.assert_array_equal(sm.seq_to_index(s, 7),
                                          jsm.seq_to_index(s, 7))
    no_x = SubstitutionMatrix.from_lines(["A C", "A 1 0", "C 0 1"])
    with pytest.raises(KeyError):
        no_x.seq_to_index("ACG")
    pm = PositionSpecificMatrix()
    pm.prepare("ACD", "AC")
    assert pm.scores.shape == (3, 2)


FASTA_TEXT = (
    ">s1 first record\nACDEFG\nHIK  LM\n"
    "junk>s2\r\nWWW\n>\n"
    ">s3\n\n>  s4   spaced  desc \nMKV\n"
)


def test_parse_fasta_matches(capsys):
    lines = FASTA_TEXT.splitlines(keepends=True)
    for retain in (False, True):
        ours = fasta.parse_fasta(lines, retain_ws=retain)
        theirs = jfasta.parse_fasta(lines, retain_ws=retain)
        assert [(r.name, r.desc, r.seq) for r in ours] == \
            [(r.name, r.desc, r.seq) for r in theirs]
    assert "was found at" in capsys.readouterr().err


def test_load_fasta_native_matches(tmp_path, capsys):
    p = tmp_path / "in.fas"
    p.write_text(FASTA_TEXT)
    ours = fasta.load_fasta(str(p))
    theirs = jfasta.load_fasta(str(p))
    assert [(r.name, r.desc, r.seq) for r in ours] == \
        [(r.name, r.desc, r.seq) for r in theirs]
    assert capsys.readouterr().err.count("was found at") == 2
    out = tmp_path / "out.fas"
    fasta.write_fasta(str(out), ours)
    assert [r.seq for r in fasta.load_fasta(str(out))] == \
        [r.seq for r in ours]
    with pytest.raises(FileNotFoundError):
        fasta.load_fasta(str(tmp_path / "missing.fas"))


@pytest.mark.parametrize("mode", [cfg.LOCAL, cfg.GLOCAL, cfg.GLOBAL])
def test_host_walk_matches_jax(mode):
    """The native walker (and its Python path) against the JAX walker on
    the torch oracle's full pointer matrices, degenerate penalties too."""
    rng = np.random.default_rng(9)
    sm = SubstitutionMatrix.blosum62()
    for og, eg in ((-10.0, -0.5), (0.0, 0.0)):
        n, m = 30, 41
        c1 = rng.integers(0, 20, size=(1, n)).astype(np.uint8)
        c2 = rng.integers(0, 20, size=(1, m)).astype(np.uint8)
        c2[0, 5:20] = c1[0, 3:18]
        S = batch.scores(torch.from_numpy(sm.table), torch.from_numpy(c1),
                         torch.from_numpy(c2))
        r = scan_dp.fill(S, torch.tensor([n]), torch.tensor([m]), og, eg,
                         mode)
        tb = r.tb[0].numpy()
        local = mode == cfg.LOCAL
        if local:
            start = (int(r.best_i[0]), int(r.best_j[0]), cfg.CELL_MATCH)
        else:
            start = (n, m, int(r.final_state[0]))
        ours = traceback.walk(tb, *start, local)
        assert ours == jtb.walk(tb, *start, local)
        assert ours == traceback.walk_py(tb, *start, local)
        assert len(ours[0]) > 0


def test_boundary_rules_match():
    for i in range(3):
        for j in range(3):
            for s in range(3):
                assert traceback.normalize_boundary_state(i, j, s) == \
                    jtb.normalize_boundary_state(i, j, s)
                for local in (False, True):
                    if i == 0 or j == 0:
                        assert traceback._boundary_prev(i, j, s, local) == \
                            jtb._boundary_prev(i, j, s, local)


def test_from_jax_state_computes_the_same():
    from smithwaterman_tpu import Aligner as JaxAligner
    from smithwaterman_tpu_torch import Aligner

    jsm = JaxSM.match_mismatch(5.0, -4.0)
    jconf = jcfg.AlignConfig(mode=jcfg.GLOBAL, gap_open=8.0, gap_extend=0.75,
                             buckets=(32, 64, 128))
    sm, conf = from_jax_state(jsm.table, "".join(jsm.letters),
                              jconf.gap_open, jconf.gap_extend, jconf.mode,
                              jconf.buckets)
    assert conf == cfg.AlignConfig(mode=cfg.GLOBAL, gap_open=8.0,
                                   gap_extend=0.75, buckets=(32, 64, 128))
    np.testing.assert_array_equal(sm.table, jsm.table)
    assert sm.letter_to_index == jsm.letter_to_index
    s1, s2 = "CATTAGATGACTGAAAGCAAGTACTGG", "ACTTCTCTAGCTCAGTTGGTAGAGCG"
    a = Aligner(scoring_matrix=sm, config=conf, device="cpu").align(s1, s2)
    b = JaxAligner(scoring_matrix=jsm, config=jconf).align(s1, s2)
    assert (a.aligned1, a.aligned2, a.score) == (b.aligned1, b.aligned2,
                                                 b.score)
    with pytest.raises(ValueError):
        from_jax_state(jsm.table[:3], "ACG", 10, 0.5, 0, (64,))


def test_stats_collector_report():
    st = StatsCollector()
    b = st.bucket(128, 256)
    b.pairs, b.true_cells, b.padded_cells = 3, 1000, 4000
    st.run_seconds = 2.0
    s = st.summary()
    assert s["pairs"] == 3 and s["padding_waste"] == 0.75
    assert s["buckets"]["128x256"]["pairs"] == 3


def test_port_never_imports_jax():
    """Importing the package and its CLI must leave jax unloaded."""
    code = ("import sys; import smithwaterman_tpu_torch, "
            "smithwaterman_tpu_torch.cli, smithwaterman_tpu_torch.ops.kernels,"
            " smithwaterman_tpu_torch.utils.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'smithwaterman_tpu.'))"
            " or m == 'smithwaterman_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
