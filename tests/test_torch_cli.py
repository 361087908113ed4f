"""The port's CLI against the JAX package's, byte for byte.

Both CLIs run in this process on the same small FASTA files (pairs,
``-list`` with ``-out``, ``-cluster``); their stdout and output files must
be identical bytes.  The port runs on the CPU here, asked for with
``device="cpu"``: its default is the card.
"""

import json
import os

import pytest

from smithwaterman_tpu import cli as jcli
from smithwaterman_tpu_torch import cli

FA1 = ">q1 first\nHEAGAWGHEEKLMNPQRSTVWY\n>q2\nMKVLAAGIVGLLLAAQPAMA\n>q3\nW\n"
FA2 = ">t1 target\nPAWHEAEKLMNQRST\n>t2\nMKVLAAGIVALLAQPAMAGG\n"
CLUSTER = (
    ">a one\nMKVLAAGIVGLLLAAQPAMAKKLL\n>b\nMKVLAAGIVGLLLAAQPAMAKKL\n"
    ">c\nMKVLAAGIVGLLLAAQPAMAKKLL\n>d\nWWWWHHHHPPPPCCCC\n"
    ">e\nMKVLSAGIVGLLLAAQPAMAKKLL\n>f\nWWWWHHHHPPPPCCC\n>g\nQQQQ\n"
)


@pytest.fixture
def files(tmp_path):
    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(FA1)
    f2.write_text(FA2)
    return tmp_path, str(f1), str(f2)


def _run(main, argv, capsys, **kw):
    main(argv, **kw)
    out = capsys.readouterr()
    return out.out


def _ours(argv, capsys):
    return _run(cli.main, argv, capsys, device="cpu")


@pytest.mark.parametrize("flag", ["-local", "-glocal", "-global"])
def test_pairs_output_identical(files, capsys, flag):
    _, f1, f2 = files
    ours = _ours([flag, f1, f2], capsys)
    theirs = _run(jcli.main, [flag, f1, f2], capsys)
    assert ours == theirs
    assert ours.count("#score:") == 6


def test_list_and_out_identical(files, capsys):
    tmp, f1, f2 = files
    lst = tmp / "list.txt"
    lst.write_text(f"{f1}\t{f2}\n{f2} {f1}\n")
    _ours(["-glocal", "-list", str(lst), "-out", str(tmp / "ours.txt")],
          capsys)
    _run(jcli.main, ["-glocal", "-list", str(lst), "-out",
                     str(tmp / "theirs.txt")], capsys)
    assert (tmp / "ours.txt").read_bytes() == (tmp / "theirs.txt").read_bytes()


@pytest.mark.parametrize("flag", ["-local", "-global"])
def test_cluster_identical(tmp_path, capsys, flag):
    inp = tmp_path / "in.fas"
    inp.write_text(CLUSTER)
    ours = str(tmp_path / "ours.fas")
    theirs = str(tmp_path / "theirs.fas")
    out_ours = _ours(["-cluster", flag, "-identity", "0.9", "-out", ours,
                      str(inp)], capsys)
    out_theirs = _run(jcli.main, ["-cluster", flag, "-identity", "0.9",
                                  "-out", theirs, str(inp)], capsys)
    assert out_ours == out_theirs
    for suffix in ("", ".clstr"):
        with open(ours + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read()
    assert os.path.getsize(ours + ".clstr") > 0


@pytest.fixture
def frozen_clock(monkeypatch):
    """A clock that stands still, for both CLIs' stats collectors too, so
    that the -stats reports' seconds (and the rates from them) are equal
    bytes."""
    import time

    from smithwaterman_tpu.utils import metrics as jmetrics
    from smithwaterman_tpu_torch.utils import metrics

    monkeypatch.setattr(time, "time", lambda: 1000.0)
    for mod in (metrics, jmetrics):
        cls = mod.StatsCollector
        monkeypatch.setattr(mod, "StatsCollector",
                            lambda cls=cls: cls(wall_start=1000.0))


def _without_spans(err: str) -> str:
    """The port's stderr with its -stats report's "spans" and "counters"
    (the program's own recorder, which the JAX CLI has not) taken out."""
    lines = err.split("\n")
    for k, line in enumerate(lines):
        if line.startswith('{"pairs"'):
            rep = json.loads(line)
            for key in ("spans", "counters"):
                rep.pop(key)
            lines[k] = json.dumps(rep)
    return "\n".join(lines)


def test_stats_and_band(files, capsys, frozen_clock):
    """-stats alone, and -band with and without -stats: stdout and the
    stderr report byte-identical to the JAX CLI's."""
    _, f1, f2 = files
    cli.main(["-stats", f1, f2], device="cpu")
    err = capsys.readouterr().err
    assert '"pairs": 6' in err
    for argv in (["-band", "64", f1, f2],
                 ["-stats", "-glocal", "-band", "128", f1, f2],
                 ["-global", "-band", "256", f2, f1]):
        cli.main(argv, device="cpu")
        ours = capsys.readouterr()
        jcli.main(argv)
        theirs = capsys.readouterr()
        assert (ours.out, _without_spans(ours.err)) == (theirs.out,
                                                        theirs.err)
        assert ours.out.count("#score:") == 6
        assert ('"pairs": 6' in ours.err) == ("-stats" in argv)


def test_usage_and_parse_errors(capsys):
    with pytest.raises(SystemExit):
        cli.main(["only-one"])
    assert "usage" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.AlignmentOptions.parse(["-bogus", "a", "b"])
    assert cli.format_score(54.5) == jcli.format_score(54.5) == "54.5"
