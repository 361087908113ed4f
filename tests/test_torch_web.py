"""The port's web surface (smithwaterman_tpu_torch/web.py) against the JAX
package's, on the CPU: ``align_request`` on tests/test_web.py's cases
(protein all-vs-all, lettermatch with penalties, bad penalties) equal to
``smithwaterman_tpu.web.align_request``, and the handler over a live
server: the page, ``POST /align`` and both 404s.

Tolerance: exact equality of every field of every result.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from smithwaterman_tpu import web as jweb
from smithwaterman_tpu_torch import web

CASES = [
    {"seq1": ">a\nHEAGAWGHEE\n>b\nPAWHEAE", "seq2": ">c\nHEAGAWGHEF",
     "gap_open": 10, "gap_extend": 0.5, "matrix": "protein"},
    {"seq1": "ACGT", "seq2": "ACGT", "gap_open": 5, "gap_extend": 1,
     "matrix": "lettermatch"},
    {"seq1": ">x\nACGTTGCA\n>y\nTTGACC\n", "seq2": ">z\nACGGTTGCAA\n>w\nGA",
     "gap_open": 3.5, "gap_extend": 0.25, "matrix": "lettermatch"},
    {"gap_open": "xx"},
]


@pytest.mark.parametrize("req", CASES, ids=["protein", "lettermatch",
                                            "lettermatch-2x2", "bad"])
def test_align_request_matches_jax(req):
    got = web.align_request(req, device="cpu")
    assert got == jweb.align_request(req)
    if "error" not in got:
        assert got["results"] and all(
            len(r["match"]) == len(r["aligned1"]) for r in got["results"])


def test_align_request_runs_on_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        web.align_request(CASES[0])


def test_http_roundtrip():
    httpd = web.Server(("127.0.0.1", 0), device="cpu")
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        page = urllib.request.urlopen(url + "/", timeout=30).read()
        assert b"Gap Open Penalty" in page
        assert b"<title>smithwaterman_tpu_torch</title>" in page
        body = json.dumps({"seq1": "HEAGAWGHEE", "seq2": "PAWHEAE"}).encode()
        data = json.loads(urllib.request.urlopen(urllib.request.Request(
            url + "/align", data=body, method="POST"), timeout=60).read())
        assert data == json.loads(json.dumps(jweb.align_request(
            {"seq1": "HEAGAWGHEE", "seq2": "PAWHEAE"})))
        for req in (urllib.request.Request(url + "/nope"),
                    urllib.request.Request(url + "/nope", data=b"{}",
                                           method="POST")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
