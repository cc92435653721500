"""The port's serving front end (`serve/scheduler.py`, `serve/http.py`,
`utils/obs.py`, `utils/goodput.py`) on the CPU: the stack that
`python -m distributed_neural_network_tpu_torch.serve` builds
(`build_server`), bound to 127.0.0.1:0.

Bars: the SSE stream and the blocking reply equal the port's offline
`generate()`; overflow answers 429 with Retry-After; `/metrics` parses with
the port's `parse_prom_samples` exactly as with the JAX package's; the
serving run record conserves and passes the JAX package's
`validate_record` / `check_record` (schema parity).
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.utils import goodput as jgoodput
from distributed_neural_network_tpu.utils import obs as jobs
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.serve.http import build_server
from distributed_neural_network_tpu_torch.serve.scheduler import AdmissionError, ServeRequest
from distributed_neural_network_tpu_torch.utils.obs import parse_prom_samples

GEOM = ["--vocab", "64", "--d-model", "32", "--n-heads", "4", "--n-layers", "2",
        "--d-ff", "64", "--seed", "3"]


def _argv(*extra):
    return ["--device", "cpu", "--port", "0", *GEOM, "--max-batch", "4",
            "--block-size", "4", "--max-seq-len", "64", *extra]


@pytest.fixture(scope="module")
def stack():
    srv, sched, eng = build_server(_argv("--num-blocks", "64", "--prefill-chunk", "4",
                                         "--warmup"), log=lambda line: None)
    yield srv, sched, eng
    sched.close(finalize=False)
    srv.close()


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(2, 64, size=n).tolist()


def _oracle(eng, prompt, n_new):
    out = tfm.generate(eng.params, torch.tensor([prompt]), eng.cfg, max_new_tokens=n_new)
    return out[0, len(prompt):].tolist()


def _post(srv, body, timeout=60):
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=timeout)
    c.request("POST", "/v1/generate", json.dumps(body), {"Content-Type": "application/json"})
    return c, c.getresponse()


def _get(srv, path):
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    c.request("GET", path)
    r = c.getresponse()
    body = r.read()
    c.close()
    return r.status, body


def _read_sse(resp):
    toks, done, buf = [], None, b""
    while done is None:
        chunk = resp.read(64)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            doc = json.loads(frame.decode().removeprefix("data: "))
            if "token" in doc:
                toks.append(doc["token"])
            if doc.get("done"):
                done = doc
    return toks, done


def test_sse_stream_matches_generate(stack):
    srv, _, eng = stack
    for seed, n in ((700, 6), (701, 13)):
        prompt = _prompt(seed, n)
        conn, resp = _post(srv, {"prompt": prompt, "max_new_tokens": 7})
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        toks, done = _read_sse(resp)
        conn.close()
        assert toks == _oracle(eng, prompt, 7)
        assert done["done"] is True and done["tokens"] == toks and done["ttft_s"] is not None


def test_blocking_reply_status_and_requests(stack):
    srv, _, eng = stack
    prompt = _prompt(702, 4)
    conn, resp = _post(srv, {"prompt": prompt, "max_new_tokens": 5, "stream": False})
    doc = json.loads(resp.read())
    conn.close()
    assert resp.status == 200 and doc["tokens"] == _oracle(eng, prompt, 5)
    code, body = _get(srv, "/v1/status")
    st = json.loads(body)
    assert code == 200 and st["kv_blocks_total"] == 63 and st["kv_dtype"] == "f32"
    assert st["decode_tokens"] >= 5 and st["compiled_programs"]["decode"] > 0
    code, body = _get(srv, f"/v1/requests?id={doc['req_id']}")
    assert code == 200 and json.loads(body)["request"]["state"] == "done"
    code, body = _get(srv, "/healthz")
    assert code == 200 and json.loads(body)["alive"] is True


def test_400s(stack):
    srv, _, _ = stack
    for body, reason in [({"prompt": [2], "max_new_tokens": 100}, "too_long"),
                         ({"prompt": [], "max_new_tokens": 2}, "empty_prompt"),
                         ({"prompt": [9999], "max_new_tokens": 2}, "bad_token"),
                         ({"max_new_tokens": 2}, "bad_prompt")]:
        conn, resp = _post(srv, body)
        doc = json.loads(resp.read())
        conn.close()
        assert resp.status == 400 and doc["reason"] == reason


def test_metrics_parse_like_the_jax_parser(stack):
    srv, _, _ = stack
    code, body = _get(srv, "/metrics")
    text = body.decode()
    assert code == 200
    samples = parse_prom_samples(text)
    assert samples == jobs.parse_prom_samples(text)
    names = {k[0] if isinstance(k, tuple) else k for k in samples}
    for name in ("serve_requests_total", "serve_tokens_total", "serve_kv_blocks_total",
                 "serve_ttft_seconds_count", "serve_engine_steps_total"):
        assert any(str(n).startswith(name) for n in names), name


def test_overflow_answers_429_with_retry_after():
    srv, sched, _ = build_server(_argv("--num-blocks", "32", "--max-batch", "1",
                                       "--max-queue", "1"), log=lambda line: None)
    results = []

    def one(i):
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        c.request("POST", "/v1/generate", json.dumps(
            {"prompt": _prompt(800 + i, 4), "max_new_tokens": 30}),
            {"Content-Type": "application/json"})
        r = c.getresponse()
        results.append((r.status, r.getheader("Retry-After")))
        r.read()
        c.close()

    try:
        ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        saw_429 = [x for x in results if x[0] == 429]
        assert saw_429 and all(ra == "1" for _, ra in saw_429), results
        with pytest.raises(AdmissionError) as ei:
            for _ in range(4):
                sched.submit(ServeRequest(prompt=[3, 4], max_new_tokens=30))
        assert ei.value.status == 429 and ei.value.reason == "queue_full"
    finally:
        sched.close(finalize=False)
        srv.close()


def test_run_record_passes_the_jax_validator(tmp_path):
    path = str(tmp_path / "serve_record.json")
    srv, sched, eng = build_server(_argv("--num-blocks", "32", "--precision", "int8-kv",
                                         "--run-record", path), log=lambda line: None)
    try:
        reqs = [sched.submit(ServeRequest(prompt=_prompt(600 + i, 5), max_new_tokens=6))
                for i in range(3)]
        for r in reqs:
            while r.events.get(timeout=60)[0] != "done":
                pass
    finally:
        rec = sched.close()  # finalize asserts conservation
        srv.close()
    assert eng.kv_dtype_name() == "int8" and eng.kv.blocks_in_use == 0
    assert rec["taxonomy"] == "serve" and rec["badput_s"]["prefill"] > 0 and rec["goodput_s"] > 0
    assert rec["goodput_s"] + sum(rec["badput_s"].values()) == pytest.approx(rec["wall_s"],
                                                                             rel=1e-6)
    on_disk = jgoodput.read_record(path)  # the JAX package's validate_record
    assert on_disk["final"] is True and on_disk["config"]["engine"]["kv_dtype"] == "int8"
    assert jgoodput.check_record(on_disk, on_disk) == []
    assert set(on_disk["badput_s"]) == set(jgoodput.SERVE_BADPUT_CAUSES)
    assert jgoodput.render_record(on_disk)


@pytest.mark.parametrize("flags", [["--spec-decode", "2"], ["--precision", "int8-w"],
                                   ["--trace-out", "t.json"], ["--heartbeat-file", "hb.json"]])
def test_later_slice_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="slice"):
        build_server(_argv("--num-blocks", "32", *flags), log=lambda line: None)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_server(["--port", "0", *GEOM], log=lambda line: None)
