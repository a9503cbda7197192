"""The port's HTTP front end (``serving/server.py``) vs the JAX package's.

The request set of ``tests/test_server.py`` runs against the port's
``create_app`` and ``InferenceWorker`` (health, upload, 403/404 paths, 503
with ``Retry-After``, the 504 deadline and its environment override, the
cancel of queued requests); the same requests into both apps give equal
status lines and JSON; the port's ``main`` resolves the same ``Config`` as
the JAX ``main`` for a table of command lines; and one upload goes over a
real socket on 127.0.0.1.
"""
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from lightly_ocr_tpu.serving import server as jserver
from lightly_ocr_tpu_torch.serving import server
from lightly_ocr_tpu_torch.serving.server import (
    InferenceWorker,
    QueueFullError,
    create_app,
    secure_filename,
)


class FakeModel:
    """serveModel-compatible stub, so no net is built."""

    def predict(self, image):
        assert image.ndim == 3 and image.dtype == np.uint8
        return ["total", "4.20"]


def _environ(method, path, body=b"", content_type=None):
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    if content_type:
        environ["CONTENT_TYPE"] = content_type
    return environ


def _make_client(app):
    """Minimal WSGI test client -> (status line, JSON payload)."""

    def request(method, path, body=b"", content_type=None):
        got = {}

        def start_response(status, headers):
            got["status"], got["headers"] = status, dict(headers)

        payload = json.loads(b"".join(app(_environ(method, path, body, content_type),
                                          start_response)))
        return got["status"], payload

    return request


def _multipart(filename, content, field="file"):
    boundary = "testboundary123"
    body = (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="{field}"; filename="{filename}"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode()
    body += content + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _png_bytes():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((20, 30, 3), 128, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture
def client(tmp_path):
    app = create_app(FakeModel(), upload_folder=str(tmp_path))
    yield _make_client(app)
    app.worker.close()


# (method, path, body, content type) -> the JAX server's answer
_REQUESTS = {
    "health": lambda: ("GET", "/", b"", None),
    "happy_path": lambda: ("POST", "/api", *_multipart("receipt.png", _png_bytes())),
    "no_file_field": lambda: ("POST", "/api", *_multipart("receipt.png", _png_bytes(), field="other")),
    "empty_filename": lambda: ("POST", "/api", *_multipart("", _png_bytes())),
    "bad_extension": lambda: ("POST", "/api", *_multipart("malware.exe", b"MZ...")),
    "gif": lambda: ("POST", "/api", *_multipart("anim.gif", b"GIF89a")),
    "corrupt_image": lambda: ("POST", "/api", *_multipart("x.png", b"not a png at all")),
    "non_multipart": lambda: ("POST", "/api", b"{}", "application/json"),
    "unknown_route": lambda: ("GET", "/nope", b"", None),
    "get_api": lambda: ("GET", "/api", b"", None),
}
_WANT = {
    "health": ("200 OK", {"status": "online"}),
    "happy_path": ("200 OK", {"status": "OK", "results": {"0": "total", "1": "4.20"}}),
    "no_file_field": ("403 FORBIDDEN", {"status": "noInput"}),
    "empty_filename": ("403 FORBIDDEN", {"status": "emptyInput"}),
    "bad_extension": ("404 NOT FOUND", {"status": "badInput"}),
    "gif": ("404 NOT FOUND", {"status": "badInput"}),
    "corrupt_image": ("404 NOT FOUND", {"status": "badInput"}),
    "non_multipart": ("403 FORBIDDEN", {"status": "noInput"}),
    "unknown_route": ("404 NOT FOUND", {"status": "notFound"}),
    "get_api": ("404 NOT FOUND", {"status": "notFound"}),
}


@pytest.mark.parametrize("case", list(_REQUESTS))
def test_request_set(client, case):
    assert client(*_REQUESTS[case]()) == _WANT[case]


@pytest.mark.parametrize("case", list(_REQUESTS))
def test_same_answers_as_the_jax_app(case, tmp_path):
    """One request into both apps: equal status lines and JSON, and the
    upload saved under the same name."""
    apps = {"jax": jserver.create_app(FakeModel(), upload_folder=str(tmp_path / "jax")),
            "port": create_app(FakeModel(), upload_folder=str(tmp_path / "port"))}
    try:
        answers = {k: _make_client(app)(*_REQUESTS[case]()) for k, app in apps.items()}
    finally:
        for app in apps.values():
            app.worker.close()
    assert answers["port"] == answers["jax"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_secure_filename_matches_jax():
    for name in ("../../etc/passwd", "a b/c.png", "x\\y\\z.jpg", "ok_name-1.PNG", "ü.png"):
        assert secure_filename(name) == jserver.secure_filename(name)
    assert secure_filename("..") != ".." and secure_filename("") != ""
    assert server.ALLOWED_EXT == jserver.ALLOWED_EXT
    for name in ("a.PNG", "b.jpeg", "c.gif", "noext", "d.tar.jpg"):
        assert server.is_allowed(name) == jserver.is_allowed(name)


def test_worker_batches():
    calls = []

    def predict_fn(images):
        calls.append(len(images))
        threading.Event().wait(0.01)
        return [["x"]] * len(images)

    w = InferenceWorker(predict_fn, max_batch=8)
    futs = [w.submit(np.zeros((4, 4, 3), np.uint8)) for _ in range(6)]
    assert all(f.result(timeout=5) == ["x"] for f in futs)
    w.close()
    assert sum(calls) == 6 and not w.thread.is_alive()


def test_worker_error_propagates():
    def predict_fn(images):
        raise RuntimeError("boom")

    w = InferenceWorker(predict_fn)
    with pytest.raises(RuntimeError, match="boom"):
        w.submit(np.zeros((4, 4, 3), np.uint8)).result(timeout=5)
    w.close()


def test_worker_bounded_queue_sheds():
    release = threading.Event()

    def predict_fn(images):
        release.wait(5)
        return [["x"]] * len(images)

    w = InferenceWorker(predict_fn, max_batch=1, max_queue=4)
    accepted, shed = [], 0
    for _ in range(32):
        try:
            accepted.append(w.submit(np.zeros((4, 4, 3), np.uint8)))
        except QueueFullError:
            shed += 1
    assert shed > 0
    release.set()
    assert all(f.result(timeout=5) == ["x"] for f in accepted)
    w.close()


def test_overload_returns_503_with_retry_after(tmp_path):
    """With the worker held busy and the queue at depth 1, concurrent
    uploads are shed with 503 + ``Retry-After`` while the accepted ones
    still answer 200."""
    release = threading.Event()

    def predict_fn(images):
        release.wait(5)
        return [["ok"]] * len(images)

    worker = InferenceWorker(predict_fn, max_batch=1, max_queue=1)
    app = create_app(FakeModel(), upload_folder=str(tmp_path), worker=worker)
    body, ctype = _multipart("receipt.png", _png_bytes())
    answers = []

    def hit():
        got = {}

        def start_response(status, headers):
            got["status"], got["headers"] = status, dict(headers)

        payload = json.loads(b"".join(app(_environ("POST", "/api", body, ctype), start_response)))
        answers.append((got["status"], payload, got["headers"]))

    first = threading.Thread(target=hit)
    first.start()
    for _ in range(100):  # until the worker has taken the first request
        if worker.q.empty():
            break
        threading.Event().wait(0.05)
    threads = [threading.Thread(target=hit) for _ in range(6)]
    for t in threads:
        t.start()
    for _ in range(100):
        if sum(a[0].startswith("503") for a in answers) >= 5:
            break
        threading.Event().wait(0.05)
    release.set()
    for t in [first, *threads]:
        t.join(timeout=10)
        assert not t.is_alive()
    worker.close()
    statuses = [a[0] for a in answers]
    assert sum(s.startswith("503") for s in statuses) >= 4, statuses
    assert sum(s.startswith("200") for s in statuses) >= 1, statuses
    for status, payload, headers in answers:
        if status.startswith("503"):
            assert payload == {"status": "overloaded"} and headers.get("Retry-After") == "1"


def test_request_timeout_returns_504(tmp_path):
    release = threading.Event()

    def predict_fn(images):
        release.wait(5)
        return [["late"]] * len(images)

    worker = InferenceWorker(predict_fn, max_batch=1, max_queue=4)
    app = create_app(FakeModel(), upload_folder=str(tmp_path), worker=worker, request_timeout_s=0.2)
    status, payload = _make_client(app)("POST", "/api", *_multipart("receipt.png", _png_bytes()))
    release.set()
    worker.close()
    assert status.startswith("504") and payload == {"status": "timeout"}


def test_request_timeout_env_override(tmp_path, monkeypatch):
    """``LIGHTLY_OCR_REQUEST_TIMEOUT_S`` sets the default deadline: below
    the inference time -> 504; raised -> the same slow inference is 200."""
    release = threading.Event()

    def predict_fn(images):
        release.wait(2)
        return [["slow-but-ok"]] * len(images)

    body, ctype = _multipart("receipt.png", _png_bytes())
    monkeypatch.setenv("LIGHTLY_OCR_REQUEST_TIMEOUT_S", "0.2")
    worker = InferenceWorker(predict_fn, max_batch=1, max_queue=4)
    status, _ = _make_client(create_app(FakeModel(), upload_folder=str(tmp_path),
                                        worker=worker))("POST", "/api", body, ctype)
    release.set()
    worker.close()
    assert status.startswith("504")

    release.clear()
    monkeypatch.setenv("LIGHTLY_OCR_REQUEST_TIMEOUT_S", "30")
    worker = InferenceWorker(predict_fn, max_batch=1, max_queue=4)
    timer = threading.Timer(0.3, release.set)
    timer.start()
    status, payload = _make_client(create_app(FakeModel(), upload_folder=str(tmp_path),
                                              worker=worker))("POST", "/api", body, ctype)
    timer.join(timeout=5)
    worker.close()
    assert status.startswith("200") and payload["results"] == {"0": "slow-but-ok"}


def test_cancelled_queued_requests_are_skipped():
    """A future cancelled while queued (the 504 path) never reaches the
    model."""
    gate = threading.Event()
    seen = []

    def predict_fn(images):
        gate.wait(5)
        seen.extend(int(img[0, 0, 0]) for img in images)
        return [["ok"]] * len(images)

    worker = InferenceWorker(predict_fn, max_batch=1, max_queue=8)
    futs = [worker.submit(np.full((2, 2, 3), i, np.uint8)) for i in range(4)]
    for _ in range(100):
        if futs[0].running():
            break
        threading.Event().wait(0.05)
    assert not futs[0].cancel()
    assert futs[1].cancel() and futs[2].cancel()
    gate.set()
    assert futs[3].result(timeout=5) == ["ok"] and futs[0].result(timeout=5) == ["ok"]
    worker.close()
    assert seen == [0, 3]


_ARGV = {
    "defaults": [],
    "bf16": ["--bf16"],
    "int8": ["--int8"],
    "beam": ["--decode", "beam"],
    "beam_width_lm": ["--decode", "beam", "--beam-width", "4", "--lm", "prior.npy"],
    "greedy_lm": ["--decode", "greedy", "--lm", "prior.npy", "--thresh", "0.5"],
    "batched": ["--batched", "--bf16", "--host", "127.0.0.1", "--port", "0",
                "--request-timeout", "5", "--docker"],
    "config_ctc": ["--config", "{yml}", "--decode", "beam"],
    "config_flag": ["--config", "{yml}", "--int8", "--beam-width", "2"],
}


@pytest.mark.parametrize("case", list(_ARGV))
def test_main_resolves_the_same_config_as_jax(case, monkeypatch, tmp_path):
    """Each module's ``run_server`` is replaced by a recorder: the port's
    ``main`` hands it the same arguments and ``Config`` fields as the JAX
    ``main``, and ``device`` ("cuda" unless ``--device``)."""
    yml = tmp_path / "c.yml"
    yml.write_text("prediction: CTC\ntransform: None\nquant_int8: false\n")
    argv = [a.format(yml=yml) for a in _ARGV[case]]
    calls = {}

    def recorder(key):
        def run_server(*args, **kw):
            calls[key] = (args, kw)
        return run_server

    monkeypatch.setattr(jserver, "run_server", recorder("jax"))
    monkeypatch.setattr(server, "run_server", recorder("port"))
    assert jserver.main(argv) == 0 and server.main(argv) == 0
    assert server.main(argv + ["--device", "cpu"]) == 0
    (jargs, jkw), (args, kw) = calls["jax"], calls["port"]
    assert args == jargs
    assert kw["config"].to_dict() == jkw.pop("config").to_dict()
    assert kw.pop("device") == "cpu"
    kw.pop("config")
    assert kw == jkw


def test_real_socket_round_trip(tmp_path):
    """``ThreadingWSGIServer`` (the server class of ``run_server``) on
    127.0.0.1, a free port: ``GET /`` and a multipart PNG upload."""
    from wsgiref.simple_server import make_server

    app = create_app(FakeModel(), upload_folder=str(tmp_path))
    httpd = make_server("127.0.0.1", 0, app, server_class=server.ThreadingWSGIServer)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "online"}
        body, ctype = _multipart("receipt.png", _png_bytes())
        req = urllib.request.Request(base + "/api", data=body, method="POST",
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read()) == {"status": "OK", "results": {"0": "total", "1": "4.20"}}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
        app.worker.close()
    assert not thread.is_alive()


def test_run_server_logs_its_plan_and_bound_port(monkeypatch, tmp_path, capsys, caplog):
    """``run_server(port=0)`` prints ``serving on host:<bound port>`` and
    logs the device and the served plan once; the per-image model is built
    on the device it is given."""
    import logging

    from lightly_ocr_tpu_torch import pipeline
    from lightly_ocr_tpu_torch.config import Config

    built = {}

    class StubServeModel(FakeModel):
        def __init__(self, config_file=None, thresh=0.7, config=None, device="cuda"):
            built.update(config=config, device=device)
            self.config = config

    def interrupt(self, *a, **kw):
        raise KeyboardInterrupt

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pipeline, "serveModel", StubServeModel)
    monkeypatch.setattr(server.ThreadingWSGIServer, "serve_forever", interrupt)
    cfg = Config(attn_decode="beam", beam_width=4, ctc_lm_path="p.npy")
    with caplog.at_level(logging.INFO, logger=server.log.name), pytest.raises(KeyboardInterrupt):
        server.run_server("127.0.0.1", 0, config=cfg, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("serving on 127.0.0.1:") and int(out.split(":")[-1]) > 0
    assert built == {"config": cfg, "device": "cpu"}
    plans = [r.getMessage() for r in caplog.records if "per-image float32" in r.getMessage()]
    assert plans == ["device cpu (host CPU); per-image float32 engines, Attention beam "
                     "beam_width=4 lm=p.npy"]


def test_burst_of_connections_is_not_dropped(tmp_path):
    """32 concurrent uploads over real sockets all answer 200 in well under
    the one-second SYN retransmit that a listen backlog of 5 (the
    ``socketserver`` default) costs the connections beyond it."""
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    app = create_app(FakeModel(), upload_folder=str(tmp_path))
    httpd = make_server("127.0.0.1", 0, app, server_class=server.ThreadingWSGIServer,
                        handler_class=Quiet)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    body, ctype = _multipart("receipt.png", _png_bytes())
    url = f"http://127.0.0.1:{httpd.server_port}/api"
    for _ in range(2):  # warm: a process's first connections pay one-off costs
        req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
        urllib.request.urlopen(req, timeout=30).close()
    answers = [None] * 32

    def hit(i):
        req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=30) as r:
            answers[i] = (r.status, time.perf_counter() - t)

    clients = [threading.Thread(target=hit, args=(i,)) for i in range(32)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
            assert not c.is_alive()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
        app.worker.close()
    assert [a[0] for a in answers] == [200] * 32
    assert max(a[1] for a in answers) < 1.0, sorted(a[1] for a in answers)[-4:]
