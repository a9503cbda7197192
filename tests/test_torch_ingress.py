"""The port's ingress service (``serving/ingress.py``, a copy of the JAX
package's): the cases of ``tests/test_ingress.py`` on the port's module,
and one request sequence into both apps with equal answers."""
import io
import json
import threading

import pytest

from lightly_ocr_tpu.serving import ingress as jingress
from lightly_ocr_tpu_torch.serving.ingress import (
    CO2,
    Store,
    User,
    create_ingress_app,
    create_table_query,
    fields_of,
    insert_query,
)


def test_fields_of():
    assert fields_of(User) == [("userName", "TEXT"), ("userScore", "INTEGER"), ("imgPath", "TEXT")]
    assert fields_of(CO2) == [("items", "TEXT"), ("emission", "REAL")]


def test_query_builders():
    assert "CREATE TABLE IF NOT EXISTS user" in create_table_query(User)
    assert insert_query(CO2) == "INSERT INTO co2 (items, emission) VALUES (?, ?)"
    for row in (User, CO2):
        assert create_table_query(row) == jingress.create_table_query(getattr(jingress, row.__name__))


def test_store_crud(tmp_path):
    store = Store(str(tmp_path / "t.db"))
    rid = store.insert(User(userName="ada", userScore=7, imgPath="/a.png"))
    assert store.select_all(User) == [{"id": rid, "userName": "ada", "userScore": 7, "imgPath": "/a.png"}]
    store.update(User, rid, userScore=9)
    assert store.select_all(User)[0]["userScore"] == 9
    store.delete(User, rid)
    assert store.select_all(User) == []
    assert store.ping()
    store.close()


def _request(app, method, path, payload=None):
    body = json.dumps(payload).encode() if payload is not None else b""
    got = {}

    def start_response(status, headers):
        got["status"] = status

    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    return got.setdefault("out", json.loads(b"".join(app(environ, start_response)))) and \
        (got["status"], got["out"])


_SEQUENCE = [
    ("GET", "/health", None),
    ("POST", "/users", {"userName": "bob", "userScore": 3, "imgPath": "/r.png"}),
    ("GET", "/users", None),
    ("POST", "/co2", {"items": "apple", "emission": 0.3}),
    ("GET", "/co2", None),
    ("POST", "/users", {"bogus": 1}),
    ("POST", "/co2", {"emission": "x", "items": 1, "extra": 2}),
    ("GET", "/nope", None),
    ("DELETE", "/users", None),
]


def test_ingress_api(tmp_path):
    store = Store(str(tmp_path / "api.db"))
    app = create_ingress_app(store)
    assert _request(app, "GET", "/health") == ("200 OK", {"status": "online"})
    assert _request(app, "POST", "/users", _SEQUENCE[1][2])[1]["status"] == "OK"
    assert _request(app, "GET", "/users")[1][0]["userName"] == "bob"
    assert _request(app, "POST", "/co2", {"items": "apple", "emission": 0.3})[1]["status"] == "OK"
    status, out = _request(app, "POST", "/users", {"bogus": 1})
    assert status.startswith("400") and out["status"] == "badInput"
    assert _request(app, "GET", "/nope")[0].startswith("404")
    store.close()


def test_same_answers_as_the_jax_ingress(tmp_path):
    stores = {"jax": jingress.Store(str(tmp_path / "jax.db")), "port": Store(str(tmp_path / "port.db"))}
    apps = {"jax": jingress.create_ingress_app(stores["jax"]), "port": create_ingress_app(stores["port"])}
    try:
        for method, path, payload in _SEQUENCE:
            assert _request(apps["port"], method, path, payload) == \
                _request(apps["jax"], method, path, payload), (method, path)
    finally:
        for s in stores.values():
            s.close()


def test_store_threaded(tmp_path):
    store = Store(str(tmp_path / "th.db"))
    errs = []

    def work(i):
        try:
            store.insert(User(userName=f"u{i}", userScore=i, imgPath=""))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not errs and len(store.select_all(User)) == 8
    store.close()


def test_module_is_the_jax_module_renamed():
    """The copy differs from the JAX package's module in nothing."""
    import inspect

    from lightly_ocr_tpu_torch.serving import ingress

    assert inspect.getsource(ingress) == inspect.getsource(jingress)


@pytest.mark.parametrize("row", ["User", "CO2"])
def test_insert_query_matches_jax(row):
    assert insert_query(globals()[row]) == jingress.insert_query(getattr(jingress, row))
