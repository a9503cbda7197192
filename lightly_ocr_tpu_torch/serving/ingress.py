"""Ingress persistence service — the working counterpart of ``ingress/``.

The reference ships a half-finished Go ingress that does not compile
(``ingress/db/table.go:19-23``, ``crud.go:22-24`` are syntactically
incomplete; ``server.go`` is empty — SURVEY §2.2).  Its *intent*: a SQL
store for ``User{userName, userScore, imgPath}`` and ``CO2{items,
emission}`` rows behind a connection manager with a ping/reconnect loop
(``ingress/db/db.go:32-132``), plus reflection-based query builders
(``query.go``, ``field.go``).

This rebuild keeps those shapes in Python (stdlib only):

* dataclass row types -> tables via type reflection (the ``TypeDict`` /
  ``GetFieldsOf`` idea);
* a ``Store`` with create/insert/select/update/delete builders;
* a background health monitor pinging every 5 s with a 1 s budget and
  reconnecting on failure (``db.go:108-132`` semantics);
* a WSGI API: ``GET /health``, ``POST|GET /users``, ``POST|GET /co2``.

Backend is sqlite (always available); the SQL surface is generic enough
that pointing ``connect()`` at another DB-API driver works.
"""
from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any, Type

# Go-type -> SQL-type mapping, in the spirit of query.go's TypeDict.
_TYPE_MAP = {str: "TEXT", int: "INTEGER", float: "REAL", bytes: "BLOB"}


@dataclass
class User:
    userName: str = ""
    userScore: int = 0
    imgPath: str = ""


@dataclass
class CO2:
    items: str = ""
    emission: float = 0.0


def fields_of(row_type: Type) -> list[tuple[str, str]]:
    """dataclass -> [(column, sql_type)] (field.go's GetFieldsOf)."""
    out = []
    for f in dataclasses.fields(row_type):
        if f.type not in _TYPE_MAP and not isinstance(f.type, str):
            raise TypeError(f"unsupported column type {f.type}")
        ftype = f.type if not isinstance(f.type, str) else {
            "str": str, "int": int, "float": float, "bytes": bytes
        }[f.type]
        out.append((f.name, _TYPE_MAP[ftype]))
    return out


def create_table_query(row_type: Type) -> str:
    cols = ", ".join(f"{n} {t}" for n, t in fields_of(row_type))
    return (
        f"CREATE TABLE IF NOT EXISTS {row_type.__name__.lower()} "
        f"(id INTEGER PRIMARY KEY AUTOINCREMENT, {cols})"
    )


def insert_query(row_type: Type) -> str:
    names = [n for n, _ in fields_of(row_type)]
    marks = ", ".join("?" for _ in names)
    return (
        f"INSERT INTO {row_type.__name__.lower()} "
        f"({', '.join(names)}) VALUES ({marks})"
    )


class Store:
    """Connection manager + CRUD over dataclass rows."""

    PING_INTERVAL_S = 5.0
    PING_TIMEOUT_S = 1.0

    def __init__(self, url: str = ":memory:", monitor: bool = False):
        self.url = url
        self._local = threading.local()
        self._stop = threading.Event()
        self.connected = threading.Event()
        self._connect()
        for t in (User, CO2):
            self.execute(create_table_query(t))
        self._monitor = None
        if monitor:
            self._monitor = threading.Thread(target=self._ping_loop,
                                             daemon=True)
            self._monitor.start()

    # --- connection management (db.go:44-132 shape) ---
    def _connect(self) -> None:
        self._local.conn = sqlite3.connect(
            self.url, timeout=self.PING_TIMEOUT_S
        )
        self.connected.set()

    @property
    def conn(self) -> sqlite3.Connection:
        if not hasattr(self._local, "conn"):
            self._connect()
        return self._local.conn

    def ping(self) -> bool:
        try:
            self.conn.execute("SELECT 1").fetchone()
            return True
        except sqlite3.Error:
            return False

    def _ping_loop(self) -> None:
        while not self._stop.wait(self.PING_INTERVAL_S):
            if not self.ping():
                self.connected.clear()
                try:
                    self._connect()
                except sqlite3.Error:
                    continue

    def close(self) -> None:
        self._stop.set()
        if self._monitor:
            self._monitor.join(timeout=2)
        self.conn.close()

    # --- CRUD ---
    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        cur = self.conn.execute(sql, params)
        self.conn.commit()
        return cur

    def insert(self, row: Any) -> int:
        cur = self.execute(
            insert_query(type(row)),
            tuple(getattr(row, f.name) for f in dataclasses.fields(row)),
        )
        return int(cur.lastrowid)

    def select_all(self, row_type: Type) -> list[dict]:
        names = ["id"] + [n for n, _ in fields_of(row_type)]
        rows = self.execute(
            f"SELECT {', '.join(names)} FROM {row_type.__name__.lower()}"
        ).fetchall()
        return [dict(zip(names, r)) for r in rows]

    def update(self, row_type: Type, row_id: int, **values) -> None:
        cols = ", ".join(f"{k} = ?" for k in values)
        self.execute(
            f"UPDATE {row_type.__name__.lower()} SET {cols} WHERE id = ?",
            (*values.values(), row_id),
        )

    def delete(self, row_type: Type, row_id: int) -> None:
        self.execute(
            f"DELETE FROM {row_type.__name__.lower()} WHERE id = ?",
            (row_id,),
        )


def create_ingress_app(store: Store):
    """WSGI API over the store."""

    def respond(start_response, status: str, payload) -> list[bytes]:
        body = json.dumps(payload).encode()
        start_response(status, [("Content-Type", "application/json"),
                                ("Content-Length", str(len(body)))])
        return [body]

    routes = {"/users": User, "/co2": CO2}

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        if path == "/health":
            ok = store.ping()
            return respond(
                start_response,
                "200 OK" if ok else "503 SERVICE UNAVAILABLE",
                {"status": "online" if ok else "degraded"},
            )
        if path in routes:
            row_type = routes[path]
            if method == "GET":
                return respond(
                    start_response, "200 OK", store.select_all(row_type)
                )
            if method == "POST":
                try:
                    length = int(environ.get("CONTENT_LENGTH") or 0)
                    data = json.loads(
                        environ["wsgi.input"].read(length) or b"{}"
                    )
                    row = row_type(**data)
                except (TypeError, ValueError) as e:
                    return respond(
                        start_response, "400 BAD REQUEST",
                        {"status": "badInput", "error": str(e)},
                    )
                rid = store.insert(row)
                return respond(start_response, "200 OK",
                               {"status": "OK", "id": rid})
        return respond(start_response, "404 NOT FOUND", {"status": "notFound"})

    return app


def main(argv=None) -> int:
    import argparse
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIServer, make_server

    p = argparse.ArgumentParser(description="ingress persistence service")
    p.add_argument("--db", default="ingress.db")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5001)
    args = p.parse_args(argv)

    class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True

    store = Store(args.db, monitor=True)
    httpd = make_server(
        args.host, args.port, create_ingress_app(store),
        server_class=ThreadingWSGIServer,
    )
    print(f"ingress on {args.host}:{args.port} (db={args.db})", flush=True)
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
