"""PEP 249 (DB-API 2.0) shim over the statement protocol.

The role the reference's JDBC driver plays for Java clients
(``client/trino-jdbc/.../TrinoConnection.java``): standard cursor
semantics over the engine, in-process or via HTTP.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

apilevel = "2.0"
threadsafety = 1
paramstyle = "qmark"


class Error(Exception):
    pass


class Cursor:
    def __init__(self, conn: "Connection"):
        self._conn = conn
        self.description = None
        self.rowcount = -1
        self._rows: List[tuple] = []
        self._pos = 0
        self.arraysize = 1

    def execute(self, sql: str, parameters: Optional[Sequence] = None):
        if parameters:
            for p in parameters:
                v = ("'" + str(p).replace("'", "''") + "'"
                     if isinstance(p, str) else repr(p))
                sql = sql.replace("?", v, 1)
        cols, rows = self._conn._run(sql)
        self.description = [
            (c["name"], c["type"], None, None, None, None, None)
            for c in cols
        ]
        self._rows = [tuple(r) for r in rows]
        self.rowcount = len(self._rows)
        self._pos = 0
        return self

    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None):
        size = size or self.arraysize
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self):
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def close(self):
        self._rows = []

    def __iter__(self):
        while True:
            r = self.fetchone()
            if r is None:
                return
            yield r


class Connection:
    def __init__(self, url: Optional[str] = None, schema: str = "tiny",
                 engine=None, device="cuda"):
        if engine is not None:
            self._engine = engine
            self._client = None
        elif url:
            from .http_client import Client

            self._client = Client(url, schema=schema)
            self._engine = None
        else:
            from ..exec.catalog import TpchCatalog
            from ..exec.engine import Engine

            self._engine = Engine(TpchCatalog(schema, device=device),
                                  device=device)
            self._client = None

    def _run(self, sql: str):
        if self._client is not None:
            return self._client.execute(sql)
        out = self._engine.execute_statement(sql)
        n = out.num_rows if isinstance(out.num_rows, int) else int(out.num_rows)
        cols = [{"name": name, "type": str(c.type)}
                for name, c in out.columns.items()]
        decoded = {name: c.decode(n) for name, c in out.columns.items()}
        rows = [[decoded[name][i] for name in decoded] for i in range(n)]
        return cols, rows

    def cursor(self) -> Cursor:
        return Cursor(self)

    def commit(self):
        pass

    def rollback(self):
        raise Error("transactions are not supported")

    def close(self):
        pass


def connect(url: Optional[str] = None, schema: str = "tiny",
            engine=None, device="cuda") -> Connection:
    """A connection over HTTP (``url``), to a given ``engine``, or to a new
    in-process engine on a TPC-H schema on ``device``."""
    return Connection(url, schema, engine, device)
