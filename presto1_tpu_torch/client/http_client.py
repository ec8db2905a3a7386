"""Statement-protocol client.

The analog of the reference's StatementClientV1
(``client/trino-client/.../StatementClientV1.java``): POST the SQL, then
follow nextUri pages until the query reaches a terminal state.  Stdlib
urllib only — no external dependencies.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import List, Optional, Tuple


class QueryFailed(Exception):
    pass


class Client:
    def __init__(self, base_url: str, user: str = "presto1",
                 schema: str = "tiny", password: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.user = user
        self.schema = schema
        self.password = password

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        headers = {"X-Presto1-User": self.user,
                   "X-Presto1-Schema": self.schema}
        if self.password is not None:
            import base64

            cred = base64.b64encode(
                f"{self.user}:{self.password}".encode()).decode()
            headers["Authorization"] = f"Basic {cred}"
        req = urllib.request.Request(
            self.base_url + path, data=body, method=method, headers=headers)
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read().decode())

    def execute(self, sql: str,
                poll_interval: float = 0.05) -> Tuple[List[dict], List[list]]:
        """Run to completion; returns (columns, rows)."""
        out = self._request("POST", "/v1/statement", sql.encode())
        columns: List[dict] = []
        rows: List[list] = []
        while True:
            state = out.get("stats", {}).get("state")
            if state in ("FAILED", "CANCELED"):
                raise QueryFailed(out.get("error", {}).get("message", state))
            if "columns" in out:
                columns = out["columns"]
                rows.extend(out.get("data", []))
            next_uri = out.get("nextUri")
            if next_uri is None:
                if state == "FINISHED":
                    return columns, rows
                raise QueryFailed(f"protocol error in state {state}")
            if state in ("QUEUED", "RUNNING"):
                time.sleep(poll_interval)
            out = self._request("GET", next_uri)

    def cancel(self, query_id: str) -> bool:
        return self._request("DELETE", f"/v1/statement/{query_id}")["canceled"]
