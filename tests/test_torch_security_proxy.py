"""The port's statement-protocol proxy (``presto1_tpu_torch/server/
proxy.py``), authentication and access control at its coordinator, and the
coordinator's web console on the CPU: twins of
``tests/test_security_proxy.py``.  Each answer through the port equals the
JAX package's coordinator on the same catalog (TPC-H at SF 0.001).
"""

import urllib.request

import pytest
import torch

import presto1_tpu.exec.catalog as j_catalog
import presto1_tpu.exec.engine as j_engine
from presto1_tpu.client.http_client import Client as JClient
from presto1_tpu.server.coordinator import CoordinatorServer as JServer
from presto1_tpu.server.proxy import ProxyServer as JProxy
from presto1_tpu_torch.client.http_client import Client
from presto1_tpu_torch.exec.catalog import TpchCatalog
from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.server.coordinator import CoordinatorServer
from presto1_tpu_torch.server.proxy import ProxyServer
from presto1_tpu_torch.server.security import (
    AccessControl, AccessDeniedError, AccessRule, PasswordAuthenticator,
    hash_password,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    return Engine(TpchCatalog(sf=0.001, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def ref_engine():
    return j_engine.Engine(j_catalog.TpchCatalog(sf=0.001))


def test_password_authenticator_and_acl(engine):
    auth = PasswordAuthenticator(users={
        "alice": hash_password("secret"),
        "bob": "plaintextpw",
    })
    acl = AccessControl([
        AccessRule(user="alice", table="nation|region", allow=True),
        AccessRule(user="alice", allow=False),
    ])
    srv = CoordinatorServer(engine, port=0, authenticator=auth,
                            access_control=acl).start()
    try:
        assert str(srv.manager.engine.device) == "cpu"
        base = f"http://127.0.0.1:{srv.port}"
        ok = Client(base, user="alice", password="secret")
        cols, rows = ok.execute("select count(*) c from nation")
        assert rows[0][0] == 25
        with pytest.raises(Exception):  # wrong password -> 401
            Client(base, user="alice", password="wrong").execute("select 1")
        with pytest.raises(Exception):  # table denied by rule
            ok.execute("select count(*) from customer")
        with pytest.raises(Exception):  # bob matches no rule
            Client(base, user="bob", password="plaintextpw").execute(
                "select count(*) from nation")
    finally:
        srv.stop()


def test_acl_unit():
    acl = AccessControl([AccessRule(user="u1", allow=True),
                         AccessRule(allow=False)])
    acl.check_can_select("u1", "tpch", "lineitem")
    with pytest.raises(AccessDeniedError):
        acl.check_can_select("u2", "tpch", "lineitem")
    assert acl.filter_tables("u2", "tpch", ["a", "b"]) == []


def test_proxy_round_robin_and_affinity(engine, ref_engine):
    """Queries through the proxy land on alternating coordinators and their
    follow-up polls on the owner; the same answers as through the JAX
    package's proxy in front of its coordinators."""
    s1 = CoordinatorServer(engine, port=0).start()
    s2 = CoordinatorServer(engine, port=0).start()
    proxy = ProxyServer([f"http://127.0.0.1:{s1.port}",
                         f"http://127.0.0.1:{s2.port}"], port=0).start()
    r1 = JServer(ref_engine, port=0).start()
    r2 = JServer(ref_engine, port=0).start()
    rproxy = JProxy([f"http://127.0.0.1:{r1.port}",
                     f"http://127.0.0.1:{r2.port}"], port=0).start()
    try:
        cli = Client(f"http://127.0.0.1:{proxy.port}")
        rcli = JClient(f"http://127.0.0.1:{rproxy.port}")
        for sql in ("select count(*) c from region",
                    "select r_name from region order by r_name",
                    "select l_orderkey from lineitem",  # paged via owner
                    "select count(*) c from region"):
            got = cli.execute(sql)
            assert got == rcli.execute(sql)
        assert cli.execute("select count(*) c from region")[1] == [[5]]
        assert (len(s1.manager.queries), len(s2.manager.queries)) == (3, 2)
        assert (len(r1.manager.queries), len(r2.manager.queries)) == (2, 2)
    finally:
        for s in (proxy, rproxy, s1, s2, r1, r2):
            s.stop()


def test_web_ui_page(engine):
    srv = CoordinatorServer(engine, port=0).start()
    try:
        Client(f"http://127.0.0.1:{srv.port}").execute("select 1")
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/ui", timeout=10).read().decode()
        assert "presto1-tpu coordinator" in html
        assert "FINISHED" in html
    finally:
        srv.stop()


def test_acl_covers_subquery_positions(engine):
    """Tables referenced only inside WHERE/SELECT/HAVING subqueries are
    still ACL-checked, and enforcement fails closed."""
    acl = AccessControl([
        AccessRule(user="carol", table="nation|region", allow=True),
        AccessRule(allow=False),
    ])
    eng = Engine(engine.catalog, access_control=acl, device="cpu")
    out = eng.sql("select count(*) c from nation", user="carol")
    assert int(out.columns["c"].data[0]) == 25
    with pytest.raises(AccessDeniedError):
        eng.sql("select n_name from nation where exists "
                "(select 1 from customer where c_nationkey = n_nationkey)",
                user="carol")
    with pytest.raises(AccessDeniedError):
        eng.sql("select r_name from region "
                "where r_regionkey < (select count(*) from supplier)",
                user="carol")
    with pytest.raises(AccessDeniedError):
        eng.sql("with x as (select * from customer) select count(*) from x",
                user="carol")


def test_ui_escapes_user_content(engine):
    """Stored-XSS guard: query text renders escaped in the web console."""
    srv = CoordinatorServer(engine, port=0).start()
    try:
        cli = Client(f"http://127.0.0.1:{srv.port}")
        try:
            cli.execute("select '<script>alert(1)</script>' x from region")
        except Exception:
            pass  # outcome irrelevant; the SQL text is now in the console
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/ui", timeout=10).read().decode()
        assert "<script>alert(1)" not in html
        assert "&lt;script&gt;" in html
    finally:
        srv.stop()
