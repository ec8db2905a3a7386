"""The port's etc-dir configuration layer (``presto1_tpu_torch/server/
config.py``) and launcher on the CPU: twins of ``tests/test_config.py``,
each parse held against the JAX package's ``server/config.py`` on the same
files, and the servers it builds started with ``device="cpu"``.  Then the
reference defect C23: a ``password-authenticator.properties`` makes the
JAX package's ``build_coordinator`` raise; the port's coordinator
authenticates against the password file.  ``connector.name=file`` builds
the port's ``FileCatalog`` over ``file.root`` on the given device, and
raises ``ConfigError`` without a root, as the JAX package does.
"""

import json
import os
import urllib.error
import urllib.request

import pytest
import torch

import presto1_tpu.server.config as j_config
from presto1_tpu_torch.client.http_client import Client
from presto1_tpu_torch.server.config import (ConfigError, ServerConfig,
                                             build_catalog, load_properties,
                                             parse_bool, parse_size)

torch.set_num_threads(1)


def write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def make_etc(tmp_path, config, catalogs=None, node=None, name="etc"):
    etc = str(tmp_path / name)
    write(os.path.join(etc, "config.properties"), config)
    for cname, text in (catalogs or {}).items():
        write(os.path.join(etc, "catalog", f"{cname}.properties"), text)
    if node:
        write(os.path.join(etc, "node.properties"), node)
    return etc


def _cpu(cfg):
    cfg.device = "cpu"
    return cfg


def test_properties_parser(tmp_path):
    p = str(tmp_path / "x.properties")
    write(p, "# comment\na=1\n  b = two \n\n! also comment\nc=x=y\n")
    assert load_properties(p) == j_config.load_properties(p) == \
        {"a": "1", "b": "two", "c": "x=y"}
    write(p, "noequals\n")
    with pytest.raises(ConfigError):
        load_properties(p)
    with pytest.raises(j_config.ConfigError):
        j_config.load_properties(p)


@pytest.mark.parametrize("text", ["4GB", "512MB", "1024", "1.5k", "2T",
                                  "4 parsecs", "", "GB"])
def test_size_matches_reference(text):
    try:
        want = j_config.parse_size(text)
    except j_config.ConfigError:
        with pytest.raises(ConfigError):
            parse_size(text)
        return
    assert parse_size(text) == want


def test_size_and_bool():
    assert parse_size("4GB") == 4 << 30
    assert parse_size("512MB") == 512 << 20
    assert parse_size("1024") == 1024
    assert parse_bool("TRUE") and not parse_bool("false")
    for t in ("TRUE", "false", "1", "no"):
        assert parse_bool(t) == j_config.parse_bool(t)
    with pytest.raises(ConfigError):
        parse_size("4 parsecs")
    with pytest.raises(ConfigError):
        parse_bool("maybe")


def test_typed_config_and_session_defaults(tmp_path):
    etc = make_etc(
        tmp_path,
        "coordinator=true\n"
        "http-server.http.port=9321\n"
        "query.max-memory-per-node=1GB\n"
        "compile_queries=true\n"          # session property default
        "spill_threshold=4096\n",
        catalogs={"tpch": "connector.name=tpch\ntpch.schema=tiny\n"},
        node="node.id=n-test\nnode.environment=ci\n")
    cfg = ServerConfig.from_etc_dir(etc)
    ref = j_config.ServerConfig.from_etc_dir(etc)
    assert cfg.coordinator and cfg.http_port == 9321
    assert cfg.query_max_memory_per_node == 1 << 30
    assert cfg.session_defaults == {"compile_queries": True,
                                    "spill_threshold": 4096}
    assert cfg.node_id == "n-test" and cfg.node_environment == "ci"
    assert list(cfg.catalogs) == ["tpch"]
    for field in ("coordinator", "http_port", "http_host", "discovery_uri",
                  "node_id", "node_environment", "query_max_memory_per_node",
                  "max_concurrency", "session_defaults", "catalogs",
                  "default_catalog", "password_file", "resource_groups_path"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert cfg.device == "cuda"  # the launcher's --device sets it


def test_unknown_property_fails_at_bootstrap(tmp_path):
    etc = make_etc(tmp_path, "coordinator=true\nhttp-sever.port=1\n")
    with pytest.raises(ConfigError):
        ServerConfig.from_etc_dir(etc)
    with pytest.raises(j_config.ConfigError):
        j_config.ServerConfig.from_etc_dir(etc)


def test_catalog_factory_validation():
    with pytest.raises(ConfigError):
        build_catalog({}, "x", device="cpu")
    with pytest.raises(ConfigError):
        build_catalog({"connector.name": "oracle9i"}, "x", device="cpu")
    cat = build_catalog({"connector.name": "tpch", "tpch.schema": "tiny"},
                        device="cpu")
    ref = j_config.build_catalog({"connector.name": "tpch",
                                  "tpch.schema": "tiny"})
    assert "lineitem" in cat.tables
    assert sorted(cat.tables) == sorted(ref.tables)
    assert cat.sf == ref.sf and str(cat.device) == "cpu"
    ds = build_catalog({"connector.name": "tpcds",
                        "tpcds.scale-factor": "0.01"}, device="cpu")
    assert "store_sales" in ds.tables


def test_file_connector_names_a10(tmp_path):
    """The file connector (ROADMAP A10, ported): a directory of one CSV file
    answers a query on the CPU, as the JAX package's catalog over the same
    directory does; without ``file.root`` both raise ``ConfigError``."""
    from presto1_tpu.exec.engine import Engine as JEngine
    from presto1_tpu_torch.exec.engine import Engine

    write(str(tmp_path / "t.csv"), "k,v\n1,2.5\n2,4.0\n2,1.5\n")
    props = {"connector.name": "file", "file.root": str(tmp_path)}
    cat = build_catalog(props, "files", device="cpu")
    assert str(cat.device) == "cpu" and sorted(cat.tables) == ["t"]
    sql = "select k, sum(v) s, count(*) c from t group by k order by k"
    got = Engine(cat, device="cpu").sql(sql).to_pylist()
    assert got == JEngine(j_config.build_catalog(props, "files")).sql(
        sql).to_pylist() == [(1, 2.5, 1), (2, 5.5, 2)]
    with pytest.raises(ConfigError, match="file.root"):
        build_catalog({"connector.name": "file"}, "files", device="cpu")
    with pytest.raises(j_config.ConfigError, match="file.root"):
        j_config.build_catalog({"connector.name": "file"}, "files")


def test_coordinator_end_to_end_from_etc(tmp_path):
    etc = make_etc(
        tmp_path,
        "coordinator=true\nhttp-server.http.port=0\n",
        catalogs={"tpch": "connector.name=tpch\ntpch.schema=tiny\n"})
    srv = _cpu(ServerConfig.from_etc_dir(etc)).build().start()
    try:
        cols, rows = Client(f"http://127.0.0.1:{srv.port}").execute(
            "select count(*) from nation")
        assert rows == [[25]]
        assert str(srv.manager.engine.device) == "cpu"
    finally:
        srv.stop()


def test_worker_role_from_etc(tmp_path):
    etc = make_etc(
        tmp_path,
        "coordinator=false\nhttp-server.http.port=0\n",
        catalogs={"tpch": "connector.name=tpch\ntpch.schema=tiny\n"})
    cfg = ServerConfig.from_etc_dir(etc)
    assert not cfg.coordinator
    assert cfg.catalog_spec() == "tpch:tiny" == \
        j_config.ServerConfig.from_etc_dir(etc).catalog_spec()
    srv = _cpu(cfg).build().start()
    try:
        with urllib.request.urlopen(srv.uri() + "/v1/status",
                                    timeout=10) as r:
            status = json.load(r)
        assert status["nodeId"] and status["device"] == "cpu"
    finally:
        srv.stop()


def test_multiple_catalogs_need_default(tmp_path):
    etc = make_etc(
        tmp_path, "coordinator=true\n",
        catalogs={"a": "connector.name=tpch\n",
                  "b": "connector.name=memory\n"})
    with pytest.raises(ConfigError):
        ServerConfig.from_etc_dir(etc).pick_catalog_props()
    etc2 = make_etc(
        tmp_path, "coordinator=true\ncatalog.default=b\n",
        catalogs={"a": "connector.name=tpch\n",
                  "b": "connector.name=memory\n"}, name="etc2")
    name, props = ServerConfig.from_etc_dir(etc2).pick_catalog_props()
    assert (name, props) == \
        j_config.ServerConfig.from_etc_dir(etc2).pick_catalog_props()
    assert name == "b" and props["connector.name"] == "memory"


def test_password_file_authenticates_c23(tmp_path):
    """``etc/password-authenticator.properties`` names a password file.
    The JAX package's ``build_coordinator`` passes it to the allow-all
    ``Authenticator``, which takes no argument
    (``presto1_tpu/server/config.py:224-225``): ``TypeError``.  The port
    builds a ``PasswordAuthenticator``: the right password answers, a wrong
    one is refused."""
    from presto1_tpu_torch.server.security import hash_password

    etc = make_etc(
        tmp_path, "coordinator=true\nhttp-server.http.port=0\n",
        catalogs={"tpch": "connector.name=tpch\ntpch.schema=tiny\n"})
    write(os.path.join(etc, "password-authenticator.properties"),
          "file.password-file=passwords\n")
    write(os.path.join(etc, "passwords"),
          f"alice:{hash_password('secret')}\n")
    with pytest.raises(TypeError):
        j_config.ServerConfig.from_etc_dir(etc).build_coordinator()
    srv = _cpu(ServerConfig.from_etc_dir(etc)).build().start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        ok = Client(base, user="alice", password="secret")
        assert ok.execute("select count(*) from region")[1] == [[5]]
        with pytest.raises(urllib.error.HTTPError):
            Client(base, user="alice", password="wrong").execute("select 1")
    finally:
        srv.stop()


def test_launcher_takes_a_device(tmp_path):
    """``python -m presto1_tpu_torch.server.launcher --etc-dir ... --device
    cpu`` starts the etc dir's server on the CPU (and prints its role)."""
    import select
    import subprocess
    import sys

    etc = make_etc(
        tmp_path, "coordinator=true\nhttp-server.http.port=0\n",
        catalogs={"tpch": "connector.name=tpch\ntpch.schema=tiny\n"})
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, "-m", "presto1_tpu_torch.server.launcher",
         "--etc-dir", etc, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, text=True)
    try:
        # the launcher prints one line once it serves (waited for, bounded)
        ready, _, _ = select.select([p.stdout], [], [], 120)
        assert ready, "the launcher printed nothing in 120 s"
        info = json.loads(p.stdout.readline())
        assert info["role"] == "coordinator" and info["device"] == "cpu"
        cols, rows = Client(info["uri"]).execute(
            "select count(*) from nation")
        assert rows == [[25]]
    finally:
        p.kill()
        p.wait(timeout=30)
        p.stdout.close()

