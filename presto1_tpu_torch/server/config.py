"""Server configuration: the etc-dir / properties-file layer.

The reference configures every server from an ``etc/`` directory of Java
properties files bound to typed ``@Config`` POJOs at bootstrap
(``server/Server.java:84``, ``execution/TaskManagerConfig`` and friends,
catalog files loaded by ``metadata/CatalogManager`` +
``server/PluginManager.java``; file layout documented in
``docs/src/main/sphinx/installation/deployment.rst``).  This module is
the same three scopes as plain Python:

* ``etc/node.properties``    — node identity (node.id, node.environment)
* ``etc/config.properties``  — server role + HTTP + memory + session
  defaults (``coordinator=true|false``,
  ``node-scheduler.include-coordinator``,
  ``internal-communication.shared-secret``, ``http-server.http.port``,
  ``discovery.uri``, ``query.max-memory-per-node``, and any
  ``<session property>=<value>`` override applied to the default
  session — the SystemSessionProperties analog)
* ``etc/catalog/*.properties`` — one file per catalog naming
  ``connector.name`` (tpch / tpcds / memory / file, or a connector's
  factory as ``<module>:<function>``, the plugin loading of the
  reference) plus connector-specific properties.

A coordinator with ``node-scheduler.include-coordinator=false`` (Trino's
multi-node deployment) schedules every query onto the workers that announce
themselves to its discovery endpoint and runs the rest of its statements
itself; with ``true`` (the default, Trino's single node) it runs them all.
Every node of a cluster reads the same ``etc/catalog``: a worker builds its
catalog from those properties as the coordinator does.  Every node of a
cluster sets the same ``internal-communication.shared-secret``, whose bearer
its internal requests carry (``security.internal_headers``); a coordinator
with password authentication and workers refuses to start without one.

Values are validated at load time (unknown connector, malformed size)
— the airlift fail-at-bootstrap contract.
"""

from __future__ import annotations

import importlib
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Optional


class ConfigError(ValueError):
    pass


def load_properties(path: str) -> Dict[str, str]:
    """Java-properties subset: ``key=value`` lines, ``#``/``!`` comments,
    whitespace trimmed (what the reference's deployment docs use)."""
    props: Dict[str, str] = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line[0] in "#!":
                continue
            if "=" not in line:
                raise ConfigError(f"{path}:{lineno}: expected key=value, "
                                  f"got {line!r}")
            key, _, value = line.partition("=")
            props[key.strip()] = value.strip()
    return props


_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*([kKmMgGtT]?)B?$")
_SIZE_MULT = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(text: str) -> int:
    """'4GB' / '512MB' / '1024' -> bytes (airlift DataSize analog)."""
    m = _SIZE_RE.match(text.strip())
    if not m:
        raise ConfigError(f"malformed size {text!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).lower()])


def parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("true", "1", "yes"):
        return True
    if t in ("false", "0", "no"):
        return False
    raise ConfigError(f"malformed boolean {text!r}")


def build_catalog(props: Dict[str, str], name: str = "catalog",
                  device="cuda"):
    """One catalog .properties -> a Catalog instance on ``device``
    (PluginManager + CatalogManager analog; ``connector.name`` selects the
    plugin).  A ``connector.name`` of the form ``<module>:<function>`` names
    a connector's factory, called as ``function(props, name, device)``."""
    kind = props.get("connector.name")
    if not kind:
        raise ConfigError(f"{name}: missing connector.name")
    if ":" in kind:
        module, _, attr = kind.partition(":")
        try:
            factory = getattr(importlib.import_module(module), attr)
        except (ImportError, AttributeError) as e:
            raise ConfigError(f"{name}: connector factory {kind!r} not "
                              f"found: {e}") from None
        return factory(props, name, device)
    if kind == "tpch":
        from ..exec.catalog import TpchCatalog

        schema = props.get("tpch.schema", "tiny")
        return TpchCatalog(schema=schema,
                           cache_dir=props.get("tpch.cache-dir"),
                           device=device)
    if kind == "tpcds":
        from ..tpcds.catalog import TpcdsCatalog

        return TpcdsCatalog(sf=float(props.get("tpcds.scale-factor", "0.01")),
                            device=device)
    if kind == "memory":
        from ..exec.catalog import Catalog

        return Catalog()  # writable tables arrive via CREATE TABLE
    if kind == "file":
        from ..exec.file_catalog import FileCatalog

        root = props.get("file.root")
        if not root:
            raise ConfigError(f"{name}: file connector needs file.root")
        return FileCatalog(root, device=device)
    raise ConfigError(f"{name}: unknown connector.name {kind!r}")


@dataclass
class ServerConfig:
    """Typed view of one etc dir (the bootstrap-validated @Config POJOs)."""

    coordinator: bool = True
    # a coordinator that also executes (single node); False: queries run
    # on the discovered workers
    include_coordinator: bool = True
    # the cluster's shared secret for internal communication (None: none)
    shared_secret: Optional[str] = None
    http_host: str = "127.0.0.1"
    http_port: int = 8080
    discovery_uri: Optional[str] = None
    node_id: Optional[str] = None
    node_environment: str = "production"
    query_max_memory_per_node: int = 0  # bytes; 0 = unlimited
    max_concurrency: int = 4
    session_defaults: Dict[str, object] = field(default_factory=dict)
    catalogs: Dict[str, Dict[str, str]] = field(default_factory=dict)
    default_catalog: Optional[str] = None
    password_file: Optional[str] = None
    resource_groups_path: Optional[str] = None
    etc_dir: Optional[str] = None
    # the torch device this server computes on (the launcher's --device)
    device: str = "cuda"

    @classmethod
    def from_etc_dir(cls, etc: str) -> "ServerConfig":
        from ..exec.session import SYSTEM_SESSION_PROPERTIES

        cfg = cls(etc_dir=etc)
        cfg_path = os.path.join(etc, "config.properties")
        props = load_properties(cfg_path) if os.path.exists(cfg_path) else {}
        known = {
            "coordinator", "node-scheduler.include-coordinator",
            "internal-communication.shared-secret",
            "http-server.http.port", "http-server.http.host",
            "discovery.uri", "query.max-memory-per-node",
            "query.max-concurrent-queries", "catalog.default",
        }
        for key, value in props.items():
            if key == "coordinator":
                cfg.coordinator = parse_bool(value)
            elif key == "node-scheduler.include-coordinator":
                cfg.include_coordinator = parse_bool(value)
            elif key == "internal-communication.shared-secret":
                if not value:
                    raise ConfigError(f"{cfg_path}: {key} is empty")
                cfg.shared_secret = value
            elif key == "http-server.http.port":
                cfg.http_port = int(value)
            elif key == "http-server.http.host":
                cfg.http_host = value
            elif key == "discovery.uri":
                cfg.discovery_uri = value
            elif key == "query.max-memory-per-node":
                cfg.query_max_memory_per_node = parse_size(value)
            elif key == "query.max-concurrent-queries":
                cfg.max_concurrency = int(value)
            elif key == "catalog.default":
                cfg.default_catalog = value
            elif key in SYSTEM_SESSION_PROPERTIES:
                ty = SYSTEM_SESSION_PROPERTIES[key][0]
                cfg.session_defaults[key] = (
                    parse_bool(value) if ty is bool else ty(value))
            elif key not in known:
                raise ConfigError(f"{cfg_path}: unknown property {key!r}")

        node_path = os.path.join(etc, "node.properties")
        if os.path.exists(node_path):
            nprops = load_properties(node_path)
            cfg.node_id = nprops.get("node.id", cfg.node_id)
            cfg.node_environment = nprops.get("node.environment",
                                              cfg.node_environment)

        cat_dir = os.path.join(etc, "catalog")
        if os.path.isdir(cat_dir):
            for fn in sorted(os.listdir(cat_dir)):
                if fn.endswith(".properties"):
                    cfg.catalogs[fn[:-len(".properties")]] = load_properties(
                        os.path.join(cat_dir, fn))
        pw = os.path.join(etc, "password-authenticator.properties")
        if os.path.exists(pw):
            pprops = load_properties(pw)
            f = pprops.get("file.password-file")
            cfg.password_file = (os.path.join(etc, f)
                                 if f and not os.path.isabs(f) else f)
        rg = os.path.join(etc, "resource-groups.json")
        if os.path.exists(rg):
            cfg.resource_groups_path = rg
        return cfg

    # ---- factories ----------------------------------------------------

    def pick_catalog_props(self):
        """The catalog this server serves (single-catalog engine)."""
        if not self.catalogs:
            raise ConfigError("no catalog/*.properties found")
        if self.default_catalog:
            if self.default_catalog not in self.catalogs:
                raise ConfigError(
                    f"catalog.default={self.default_catalog!r} has no "
                    f"catalog/{self.default_catalog}.properties")
            name = self.default_catalog
        elif len(self.catalogs) == 1:
            name = next(iter(self.catalogs))
        else:
            raise ConfigError(
                "multiple catalogs configured; set catalog.default in "
                "config.properties")
        return name, self.catalogs[name]

    def build_coordinator(self):
        """etc dir -> a ready CoordinatorServer (Server.java:84 analog)."""
        import json

        from ..exec.engine import Engine
        from ..exec.memory import MemoryPool
        from ..exec.session import Session
        from .coordinator import CoordinatorServer
        from .security import PasswordAuthenticator

        name, props = self.pick_catalog_props()
        catalog = build_catalog(props, name, device=self.device)
        session = Session(catalog=name)
        for key, value in self.session_defaults.items():
            session.set(key, value)
        pool = (MemoryPool(self.query_max_memory_per_node)
                if self.query_max_memory_per_node else None)
        engine = Engine(catalog, session=session, memory_pool=pool,
                        device=self.device)
        cluster = None
        if not self.include_coordinator:
            # Trino's multi-node layout: queries go to the workers that
            # announce themselves here; planning, the final stage and every
            # other statement stay here
            from ..exec.dist_engine import MultiHostEngine
            from .discovery import NodeRegistry

            cluster = MultiHostEngine(catalog, NodeRegistry(),
                                      device=self.device, session=session,
                                      internal_secret=self.shared_secret)
        # a password file means password authentication (the JAX package
        # passes it to the allow-all base class, which takes no argument:
        # ROADMAP C23)
        auth = (PasswordAuthenticator(self.password_file)
                if self.password_file else None)
        groups = None
        if self.resource_groups_path:
            with open(self.resource_groups_path) as f:
                groups = json.load(f)
        return CoordinatorServer(engine, host=self.http_host,
                                 port=self.http_port, authenticator=auth,
                                 resource_groups=groups, cluster=cluster)

    def build_worker(self):
        """A worker over the catalog its properties describe (built when its
        first task arrives), announcing itself to ``discovery.uri``."""
        from .worker import WorkerServer

        return WorkerServer(self.pick_catalog_props()[1],
                            host=self.http_host,
                            port=self.http_port,
                            coordinator=self.discovery_uri,
                            device=self.device,
                            internal_secret=self.shared_secret)

    def build(self):
        return (self.build_coordinator() if self.coordinator
                else self.build_worker())
