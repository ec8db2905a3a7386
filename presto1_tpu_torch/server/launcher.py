"""Server launcher: ``python -m presto1_tpu_torch.server.launcher --etc-dir etc``.

The reference ships a provisio tarball whose ``bin/launcher`` script
starts ``TrinoServer.main`` against an ``etc/`` directory
(``core/trino-server/src/main/provisio/presto.xml``,
``core/trino-server-main/.../TrinoServer.java:27``); coordinator vs
worker is purely config (``coordinator=true|false`` in
config.properties).  Same contract here: one entrypoint, role chosen by
the etc dir, and the torch device to compute on chosen by ``--device``
(default ``cuda``; ``cpu`` runs without a card).
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="presto1_tpu_torch server "
                                             "launcher")
    ap.add_argument("--etc-dir", default="etc",
                    help="configuration directory (config.properties, "
                         "node.properties, catalog/*.properties)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the server computes on (default: "
                         "cuda)")
    ap.add_argument("--parent-pid", type=int, default=None,
                    help="exit when this process is gone (a launcher that "
                         "dies leaves no server behind)")
    args = ap.parse_args(argv)
    if args.parent_pid is not None:
        from .worker import _exit_with

        threading.Thread(target=_exit_with, args=(args.parent_pid,),
                         daemon=True).start()

    from .config import ServerConfig

    cfg = ServerConfig.from_etc_dir(args.etc_dir)
    cfg.device = args.device
    srv = cfg.build().start()
    role = "coordinator" if cfg.coordinator else "worker"
    uri = getattr(srv, "uri", None)
    uri = uri() if callable(uri) else f"http://{cfg.http_host}:{srv.port}"
    print(json.dumps({"role": role, "uri": uri, "device": args.device,
                      "environment": cfg.node_environment}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
