"""The in-process layout: one ``Engine`` over the benchmark's catalog in
the harness's own process; a query is ``engine.sql(text).to_pylist()``.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.session import Session

from ..harness import PROFILE_LEAD, copy_rate, sync
from ..port_catalog import BenchCatalog


class Driver:
    PART = "sql"

    def __init__(self, setting):
        self.setting = setting
        self.engine = None
        self.catalog = None
        self.prof = None

    def setup(self) -> dict:
        dev = self.setting.device
        t0 = time.perf_counter()
        t_upload = self.build()
        self.warm()
        t_compile = time.perf_counter()
        self.warm()
        sync(dev)
        t_warm = time.perf_counter()
        self.reset_peak()
        return {"upload_s": t_upload - t0, "compile_s": t_compile - t_upload,
                "warm_s": t_warm - t_compile}

    def build(self, catalog: Optional[str] = None) -> float:
        """The catalog with the mix's columns on the device, and the engine
        over it with the mix's session properties (on a ``Session`` of the
        catalog ``catalog``, where given).  Returns the host's
        ``perf_counter`` when the upload had ended."""
        s, dev = self.setting, self.setting.device
        self.catalog = BenchCatalog(s.store, device=dev)
        for t, cols in s.columns.items():
            for c in cols:
                self.catalog.table(t).column(c)
        sync(dev)
        t_upload = time.perf_counter()
        session = Session() if catalog is None else Session(catalog=catalog)
        for k, v in s.mix["session"].items():
            session.set(k, v)
        self.engine = Engine(self.catalog, session=session, device=dev)
        return t_upload

    def warm(self) -> None:
        """One call of every text."""
        for inst in self.setting.traffic.instances:
            self.engine.sql(inst.text).to_pylist()

    def query(self, session: int, text: str, parts):
        if parts is None:
            return self.engine.sql(text).to_pylist()
        out = self.engine.sql(text)
        parts.append(("to_host", time.perf_counter()))
        return out.to_pylist()

    def answer(self, rows):
        return rows, None, None

    def start_profile(self) -> int:
        dev = self.setting.device
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(dev)
        return round(time.perf_counter() * 1e9)

    def stop_profile(self):
        self.prof.__exit__(None, None, None)
        return self.prof

    def reset_peak(self) -> None:
        if self.setting.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.setting.device)

    def device(self) -> dict:
        dev = self.setting.device
        if dev.type != "cuda":
            return {"kind": dev.type, "memory_peak_bytes": 0}
        return {"kind": torch.cuda.get_device_name(dev),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}

    def notes(self) -> dict:
        dev = self.setting.device
        return {"copy_rate_gb_s": copy_rate(dev)} if dev.type == "cuda" \
            else {}

    def close(self) -> list:
        if self.engine is not None or self.catalog is not None:
            self.engine = self.catalog = self.prof = None
            gc.collect()
            if self.setting.device.type == "cuda":
                torch.cuda.empty_cache()
        return []
