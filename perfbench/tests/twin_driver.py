"""A driver that only a test ships: one ``Engine`` a session over one
catalog, in the harness's process.  The test copies it into a copy of the
benchmark as ``perfbench/drivers/twin.py``, beside a mix that names it, to
show that a layout the harness does not know comes as new files alone."""

from presto1_tpu_torch.exec.engine import Engine
from presto1_tpu_torch.exec.session import Session

from perfbench.drivers import engine


class Driver(engine.Driver):
    def setup(self) -> dict:
        phases = super().setup()
        self.engines = [self.engine]
        for _ in range(1, self.setting.sessions):
            session = Session()
            for k, v in self.setting.mix["session"].items():
                session.set(k, v)
            self.engines.append(Engine(self.catalog, session=session,
                                       device=self.setting.device))
            for _ in range(2):
                for inst in self.setting.traffic.instances:
                    self.engines[-1].sql(inst.text).to_pylist()
        return phases

    def query(self, session, text, parts):
        return self.engines[session].sql(text).to_pylist()

    def close(self) -> list:
        self.engines = []
        return super().close()
