"""The one traffic generator: a mix file (``perfbench/mixes/<name>.json``)
and a seed give the instances of each template and the order of the
closed loop.

Mix keys:
  ``driver``           what runs the program and sends its queries, found as
                       ``perfbench/drivers/<name>.py`` (default ``engine``:
                       one ``Engine`` in the harness's own process)
  ``sessions``         client sessions, each a closed loop of its own
                       (default 1)
  ``session``          session properties of the program's engine
  ``templates``        template names (``q3``), found as
                       ``perfbench/reference/<suite>_<name>.py``
  ``instances``        parameter instances drawn per template
  ``instance_seed``    the seed those instances are drawn from
  ``trace_queries``    queries the traced run profiles

The instances are the same for every run's seed, so that every seed asks
for the same work; the run's seed draws the order, and each session its
own order from the seed and its index (session 0's is the one a cell of
one session has always drawn).  The tests and the
control draw other instances by passing ``instance_seed`` themselves.  Every cycle of the
loop sends each template once, in an order drawn anew for each cycle, and
a template's instances come round in a seeded order, each as often as the
others.
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterator, List, Optional

import numpy as np


def template(suite: str, name: str):
    return importlib.import_module(f"{__package__}.reference.{suite}_{name}")


class Instance:
    def __init__(self, index: int, name: str, module, params: dict):
        self.index, self.name, self.module = index, name, module
        self.params = params
        self.text = module.SQL.format(**params)


class Traffic:
    def __init__(self, mix: dict, suite: str, seed: int,
                 instance_seed: Optional[int] = None):
        self.mix = mix
        self.seed = seed % (1 << 128)
        self.rng = np.random.default_rng(self.seed)
        self.templates = {t: template(suite, t) for t in mix["templates"]}
        self.instances: List[Instance] = []
        self.by_template: Dict[str, List[Instance]] = {}
        draws = np.random.default_rng(
            mix["instance_seed"] if instance_seed is None else instance_seed)
        for name, module in self.templates.items():
            texts = {}
            for _ in range(mix["instances"]):
                params = module.draw(draws)
                text = module.SQL.format(**params)
                if text not in texts:
                    texts[text] = Instance(len(self.instances), name,
                                           module, params)
                    self.instances.append(texts[text])
            self.by_template[name] = list(texts.values())

    def columns(self) -> Dict[str, List[str]]:
        """Every column the mix's templates read, by table."""
        out: Dict[str, List[str]] = {}
        for module in self.templates.values():
            for table, cols in module.COLUMNS.items():
                have = out.setdefault(table, [])
                have += [c for c in cols if c not in have]
        return out

    def sequence(self, session: int = 0) -> Iterator[Instance]:
        """The closed loop's queries of one session, without end."""
        rng = self.rng if session == 0 else \
            np.random.default_rng([self.seed, session])
        names = list(self.templates)
        turns = {n: [self.by_template[n][k] for k in
                     rng.permutation(len(self.by_template[n]))]
                 for n in names}
        step = {n: 0 for n in names}
        while True:
            for k in rng.permutation(len(names)):
                n = names[k]
                yield turns[n][step[n] % len(turns[n])]
                step[n] += 1
