"""Hierarchical resource groups (admission control).

The coordinator-side analog of the reference's
``execution/resourcegroups/InternalResourceGroup.java:77`` +
``ResourceGroupConfigurationManager``: a tree of named groups, each with a
hard concurrency limit and a queue bound, selected per query by
(user, source) selector rules with ``${USER}`` template expansion.  A
query runs when EVERY group on its path to the root has capacity;
otherwise it queues FIFO in its leaf group (or is rejected when the queue
is full — the reference's QUERY_QUEUE_FULL).  Completion releases the
path and dequeues eligible work, children in round-robin order (the
reference's fair scheduling policy reduced to its observable behavior).
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Callable, Dict, List, Optional


class QueryQueueFull(Exception):
    pass


class ResourceGroup:
    def __init__(self, name: str, parent: Optional["ResourceGroup"] = None,
                 hard_concurrency_limit: Optional[int] = None,
                 max_queued: Optional[int] = None):
        self.name = name
        self.parent = parent
        self.hard_concurrency_limit = hard_concurrency_limit
        self.max_queued = max_queued
        self.children: Dict[str, ResourceGroup] = {}
        self.running = 0        # subtree running count
        self.queued = 0         # subtree queued count
        self.queue: deque = deque()  # leaf FIFO of pending thunks
        self._rr = 0            # child round-robin cursor

    @property
    def path(self) -> str:
        if self.parent is None or self.parent.name == "" \
                and self.parent.parent is None:
            return self.name
        return f"{self.parent.path}.{self.name}"

    def child(self, name: str, **limits) -> "ResourceGroup":
        if name not in self.children:
            self.children[name] = ResourceGroup(name, self, **limits)
        return self.children[name]

    def _ancestors(self):
        g = self
        while g is not None:
            yield g
            g = g.parent

    def can_run(self) -> bool:
        return all(g.hard_concurrency_limit is None
                   or g.running < g.hard_concurrency_limit
                   for g in self._ancestors())

    def _acquire(self):
        for g in self._ancestors():
            g.running += 1

    def _release(self):
        for g in self._ancestors():
            g.running -= 1

    def info(self) -> dict:
        return {"path": self.path, "running": self.running,
                "queued": self.queued,
                "hardConcurrencyLimit": self.hard_concurrency_limit,
                "maxQueued": self.max_queued,
                "children": [c.info() for c in self.children.values()]}


class ResourceGroupManager:
    """Owns the group tree, the selector rules, and the run/queue decision.
    ``config`` mirrors the reference's resource-groups JSON: a recursive
    group spec plus ordered selectors (first match wins)."""

    def __init__(self, config: Optional[dict] = None,
                 default_concurrency: int = 4):
        self._lock = threading.Lock()
        config = config or {
            "groups": [{"name": "global",
                        "hardConcurrencyLimit": default_concurrency,
                        "maxQueued": 1000}],
            "selectors": [{"group": "global"}],
        }
        self.root = ResourceGroup("", None)
        for spec in config["groups"]:
            self._build(self.root, spec)
        self.selectors: List[dict] = list(config["selectors"])

    def _build(self, parent: ResourceGroup, spec: dict) -> None:
        g = parent.child(spec["name"],
                         hard_concurrency_limit=spec.get(
                             "hardConcurrencyLimit"),
                         max_queued=spec.get("maxQueued"))
        for sub in spec.get("subGroups", []):
            self._build(g, sub)

    def _resolve(self, path: str, user: str) -> ResourceGroup:
        g = self.root
        for part in path.split("."):
            part = part.replace("${USER}", user)
            if part in g.children:
                g = g.children[part]
            elif "${USER}" in g.children:
                # templated subtree (a configured "${USER}" group):
                # instantiate a per-user sibling carrying its limits
                tmpl = g.children["${USER}"]
                g = g.child(part,
                            hard_concurrency_limit=tmpl
                            .hard_concurrency_limit,
                            max_queued=tmpl.max_queued)
            else:
                # dynamic leaf with no limits of its own (ancestors gate)
                g = g.child(part)
        return g

    def select(self, user: str, source: Optional[str] = None) -> ResourceGroup:
        for rule in self.selectors:
            if "user" in rule and not re.fullmatch(rule["user"], user or ""):
                continue
            if "source" in rule and not re.fullmatch(rule["source"],
                                                     source or ""):
                continue
            return self._resolve(rule["group"], user or "")
        return self._resolve("global", user or "")

    def submit(self, user: str, source: Optional[str],
               run: Callable[[], None],
               execute: Callable[[Callable[[], None]], None]) -> str:
        """Admit or queue one query.  ``run`` is the query body; ``execute``
        schedules a thunk on the actual worker pool.  Returns the selected
        group path.  Raises QueryQueueFull when the leaf queue is at its
        bound."""
        with self._lock:
            group = self.select(user, source)
            thunk = self._wrap(group, run, execute)
            if group.can_run():
                group._acquire()
                execute(thunk)
            else:
                limit = group.max_queued
                if limit is not None and len(group.queue) >= limit:
                    raise QueryQueueFull(
                        f"Too many queued queries for {group.path!r}")
                group.queue.append(thunk)
                for g in group._ancestors():
                    g.queued += 1
            return group.path

    def _wrap(self, group: ResourceGroup, run, execute):
        def thunk():
            try:
                run()
            finally:
                with self._lock:
                    group._release()
                    self._dispatch(self.root, execute)
        return thunk

    def _dispatch(self, g: ResourceGroup, execute) -> bool:
        """Start one eligible queued query under ``g`` (children visited
        round-robin).  Caller holds the lock."""
        if g.queue and g.can_run():
            thunk = g.queue.popleft()
            for a in g._ancestors():
                a.queued -= 1
            g._acquire()
            execute(thunk)
            return True
        kids = list(g.children.values())
        for i in range(len(kids)):
            child = kids[(g._rr + i) % len(kids)]
            if self._dispatch(child, execute):
                g._rr = (g._rr + i + 1) % len(kids)
                return True
        return False

    def info(self) -> dict:
        with self._lock:
            return {"groups": [c.info() for c in self.root.children.values()]}
