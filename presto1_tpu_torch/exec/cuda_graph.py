"""A compiled statement's fragments captured as one CUDA graph.

``StatementGraph.capture(run, device)`` records every kernel that
``run()`` enqueues (a ``CompiledQuery``'s fragments, in stage order, and
the flags of its readback) into one ``torch.cuda.CUDAGraph``;
``replay()`` launches the whole statement with one call and no Python per
kernel.  The graph reads the tensors that were on the device at capture
(the statement's scan inputs, the tables its record keeps) and writes into
buffers of its own, which every replay rewrites, so a replay hands out
fresh copies: the final fragment's arrays and the readback pair are packed
into one buffer inside the graph, and a replay copies that buffer once, on
the stream, without waiting for the device.

Every graph of a device captures into one memory pool, so the device holds
the largest statement's intermediates once, not each statement's: a graph's
packed buffer stays its own, and its intermediates lie where the next
capture may put its own.  So the device runs those graphs one at a time: a
replay waits on the stream for the previous replay's copy, whichever
thread and stream made it (``_DeviceGraphs``).

What a capture cannot do, it raises; the caller then runs the statement
eagerly and says why (``CompiledQuery.graph_reason``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Tuple, Union

import torch

# bytes each packed array starts on: the widest element's alignment
_ALIGN = 16
# one capture at a time in a process: a device's captures share its pool
# and its capture stream
_CAPTURE_LOCK = threading.Lock()


class _DeviceGraphs:
    """What the statement graphs of one device share: one memory pool, the
    stream every capture runs on (the allocator keeps a pool's free blocks
    by stream, so one stream lets a capture reuse what an earlier one
    freed), and the order of their replays.  As a context manager it holds
    one replay and its copy: the current stream waits for the previous
    replay's copy, and this one's is recorded on leaving."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        # the latest graph captured into the pool: a pool is released when
        # the last graph that captured into it goes, and no capture may
        # name it after that, so one is kept whatever becomes of its
        # statement
        self.anchor = None
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.device = device

    def __enter__(self):
        self.lock.acquire()
        torch.cuda.current_stream(self.device).wait_event(self.done)
        return self

    def __exit__(self, *exc):
        try:
            self.done.record(torch.cuda.current_stream(self.device))
        finally:
            self.lock.release()


# device index -> its graphs' pool, capture stream and replay order
_DEVICES: Dict[int, _DeviceGraphs] = {}


def _device_graphs(device: torch.device) -> _DeviceGraphs:
    """The shared state of ``device``'s graphs (called under the capture
    lock)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _DEVICES:
        _DEVICES[index] = _DeviceGraphs(torch.device("cuda", index))
    return _DEVICES[index]


class StatementGraph:
    """One statement's graph, the packed buffer it writes, where each array
    lies in that buffer, and the order its replays keep."""

    __slots__ = ("graph", "pack", "layout", "pair", "order", "keep")

    def __init__(self, graph, pack: torch.Tensor, layout: List[tuple],
                 pair: Union[int, tuple], order):
        self.graph = graph
        self.pack = pack
        # (dict "data" or "validity", key, byte offset, bytes, dtype, shape)
        self.layout = layout
        # the readback pair: a row count fixed at capture (an int), or
        # (byte offset, ) of the [count, ok] int64 pair in the pack
        self.pair = pair
        # held around each replay and its copy (``_DeviceGraphs``)
        self.order = order
        # device tensors the graph reads that nothing else may free
        self.keep: list = []

    @classmethod
    def capture(cls, run: Callable[[], Tuple[dict, dict, object]],
                device: torch.device) -> "StatementGraph":
        """Capture ``run()``, which returns ``(data, validity, pair)`` as
        ``CompiledQuery._execute`` does, into the device's pool."""
        with _CAPTURE_LOCK:
            shared = _device_graphs(device)
            graph = torch.cuda.CUDAGraph()
            main = torch.cuda.current_stream(device)
            shared.stream.wait_stream(main)
            with torch.cuda.stream(shared.stream):
                # thread-local: another thread's work on its own streams
                # does not invalidate this capture
                graph.capture_begin(pool=shared.pool,
                                    capture_error_mode="thread_local")
                try:
                    data, validity, pair = run()
                    pack, layout, at = _pack(data, validity, pair, device)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:  # the capture was already invalid
                        pass
                    raise
                graph.capture_end()
            main.wait_stream(shared.stream)
            shared.anchor = graph
        return cls(graph, pack, layout, pair if at is None else (at,),
                   shared)

    def replay(self) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor], object]:
        """Launch the graph on the current stream and return
        ``(data, validity, pair)`` as views of one fresh copy of its
        outputs: no later replay writes them."""
        with self.order:
            self.graph.replay()
            fresh = self.pack.clone()
        out = {"data": {}, "validity": {}}
        for part, key, at, n, dtype, shape in self.layout:
            out[part][key] = fresh[at:at + n].view(dtype).view(shape)
        pair = self.pair
        if isinstance(pair, tuple):
            pair = fresh[pair[0]:pair[0] + 16].view(torch.int64)
        return out["data"], out["validity"], pair


def _pack(data: dict, validity: dict, pair, device):
    """(the packed uint8 buffer, its layout, the pair's offset or None):
    every array's bytes at a 16-byte boundary, in one ``torch.cat``."""
    parts = [("data", k, t) for k, t in data.items()]
    parts += [("validity", k, t) for k, t in validity.items()]
    if isinstance(pair, torch.Tensor):
        parts.append(("pair", None, pair))
    pieces, layout, at, pair_at = [], [], 0, None
    for part, key, t in parts:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        if part == "pair":
            pair_at = at
        else:
            layout.append((part, key, at, raw.numel(), t.dtype,
                           tuple(t.shape)))
        pieces.append(raw)
        pad = -raw.numel() % _ALIGN
        if pad:
            pieces.append(torch.empty((pad,), dtype=torch.uint8,
                                      device=device))
        at += raw.numel() + pad
    pack = torch.cat(pieces) if pieces else torch.empty(
        (0,), dtype=torch.uint8, device=device)
    return pack, layout, pair_at
