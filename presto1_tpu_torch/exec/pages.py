"""Binary page wire format.

The reference serializes pages per-block with optional LZ4 and a checksum
marker (``execution/buffer/PagesSerde.java:41,64-79``,
``spi/block/*Encoding.java``).  Our columns are already fixed-width
tensors, so the wire format is trivial by design: a JSON header describing
each column (name, type, dtype, validity, dictionary) followed by raw
little-endian buffers, zlib-compressed, with a crc32 trailer (the
PageCodecMarker checksum analog; zlib/crc32 are the stdlib equivalents of
LZ4/xxhash).

The bytes are the JAX package's (``presto1_tpu/exec/pages.py``) for the same
batch, so a page made by either package reads back in the other.
``deserialize_batch`` and ``concat_batches`` give host (CPU) tensors unless
they are given a ``device``.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from ..batch import Column, RecordBatch
from ..types import SqlType, parse_type_str

MAGIC = b"P1PG"


def _type_str(t: SqlType) -> str:
    return str(t)


def _np(t) -> np.ndarray:
    """A part of a column as a host numpy array (a device tensor is read
    back here: the page boundary is where the engine pays the copy)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _tensor(a: np.ndarray, device=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)


def serialize_batch(batch: RecordBatch, compress: bool = True) -> bytes:
    """RecordBatch -> bytes.  Device tensors are read back to host here."""
    n = batch.num_rows if isinstance(batch.num_rows, int) else int(batch.num_rows)
    header = {"num_rows": n, "columns": []}
    buffers = []

    def add(arr: np.ndarray) -> int:
        buffers.append(np.ascontiguousarray(arr))
        return len(buffers) - 1

    for name, c in batch.columns.items():
        data = _np(c.data[:n])
        col = {
            "name": name,
            "type": _type_str(c.type),
            "dtype": str(data.dtype),
            "data": add(data),
            "validity": None,
            "dictionary": None,
        }
        if data.ndim > 1:  # nested (array/map): [n, W] element matrix
            col["shape"] = list(data.shape)
        if c.lengths is not None:
            col["lengths"] = add(_np(c.lengths[:n]).astype(np.int32))
        if c.map_values is not None:
            mv = _np(c.map_values[:n])
            col["map_values"] = add(mv)
            col["mv_dtype"] = str(mv.dtype)
        if c.validity is not None:
            col["validity"] = add(_np(c.validity[:n]).astype(np.uint8))
        if c.dictionary is not None:
            d = np.asarray(c.dictionary, dtype="U")
            blob = "\x00".join(d.tolist()).encode("utf-8")
            col["dictionary"] = add(np.frombuffer(blob, dtype=np.uint8))
        header["columns"].append(col)
    header["buffer_lengths"] = [b.nbytes for b in buffers]
    hjson = json.dumps(header).encode()
    body = b"".join(b.tobytes() for b in buffers)
    flags = 1 if compress else 0
    if compress:
        body = zlib.compress(body, level=1)
    payload = struct.pack("<II", len(hjson), flags) + hjson + body
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return MAGIC + struct.pack("<I", crc) + payload


def deserialize_batch(data: bytes, device=None) -> RecordBatch:
    """bytes -> RecordBatch of tensors on ``device`` (None: the host)."""
    if data[:4] != MAGIC:
        raise ValueError("bad page magic")
    (crc,) = struct.unpack_from("<I", data, 4)
    payload = data[8:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ValueError("page checksum mismatch")
    hlen, flags = struct.unpack_from("<II", payload, 0)
    header = json.loads(payload[8:8 + hlen].decode())
    body = payload[8 + hlen:]
    if flags & 1:
        body = zlib.decompress(body)
    lengths = header["buffer_lengths"]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)

    def buf(i: int) -> bytes:
        return body[offsets[i]:offsets[i + 1]]

    n = header["num_rows"]
    cols = {}
    for col in header["columns"]:
        t = parse_type_str(col["type"])
        arr = np.frombuffer(buf(col["data"]), dtype=np.dtype(col["dtype"]))
        if col.get("shape"):
            arr = arr.reshape(col["shape"])
        lens = None
        if col.get("lengths") is not None:
            lens = _tensor(np.frombuffer(buf(col["lengths"]),
                                         dtype=np.int32), device)
        map_values = None
        if col.get("map_values") is not None:
            map_values = _tensor(np.frombuffer(
                buf(col["map_values"]),
                dtype=np.dtype(col["mv_dtype"])).reshape(col["shape"]),
                device)
        validity = None
        if col["validity"] is not None:
            validity = _tensor(np.frombuffer(buf(col["validity"]),
                                             dtype=np.uint8).astype(bool),
                               device)
        dictionary = None
        if col["dictionary"] is not None:
            blob = bytes(buf(col["dictionary"])).decode("utf-8")
            dictionary = np.array(blob.split("\x00") if blob else [],
                                  dtype="U")
        cols[col["name"]] = Column(_tensor(arr, device), t,
                                   validity=validity, dictionary=dictionary,
                                   lengths=lens, map_values=map_values)
    return RecordBatch(cols, n)


def concat_batches(batches, device=None) -> Optional[RecordBatch]:
    """Concatenate batches on the host (a merge after pages arrive); with a
    ``device`` the result is padded and placed there (``_to_device``).
    Dictionary columns are re-encoded against the union dictionary so codes
    stay comparable."""
    batches = [b for b in batches if b is not None]
    if not batches:
        return None
    if len(batches) == 1:
        return _to_device(batches[0], device) if device is not None \
            else batches[0]
    names = list(batches[0].columns.keys())
    total = sum(int(b.num_rows) for b in batches)
    cols = {}
    for name in names:
        parts = [(b[name], int(b.num_rows)) for b in batches]
        t = parts[0][0].type

        def validity_of(parts):
            if all(p.validity is None for p, _ in parts):
                return None
            return np.concatenate([
                _np(p.validity)[:n] if p.validity is not None
                else np.ones(n, dtype=bool) for p, n in parts])

        if any(p.is_nested for p, _ in parts):
            # nested [n, W] element matrices: pad every part to the max W
            # before concatenating, and carry lengths/map_values through
            w = max(_np(p.data).shape[1] for p, _ in parts)

            def _pad_w(m):
                m = _np(m)
                if m.shape[1] == w:
                    return m
                return np.concatenate(
                    [m, np.zeros((m.shape[0], w - m.shape[1]), m.dtype)],
                    axis=1)

            data = np.concatenate([_pad_w(p.data)[:n] for p, n in parts])
            lens = np.concatenate([_np(p.lengths)[:n] for p, n in parts])
            mv = None
            if any(p.map_values is not None for p, _ in parts):
                mv = _tensor(np.concatenate(
                    [_pad_w(p.map_values)[:n] for p, n in parts]))
            v = validity_of(parts)
            cols[name] = Column(_tensor(data), t,
                                validity=None if v is None else _tensor(v),
                                lengths=_tensor(lens), map_values=mv)
            continue
        if any(p.dictionary is not None for p, _ in parts):
            union = np.unique(np.concatenate(
                [p.dictionary for p, _ in parts if p.dictionary is not None]))
            datas = []
            for p, n in parts:
                codes = _np(p.data)[:n]
                if p.dictionary is None or len(p.dictionary) == 0:
                    # no value to remap (an all-NULL column; the JAX
                    # package indexes the empty dictionary: ROADMAP C14)
                    datas.append(np.zeros(n, np.int32))
                    continue
                # remap codes into the union dictionary (order-preserving:
                # both source and union dictionaries are sorted)
                codes = np.searchsorted(union, p.dictionary[
                    np.clip(codes, 0, len(p.dictionary) - 1)])
                datas.append(codes.astype(np.int32))
            data = np.concatenate(datas)
            dictionary = union
        else:
            data = np.concatenate([_np(p.data)[:n] for p, n in parts])
            dictionary = None
        v = validity_of(parts)
        cols[name] = Column(_tensor(data), t,
                            validity=None if v is None else _tensor(v),
                            dictionary=dictionary)
    out = RecordBatch(cols, total)
    return _to_device(out, device) if device is not None else out


def _to_device(batch: RecordBatch, device) -> RecordBatch:
    """The batch on ``device``, every part padded with zeros to
    ``round_capacity`` of its row count (validity False there)."""
    from ..batch import round_capacity

    n = int(batch.num_rows)
    cap = round_capacity(n)

    def pad(t) -> torch.Tensor:
        a = _np(t)
        if a.shape[0] < cap:
            a = np.concatenate(
                [a, np.zeros((cap - a.shape[0],) + a.shape[1:], a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cols = {}
    for name, c in batch.columns.items():
        cols[name] = Column(
            pad(c.data), c.type,
            validity=None if c.validity is None else pad(c.validity),
            dictionary=c.dictionary,
            lengths=None if c.lengths is None else pad(c.lengths),
            map_values=None if c.map_values is None else pad(c.map_values))
    return RecordBatch(cols, n)
