"""Wire formats: the columnar SerializedPage and the row-major CompactRow
(the port of the JAX package's ``serial/page.py``).

velox/serializers' PrestoPage (columnar, encodings preserved, optional
compression, a checksum) and CompactRow (null bits and fixed-width
fields a row). Columns are fixed-width lanes (strings are int32
dictionary codes), so a page is the lanes' bytes, a validity bitmap a
column and the dictionaries in the header; reading one back is a copy
and an upload.

Layout (both forms)::

  [u32 magic][u8 version][u8 flags][u32 crc32 of body][u32 header_len]
  [header json utf-8][body]

flags bit 0 marks a zlib body, bit 1 a zstd body. A page of flat columns
is byte for byte the JAX package's, so either package reads the other's.
A page of the spill rung may also hold ARRAY, MAP and ROW columns: their
header entry carries ``"complex"`` (offsets, validity and child entries;
element columns are written whole), which only this package reads.
Compression is zlib or none here: a zstd page needs the ``zstandard``
package, and raises where it is missing.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from velox_tpu_torch import resolve_device
from velox_tpu_torch.types.types import (
    ArrayType, DataType, DecimalType, MapType, RowType, TypeKind,
)
from velox_tpu_torch.vector.batch import Batch, round_capacity
from velox_tpu_torch.vector.column import (
    ArrayColumn, Column, Dictionary, MapColumn, RowColumn,
)

_MAGIC = 0x56545047  # "VTPG"
_VERSION = 1
_FLAG_ZLIB = 1
_FLAG_ZSTD = 2
_HEAD = "<IBBII"


def _type_to_json(t: DataType) -> dict:
    d = {"kind": t.kind.name}
    if isinstance(t, DecimalType):
        d["precision"] = t.precision
        d["scale"] = t.scale
    elif isinstance(t, ArrayType):
        d["element"] = _type_to_json(t.element)
    elif isinstance(t, MapType):
        d["key"] = _type_to_json(t.key)
        d["value"] = _type_to_json(t.value)
    elif isinstance(t, RowType):
        d["names"] = list(t.names)
        d["children"] = [_type_to_json(c) for c in t.children]
    return d


def _type_from_json(d: dict) -> DataType:
    kind = TypeKind[d["kind"]]
    if kind == TypeKind.DECIMAL:
        return DecimalType(kind, d["precision"], d["scale"])
    if kind == TypeKind.ARRAY:
        return ArrayType(kind, _type_from_json(d["element"]))
    if kind == TypeKind.MAP:
        return MapType(kind, _type_from_json(d["key"]),
                       _type_from_json(d["value"]))
    if kind == TypeKind.ROW:
        return RowType(kind, tuple(d["names"]), tuple(
            _type_from_json(c) for c in d["children"]))
    return DataType(kind)


def _zstd():
    try:
        import zstandard
    except ImportError as e:
        raise RuntimeError(
            "a zstd-compressed page needs the zstandard package, which is "
            "not installed; write pages with compress=False or 'zlib'"
        ) from e
    return zstandard


def _frame(header: dict, body: bytes, compress) -> bytes:
    """``compress``: False, True or "zlib" (level 1), or "zstd"."""
    flags = 0
    if compress == "zstd":
        body = _zstd().ZstdCompressor(level=1).compress(body)
        flags |= _FLAG_ZSTD
    elif compress:
        body = zlib.compress(body, 1)
        flags |= _FLAG_ZLIB
    hj = json.dumps(header, separators=(",", ":")).encode()
    return (struct.pack(_HEAD, _MAGIC, _VERSION, flags, zlib.crc32(body),
                        len(hj)) + hj + body)


def _unframe(buf: bytes) -> Tuple[dict, bytes]:
    magic, version, flags, crc, hlen = struct.unpack_from(_HEAD, buf, 0)
    if magic != _MAGIC or version != _VERSION:
        raise ValueError("bad page frame")
    off = struct.calcsize(_HEAD)
    header = json.loads(buf[off: off + hlen].decode())
    body = buf[off + hlen:]
    if zlib.crc32(body) != crc:
        raise ValueError("page checksum mismatch")
    if flags & _FLAG_ZSTD:
        body = _zstd().ZstdDecompressor().decompress(body)
    elif flags & _FLAG_ZLIB:
        body = zlib.decompress(body)
    return header, body


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _entry(name: str, col, idx: np.ndarray, parts: List[bytes]) -> dict:
    """Header entry of ``col`` at rows ``idx``; its bytes go to ``parts``:
    the lane then the packed validity (a flat column, as the JAX package
    writes it), or the offsets, the validity and the children."""
    valid = None if col.valid is None else _np(col.valid)[idx]
    e = {"name": name, "type": _type_to_json(col.dtype)}
    if isinstance(col, Column):
        vals = np.ascontiguousarray(_np(col.values)[idx])
        parts.append(vals.tobytes())
        if valid is not None:
            parts.append(np.packbits(valid).tobytes())
        e.update({"lane": vals.dtype.str, "nulls": valid is not None,
                  "dict": (None if col.dictionary is None
                           else list(col.dictionary.values)),
                  "stats": ([int(x) for x in col.stats]
                            if col.stats is not None else None)})
        return e
    e["nulls"] = valid is not None
    if isinstance(col, RowColumn):
        kids = [_entry(n, c, idx, parts)
                for n, c in zip(col.names, col.children)]
    else:
        parts.append(np.ascontiguousarray(
            _np(col.starts)[idx].astype(np.int32)).tobytes())
        parts.append(np.ascontiguousarray(
            _np(col.lengths)[idx].astype(np.int32)).tobytes())
        flat = ([col.keys, col.values] if isinstance(col, MapColumn)
                else [col.elements])
        kids = [_entry(n, c, np.arange(c.capacity), parts)
                for n, c in zip(("k", "v"), flat)]
        kids[0]["rows"] = flat[0].capacity
    if valid is not None:
        parts.append(np.packbits(valid).tobytes())
    e["complex"] = kids
    return e


def _read(e: dict, body: bytes, off: int, rows: int, cap: int, device):
    """(column, new offset) of entry ``e`` padded to ``cap`` slots."""
    t = _type_from_json(e["type"])

    def lane(dtype, n, pad):
        vals = np.frombuffer(body, dtype, count=n, offset=off)
        out = np.zeros(pad, dtype=dtype)
        out[:n] = vals
        return torch.from_numpy(out).to(device), off + n * dtype.itemsize

    def bits(n, pad):
        vb = (n + 7) // 8
        v = np.zeros(pad, dtype=bool)
        v[:n] = np.unpackbits(np.frombuffer(
            body, np.uint8, count=vb, offset=off))[:n].astype(bool)
        return torch.from_numpy(v).to(device), off + vb

    if "complex" not in e:
        vals, off = lane(np.dtype(e["lane"]), rows, cap)
        valid = None
        if e["nulls"]:
            valid, off = bits(rows, cap)
        d = Dictionary(e["dict"]) if e["dict"] is not None else None
        stats = tuple(e["stats"]) if e["stats"] else None
        return Column(t, vals, valid, d, stats), off
    kids = e["complex"]
    if t.kind == TypeKind.ROW:
        children = []
        for k in kids:
            c, off = _read(k, body, off, rows, cap, device)
            children.append(c)
        valid = None
        if e["nulls"]:
            valid, off = bits(rows, cap)
        return RowColumn(t, tuple(children), valid), off
    starts, off = lane(np.dtype(np.int32), rows, cap)
    lengths, off = lane(np.dtype(np.int32), rows, cap)
    n = kids[0]["rows"]
    flat = []
    for k in kids:
        c, off = _read(k, body, off, n, n, device)
        flat.append(c)
    valid = None
    if e["nulls"]:
        valid, off = bits(rows, cap)
    if t.kind == TypeKind.MAP:
        return MapColumn(t, starts, lengths, flat[0], flat[1], valid), off
    return ArrayColumn(t, starts, lengths, flat[0], valid), off


def _live_rows(batch: Batch) -> np.ndarray:
    return np.nonzero(_np(batch.sel))[0]


# ------------------------------------------------------------------- page

def serialize_page(batch: Batch, compress=False) -> bytes:
    """Columnar page of the batch's live rows: each column's lane bytes
    and validity bitmap, dictionaries kept."""
    idx = _live_rows(batch)
    parts: List[bytes] = []
    columns = [_entry(n, c, idx, parts) for n, c in batch.columns.items()]
    header = {"layout": "page", "rows": int(len(idx)), "columns": columns}
    return _frame(header, b"".join(parts), compress)


def deserialize_page(buf: bytes, device=None) -> Batch:
    """A page back as a batch on ``device`` (``None``: the card, as
    ``resolve_device`` reads it), its rows a dense prefix."""
    device = resolve_device(device)
    header, body = _unframe(buf)
    if header["layout"] != "page":
        raise ValueError("not a columnar page")
    rows = header["rows"]
    cap = round_capacity(max(rows, 1))
    off = 0
    cols: Dict[str, object] = {}
    for e in header["columns"]:
        cols[e["name"]], off = _read(e, body, off, rows, cap, device)
    sel = torch.zeros(cap, dtype=torch.bool)
    sel[:rows] = True
    return Batch(cols, sel.to(device), num_rows=rows)


# ----------------------------------------------------------- compact row

def _flat_columns(batch: Batch) -> None:
    bad = [n for n, c in batch.columns.items() if not isinstance(c, Column)]
    if bad:
        raise NotImplementedError(
            f"CompactRow holds flat columns only, not {bad}")


def serialize_compact_rows(batch: Batch, compress=False) -> bytes:
    """Row-major form: one numpy structured record a row (null bitmap
    bytes, then every lane), filled by one vectorized assignment a
    column (row/CompactRow.h)."""
    _flat_columns(batch)
    idx = _live_rows(batch)
    rows = len(idx)
    names = list(batch.columns)
    host = [(_np(c.values)[idx],
             None if c.valid is None else _np(c.valid)[idx])
            for c in batch.columns.values()]
    nullbytes = (len(names) + 7) // 8
    fields = [("__nulls__", np.uint8, (nullbytes,))] + [
        (f"f{i}", host[i][0].dtype) for i in range(len(names))]
    rec = np.zeros(rows, dtype=np.dtype(fields))
    nulls = np.zeros((rows, nullbytes * 8), dtype=np.uint8)
    columns = []
    for i, (n, c) in enumerate(batch.columns.items()):
        vals, valid = host[i]
        rec[f"f{i}"] = vals
        if valid is not None:
            nulls[:, i] = ~valid
        columns.append({
            "name": n, "type": _type_to_json(c.dtype),
            "lane": vals.dtype.str, "nulls": valid is not None,
            "dict": (None if c.dictionary is None
                     else list(c.dictionary.values)),
            "stats": ([int(x) for x in c.stats]
                      if c.stats is not None else None)})
    rec["__nulls__"] = np.packbits(nulls, axis=1)
    header = {"layout": "compact", "rows": rows, "columns": columns}
    return _frame(header, rec.tobytes(), compress)


def deserialize_compact_rows(buf: bytes, device=None) -> Batch:
    """A CompactRow page back as a batch on ``device`` (``None``: the
    card), its rows a dense prefix."""
    device = resolve_device(device)
    header, body = _unframe(buf)
    if header["layout"] != "compact":
        raise ValueError("not a CompactRow page")
    rows = header["rows"]
    cap = round_capacity(max(rows, 1))
    nullbytes = (len(header["columns"]) + 7) // 8
    fields = [("__nulls__", np.uint8, (nullbytes,))] + [
        (f"f{i}", np.dtype(c["lane"]))
        for i, c in enumerate(header["columns"])]
    rec = np.frombuffer(body, dtype=np.dtype(fields), count=rows)
    nulls = (np.unpackbits(rec["__nulls__"], axis=1) if rows
             else np.zeros((0, nullbytes * 8), np.uint8))
    cols: Dict[str, Column] = {}
    for i, c in enumerate(header["columns"]):
        padded = np.zeros(cap, dtype=np.dtype(c["lane"]))
        padded[:rows] = rec[f"f{i}"]
        valid = None
        if c["nulls"]:
            v = np.zeros(cap, dtype=bool)
            v[:rows] = nulls[:, i] == 0
            valid = torch.from_numpy(v).to(device)
        d = Dictionary(c["dict"]) if c["dict"] is not None else None
        stats = tuple(c["stats"]) if c["stats"] else None
        cols[c["name"]] = Column(_type_from_json(c["type"]),
                                 torch.from_numpy(padded).to(device), valid,
                                 d, stats)
    sel = torch.zeros(cap, dtype=torch.bool)
    sel[:rows] = True
    return Batch(cols, sel.to(device), num_rows=rows)
