"""IANA time-zone offset tables for timestamp adjustment on the device.

The port of the JAX package's ``utils/tz.py``. A zone becomes two
arrays, the transition instants and the UTC offset from each one, so
"this instant in zone Z" is one ``torch.searchsorted`` and one gather
(velox/type/tz/ and QueryConfig adjust_timestamp_to_session_timezone).
The tables parse from TZif files (RFC 8536 v1/v2/v3) of the system's
``/usr/share/zoneinfo`` (``VELOX_TPU_ZONEINFO`` overrides it);
``zone_source`` names the file read.
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

_ZONEINFO = os.environ.get("VELOX_TPU_ZONEINFO", "/usr/share/zoneinfo")

#: sentinel well before any real transition
_NEG_INF = -(1 << 62)


def _parse_tzif(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(transition times s, utc offsets s) from a TZif blob."""
    def read_header(off):
        magic, ver = data[off:off + 4], data[off + 4:off + 5]
        assert magic == b"TZif", "not a TZif file"
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack(">6I", data[off + 20:off + 44])
        return ver, isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt

    ver, isut, isstd, leap, timecnt, typecnt, charcnt = read_header(0)
    if ver in (b"2", b"3"):
        # skip the v1 block, parse the 64-bit v2 block
        off = 44 + timecnt * 5 + typecnt * 6 + charcnt + leap * 8 \
            + isstd + isut
        (ver, isut, isstd, leap, timecnt, typecnt,
         charcnt) = read_header(off)
        off += 44
        tsize = 8
    else:
        off = 44
        tsize = 4

    times = np.frombuffer(data[off: off + timecnt * tsize],
                          dtype=(">i8" if tsize == 8 else ">i4"),
                          count=timecnt).astype(np.int64)
    off += timecnt * tsize
    idx = np.frombuffer(data[off: off + timecnt], dtype=np.uint8,
                        count=timecnt)
    off += timecnt
    offsets = np.asarray(
        [struct.unpack(">iBB", data[off + 6 * i: off + 6 * i + 6])[0]
         for i in range(typecnt)], dtype=np.int64)

    # the first ttinfo applies before the first transition (RFC 8536 3.2)
    first = offsets[0] if typecnt else 0
    trans = np.concatenate([[_NEG_INF], times])
    offs = np.concatenate(
        [[first], offsets[idx] if timecnt else []]).astype(np.int64)
    return trans, offs


def _zone_path(zone: str) -> str:
    """The TZif file of ``zone`` under the zone database."""
    path = os.path.join(_ZONEINFO, zone)
    if not os.path.realpath(path).startswith(os.path.realpath(_ZONEINFO)):
        raise ValueError(f"invalid timezone name {zone!r}")
    if not os.path.isfile(path):
        raise ValueError(f"unknown timezone {zone!r}")
    return path


def _fixed(zone: str):
    """The offset in microseconds of a zone that needs no file (UTC,
    '+05:30', '-08:00'), else None."""
    z = zone.strip()
    if z.upper() in ("UTC", "GMT", "Z") or z == "":
        return 0
    if z[0] in "+-":
        sign = -1 if z[0] == "-" else 1
        hh, _, mm = z[1:].partition(":")
        return sign * (int(hh) * 3600 + int(mm or 0)) * 1_000_000
    return None


def zone_source(zone: str) -> str:
    """Where ``zone``'s table comes from: "fixed", or the file read."""
    return "fixed" if _fixed(zone) is not None else _zone_path(zone.strip())


@lru_cache(maxsize=64)
def zone_tables_us(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transition instants us, utc offsets us) for an IANA zone name."""
    off = _fixed(zone)
    if off is not None:
        return (np.asarray([_NEG_INF], np.int64),
                np.asarray([off], np.int64))
    with open(_zone_path(zone.strip()), "rb") as f:
        trans, offs = _parse_tzif(f.read())
    return (np.where(trans == _NEG_INF, trans,
                     trans * 1_000_000).astype(np.int64),
            (offs * 1_000_000).astype(np.int64))


class ZoneTable:
    """A zone's tables as an expression literal: the host arrays and
    their device copies, made once per device."""

    __slots__ = ("name", "trans", "offs", "_on")

    def __init__(self, name: str):
        self.name = name
        self.trans, self.offs = zone_tables_us(name)
        self._on: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = str(device)
        hit = self._on.get(key)
        if hit is None:
            hit = self._on[key] = (torch.from_numpy(self.trans).to(device),
                                   torch.from_numpy(self.offs).to(device))
        return hit

    def __repr__(self):
        return f"ZoneTable<{self.name}>"


@lru_cache(maxsize=64)
def zone_table(zone: str) -> ZoneTable:
    return ZoneTable(zone)


def offsets_at(ts: torch.Tensor, zone: ZoneTable) -> torch.Tensor:
    """The zone's UTC offset (us) at each instant of ``ts``."""
    trans, offs = zone.tensors(ts.device)
    idx = torch.searchsorted(trans, ts.to(torch.int64), right=True) - 1
    return offs.index_select(0, idx.clamp(0, offs.shape[0] - 1).reshape(-1)
                             ).reshape(ts.shape)
