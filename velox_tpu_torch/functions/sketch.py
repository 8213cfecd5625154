"""Set-membership sketches: HyperLogLog, SetDigest, KHyperLogLog (the
port of the JAX package's ``functions/sketch.py``: the same blobs, byte
for byte).

Reference: velox/functions/prestosql/aggregates/HyperLogLogAggregate.cpp
(approx_set / merge), SetDigestFunctions (make_set_digest,
merge_set_digest, intersection_cardinality, jaccard_index, hash_counts)
and KHyperLogLogFunctions (khyperloglog_agg, merge_khll,
uniqueness_distribution, reidentification_potential). Re-designed for
this engine: sketch *construction* happens once per group over the
group-contiguous value runs the collect path already produces (one
global sort — no per-row streaming insertion), and sketch *values* are
compact ASCII blobs living in a string Dictionary, exactly like the
t-digest family (functions/digest.py).

The hash is the JAX package's: BLAKE2b-64 of a value's canonical text
(``hash64``). Where it calls ``blake2b`` once per row, the port hashes
each distinct value once (``hash64_array``), and integers on the device
(``hash64_ints``: BLAKE2b over the decimal digits, in torch int64 ops),
so a column of millions of keys costs no host loop.

Blob formats (documented deviation: NOT Presto wire-compatible —
sketches round-trip within velox_tpu only):

    HL1|<log2m>|<b64 uint8 registers>                 HyperLogLog
    SD1|<log2m>|<b64 regs>|<b64 minhash u64 BE> (K min hashes + counts)
    KH1|<K>|<UCAP>|<b64 records>                      KHyperLogLog

KHyperLogLog records are ``xhash(u64 BE) | n(u8) | n * uiihash(u64 BE)``
— the K minimum x-hashes, each carrying up to UCAP minimum uii-hashes
(a per-bucket KMV sketch standing in for Presto's per-bucket HLL; exact
while a bucket holds <= UCAP distinct uii values, which covers the
uniqueness-distribution histogram range exactly).
"""

from __future__ import annotations

import base64
import hashlib
import struct
from typing import Dict, Optional, Sequence

import numpy as np

HLL_LOG2M = 11                    # 2048 registers, stderr ~2.3%
SD_K = 2048                       # SetDigest min-hash capacity
KHLL_K = 512                      # KHyperLogLog bucket capacity
KHLL_UCAP = 32                    # per-bucket uii KMV capacity
_TWO64 = float(1 << 64)


def hash64(v) -> int:
    """Stable unsigned 64-bit hash of a scalar value (strings hash
    their text; integral floats hash as ints so 3 == 3.0 across
    columns, matching one hash domain per value like Presto's
    XxHash64 over the canonical encoding)."""
    if isinstance(v, (np.floating, float)):
        f = float(v)
        v = int(f) if f.is_integer() else f
    elif isinstance(v, (np.integer, int, np.bool_, bool)):
        v = int(v)
    b = repr(v).encode() if not isinstance(v, str) else v.encode()
    return struct.unpack("<Q", hashlib.blake2b(b, digest_size=8)
                         .digest())[0]


def hash64_array(vals: np.ndarray) -> np.ndarray:
    """``hash64`` of every element: one hash per distinct value."""
    vals = np.asarray(vals)
    if len(vals) == 0:
        return np.zeros(0, np.uint64)
    if vals.dtype == object:
        index: Dict[object, int] = {}
        inv = np.fromiter((index.setdefault(v, len(index))
                           for v in vals.tolist()), np.int64, len(vals))
        uniq = list(index)
    else:
        uniq, inv = np.unique(vals, return_inverse=True)
        uniq = uniq.tolist()
    h = np.fromiter((hash64(v) for v in uniq), np.uint64, len(uniq))
    return h[np.asarray(inv).reshape(-1)]


# BLAKE2b (RFC 7693) for digest size 8, unkeyed, one block
_IV = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
       0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
       0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]
_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _rotr(x, n: int):
    """64-bit rotate right of int64 bit patterns (torch's ``>>`` is
    arithmetic: mask the shifted-in sign bits)."""
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def hash64_ints(values):
    """``hash64`` of every int64 of a torch tensor, on its device: the
    BLAKE2b-64 of the decimal text ``repr(v)`` (at most 20 bytes, so
    three message words and one block), as the int64 with the hash's
    bits. Additions wrap modulo 2^64 in int64, as the hash's do."""
    import torch

    v = values.to(torch.int64)
    neg = v < 0
    # the digits of -|v| (no overflow at the int64 minimum)
    n = torch.where(neg, v, -v)
    digits = []
    for _ in range(19):
        digits.append(-torch.fmod(n, 10))
        n = torch.div(n, 10, rounding_mode="trunc")
    digits.append(-n)
    nz = torch.stack([d != 0 for d in digits])
    idx = torch.arange(20, device=v.device)[:, None].expand_as(nz)
    ndig = torch.where(nz, idx + 1, torch.zeros_like(idx)).amax(0)
    ndig = torch.clamp(ndig, min=1)
    length = ndig + neg.to(torch.int64)
    words = [torch.zeros_like(v) for _ in range(3)]
    for k, d in enumerate(digits):
        pos = length - 1 - k
        byte = (d + 48) << (8 * (pos % 8))
        live = k < ndig
        for j in range(3):
            words[j] = words[j] + torch.where(
                live & (pos // 8 == j), byte, torch.zeros_like(byte))
    words[0] = words[0] + torch.where(neg, torch.full_like(v, 45),
                                      torch.zeros_like(v))
    h0 = _i64(_IV[0] ^ 0x01010008)
    st = [torch.full_like(v, h0)] + [torch.full_like(v, _i64(c))
                                     for c in _IV[1:]]
    st += [torch.full_like(v, _i64(c)) for c in _IV]
    st[12] = st[12] ^ length
    st[14] = st[14] ^ -1

    def g(a, b, c, d, x, y):
        st[a] = st[a] + st[b] + (words[x] if x < 3 else 0)
        st[d] = _rotr(st[d] ^ st[a], 32)
        st[c] = st[c] + st[d]
        st[b] = _rotr(st[b] ^ st[c], 24)
        st[a] = st[a] + st[b] + (words[y] if y < 3 else 0)
        st[d] = _rotr(st[d] ^ st[a], 16)
        st[c] = st[c] + st[d]
        st[b] = _rotr(st[b] ^ st[c], 63)

    for r in range(12):
        s = _SIGMA[r % 10]
        g(0, 4, 8, 12, s[0], s[1])
        g(1, 5, 9, 13, s[2], s[3])
        g(2, 6, 10, 14, s[4], s[5])
        g(3, 7, 11, 15, s[6], s[7])
        g(0, 5, 10, 15, s[8], s[9])
        g(1, 6, 11, 12, s[10], s[11])
        g(2, 7, 8, 13, s[12], s[13])
        g(3, 4, 9, 14, s[14], s[15])
    return h0 ^ st[0] ^ st[8]


# ------------------------------------------------------------------ HLL

def _hll_regs_from_hashes(h: np.ndarray, log2m: int) -> np.ndarray:
    m = 1 << log2m
    bucket = (h & np.uint64(m - 1)).astype(np.int64)
    rest = (h >> np.uint64(log2m)).astype(np.uint64)
    # rank = number of leading-ish zeros + 1 over the remaining bits
    width = 64 - log2m
    bl = np.zeros(len(h), np.int64)
    nz = rest != 0
    bl[nz] = np.frexp(rest[nz].astype(np.float64))[1]  # bit_length
    rank = np.where(nz, width - bl + 1, width + 1).astype(np.uint8)
    regs = np.zeros(m, np.uint8)
    np.maximum.at(regs, bucket, rank)
    return regs


def hll_build(vals: np.ndarray) -> str:
    regs = _hll_regs_from_hashes(hash64_array(vals), HLL_LOG2M)
    return "HL1|%d|%s" % (
        HLL_LOG2M, base64.b64encode(regs.tobytes()).decode())


def _hll_parse(blob: str) -> np.ndarray:
    _, log2m, b = blob.split("|")
    return np.frombuffer(base64.b64decode(b), np.uint8).copy()


def _hll_estimate(regs: np.ndarray) -> float:
    m = float(len(regs))
    est = (0.7213 / (1 + 1.079 / m)) * m * m / np.sum(
        np.ldexp(1.0, -regs.astype(np.int64)))
    zeros = int(np.sum(regs == 0))
    if zeros and est <= 2.5 * m:
        est = m * np.log(m / zeros)
    return float(est)


def hll_merge(blobs: Sequence[str]) -> str:
    regs = _hll_parse(blobs[0])
    for b in blobs[1:]:
        np.maximum(regs, _hll_parse(b), out=regs)
    return "HL1|%d|%s" % (
        HLL_LOG2M, base64.b64encode(regs.tobytes()).decode())


# ------------------------------------------------------------ SetDigest

def _pack_u64(a: np.ndarray) -> str:
    return base64.b64encode(
        a.astype(">u8").tobytes()).decode()


def _unpack_u64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), ">u8").astype(np.uint64)


def setdigest_build(vals: np.ndarray) -> str:
    h = np.unique(hash64_array(vals))
    regs = _hll_regs_from_hashes(h, HLL_LOG2M)
    mins = np.sort(h)[:SD_K]
    return "SD1|%d|%s|%s" % (
        HLL_LOG2M, base64.b64encode(regs.tobytes()).decode(),
        _pack_u64(mins))


def _sd_parse(blob: str):
    _, log2m, regs_b, mins_b = blob.split("|")
    return (np.frombuffer(base64.b64decode(regs_b), np.uint8).copy(),
            _unpack_u64(mins_b))


def setdigest_merge(blobs: Sequence[str]) -> str:
    regs, mins = _sd_parse(blobs[0])
    for b in blobs[1:]:
        r2, m2 = _sd_parse(b)
        np.maximum(regs, r2, out=regs)
        mins = np.unique(np.concatenate([mins, m2]))[:SD_K]
    return "SD1|%d|%s|%s" % (
        HLL_LOG2M, base64.b64encode(regs.tobytes()).decode(),
        _pack_u64(mins))


def sketch_cardinality(blob: str) -> Optional[int]:
    """cardinality() over any sketch blob (HLL / SetDigest / KHLL)."""
    if blob is None:
        return None
    if blob.startswith("HL1|"):
        return int(round(_hll_estimate(_hll_parse(blob))))
    if blob.startswith("SD1|"):
        regs, mins = _sd_parse(blob)
        if len(mins) < SD_K:        # exact below capacity
            return int(len(mins))
        return int(round(_hll_estimate(regs)))
    if blob.startswith("KH1|"):
        recs = _khll_parse(blob)
        if len(recs) < KHLL_K:
            return len(recs)
        mx = max(recs) if recs else 0
        return int(round((KHLL_K - 1) * _TWO64 / max(mx, 1)))
    return None


def sketch_cardinalities(blobs) -> list:
    """``sketch_cardinality`` of each blob, the HyperLogLog estimates of
    all ``HL1`` blobs in one pass over their stacked registers (the same
    float64 operations row by row)."""
    out = [None] * len(blobs)
    hll = [i for i, b in enumerate(blobs)
           if isinstance(b, str) and b.startswith("HL1|")]
    for i, b in enumerate(blobs):
        if b is not None and not (isinstance(b, str)
                                  and b.startswith("HL1|")):
            out[i] = sketch_cardinality(b)
    if not hll:
        return out
    regs = np.stack([_hll_parse(blobs[i]) for i in hll])
    m = float(regs.shape[1])
    # 2^-r by table: the values np.ldexp gives, summed row by row in
    # blocks that stay in cache
    inv = np.ldexp(1.0, -np.arange(256, dtype=np.int64))
    total = np.concatenate([inv[regs[i:i + 4096]].sum(axis=1)
                            for i in range(0, len(regs), 4096)])
    est = (0.7213 / (1 + 1.079 / m)) * m * m / total
    zeros = np.sum(regs == 0, axis=1)
    lc = (zeros > 0) & (est <= 2.5 * m)
    with np.errstate(divide="ignore"):
        est = np.where(lc, m * np.log(m / np.maximum(zeros, 1)), est)
    for i, e in zip(hll, est.tolist()):
        out[i] = int(round(e))
    return out


def _minhash_jaccard(a: np.ndarray, b: np.ndarray, k: int) -> float:
    """Jaccard estimate from two bottom-k min-hash sets: the overlap
    fraction within the bottom-k of the union (standard KMV/bottom-k
    estimator, also what Presto's SetDigest does)."""
    if len(a) == 0 and len(b) == 0:
        return 1.0
    u = np.unique(np.concatenate([a, b]))[:k]
    inter = np.intersect1d(a, b, assume_unique=True)
    return float(len(np.intersect1d(u, inter, assume_unique=True))
                 / max(len(u), 1))


def intersection_cardinality(a: str, b: str) -> Optional[int]:
    """|A ∩ B| = jaccard * |A ∪ B| (SetDigest or KHLL blobs)."""
    if a is None or b is None:
        return None
    if a.startswith("SD1|") and b.startswith("SD1|"):
        ra, ma = _sd_parse(a)
        rb, mb = _sd_parse(b)
        j = _minhash_jaccard(ma, mb, SD_K)
        union = sketch_cardinality(setdigest_merge([a, b]))
    elif a.startswith("KH1|") and b.startswith("KH1|"):
        ma = np.array(sorted(_khll_parse(a)), np.uint64)
        mb = np.array(sorted(_khll_parse(b)), np.uint64)
        j = _minhash_jaccard(ma, mb, KHLL_K)
        union = sketch_cardinality(khll_merge([a, b]))
    else:
        return None
    return int(round(j * union))


def jaccard_index(a: str, b: str) -> Optional[float]:
    if a is None or b is None:
        return None
    if a.startswith("SD1|") and b.startswith("SD1|"):
        _, ma = _sd_parse(a)
        _, mb = _sd_parse(b)
        return _minhash_jaccard(ma, mb, SD_K)
    if a.startswith("KH1|") and b.startswith("KH1|"):
        ma = np.array(sorted(_khll_parse(a)), np.uint64)
        mb = np.array(sorted(_khll_parse(b)), np.uint64)
        return _minhash_jaccard(ma, mb, KHLL_K)
    return None


def hash_counts(blob: str) -> Optional[str]:
    """SetDigest min-hash -> count map as JSON text (deviation: Presto
    returns map<bigint, smallint>; counts here are 1 per distinct value
    since construction dedupes — the Presto semantics for digests built
    via make_set_digest over distinct-counted inputs)."""
    if blob is None or not blob.startswith("SD1|"):
        return None
    import json

    _, mins = _sd_parse(blob)
    return json.dumps(
        {str(np.int64(h.astype(np.uint64))): 1 for h in mins})


# --------------------------------------------------------- KHyperLogLog

def khll_build(xh: np.ndarray, uh: np.ndarray) -> str:
    """Build from parallel (x-hash, uii-hash) arrays: keep the KHLL_K
    minimum x-hashes, each with its KHLL_UCAP minimum uii-hashes (the
    first KHLL_K distinct x-hashes in ascending order, which is what the
    JAX package's insert-and-evict loop keeps)."""
    order = np.lexsort((uh, xh))
    xs, us = xh[order], uh[order]
    starts = np.searchsorted(xs, np.unique(xs))
    ends = np.append(starts[1:], len(xs))
    recs: Dict[int, np.ndarray] = {}
    for s, e in zip(starts[:KHLL_K].tolist(), ends[:KHLL_K].tolist()):
        recs[int(xs[s])] = np.unique(us[s:e])[:KHLL_UCAP]
    return _khll_serialize(recs)


def _khll_serialize(recs: Dict[int, np.ndarray]) -> str:
    out = bytearray()
    for x in sorted(recs):
        u = recs[x]
        out += struct.pack(">QB", x, len(u))
        out += u.astype(">u8").tobytes()
    return "KH1|%d|%d|%s" % (
        KHLL_K, KHLL_UCAP, base64.b64encode(bytes(out)).decode())


def _khll_parse(blob: str) -> Dict[int, np.ndarray]:
    _, k, ucap, b = blob.split("|")
    raw = base64.b64decode(b)
    recs: Dict[int, np.ndarray] = {}
    i = 0
    while i < len(raw):
        x, n = struct.unpack_from(">QB", raw, i)
        i += 9
        recs[x] = np.frombuffer(raw, ">u8", n, i).astype(np.uint64)
        i += 8 * n
    return recs


def khll_merge(blobs: Sequence[str]) -> str:
    recs = _khll_parse(blobs[0])
    for b in blobs[1:]:
        for x, u in _khll_parse(b).items():
            if x in recs:
                recs[x] = np.unique(
                    np.concatenate([recs[x], u]))[:KHLL_UCAP]
            else:
                recs[x] = u
    for x in sorted(recs)[KHLL_K:]:
        del recs[x]
    return _khll_serialize(recs)


def _bucket_uniqueness(u: np.ndarray) -> int:
    """Distinct-uii estimate for one bucket's KMV sample."""
    if len(u) < KHLL_UCAP:
        return len(u)
    return int(round((KHLL_UCAP - 1) * _TWO64 / max(int(u[-1]), 1)))


def uniqueness_distribution(blob: str, hist: int = 256) -> Optional[str]:
    """histogram of per-value uniqueness as JSON {uniqueness: value_count}
    (deviation: Presto returns map<bigint, double>)."""
    if blob is None or not blob.startswith("KH1|"):
        return None
    import json

    recs = _khll_parse(blob)
    out: Dict[int, int] = {}
    for u in recs.values():
        q = min(_bucket_uniqueness(u), int(hist))
        out[q] = out.get(q, 0) + 1
    return json.dumps({str(k): out[k] for k in sorted(out)})


def reidentification_potential(blob: str, threshold: int
                               ) -> Optional[float]:
    """Fraction of sampled values whose uii uniqueness <= threshold."""
    if blob is None or not blob.startswith("KH1|"):
        return None
    recs = _khll_parse(blob)
    if not recs:
        return None
    low = sum(1 for u in recs.values()
              if _bucket_uniqueness(u) <= int(threshold))
    return low / len(recs)


# ----------------------------------------------------- merge dispatch

def merge_blobs(blobs: Sequence[str]) -> Optional[str]:
    """merge() aggregate over any sketch-blob family (also TD1/QD1
    t-digests, delegated to functions/digest.py)."""
    blobs = [b for b in blobs if b is not None]
    if not blobs:
        return None
    tag = blobs[0][:4]
    if tag in ("TD1|", "QD1|"):
        from velox_tpu_torch.functions.digest import merge_digests

        return merge_digests(blobs)
    if tag == "HL1|":
        return hll_merge(blobs)
    if tag == "SD1|":
        return setdigest_merge(blobs)
    if tag == "KH1|":
        return khll_merge(blobs)
    raise ValueError(f"unknown sketch blob tag {tag!r}")
