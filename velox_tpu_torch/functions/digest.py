"""t-digest / qdigest: mergeable quantile sketches as VARBINARY blobs (the
port of the JAX package's ``functions/digest.py``, numpy on the host).

Reference: velox/functions/prestosql/aggregates/TDigestAggregate.cpp,
QDigestAggAggregate.cpp and velox/functions/prestosql/TDigestFunctions.h
(value_at_quantile / quantile_at_value / merge). The collect path
delivers every group's values as one SORTED contiguous run, so digest
construction is one vectorized pass over all groups at once: each element
gets its in-group quantile midpoint, is bucketed by the t-digest k1 scale
function, and buckets are averaged.

The blob is the JAX package's ASCII format, byte for byte (not Presto
wire-compatible):

    TD1|<kind>|<n>|<min>|<max>|m1:w1,m2:w2,...

where kind is 'i' (integral source) or 'f'. qdigest_agg produces the same
centroid structure tagged ``QD1``.

Where the JAX package formats and parses one centroid at a time, the port
buckets only the groups that hold values (a slot per row would be
``rows x compression`` cells), reads a bucket's position from one table
per group size (``bucket_table``, which the collect mode also gathers on
the device), writes integral numbers through ``str`` and parses a
centroid list with one numpy conversion; the strings are the same.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

DEFAULT_COMPRESSION = 100


def _k1_buckets(q: np.ndarray, compression: int) -> np.ndarray:
    """t-digest k1 scale: bucket index in [0, compression) with finer
    buckets near q=0 and q=1 (the tails quantile sketches must protect)."""
    return np.floor(
        compression * (np.arcsin(2.0 * q - 1.0) / np.pi + 0.5)
    ).astype(np.int64)


def format_17g(values: np.ndarray) -> np.ndarray:
    """``'%.17g' % v`` of every float64, as an object array of strings.
    Integral values below 1e17 (but -0.0) format as their ``int``, one
    ``str`` per distinct value."""
    v = np.asarray(values, dtype=np.float64)
    out = np.empty(len(v), dtype=object)
    integral = (np.isfinite(v) & (np.abs(v) < 1e17) & (np.floor(v) == v)
                & ~((v == 0) & np.signbit(v)))
    if integral.any():
        uniq, inv = np.unique(v[integral], return_inverse=True)
        out[integral] = np.asarray([str(int(u)) for u in uniq.tolist()],
                                   dtype=object)[inv.reshape(-1)]
    rest = ~integral
    if rest.any():
        out[rest] = ["%.17g" % x for x in v[rest].tolist()]
    return out


def _serialize(tag: str, kind: str, n: float, lo: float, hi: float,
               means: np.ndarray, weights: np.ndarray) -> str:
    cent = ",".join(
        f"{m:.17g}:{w:.17g}" for m, w in zip(means, weights))
    return f"{tag}|{kind}|{n:.17g}|{lo:.17g}|{hi:.17g}|{cent}"


def bucket_table(counts: np.ndarray, compression: int):
    """Per distinct group size c, the k1 bucket of each in-group position
    ``i < c`` (the JAX package's ``(i + 0.5) / c`` midpoint): the flat
    table, the sizes (ascending) and each size's offset into the table."""
    sizes = np.unique(counts)
    offsets = np.zeros(len(sizes), np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    total = int(sizes.sum())
    c = np.repeat(sizes, sizes)
    i_in = np.arange(total) - np.repeat(offsets, sizes)
    q = (i_in + 0.5) / c
    return (np.clip(_k1_buckets(q, compression), 0, compression - 1),
            sizes, offsets)


def digest_strings(n_slots: int, live: np.ndarray, counts: np.ndarray,
                   cells: np.ndarray, means: np.ndarray,
                   weights: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                   kind: str, tag: str,
                   compression: int = DEFAULT_COMPRESSION
                   ) -> List[Optional[str]]:
    """The blobs of the live group slots ``live`` (their value counts
    ``counts``, value ranges ``lo``/``hi``), from their nonzero centroid
    cells ``cells`` (``live index * compression + bucket``, ascending)
    with ``means`` and ``weights``; None for every other slot."""
    out: List[Optional[str]] = [None] * n_slots
    if len(live) == 0:
        return out
    text = (format_17g(means) + ":" + format_17g(weights)).tolist()
    ends = np.cumsum(np.bincount(cells // compression,
                                 minlength=len(live))).tolist()
    lo_s = format_17g(lo)
    hi_s = format_17g(hi)
    n_s = format_17g(np.asarray(counts, dtype=np.float64))
    head = f"{tag}|{kind}|"
    prev = 0
    for j, g in enumerate(np.asarray(live).tolist()):
        e = ends[j]
        out[g] = (head + n_s[j] + "|" + lo_s[j] + "|" + hi_s[j] + "|"
                  + ",".join(text[prev:e]))
        prev = e
    return out


def build_group_digests(
    counts: np.ndarray,
    starts: np.ndarray,
    sorted_vals: np.ndarray,
    kind: str,
    tag: str = "TD1",
    compression: int = DEFAULT_COMPRESSION,
) -> List[Optional[str]]:
    """Per-group digests from group-contiguous VALUE-SORTED runs laid out
    from offset 0 (``starts`` the prefix sums of ``counts``).

    One vectorized bucketing over the flat element array, then one
    serialization per live group (<= ``compression`` centroids each).
    """
    counts = np.asarray(counts).astype(np.int64)
    starts = np.asarray(starts).astype(np.int64)
    vals = np.asarray(sorted_vals, dtype=np.float64)
    total = int(counts.sum())
    if total == 0:
        return [None] * counts.shape[0]
    live = np.nonzero(counts > 0)[0]
    lc = counts[live]
    table, sizes, offsets = bucket_table(lc, compression)
    # element -> (live group, in-group position): runs are contiguous
    owner = np.repeat(np.arange(len(live)), lc)
    i_in = np.arange(total) - np.repeat(starts[live], lc)
    base = offsets[np.searchsorted(sizes, lc)]
    b = table[np.repeat(base, lc) + i_in]
    key = owner * compression + b
    size = len(live) * compression
    w = np.bincount(key, minlength=size).astype(np.float64)
    s = np.bincount(key, weights=vals[:total], minlength=size)
    nz = np.nonzero(w)[0]
    return digest_strings(
        counts.shape[0], live, lc, nz, s[nz] / w[nz], w[nz],
        vals[starts[live]], vals[starts[live] + lc - 1], kind, tag,
        compression)


def parse_digest(s: str):
    """-> (kind, n, lo, hi, means, weights); raises on malformed input."""
    tag, kind, n, lo, hi, cent = s.split("|")
    if tag not in ("TD1", "QD1"):
        raise ValueError(f"not a velox_tpu digest: {tag!r}")
    if cent:
        flat = np.asarray(cent.replace(":", ",").split(","),
                          dtype=np.float64)
        if len(flat) % 2:
            raise ValueError(f"malformed centroid list: {cent[:40]!r}")
        means = flat[0::2].copy()
        weights = flat[1::2].copy()
    else:
        means = np.zeros(0)
        weights = np.zeros(0)
    return kind, float(n), float(lo), float(hi), means, weights


def merge_digests(blobs: Sequence[str],
                  compression: int = DEFAULT_COMPRESSION) -> Optional[str]:
    """Merge digests: pool centroids, re-bucket by cumulative-weight
    quantile (the standard t-digest merge), re-serialize."""
    parsed = [parse_digest(b) for b in blobs if b is not None]
    if not parsed:
        return None
    tag = "TD1" if blobs[0].startswith("TD1") else "QD1"
    kind = parsed[0][0]
    n = sum(p[1] for p in parsed)
    lo = min(p[2] for p in parsed)
    hi = max(p[3] for p in parsed)
    means = np.concatenate([p[4] for p in parsed])
    weights = np.concatenate([p[5] for p in parsed])
    order = np.argsort(means, kind="stable")
    means, weights = means[order], weights[order]
    cum = np.cumsum(weights)
    q = (cum - weights / 2.0) / n
    b = np.clip(_k1_buckets(q, compression), 0, compression - 1)
    w = np.bincount(b, weights=weights, minlength=compression)
    s = np.bincount(b, weights=means * weights, minlength=compression)
    nz = np.nonzero(w)[0]
    return _serialize(tag, kind, n, lo, hi, s[nz] / w[nz], w[nz])


def value_at_quantile(digest: str, q) -> Optional[float]:
    """Quantile estimate by linear interpolation between centroid
    midpoints (TDigestFunctions.h valueAtQuantile contract), clamped to
    the exact [min, max] the digest records."""
    return value_at_quantile_parsed(parse_digest(digest), q)


def value_at_quantile_parsed(parsed, q) -> Optional[float]:
    """``value_at_quantile`` of a ``parse_digest`` result."""
    kind, n, lo, hi, means, weights = parsed
    q = float(q)
    if n <= 0 or len(means) == 0:
        return None
    if q <= 0:
        v = lo
    elif q >= 1:
        v = hi
    else:
        cum = np.cumsum(weights)
        mid = (cum - weights / 2.0) / n
        v = float(np.interp(q, mid, means, left=lo, right=hi))
        v = min(max(v, lo), hi)
    return float(round(v)) if kind == "i" else float(v)


def quantile_at_value(digest: str, v) -> Optional[float]:
    """Inverse of value_at_quantile (rank of a value in [0, 1])."""
    return quantile_at_value_parsed(parse_digest(digest), v)


def quantile_at_value_parsed(parsed, v) -> Optional[float]:
    """``quantile_at_value`` of a ``parse_digest`` result."""
    kind, n, lo, hi, means, weights = parsed
    v = float(v)
    if n <= 0 or len(means) == 0:
        return None
    if v <= lo:
        return 0.0
    if v >= hi:
        return 1.0
    cum = np.cumsum(weights)
    mid = (cum - weights / 2.0) / n
    return float(np.interp(v, means, mid, left=0.0, right=1.0))


def scale_tdigest_blob(blob: str, factor: float) -> "Optional[str]":
    """scale_tdigest(tdigest, scale) — multiply every centroid weight
    (velox/functions/prestosql/TDigestFunctions.h scale_tdigest)."""
    if blob is None:
        return None
    return scale_tdigest_parsed(parse_digest(blob), blob.split("|", 1)[0],
                                factor)


def scale_tdigest_parsed(parsed, tag: str, factor: float) -> str:
    """``scale_tdigest_blob`` of a ``parse_digest`` result and its tag."""
    factor = float(factor)
    if factor <= 0:
        raise ValueError("scale factor should be positive")
    kind, n, lo, hi, means, weights = parsed
    return _serialize(tag, kind, n * factor, lo, hi, means,
                      weights * factor)


def trimmed_mean_blob(blob: str, lo_q: float, hi_q: float
                      ) -> "Optional[float]":
    """trimmed_mean(tdigest, lo, hi) — mean of the mass between the
    two quantiles, partial centroids pro-rated
    (velox/functions/prestosql/TDigestFunctions.h)."""
    if blob is None:
        return None
    return trimmed_mean_parsed(parse_digest(blob), lo_q, hi_q)


def trimmed_mean_parsed(parsed, lo_q: float, hi_q: float
                        ) -> "Optional[float]":
    """``trimmed_mean_blob`` of a ``parse_digest`` result."""
    _kind, n, _lo, _hi, means, weights = parsed
    if n <= 0 or len(means) == 0:
        return None
    lo_w, hi_w = float(lo_q) * n, float(hi_q) * n
    cum = np.cumsum(weights)
    start = cum - weights
    take = np.clip(np.minimum(cum, hi_w) - np.maximum(start, lo_w),
                   0.0, None)
    tw = take.sum()
    if tw <= 0:
        return None
    return float((means * take).sum() / tw)
