"""Collect-mode aggregation, digests, set sketches and long decimals over
TPC-H at full width, with oracles computed on the host from the generated
arrays (cents, string codes): the plans of ``chip_smoke.py``'s phase 13.

**Exact percentiles** (``plan_percentiles``): ``approx_percentile`` of
``l_extendedprice`` (0.5) and ``l_quantity`` (0.9) beside ``sum``,
``avg`` and ``count(*)``, and ``approx_winsorized_mean(l_extendedprice,
0.05, 0.95)`` where keyed, by Q1's keys, ``l_suppkey`` (100,000 groups)
and keyless (one group of every row). The oracle sorts each group's
values and takes the float32 position ``floor(float32(q) *
float32(n - 1))``, as the JAX package does.

**Two-step** (``plan_two_step``): the same percentiles through the K = 64
digest lanes. Each result's rank in its group's sorted values must lie
within ``n / RANK_BOUND`` of ``q (n - 1)``; a group of at most 64 rows
gives the value at rank ``floor(float64(float32(q)) * (n - 1))``
exactly. The result is one centroid's mean, and a centroid spans about
n / 64 ranks, more after the rebinning of a merge: by ``l_suppkey`` (8
splits of about 75 rows a group, merged) ranks reach 1.75% of n, past
the n / 64 (1.56%) that twice the reference's documented 1/(2K) would
give; the count of groups past n / 64 is logged.

**Digests** (``plan_digests``, ``plan_digest_merge``): ``tdigest_agg(
l_extendedprice)`` and ``qdigest_agg(l_quantity)`` by ``l_suppkey`` over
the first ``SUPPLIER_CUT`` suppliers (2,000 groups, 1.2M rows: the
blobs are written and read on the host, which over all 100,000
suppliers took longer than the rest of the phase, and over 5,000 pushed
the script past its time limit's margin once phase 14 came) with the
readers
``value_at_quantile``, ``quantile_at_value``, ``trimmed_mean`` and
``scale_tdigest`` projected over them, and ``merge`` of both by
``l_suppkey % 100``. The blobs must equal ``functions/digest.py`` over
the oracle's sorted runs, the readers the same functions over those
blobs, and each reader the exact quantity within the digest's error
(``READER_TOL``).

**Set sketches**: ``approx_set(l_partkey)`` by ``l_suppkey`` over the
first ``SUPPLIER_CUT`` suppliers (over all 100,000, the host wrote
100,000 blobs in 3.6 s a run beside one H100, too long for the
script's time limit; every
blob equal to the registers built on the host over the same hash, and
``cardinality`` to ``sketch.py``'s estimate of it; the spread against
the distinct counts is logged: a supplier holds about 80 distinct parts,
where the estimate's own spread is about 1.6% and over many groups some
lie past 3 of the asymptotic standard errors, 1.04 / sqrt(2048)) and
keyless (within those 3 standard errors); ``make_set_digest(l_partkey)``
by ``l_suppkey`` (the first ``SUPPLIER_CUT``) under the masks
``l_shipmode = 'AIR'`` and ``'RAIL'`` with ``intersection_cardinality``
and ``jaccard_index`` of the two (exact: each supplier holds fewer than
2048 distinct parts); ``merge`` and ``merge_set_digest`` of the sketches
by ``l_suppkey % 1000``, equal to the keyless sketches;
``khyperloglog_agg(ps_partkey, ps_suppkey)`` over partsupp with its
readers, and ``merge_khll`` of it by ``ps_suppkey % 100``. The keyless
blobs must equal ``functions/sketch.py`` built on the host over the
same hash.

**Long decimals** (``wide_columns``, ``plan_wide``): a seeded table of
2^22 rows, ``x DECIMAL(38, 2)`` of magnitudes up to 10^30 (1% NULL) and
a key ``k`` of 1024 values; ``sum``, ``avg``, ``min``, ``max``,
``count`` by ``k``, keyless and in two steps, and a filter against a
literal past int64, each exact against Python's ints.
"""

from __future__ import annotations

import decimal
from typing import Dict, List, Optional

import numpy as np

from velox_tpu_torch.tpch.join_agg_plans import group_rows

GROUPINGS = {"q1_keys": ["l_returnflag", "l_linestatus"],
             "suppkey": ["l_suppkey"], "keyless": []}

#: (name, column, q) of each percentile
PERCENTILES = [("p_price", "l_extendedprice", 0.5),
               ("p_qty", "l_quantity", 0.9)]
WINSOR = (0.05, 0.95)

#: the value ``quantile_at_value`` reads (cents: $36,000)
QV_AT = 3600000.0

#: a two-step result's rank lies within n / RANK_BOUND of q (n - 1): two
#: nominal centroid widths
RANK_BOUND = 32

#: how far each digest reader may lie from the exact quantity: a rank
#: error (fraction of the group) or a relative error
READER_TOL = {"v50": 0.03, "qv": 0.03, "tm": 0.02, "q90": 0.03}


def _scan(pb, table, cols):
    return pb().table_scan(table, columns=list(dict.fromkeys(cols)))


def plan_percentiles(pb, grouping: str):
    keys = GROUPINGS[grouping]
    aggs = [f"approx_percentile({c}, {q}) AS {n}" for n, c, q in PERCENTILES]
    aggs += ["sum(l_quantity) AS sum_qty", "avg(l_discount) AS avg_disc",
             "count(*) AS n"]
    if keys:
        aggs.append("approx_winsorized_mean(l_extendedprice, "
                    f"{WINSOR[0]}, {WINSOR[1]}) AS w_price")
    return _scan(pb, "lineitem", keys + [
        "l_extendedprice", "l_quantity", "l_discount"]).aggregate(keys, aggs)


def plan_two_step(pb, grouping: str):
    keys = GROUPINGS[grouping]
    aggs = [f"approx_percentile({c}, {q}) AS {n}" for n, c, q in PERCENTILES]
    aggs += ["count(*) AS n"]
    return (_scan(pb, "lineitem", keys + ["l_extendedprice", "l_quantity"])
            .partial_aggregation(keys, aggs).final_aggregation())


DIGEST_READERS = [
    "value_at_quantile(td, 0.5) AS v50",
    f"quantile_at_value(td, {QV_AT}) AS qv",
    "trimmed_mean(td, 0.1, 0.9) AS tm",
    "scale_tdigest(td, 2.0) AS sc",
    "value_at_quantile(qd, 0.9) AS q90"]


#: the digest and pair-reader plans read the first this many suppliers:
#: their blobs are written and read on the host
SUPPLIER_CUT = 2000


def _digests(pb):
    return (_scan(pb, "lineitem", ["l_suppkey", "l_extendedprice",
                                   "l_quantity"])
            .filter(f"l_suppkey <= {SUPPLIER_CUT}")
            .aggregate(["l_suppkey"], ["tdigest_agg(l_extendedprice) AS td",
                                       "qdigest_agg(l_quantity) AS qd",
                                       "count(*) AS n"]))


def plan_digests(pb):
    """The digests by supplier and their readers, in one projection."""
    return _digests(pb).project(["l_suppkey", "td", "qd", "n"]
                                + DIGEST_READERS)


def plan_digest_merge(pb):
    return (_digests(pb).project(["l_suppkey % 100 AS g", "td", "qd"])
            .aggregate(["g"], ["merge(td) AS mt", "merge(qd) AS mq",
                               "count(*) AS n"]))


def plan_approx_set(pb, grouping: str):
    """By ``l_suppkey``: the first ``SUPPLIER_CUT`` suppliers only."""
    keys = GROUPINGS[grouping]
    scan = _scan(pb, "lineitem", keys + ["l_partkey"])
    if grouping == "suppkey":
        scan = scan.filter(f"l_suppkey <= {SUPPLIER_CUT}")
    return (scan.aggregate(keys, ["approx_set(l_partkey) AS hs",
                                  "count(*) AS n"])
            .project(keys + ["hs", "cardinality(hs) AS card", "n"]))


def plan_set_digests(pb):
    return (_scan(pb, "lineitem", ["l_suppkey", "l_partkey", "l_shipmode"])
            .filter(f"l_suppkey <= {SUPPLIER_CUT}")
            .project(["l_suppkey", "l_partkey", "l_shipmode = 'AIR' AS air",
                      "l_shipmode = 'RAIL' AS rail"])
            .aggregate(["l_suppkey"], ["make_set_digest(l_partkey) AS sa",
                                       "make_set_digest(l_partkey) AS sb"],
                       masks={"sa": "air", "sb": "rail"})
            .project(["l_suppkey", "sa", "sb",
                      "intersection_cardinality(sa, sb) AS ic",
                      "jaccard_index(sa, sb) AS jj"]))


def plan_set_merges(pb):
    return (_scan(pb, "lineitem", ["l_suppkey", "l_partkey"])
            .project(["l_suppkey % 1000 AS g", "l_partkey"])
            .aggregate(["g"], ["approx_set(l_partkey) AS hs",
                               "make_set_digest(l_partkey) AS sd"])
            .aggregate([], ["merge(hs) AS mh", "merge_set_digest(sd) AS md",
                            "count(*) AS n"]))


def plan_khll(pb):
    return (_scan(pb, "partsupp", ["ps_partkey", "ps_suppkey"])
            .aggregate([], ["khyperloglog_agg(ps_partkey, ps_suppkey) AS kh"])
            .project(["kh", "uniqueness_distribution(kh) AS ud",
                      "reidentification_potential(kh, 10) AS rp",
                      "cardinality(kh) AS card"]))


def plan_khll_merge(pb):
    return (_scan(pb, "partsupp", ["ps_partkey", "ps_suppkey"])
            .project(["ps_suppkey % 100 AS g", "ps_partkey", "ps_suppkey"])
            .aggregate(["g"], ["khyperloglog_agg(ps_partkey, ps_suppkey) "
                               "AS kh"])
            .aggregate([], ["merge_khll(kh) AS mk", "count(*) AS n"]))


# ------------------------------------------------------------- oracles

def f32_rank(q: float, n: np.ndarray) -> np.ndarray:
    """The JAX package's single-step position: float32 product."""
    return np.floor(np.float32(q) * np.maximum(n - 1, 0).astype(
        np.float32)).astype(np.int64)


def sorted_runs(li, grouping: str, column: str, rows_cache: dict):
    """(keys, starts, counts, values sorted within each group) of one
    column by one grouping; the groups in key order."""
    if grouping == "keyless":
        n = len(li[column])
        perm, starts, keys = np.arange(n), np.zeros(1, np.int64), {}
    else:
        if grouping not in rows_cache:
            rows_cache[grouping] = group_rows(li, grouping)
        perm, starts, keys = rows_cache[grouping]
    counts = np.diff(np.append(starts, len(perm)))
    v = li[column][perm].astype(np.int64)
    lo = int(v.min())
    step = max(int(np.gcd.reduce(v - lo)), 1)    # cents of whole units
    span = (int(v.max()) - lo) // step + 1
    gid = np.repeat(np.arange(len(starts)), counts)
    key = gid * span + (v - lo) // step
    if len(starts) * span <= 1 << 27:
        # few (group, value) cells: a counting sort
        cells = np.bincount(key, minlength=len(starts) * span)
        out = np.repeat(np.arange(len(cells)), cells)
    else:
        # one sort of (group, value) packed into an int64
        out = np.sort(key)
    return keys, starts, counts, (out % span) * step + lo


def percentile_oracle(runs, q: float):
    """Exact values at the float32 position, and how many groups a
    float64 position would move."""
    _keys, starts, counts, vals = runs
    pos = f32_rank(q, counts)
    moved = int((np.floor(q * np.maximum(counts - 1, 0)).astype(np.int64)
                 != pos).sum())
    return vals[starts + pos], moved


def winsorized_oracle(runs, lo: float, hi: float) -> np.ndarray:
    """Mean of each group's values clamped to its lo/hi position values
    (float32 positions), in the lane's units (cents)."""
    _keys, starts, counts, vals = runs
    gid = np.repeat(np.arange(len(starts)), counts)
    vlo = vals[starts + f32_rank(lo, counts)][gid]
    vhi = vals[starts + f32_rank(hi, counts)][gid]
    cl = np.minimum(np.maximum(vals, vlo), vhi).astype(np.float64)
    return np.bincount(gid, weights=cl) / counts


def rank_errors(runs, got: np.ndarray, q: float):
    """For each two-step result, how far (in ranks) its value lies from
    rank ``q (n - 1)`` in its group, and whether the group is exact (at
    most 64 rows: the value at rank ``floor(float64(float32(q)) * (n -
    1))``)."""
    _keys, starts, counts, vals = runs
    target = q * (counts - 1)
    err = np.zeros(len(starts))
    exact_ok = np.ones(len(starts), bool)
    q64 = float(np.float32(q))
    for g in range(len(starts)):
        run = vals[starts[g]:starts[g] + counts[g]]
        lo = np.searchsorted(run, got[g], side="left")
        hi = np.searchsorted(run, got[g], side="right")
        err[g] = 0.0 if lo - 1 <= target[g] <= hi else min(
            abs(lo - target[g]), abs(hi - target[g]))
        if counts[g] <= 64:
            exact_ok[g] = run[int(np.floor(q64 * (counts[g] - 1)))] == got[g]
    return err, exact_ok


def sampled(runs, groups: np.ndarray):
    """The runs of the groups ``groups`` (indices, ascending) alone."""
    _keys, starts, counts, vals = runs
    c = counts[groups]
    total = int(c.sum())
    idx = (np.arange(total) - np.repeat(np.cumsum(c) - c, c)
           + np.repeat(starts[groups], c))
    return {}, np.cumsum(c) - c, c, vals[idx]


def digest_oracle(runs, tag: str) -> List[Optional[str]]:
    """The blobs ``functions/digest.py`` builds over the oracle's runs."""
    from velox_tpu_torch.functions.digest import build_group_digests

    _keys, starts, counts, vals = runs
    return build_group_digests(counts, starts, vals, "i", tag)


def reader_oracle(td: List[str], qd: List[str]) -> Dict[str, list]:
    """The readers, by ``functions/digest.py``, over the oracle's blobs."""
    from velox_tpu_torch.functions import digest as D

    pt = [D.parse_digest(b) for b in td]
    return {"v50": [D.value_at_quantile_parsed(p, 0.5) for p in pt],
            "qv": [D.quantile_at_value_parsed(p, QV_AT) for p in pt],
            "tm": [D.trimmed_mean_parsed(p, 0.1, 0.9) for p in pt],
            "sc": [D.scale_tdigest_parsed(p, "TD1", 2.0) for p in pt],
            "q90": [D.value_at_quantile_parsed(D.parse_digest(b), 0.9)
                    for b in qd]}


def reader_errors(runs_price, runs_qty, got: Dict[str, list]):
    """Each reader against the exact quantity: the worst rank error of
    the value readers, the worst quantile error of ``quantile_at_value``
    and the worst relative error of ``trimmed_mean``."""
    out = {}
    for name, runs, q in (("v50", runs_price, 0.5), ("q90", runs_qty, 0.9)):
        _k, starts, counts, vals = runs
        worst = 0.0
        for g in range(len(starts)):
            # a value's ranks: every position its ties hold
            run = vals[starts[g]:starts[g] + counts[g]]
            lo = np.searchsorted(run, got[name][g], side="left")
            hi = np.searchsorted(run, got[name][g], side="right")
            t = q * (counts[g] - 1)
            err = 0.0 if lo - 1 <= t <= hi else min(abs(lo - t),
                                                    abs(hi - t))
            worst = max(worst, err / counts[g])
        out[name] = worst
    _k, starts, counts, vals = runs_price
    worst_q = worst_t = 0.0
    for g in range(len(starts)):
        run = vals[starts[g]:starts[g] + counts[g]].astype(np.float64)
        below = np.searchsorted(run, QV_AT, side="left") / counts[g]
        upto = np.searchsorted(run, QV_AT, side="right") / counts[g]
        qv = got["qv"][g]
        worst_q = max(worst_q, 0.0 if below <= qv <= upto
                      else min(abs(qv - below), abs(qv - upto)))
        lo, hi = int(np.ceil(0.1 * counts[g])), int(np.floor(0.9 * counts[g]))
        if hi > lo:
            exact = run[lo:hi].mean()
            worst_t = max(worst_t, abs(got["tm"][g] - exact) / abs(exact))
    out["qv"], out["tm"] = worst_q, worst_t
    return out


def merge_oracle(blobs: List[str], keys: np.ndarray, mod: int,
                 groups) -> List[Optional[str]]:
    """``merge_digests`` of the blobs of each ``key % mod`` in ``groups``,
    in key order (the first aggregation's output order); ``blobs`` and
    ``keys`` hold (at least) every key of those groups."""
    from velox_tpu_torch.functions.digest import merge_digests

    g = keys % mod
    return [merge_digests([blobs[i] for i in np.nonzero(g == m)[0]])
            for m in groups]


def supplier_parts(li, ps, rows):
    """The distinct (``l_suppkey`` group, ``l_partkey``) pairs, as two
    arrays ordered by group. Every lineitem pair is a partsupp row (spec
    4.2.3: four suppliers a part, four rows a part in part order), so a
    flag a partsupp row marks the pairs in one pass, no sort."""
    _perm, _starts, keys = rows
    pk = li["l_partkey"].astype(np.int64)
    sk = li["l_suppkey"].astype(np.int64)
    ps_pk = ps["ps_partkey"].astype(np.int64)
    ps_sk = ps["ps_suppkey"].astype(np.int64)
    n_parts = len(ps_pk) // 4
    if np.array_equal(ps_pk, np.repeat(np.arange(1, n_parts + 1), 4)):
        first = 4 * (pk - 1)                    # the part's first row
    else:
        first = np.searchsorted(ps_pk, pk)
    seen = np.zeros(len(ps_pk) + 1, bool)
    found = np.zeros(len(pk), bool)
    for i in range(4):
        row = np.minimum(first + i, len(ps_pk) - 1)
        hit = ~found & (ps_pk[row] == pk) & (ps_sk[row] == sk)
        seen[np.where(hit, row, len(ps_pk))] = True
        found |= hit
    if not found.all():
        raise AssertionError("a lineitem (part, supplier) is no partsupp row")
    rows_ps = np.flatnonzero(seen[:-1])
    g = np.searchsorted(keys["l_suppkey"], ps_sk[rows_ps])
    order = np.argsort(g, kind="stable")
    return g[order], ps_pk[rows_ps][order], len(keys["l_suppkey"])


def supplier_sets(pairs, sketches) -> Dict[str, object]:
    """Per ``l_suppkey`` group: the distinct ``l_partkey`` count, and the
    ``approx_set`` blob built on the host from the registers of those
    distinct parts over the same hash (``sketches``' hash table)."""
    import base64

    from velox_tpu_torch.functions import sketch as SK

    g, part, n_groups = pairs
    keys, hashes = sketches["hash_table"]
    h = hashes[np.searchsorted(keys, part)]
    m = 1 << SK.HLL_LOG2M
    bucket = (h & np.uint64(m - 1)).astype(np.int64)
    rest = h >> np.uint64(SK.HLL_LOG2M)
    width = 64 - SK.HLL_LOG2M
    bl = np.frexp(rest.astype(np.float64))[1]
    rank = np.where(rest != 0, width - bl + 1, width + 1).astype(np.uint8)
    regs = np.zeros(n_groups * m, np.uint8)
    np.maximum.at(regs, g * m + bucket, rank)
    regs = regs.reshape(n_groups, m)
    head = "HL1|%d|" % SK.HLL_LOG2M
    return {"distinct": np.bincount(g, minlength=n_groups),
            "hs": [head + base64.b64encode(r.tobytes()).decode()
                   for r in regs]}


def masked_sets(li, rows, dicts) -> Dict[str, np.ndarray]:
    """Per supplier of the first ``SUPPLIER_CUT``: distinct parts shipped
    by AIR, by RAIL, both, and either."""
    perm, starts, keys = rows
    n = int(np.searchsorted(keys["l_suppkey"], SUPPLIER_CUT, side="right"))
    modes = list(dicts["l_shipmode"])
    counts = np.diff(np.append(starts, len(perm)))[:n]
    gid = np.repeat(np.arange(n), counts)
    take = perm[:len(gid)]
    pk = li["l_partkey"][take].astype(np.int64)
    mode = li["l_shipmode"][take]
    span = int(pk.max()) + 1
    starts = starts[:n]
    out = {}
    sets = []
    for m in ("AIR", "RAIL"):
        sel = mode == modes.index(m)
        sets.append(np.unique(gid[sel] * span + pk[sel]))
    both = np.intersect1d(sets[0], sets[1], assume_unique=True)
    union = np.union1d(sets[0], sets[1])
    for name, s in (("air", sets[0]), ("rail", sets[1]), ("both", both),
                    ("union", union)):
        out[name] = np.bincount(s // span, minlength=len(starts))
    return out


def sketch_oracles(li, ps) -> Dict[str, str]:
    """The keyless blobs ``functions/sketch.py``'s formats hold, built on
    the host from one ``hash64`` per distinct key (a set sketch depends
    only on the distinct values; a KHyperLogLog on the distinct pairs)."""
    import base64

    from velox_tpu_torch.functions import sketch as SK

    parts = np.flatnonzero(np.bincount(li["l_partkey"]))
    pairs = np.unique(ps["ps_partkey"].astype(np.int64) * (1 << 32)
                      + ps["ps_suppkey"].astype(np.int64))
    xs, us = pairs >> 32, pairs & ((1 << 32) - 1)
    keys = np.unique(np.concatenate([parts, xs, us]))
    hashes = SK.hash64_array(keys)

    def hash_of(v):
        return hashes[np.searchsorted(keys, v)]

    hp = hash_of(parts)
    regs = base64.b64encode(SK._hll_regs_from_hashes(
        hp, SK.HLL_LOG2M).tobytes()).decode()
    head = "%d|%s" % (SK.HLL_LOG2M, regs)
    return {"hs": "HL1|" + head,
            "sd": "SD1|" + head + "|" + SK._pack_u64(
                np.unique(hp)[:SK.SD_K]),
            "kh": SK.khll_build(hash_of(xs), hash_of(us)),
            "distinct": len(parts), "hash_table": (keys, hashes)}


# --------------------------------------------------------- long decimals

WIDE_ROWS = 1 << 22
WIDE_KEYS = 1024
#: past int64 (2^63 ~ 9.2e18), in units: 1.2e28 cents, inside the
#: values' 10^30
WIDE_LITERAL = 123456789012345678901234567


def wide_columns(seed: int, n: int = WIDE_ROWS):
    """``k`` (int64, 1024 values) and ``x`` (unscaled cents as Python
    ints up to 10^30 in magnitude, 1% None) of the long-decimal table."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, WIDE_KEYS, n).astype(np.int64)
    hi = rng.integers(0, 10 ** 15, n).astype(object)
    lo = rng.integers(0, 10 ** 15, n).astype(object)
    sign = (rng.integers(0, 2, n) * 2 - 1).astype(object)
    x = sign * (hi * 10 ** 15 + lo)
    x[rng.random(n) < 0.01] = None
    return {"k": k, "x": x}


def plan_wide(pb, keys: List[str], two_step: bool = False):
    aggs = ["sum(x) AS s", "avg(x) AS a", "min(x) AS mn", "max(x) AS mx",
            "count(x) AS c", "count(*) AS n"]
    scan = pb().table_scan("wide")
    if two_step:
        return scan.partial_aggregation(keys, aggs).final_aggregation()
    return scan.aggregate(keys, aggs)


def plan_wide_filter(pb):
    return (pb().table_scan("wide").filter(f"x > {WIDE_LITERAL}")
            .aggregate([], ["count(*) AS n", "sum(x) AS s"]))


_CTX = decimal.Context(prec=60)


def _dec(v):
    return None if v is None else decimal.Decimal(v).scaleb(-2, _CTX)


def wide_oracle(cols, keyed: bool) -> Dict[str, list]:
    """``plan_wide``'s rows from Python's ints: groups in key order; an
    average rounds half away from zero; NULL where a group has no value
    (a sum of magnitude 10^38 or more would be NULL too)."""
    k = cols["k"] if keyed else np.zeros(len(cols["k"]), np.int64)
    x = cols["x"]
    order = np.argsort(k, kind="stable")
    ks = k[order]
    xs = x[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    isnull = np.equal(xs, None)
    zero = np.where(isnull, 0, xs)
    big = 10 ** 40
    sums = np.add.reduceat(zero, starts)
    cnt = np.add.reduceat((~isnull).astype(np.int64), starts)
    mins = np.minimum.reduceat(np.where(isnull, big, xs), starts)
    maxs = np.maximum.reduceat(np.where(isnull, -big, xs), starts)
    rows = {"k": ks[starts].tolist()} if keyed else {}
    s, a, mn, mx = [], [], [], []
    for v, c, lo, hi in zip(sums.tolist(), cnt.tolist(), mins.tolist(),
                            maxs.tolist()):
        if c == 0:
            s.append(None), a.append(None), mn.append(None), mx.append(None)
            continue
        sgn = -1 if v < 0 else 1
        s.append(_dec(v) if abs(v) < 10 ** 38 else None)
        a.append(_dec(sgn * ((2 * abs(v) + c) // (2 * c))))
        mn.append(_dec(lo))
        mx.append(_dec(hi))
    counts = np.diff(np.append(starts, len(ks)))
    rows.update({"s": s, "a": a, "mn": mn, "mx": mx, "c": cnt.tolist(),
                 "n": counts.tolist()})
    return rows


def wide_filter_oracle(cols) -> Dict[str, list]:
    x = cols["x"]
    keep = x[np.not_equal(x, None)]
    keep = keep[keep > WIDE_LITERAL * 100]   # the literal is in units
    total = int(np.sum(keep)) if len(keep) else None
    return {"n": [len(keep)], "s": [_dec(total)]}
