"""Two-step (PARTIAL -> FINAL) and adaptive partial aggregation, and the
multi-argument, bitwise, sketch and noisy aggregates, over TPC-H's
lineitem at full width, with oracles computed on the host from the
generated arrays (cents, string codes).

**S, two-step TPC-H.**

* ``q1``: Q1 with its aggregation split into PARTIAL and FINAL steps
  (kArray in both: the keys are dictionary-coded); its rows are Q1's;
* ``q6``: Q6's keyless aggregation in two steps;
* ``q18_inner``: Q18's inner ``sum(l_quantity)`` by ``l_orderkey`` in two
  steps (generic: about 2.1M orders a 2^23-row split, a ratio of 0.25,
  so the PARTIAL step keeps aggregating);
* ``unique``: ``sum``, ``count`` and ``min_by`` by (``l_orderkey``,
  ``l_linenumber``), a unique key: the PARTIAL step's ratio is 1.0 and
  it abandons after the first split.

**M, the 17 aggregates**, in five families (``FAMILIES``: each small
enough that the generic mode's per-split partials and their merge stay
well under 40 GiB), grouped by Q1's keys (kArray), by ``l_suppkey``
(generic, 100,000 groups), by ``l_orderkey`` (streaming, 15M groups) and
keyless. ``approx_distinct`` is left out of the streaming grouping: its
registers would take 15M x 1024 x 4 bytes a batch. The ``by`` and
``bits`` families also run in two steps by ``l_suppkey``
(``TWO_STEP_FAMILIES``).

Oracles (``GroupOracle.family``) give ``{name: (values, mask, err)}`` for
``join_agg_plans.check_aggregates``: ``err`` None is exact, else the
absolute tolerance beyond 1e-9 relative:

* ``min_by``/``max_by``: the mode's tie rule (kArray: the first optimum
  row of the last split that holds one; generic, keyless, streaming:
  the first optimum row);
* bitwise, ``approx_distinct`` (a numpy copy of the sketch over the same
  hash, ``approx_distinct``) and the counts: exact;
* the covariance family: the extract formulas over numpy's sums, with
  the rounding their cancellation can amplify (as
  ``join_agg_plans._variance``);
* ``product``: 1e-12 relative; ``entropy``: its formula in float64 with
  the rounding of its n-term sum;
* the noisy family: the exact sum or count plus ``scale * z``, ``z`` from
  ``group_gaussian`` (a numpy float32 copy of the port's draw) at the
  group's output slot; 1e-6 x scale, and a count may differ by one
  where the oracle's value lies within 1e-5 of a .5 boundary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from velox_tpu_torch.tpch.join_agg_plans import EPS, GROUPINGS, group_rows

# ------------------------------------------------------- numpy copies

_HLL_M = 1024
_LC_TABLE = np.concatenate([
    [0.0], _HLL_M * np.log(_HLL_M / np.arange(1, _HLL_M + 1.0))])
_HLL_ALPHA_MM = (0.7213 / (1 + 1.079 / float(_HLL_M))) * float(_HLL_M) \
    * float(_HLL_M)


def hash_i64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer of int64 values (uint64)."""
    z = np.asarray(x, dtype=np.int64).view(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _saturating_i64(x: np.ndarray) -> np.ndarray:
    big = float(2 ** 63)
    inr = (x > -big) & (x < big)
    t = np.where(inr, x, 0.0).astype(np.int64)
    t = np.where(x >= big, np.iinfo(np.int64).max, t)
    return np.where(x <= -big, np.iinfo(np.int64).min, t)


def hll_bucket_rank(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each value's register and rank, as the port's ``hll_bucket_rank``
    (a float scaled by 2^20 and truncated first)."""
    if v.dtype.kind == "f":
        v = _saturating_i64(v.astype(np.float64) * float(1 << 20))
    h = hash_i64(v)
    bucket = (h & np.uint64(_HLL_M - 1)).astype(np.int64)
    rest = (h >> np.uint64(10)) & np.uint64((1 << 53) - 1)
    # below 2^53 the float64 step is exact, so one rounding to float32
    restf = np.maximum(rest, 1).astype(np.float64).astype(np.float32)
    e = (restf.view(np.int32) >> 23) & 0xFF
    return bucket, np.clip(54 - (e - 127), 1, 54).astype(np.int32)


def approx_distinct(v: np.ndarray, gids: np.ndarray, ng: int) -> np.ndarray:
    """The sketch's estimate for each of ``ng`` groups (``gids`` per row):
    registers by one max-scatter, the estimate as the port extracts it."""
    bucket, rank = hll_bucket_rank(v)
    regs = np.zeros(ng * _HLL_M, np.int32)
    np.maximum.at(regs, gids.astype(np.int64) * _HLL_M + bucket, rank)
    return _hll_extract(regs.reshape(ng, _HLL_M),
                        np.bincount(gids, minlength=ng))


def _hll_extract(regs: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The estimate of each row of (groups, 1024) registers, as the port
    extracts it, at most the group's row count ``n``."""
    inv = np.ldexp(1.0, -np.clip(regs, 0, 63))
    est = _HLL_ALPHA_MM / inv.sum(axis=1)
    zeros = (regs == 0).sum(axis=1)
    est = np.where((est <= 2.5 * _HLL_M) & (zeros > 0), _LC_TABLE[zeros],
                   est)
    return np.minimum(np.round(est).astype(np.int64), n)


def _mix_u32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def group_gaussian(seed: np.ndarray, ng: int) -> np.ndarray:
    """The port's per-slot draw in numpy float32 (uint32 hashing is
    exact; ``log`` and ``cos`` are numpy's own)."""
    g = np.arange(ng, dtype=np.uint32)
    s = np.asarray(seed).astype(np.int64).astype(np.uint32) \
        * np.uint32(2654435761)
    h1 = _mix_u32(s ^ (g * np.uint32(2)))
    h2 = _mix_u32(s ^ (g * np.uint32(2) + np.uint32(1)))
    scale = np.float32(2.0 ** -32)
    u1 = (h1.astype(np.float32) + np.float32(0.5)) * scale
    u2 = (h2.astype(np.float32) + np.float32(0.5)) * scale
    z = np.sqrt(np.float32(-2.0) * np.log(u1)) * np.cos(
        np.float32(2.0 * np.pi) * u2)
    return z.astype(np.float64)


# ------------------------------------------------------------ S plans

def plan_q1(pb, final: bool = True):
    """Q1 with PARTIAL -> FINAL aggregation (``final=False``: the PARTIAL
    step's lane columns)."""
    b = (pb().table_scan(
            "lineitem",
            columns=["l_returnflag", "l_linestatus", "l_quantity",
                     "l_extendedprice", "l_discount", "l_tax",
                     "l_shipdate"],
            subfilter="l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY")
         .project([
             "l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount",
             "l_extendedprice * (1.0 - l_discount) AS disc_price",
             "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax) "
             "AS charge"])
         .partial_aggregation(
             ["l_returnflag", "l_linestatus"],
             ["sum(l_quantity) AS sum_qty",
              "sum(l_extendedprice) AS sum_base_price",
              "sum(disc_price) AS sum_disc_price",
              "sum(charge) AS sum_charge",
              "avg(l_quantity) AS avg_qty",
              "avg(l_extendedprice) AS avg_price",
              "avg(l_discount) AS avg_disc",
              "count(*) AS count_order"]))
    if not final:
        return b
    return b.final_aggregation().order_by(["l_returnflag", "l_linestatus"])


def plan_q6(pb):
    """Q6 with PARTIAL -> FINAL (keyless) aggregation."""
    return (pb().table_scan(
                "lineitem",
                columns=["l_extendedprice", "l_discount", "l_quantity",
                         "l_shipdate"],
                subfilter="l_shipdate >= DATE '1994-01-01' AND "
                          "l_shipdate < DATE '1995-01-01' AND "
                          "l_discount BETWEEN 0.05 AND 0.07 AND "
                          "l_quantity < 24.0")
            .project(["l_extendedprice * l_discount AS part_rev"])
            .partial_aggregation([], ["sum(part_rev) AS revenue"])
            .final_aggregation())


def plan_q18_inner(pb, two_step: bool = True):
    """Q18's inner aggregation; ``two_step=False``: its single step (the
    optimizer streams it)."""
    b = pb().table_scan("lineitem", columns=["l_orderkey", "l_quantity"])
    aggs = ["sum(l_quantity) AS total_qty"]
    if not two_step:
        return b.aggregate(["l_orderkey"], aggs)
    return b.partial_aggregation(["l_orderkey"], aggs).final_aggregation()


UNIQUE_KEYS = ["l_orderkey", "l_linenumber"]


def plan_unique(pb, two_step: bool = True):
    """Aggregates by a unique key: each row its own group."""
    b = (pb().table_scan("lineitem", columns=UNIQUE_KEYS + [
            "l_quantity", "l_partkey", "l_extendedprice"])
         .project(UNIQUE_KEYS + [
             "l_quantity", "l_partkey",
             "CAST(l_extendedprice AS DOUBLE) AS price"]))
    aggs = ["sum(l_quantity) AS sq", "count(*) AS n",
            "min_by(l_partkey, price) AS mb"]
    if not two_step:
        return b.aggregate(UNIQUE_KEYS, aggs)
    return b.partial_aggregation(UNIQUE_KEYS, aggs).final_aggregation()


def partial_ops(task) -> list:
    """The PARTIAL aggregation operators of a run Task (fused or not)."""
    from velox_tpu_torch.exec.fused import FusedScanAggOp
    from velox_tpu_torch.exec.operators import HashAggregationOp
    from velox_tpu_torch.plan.nodes import AggStep

    out = []
    for p in task.planner.pipelines:
        for op in p.operators:
            op = op.agg if isinstance(op, FusedScanAggOp) else op
            if (isinstance(op, HashAggregationOp)
                    and op.step == AggStep.PARTIAL):
                out.append(op)
    return out


# ------------------------------------------------------------ M plans

#: the groupings: join_agg_plans' three and keyless
M_GROUPINGS: Dict[str, List[str]] = {**GROUPINGS, "keyless": []}

#: five families; each aggregate is (name, function, arguments)
FAMILIES: Dict[str, List[Tuple[str, str, Tuple[str, ...]]]] = {
    "by": [
        ("mb_pk_price", "min_by", ("l_partkey", "price")),
        ("xb_ok_qty", "max_by", ("l_orderkey", "l_quantity")),
        ("mb_price_ok", "min_by", ("price", "l_orderkey"))],
    "covar": [
        ("cs", "covar_samp", ("price", "qty")),
        ("cp", "covar_pop", ("price", "qty")),
        ("co", "corr", ("price", "qty"))],
    "regr": [
        ("rs", "regr_slope", ("price", "qty")),
        ("ri", "regr_intercept", ("price", "qty")),
        ("pt", "product", ("tax1",)),
        ("en", "entropy", ("l_quantity",))],
    "bits": [
        ("band", "bitwise_and_agg", ("l_orderkey",)),
        ("bor", "bitwise_or_agg", ("l_partkey",)),
        ("bxor", "bitwise_xor_agg", ("l_orderkey",)),
        ("ad_pk", "approx_distinct", ("l_partkey",)),
        ("ad_price", "approx_distinct", ("price",))],
    "noisy": [
        ("nc", "noisy_count_gaussian", ("l_orderkey", "20.0")),
        ("nci", "noisy_count_if_gaussian", ("big", "5.0", "11")),
        ("ns", "noisy_sum_gaussian", ("l_quantity", "100.0", "7")),
        ("na", "noisy_avg_gaussian", ("l_partkey", "2.0", "3"))],
}

#: the families that also run PARTIAL -> FINAL by l_suppkey
TWO_STEP_FAMILIES = ("by", "bits")

#: the projected arguments
M_ARGS = {
    "price": "CAST(l_extendedprice AS DOUBLE) AS price",
    "qty": "CAST(l_quantity AS DOUBLE) AS qty",
    "tax1": "CAST(1 + l_tax AS DOUBLE) AS tax1",
    "big": "l_quantity > 25 AS big",
    "l_partkey": "l_partkey", "l_orderkey": "l_orderkey",
    "l_quantity": "l_quantity",
}
_M_RAW = {"price": ["l_extendedprice"], "qty": ["l_quantity"],
          "tax1": ["l_tax"], "big": ["l_quantity"]}


def family_aggs(grouping: str, family: str, two_step: bool = False):
    """The family's aggregates that run in this grouping and step."""
    return [a for a in FAMILIES[family]
            if not (a[1] == "approx_distinct"
                    and (grouping == "orderkey" or two_step))]


def plan_family(pb, grouping: str, family: str, two_step: bool = False):
    keys = M_GROUPINGS[grouping]
    aggs = family_aggs(grouping, family, two_step)
    args = list(dict.fromkeys(a for _, _, fa in aggs for a in fa
                              if a in M_ARGS))
    scan = list(dict.fromkeys(keys + [c for a in args
                                      for c in _M_RAW.get(a, [a])]))
    proj = list(dict.fromkeys(keys + [M_ARGS[a] for a in args]))
    calls = [f"{fn}({', '.join(fa)}) AS {name}" for name, fn, fa in aggs]
    b = pb().table_scan("lineitem", columns=scan).project(proj)
    if two_step:
        return b.partial_aggregation(keys, calls).final_aggregation()
    return b.aggregate(keys, calls)


def m_arguments(li) -> Dict[str, np.ndarray]:
    """Each argument as the port's projection makes it (a DOUBLE cast of
    cents divides by 100; a decimal lane is read as its cents)."""
    return {
        "price": li["l_extendedprice"] / 100.0,
        "qty": li["l_quantity"] / 100.0,
        "tax1": (100 + li["l_tax"]) / 100.0,
        "big": li["l_quantity"] > 2500,
        "l_partkey": li["l_partkey"], "l_orderkey": li["l_orderkey"],
        "l_quantity": li["l_quantity"],
    }


# ---------------------------------------------------------- M oracles

def _first_rows(hit: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per group (``starts`` into ``hit``'s order), the position of its
    first True (every group holds one)."""
    idx = np.flatnonzero(hit)
    return idx[np.searchsorted(idx, starts)]


def _elect(v, cs, perm, starts, sizes, is_min: bool,
           last_split: Optional[int]):
    """min_by/max_by: the payload of the elected optimum row (``cs``: the
    comparison values in group order). With ``last_split`` (split rows,
    the kArray rule) the first optimum row of the last split holding
    one, else the first optimum row."""
    red = np.minimum if is_min else np.maximum
    best = red.reduceat(cs, starts)
    hit = cs == np.repeat(best, sizes)
    if last_split is not None:
        split = perm // last_split
        last = np.maximum.reduceat(np.where(hit, split, -1), starts)
        hit &= split == np.repeat(last, sizes)
    return v[perm[_first_rows(hit, starts)]]


def _covar(sums, name: str):
    """covar_samp/covar_pop/corr/regr_*(price, qty) by the extract
    formulas over numpy's sums (``sums``: n, sx, sy, sxx, syy, sxy), and
    the bound on their rounding: each centred sum loses up to 8 n eps of
    the magnitudes that cancel."""
    n, sx, sy, sxx, syy, sxy = sums
    nf = np.maximum(n.astype(np.float64), 1.0)
    cxy = sxy - sx * sy / nf
    cxx = np.maximum(sxx - sx * sx / nf, 0.0)
    cyy = np.maximum(syy - sy * sy / nf, 0.0)
    e = 8 * nf * EPS
    exy = e * (np.abs(sxy) + np.abs(sx * sy) / nf)
    exx = e * (sxx + sx * sx / nf)
    eyy = e * (syy + sy * sy / nf)
    with np.errstate(divide="ignore", invalid="ignore"):
        if name == "covar_samp":
            d = np.maximum(nf - 1.0, 1.0)
            return cxy / d, n >= 2, exy / d
        if name == "covar_pop":
            return cxy / nf, n >= 1, exy / nf
        if name == "corr":
            denom = np.sqrt(cxx * cyy)
            ok = (n >= 2) & (denom > 0)
            out = np.where(ok, cxy / np.maximum(denom, 1e-300), np.nan)
            err = np.abs(out) * (exy / np.abs(cxy) + 0.5 * exx / cxx
                                 + 0.5 * eyy / cyy)
            return out, ok, np.where(np.isfinite(err), err, np.inf)
        ok = (n >= 2) & (cxx > 0)
        slope = cxy / np.maximum(cxx, 1e-300)
        es = np.abs(slope) * (exy / np.abs(cxy) + exx / cxx)
        es = np.where(np.isfinite(es), es, np.inf)
        if name == "regr_slope":
            return np.where(ok, slope, np.nan), ok, es
        out = (sy - slope * sx) / nf
        err = (es * np.abs(sx) + e * (np.abs(sy) + np.abs(slope * sx))) / nf
        return np.where(ok, out, np.nan), ok, err


def streaming_slots(starts: np.ndarray, split_rows: int) -> np.ndarray:
    """Each group's output slot in the streaming aggregation over splits
    of ``split_rows`` rows (no rows filtered): group g is emitted in the
    split that holds group g+1's first row, as the (k - first)-th group
    emitted there; the last group is flushed alone, at slot 0."""
    split = np.r_[starts[1:] // split_rows, -1]
    first = np.r_[True, split[1:] != split[:-1]]
    head = np.maximum.accumulate(np.where(first, np.arange(len(split)), 0))
    slots = np.arange(len(split)) - head
    slots[-1] = 0
    return slots


class GroupOracle:
    """The oracles of one grouping (``rows``: ``group_rows``' ``(perm,
    starts, keys)``) over ``m_arguments``; the arguments in group order,
    the covariance sums and the sketch's hashes are made once and kept
    (``hashes``: shared by every grouping)."""

    def __init__(self, grouping: str, rows, args, dicts, split_rows: int,
                 hashes: dict):
        self.grouping = grouping
        self.perm, self.starts, self.keys = rows
        #: the rows are already in group order: no gathers
        self.identity = bool((np.diff(self.perm) == 1).all())
        self.args = args
        self.split_rows = split_rows
        self.hashes = hashes
        self.sizes = np.diff(np.r_[self.starts, len(self.perm)])
        self._sorted: Dict[str, np.ndarray] = {}
        self._covar = None
        self._gids = None
        ng = len(self.starts)
        if grouping == "q1_keys":
            rf = self.keys["l_returnflag"].astype(np.int64)
            self.slots = rf + (len(dicts["l_returnflag"]) + 1) \
                * self.keys["l_linestatus"]
        elif grouping == "orderkey":
            self.slots = streaming_slots(self.starts, split_rows)
        else:
            self.slots = np.arange(ng)

    def prepare(self) -> None:
        """Fill every cache the families read (the arguments in group
        order, the covariance sums, each row's group), so that families
        computed side by side in threads share them."""
        for a in self.args:
            self.sorted(a)
        self.covar_sums()
        self.gids()

    def sorted(self, a: str) -> np.ndarray:
        """Argument ``a`` in group order."""
        if a not in self._sorted:
            v = self.args[a]
            self._sorted[a] = v if self.identity else v[self.perm]
        return self._sorted[a]

    def covar_sums(self):
        if self._covar is None:
            y, x = self.sorted("price"), self.sorted("qty")
            red = np.add.reduceat
            self._covar = (self.sizes, red(x, self.starts),
                           red(y, self.starts), red(x * x, self.starts),
                           red(y * y, self.starts), red(x * y, self.starts))
        return self._covar

    def gids(self) -> np.ndarray:
        """Each row's group index, rows in group order."""
        if self._gids is None:
            self._gids = np.repeat(np.arange(len(self.starts)), self.sizes)
        return self._gids

    def bucket_rank(self, a: str):
        if a not in self.hashes:
            self.hashes[a] = hll_bucket_rank(self.args[a])
        b, r = self.hashes[a]
        return (b, r) if self.identity else (b[self.perm], r[self.perm])

    def family(self, family: str, two_step: bool = False):
        """``{name: (values, mask, err)}`` for ``check_aggregates``, the
        group keys first."""
        g = self.grouping
        perm, starts, sizes = self.perm, self.starts, self.sizes
        ng = len(starts)
        out = {k: (v, None, None) for k, v in self.keys.items()}
        slots = np.zeros(ng, np.int64) if (
            two_step and g == "orderkey") else self.slots
        for name, fn, a in family_aggs(g, family, two_step):
            if fn in ("min_by", "max_by"):
                out[name] = (_elect(
                    self.args[a[0]], self.sorted(a[1]), perm, starts, sizes,
                    fn == "min_by",
                    self.split_rows if g == "q1_keys" else None), None, None)
            elif fn in ("covar_samp", "covar_pop", "corr", "regr_slope",
                        "regr_intercept"):
                out[name] = _covar(self.covar_sums(), fn)
            elif fn.startswith("bitwise_"):
                red = {"bitwise_and_agg": np.bitwise_and,
                       "bitwise_or_agg": np.bitwise_or,
                       "bitwise_xor_agg": np.bitwise_xor}[fn]
                out[name] = (red.reduceat(self.sorted(a[0]).astype(
                    np.int64, copy=False), starts), None, None)
            elif fn == "approx_distinct":
                bucket, rank = self.bucket_rank(a[0])
                regs = np.zeros(ng * _HLL_M, np.int32)
                np.maximum.at(regs, self.gids() * _HLL_M + bucket, rank)
                out[name] = (_hll_extract(regs.reshape(ng, _HLL_M), sizes),
                             None, None)
            elif fn == "product":
                with np.errstate(over="ignore"):    # inf, as the port
                    v = np.multiply.reduceat(self.sorted(a[0]), starts)
                out[name] = (v, None, np.where(np.isfinite(v),
                                               1e-12 * np.abs(v), 0.0))
            elif fn == "entropy":
                c = self.sorted(a[0]).astype(np.float64, copy=False)
                s = np.add.reduceat(c, starts)
                cl = np.where(c > 0, c * np.log2(np.maximum(c, 1e-30)), 0.0)
                slog = np.add.reduceat(cl, starts)
                lg = np.log2(np.maximum(s, 1e-30))
                h = lg - slog / np.maximum(s, 1e-300)
                err = (8 * sizes * EPS * np.add.reduceat(np.abs(cl), starts)
                       / np.maximum(s, 1e-300) + 4 * EPS * np.abs(lg))
                out[name] = (np.where(s > 0, h, 0.0), None, err)
            else:
                out[name] = self._noisy(fn[len("noisy_"):-len("_gaussian")],
                                        a, slots)
        return out

    def _noisy(self, kind: str, a, slots):
        """The exact sum (or count) plus scale * z at each group's slot;
        1e-6 x scale (and 1e-9 of the sum), a count +-1 where the
        oracle's value lies within 1e-5 of a .5 boundary."""
        starts, sizes = self.starts, self.sizes
        scale, seed = float(a[1]), int(a[2]) if len(a) > 2 else 0
        if kind == "count":
            s = sizes.astype(np.float64)
        elif kind == "count_if":
            s = np.add.reduceat(self.sorted(a[0]).astype(
                np.int64, copy=False), starts).astype(np.float64)
        else:
            s = np.add.reduceat(self.sorted(a[0]).astype(
                np.float64, copy=False), starts)
        z = group_gaussian(np.int64(seed), int(slots.max()) + 1)[slots]
        if kind in ("count", "count_if"):
            # NULL where no row counted (count_if's rows are its true ones)
            v = s + scale * z
            near = np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-5
            return (np.maximum(np.round(v), 0.0).astype(np.int64), s > 0,
                    near.astype(np.float64))
        if kind == "avg":
            s = s / np.maximum(sizes, 1)
        return s + scale * z, None, 1e-6 * scale + 1e-9 * np.abs(s)


def keyless_rows(n: int):
    """``(perm, starts, keys)`` of the keyless grouping: one group."""
    return np.arange(n), np.zeros(1, np.int64), {}


def m_rows(li, grouping: str, cache: dict):
    """``group_rows`` of a grouping, made once per ``cache``."""
    if grouping not in cache:
        cache[grouping] = (keyless_rows(len(li["l_orderkey"]))
                           if grouping == "keyless"
                           else group_rows(li, grouping))
    return cache[grouping]
