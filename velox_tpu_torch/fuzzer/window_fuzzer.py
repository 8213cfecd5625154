"""Window fuzzer: random functions x random frames vs an exact row-by-row
Python oracle (the port of ``velox_tpu/fuzzer/window_fuzzer.py``;
velox/exec/fuzzer/WindowFuzzer.cpp analog: there the oracle is
DuckDB/Presto, here frames are small enough to evaluate literally).

For a seed the tables, functions and frames are the JAX package's; the
reference's pandas sort and groupby are a plain sort by ``(p, o, rid)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from velox_tpu_torch import resolve_device
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.types import BIGINT, DOUBLE
from velox_tpu_torch.vector.batch import Batch

_FNS = ["row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
        "sum", "count", "avg", "min", "max", "first_value", "last_value",
        "lead", "lag"]
_FRAME_FNS = {"sum", "count", "avg", "min", "max", "first_value",
              "last_value"}
_RANKS = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist")
_TYPES = {"p": BIGINT, "o": BIGINT, "v": DOUBLE, "rid": BIGINT}


def _frame_text(rng):
    kind = str(rng.choice(["rows", "range"]))
    lo = rng.choice(["unbounded preceding", "current row", "k preceding"])
    hi = rng.choice(["unbounded following", "current row", "k following"])
    klo = int(rng.integers(0, 5))
    khi = int(rng.integers(0, 5))
    lo_t = str(lo).replace("k ", f"{klo} ")
    hi_t = str(hi).replace("k ", f"{khi} ")
    lo_v = None if "unbounded" in lo_t else (
        0 if "current" in lo_t else klo)
    hi_v = None if "unbounded" in hi_t else (
        0 if "current" in hi_t else khi)
    return (f" {kind.upper()} BETWEEN {lo_t} AND {hi_t}",
            kind, lo_v, hi_v)


def _oracle_frame(rows, i, kind, lo, hi, order_vals):
    """Index list of row i's frame inside its partition slice."""
    n = len(rows)
    if kind == "rows":
        s = 0 if lo is None else max(0, i - lo)
        e = n if hi is None else min(n, i + hi + 1)
        return rows[s:e] if e > s else []
    v = order_vals[i]
    out = []
    for j, ov in enumerate(order_vals):
        if lo is not None and ov < v - lo:
            continue
        if hi is not None and ov > v + hi:
            continue
        out.append(rows[j])
    return out


class Case:
    """One iteration's table (column -> list), window call and frame."""

    def __init__(self, data, fn, framed, kind, lo, hi, expr):
        self.data, self.fn, self.framed = data, fn, framed
        self.kind, self.lo, self.hi, self.expr = kind, lo, hi, expr

    def plan(self, device) -> PlanBuilder:
        return (PlanBuilder()
                .values([Batch.from_pydict(self.data, _TYPES,
                                           device=device)])
                .window(["p"], ["o", "rid"], [self.expr])
                .order_by(["rid"]))


def draw_case(rng: np.random.Generator) -> Case:
    """One iteration, drawn from ``rng`` in the reference fuzzer's
    order."""
    n = int(rng.integers(8, 120))
    data = {
        "p": [int(v) for v in rng.integers(0, 4, n)],
        "o": [int(v) for v in rng.integers(0, 30, n)],
        "v": [float(np.round(v, 3)) for v in rng.normal(size=n)],
        "rid": list(range(n)),
    }
    fn = str(rng.choice(_FNS))
    framed = fn in _FRAME_FNS and bool(rng.random() < 0.6)
    frame_txt, kind, lo, hi = (
        _frame_text(rng) if framed else ("", None, None, None))
    if fn in _RANKS:
        call = f"{fn}()"
    elif fn in ("lead", "lag"):
        call = f"{fn}(v, 1)"
    else:
        call = f"{fn}(v)"
    return Case(data, fn, framed, kind, lo, hi, f"{call}{frame_txt} as w")


def oracle(case: Case) -> Dict[int, Optional[float]]:
    """rid -> the window value, by the literal row-by-row definitions."""
    d, fn = case.data, case.fn
    order = sorted(range(len(d["rid"])),
                   key=lambda r: (d["p"][r], d["o"][r], d["rid"][r]))
    parts: Dict[int, List[int]] = {}
    for r in order:
        parts.setdefault(d["p"][r], []).append(r)
    exp: Dict[int, Optional[float]] = {}
    for p in sorted(parts):
        vals = [d["v"][r] for r in parts[p]]
        os_ = [d["o"][r] for r in parts[p]]
        rids = [d["rid"][r] for r in parts[p]]
        keys = list(zip(os_, rids))
        for j, rid in enumerate(rids):
            if fn == "row_number":
                exp[rid] = j + 1
                continue
            if fn in _RANKS:
                key = keys[j]
                lesser = sum(1 for kk in keys if kk < key)
                if fn == "rank":
                    exp[rid] = lesser + 1
                elif fn == "dense_rank":
                    exp[rid] = len({kk for kk in keys if kk < key}) + 1
                elif fn == "percent_rank":
                    exp[rid] = (lesser / (len(keys) - 1)
                                if len(keys) > 1 else 0.0)
                else:
                    exp[rid] = (sum(1 for kk in keys if kk <= key)
                                / len(keys))
                continue
            if fn == "lead":
                exp[rid] = vals[j + 1] if j + 1 < len(vals) else None
                continue
            if fn == "lag":
                exp[rid] = vals[j - 1] if j >= 1 else None
                continue
            if case.framed:
                fr = _oracle_frame(vals, j, case.kind, case.lo, case.hi,
                                   os_)
            else:
                # default frame: partition start .. current peers (rid
                # is unique, so each row is its own peer group)
                fr = vals[: j + 1]
            if fn == "count":
                exp[rid] = len(fr)
            elif not fr:
                exp[rid] = None
            elif fn == "sum":
                exp[rid] = sum(fr)
            elif fn == "avg":
                exp[rid] = sum(fr) / len(fr)
            elif fn == "min":
                exp[rid] = min(fr)
            elif fn == "max":
                exp[rid] = max(fr)
            elif fn == "first_value":
                exp[rid] = fr[0]
            elif fn == "last_value":
                exp[rid] = fr[-1]
    return exp


def check(i: int, case: Case, got: list, exp: Dict[int, object]) -> None:
    """The reference's checks, as they are: an empty frame's NULL may
    come out as NULL or 0."""
    for rid in range(len(case.data["rid"])):
        g, e = got[rid], exp[rid]
        if e is None:
            assert g is None or g == 0, (i, case.expr, rid, g, e)
        else:
            assert g is not None and abs(g - e) < 1e-9 + 1e-9 * abs(
                e), (i, case.expr, rid, g, e)


def run_window_fuzz(iterations: int = 40, seed: int = 0,
                    verbose: bool = False, device=None) -> None:
    """``iterations`` random window plans on ``device`` (default: the
    card) against the oracle."""
    from velox_tpu_torch.exec import run_plan

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    for i in range(iterations):
        case = draw_case(rng)
        got = run_plan(case.plan(device).build())["w"]
        check(i, case, got, oracle(case))
        if verbose:
            print(f"iter {i}: {case.expr} ok")
