#!/usr/bin/env python3
"""Drive velox_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):

1. print the card's name and power limit; build every CUDA kernel of the
   package from its sources;
2. hold each kernel against its plain torch version on the card, exactly,
   under uniform gids and all rows in one group, at G in {2, 12, 13, 128},
   L in {1, 17, 18}, a ragged n, tensors off a 16-byte boundary, and the
   extremes of its domain;
3. register TPC-H lineitem at SF10 on the card (8 splits of 2^23 rows) in
   both money schemas, hold the kernels against their plain versions on
   Q1's gids of split 0, and run, with ``narrow_lanes`` on, Q1 and Q6 over
   decimal cents and Q1 over DOUBLE money through ``run_plan``; compare
   each result with a numpy oracle computed on the host from the same
   arrays (decimal results exactly in int64, DOUBLE ones to rtol=1e-9) and
   check that the kernels' launch counters rose once per split;
4. generate the eight TPC-H tables at SF10 and register them
   and run Q3 and Q18 through ``run_plan`` with ``optimize_plans`` on
   (merge joins, streaming aggregation) and off (hash joins, generic
   aggregation) over decimal cents, with it on once more without kArray
   join tables (``karray_join_span = 0``: the binary-search and flipped
   merge probes run), then (after phase 5) with it on over DOUBLE money
   (lineitem, orders and customer registered again, Q3 and Q18's columns
   only); compare each with a numpy oracle (exact in int64 cents, row
   order included; DOUBLE to rtol=1e-9) and print each run's host syncs,
   kernel launches and join probe forms; time the merge probe's two rank
   forms (``torch.searchsorted``, ``_rank_in_sorted``) at Q3's shape;
5. over the same eight tables (cents, narrow lanes, ``optimize_plans``
   on) run the other 18 queries through ``run_plan``: each checked
   against its numpy oracle (``velox_tpu_torch/tpch/oracle.py``, computed
   on the host from the generated arrays: decimals, integers, dates and
   strings exactly, row order included, DOUBLE to rtol=1e-9) in a run
   whose host syncs and B1/B2 launches are counted, then timed (median
   of 5 warm runs) and profiled once (device busy share); B2 must launch
   in at least one of them; then phases 9 and 10 run over the same tables;
6. time each kernel at Q1's shape on Q1's gids of split 0 and at G = 128
   on uniform gids: ``ms`` is a call from Python between CUDA events,
   ``device_ms`` the device time of a call from CUDA graph replay (no
   host cost), beside its plain version, one ``index_add_`` over the
   same bins, and its bound (bytes moved / 3.35 TB/s); print the query
   times;
7. with the TPC-H tables dropped, generate the eight TPC-DS tables at
   SF10 (``velox_tpu_torch.io.tpcds``, seed 7; store_sales 28.8M rows)
   and register them on the card in splits of 2^23 rows; run the 15
   ``SPEC_QUERIES`` (``optimize_plans`` on), each checked against its
   numpy oracle (``velox_tpu_torch/tpcds/oracle.py``) with its host
   syncs, B1/B2 launches and peak device memory counted, then timed and
   profiled as in phase 5;
8. over that store_sales, the window plans W1-W3
   (``velox_tpu_torch/tpcds/window_plans.py``: the blocking window with
   every function and frame, the streaming window, which the optimizer
   must choose, TopNRowNumber, RowNumber, MarkDistinct, GroupId and
   UnionAll), each result's arrays checked against a numpy oracle, then
   timed, profiled and measured as the queries are; print the kernels
   as one JSON line (with each kernel's launches in every checked run of
   every phase), the card line, and last the device line
   ``{"ok": true, "device": {...}}``. Each phase logs its seconds.
9. (run right after phase 5, while the TPC-H tables are on the card)
   the scalar functions (``velox_tpu_torch/tpch/scalar_plans.py``): the
   date, timestamp, math, bitwise and hash, NULL-function and ``rand``
   families projected over lineitem's 60M rows and the probability
   family over part's 2M, each result array checked element by element
   against its oracle computed on the host (numpy; scipy for
   probability), timed and profiled as the queries are; a seeded
   2^24-row ``datetime64[us]`` table registered and read back as a
   TIMESTAMP through the same functions; and one aggregation of
   integer results of new functions grouped by Q1's kArray keys through
   ``run_plan``, exact against its oracle, which must launch B2 once per
   split.
10. (right after phase 9, on the same tables) the string functions
   (``velox_tpu_torch/tpch/string_plans.py``): the bind-time dictionary
   transforms, string casts, value functions (regex, JSON, URL, hashes,
   codecs), date formats over lineitem's short dictionaries and
   ``l_shipdate`` (60M rows), a filter comparing two string columns of
   different dictionaries, customer's phone, name, address and comment
   columns (up to 1.5M distinct values; the casts must give
   ``c_nationkey + 10`` and ``c_custkey``), part's ``p_type`` (2M rows)
   and orders' ``o_comment`` (about 14M distinct values); each family's
   host bind timed alone, every result array checked against its oracle
   computed on the host from the generated strings, then timed and
   profiled as the queries are; and an aggregation grouped by
   ``lower(l_returnflag)`` and ``concat(l_linestatus, '-')`` through
   ``run_plan``, exact against its oracle, which must launch B2 once per
   split.
11. (right after phase 10, on the same tables) the rest of the join
   family and the single-argument aggregates
   (``velox_tpu_torch/tpch/join_agg_plans.py``): full, right and
   right-semi joins, each with and without a filter that reads a column
   of each side and with ``optimize_plans`` on (merge probes) and off
   (hash probes), every result exact against its oracle, each family
   shown to hold every kind of row it claims (probe-only, build-only,
   resurrected, filtered-out), the probe forms and what each probe
   pushed into its scan recorded (the full join pushes nothing); TPC-H
   Q13 with its predicate in the left join's filter, equal to Q13's
   oracle, its filter's first bind timed alone; and the 14 new
   aggregates over lineitem grouped by Q1's keys (kArray), by
   ``l_suppkey`` (generic) and by ``l_orderkey`` (streaming), each
   value against numpy (the variance family and the moments through the
   extract formulas, held in turn against numpy's ``var``/``std`` and
   scipy's ``skew``/``kurtosis``; ``checksum`` exactly against a numpy
   splitmix64 written here), each plan timed and profiled as the queries
   are.

It needs a CUDA card and the repository beside it; without either it
exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SF = 10
SEED = 20240601
SPLIT_ROWS = 1 << 23
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
RTOL = 1e-9
SHIP_Q1 = 10471                    # DATE '1998-12-01' - 90 days
Q6_LO, Q6_HI = 8766, 9131          # 1994-01-01, 1995-01-01
Q3_DATE = 9204                     # DATE '1995-03-15'
Q18_MIN_QTY = 30000                # total_qty > 300.0, in cents
SOURCE = "velox_tpu_torch/csrc/grouped_sum.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


# ------------------------------------------------------------ timing

def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed 3 times between CUDA events (no host overhead)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def device_breakdown(fn, label: str, wall: float, card: str,
                     top: int = 8) -> float:
    """One profiled run of ``fn``: device time by kernel (the ``top``
    largest) and the device busy share of the unprofiled median wall;
    returns the busy ms. Only the device's activity is recorded: the
    kernel rows are all the sum reads, and the host operator events of
    a run of 10^5 launches take minutes to collect. A trace that holds
    no device row at all (the tracer missed the run, as it once did for
    a run of a few dozen kernels) is taken once more."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us / 1e3, e.count, e.key))
        if rows:
            break
        log(f"profile {label}: the trace holds no device time; again")
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile {label}: device busy {busy} ms of {wall} ms wall "
        f"(busy share {busy / wall}) on {card}")
    for ms, count, key in rows[:top]:
        log(f"profile {label}:   {ms} ms  x{count}  {key[:90]}")
    return busy


def wall_ms(fn, reps: int = 5) -> float:
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# --------------------------------------------------------- kernels

def kernel_values(n: int, L: int, seed: int):
    """(L, n) int32 values spanning the domain, distinct in every lane and
    row, every 7th at +-(2^31 - 1)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    top = 2 ** 31 - 1
    vals = torch.randint(-top, top, (L, n), generator=g, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    vals[:, ::7] = top
    vals[:, 3::7] = -top
    return vals.contiguous()


def kernel_gids(mix: str, n: int, G: int, seed: int):
    """``uniform``: gids over [-3, G] (negatives and G are sentinels);
    ``zero``: every row in group 0."""
    import torch

    if mix == "zero":
        return torch.zeros(n, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-3, G + 1, (n,), generator=g, device="cuda",
                         dtype=torch.int32)


def check_one(gs, gids, vals, G: int, what: str) -> None:
    """B2 on all lanes and B1 on lane 0 equal to their plain versions."""
    import torch

    got = gs.grouped_multi_sum_i32(gids, vals, G)
    torch.cuda.synchronize()
    check(torch.equal(got, gs.grouped_multi_sum_i32_plain(gids, vals, G)),
          f"B2 differs from plain: {what}")
    v0 = vals[0].contiguous()
    got1 = gs.grouped_sum_i32(gids, v0, G)
    torch.cuda.synchronize()
    check(torch.equal(got1, gs.grouped_sum_i32_plain(gids, v0, G)),
          f"B1 differs from plain: {what}")


def check_kernels(gs) -> None:
    """Exact equality under uniform gids (ragged n = 2^23 - 13, which the
    wrapper pads to whole quads of rows) and all rows in group 0
    (n = 2^23), at G in {2, 12, 13, 128} and L in {1, 17, 18}; then
    tensors that start 4 bytes past a 16-byte boundary (padded too); then
    the extremes, every value +(2^31 - 1) or every value -(2^31 - 1) in
    one group over a whole split."""
    import torch

    for mix, n in (("uniform", SPLIT_ROWS - 13), ("zero", SPLIT_ROWS)):
        for G in (2, 12, 13, 128):
            gids = kernel_gids(mix, n, G, G)
            for L in (1, 17, 18):
                vals = kernel_values(n, L, 100 * G + L)
                check_one(gs, gids, vals, G, f"{mix} gids, n={n} L={L} G={G}")
            log(f"kernel check {mix} gids G={G}: B2 (L=1, 17, 18) and B1 "
                f"equal to plain at n={n}")
    n = SPLIT_ROWS
    gids = kernel_gids("uniform", n + 1, 12, 5)[1:]
    vals = kernel_values(17 * n + 1, 1, 5)[0, 1:].view(17, n)
    check_one(gs, gids, vals, 12, "tensors off a 16-byte boundary")
    log(f"kernel check misaligned: gids and lanes 4 bytes past a 16-byte "
        f"boundary, n={n} L=17 and L=1, G=12, equal to plain")
    del gids, vals
    gids = kernel_gids("zero", SPLIT_ROWS, 12, 0)
    for v in (2 ** 31 - 1, -(2 ** 31 - 1)):
        vals = torch.full((17, SPLIT_ROWS), v, dtype=torch.int32,
                          device="cuda")
        check_one(gs, gids, vals, 12, f"every value {v} in group 0")
    log(f"kernel check extremes: all +-(2^31 - 1) in one group over "
        f"n={SPLIT_ROWS}, L=17 and L=1, equal to plain")


def q1_split0_gids(cols):
    """Q1's group codes over split 0 of lineitem, as its aggregation makes
    them: rf + 4 ls (radices |dict| + 1), sentinel 12 where the l_shipdate
    filter drops the row."""
    import torch

    ship = cols["l_shipdate"][:SPLIT_ROWS].astype(np.int64)
    gid = cols["l_returnflag"][:SPLIT_ROWS] + 4 * cols["l_linestatus"][
        :SPLIT_ROWS]
    gid = np.where(ship <= SHIP_Q1, gid, 12).astype(np.int32)
    return torch.from_numpy(gid).cuda()


def check_real_gids(gs, gids) -> None:
    for L in (1, 17, 18):
        vals = kernel_values(gids.shape[0], L, 7 + L)
        check_one(gs, gids, vals, 12, f"Q1's gids L={L}")
    log(f"kernel check Q1's gids (split 0, G=12): B2 (L=1, 17, 18) and B1 "
        f"equal to plain at n={gids.shape[0]}")


def time_kernel(gs, name: str, gids, L: int, G: int) -> dict:
    import torch

    n = gids.shape[0]
    vals = kernel_values(n, L, 7)
    if L == 1:
        v1 = vals[0].contiguous()
        kern = lambda: gs.grouped_sum_i32(gids, v1, G)          # noqa: E731
        plain = lambda: gs.grouped_sum_i32_plain(gids, v1, G)   # noqa: E731
    else:
        kern = lambda: gs.grouped_multi_sum_i32(gids, vals, G)  # noqa: E731
        plain = lambda: gs.grouped_multi_sum_i32_plain(       # noqa: E731
            gids, vals, G)
    err = (kern() - plain()).abs().max().item()
    # yardstick: one index_add_ in int64 over the same G + 1 bins
    g64 = torch.where((gids >= 0) & (gids < G), gids,
                      torch.full_like(gids, G)).long()
    v64 = vals.long()
    out = torch.zeros((L, G + 1), dtype=torch.int64, device="cuda")
    lib = lambda: out.index_add_(1, g64, v64)                   # noqa: E731
    ms = cuda_ms(kern)
    device_ms = graph_ms(kern)
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(lib)
    # bytes: gids and each lane read once, the (L, G) int64 sums written
    # once. The function's own work is one integer add per 4-byte value
    # read, and 4 bytes at 3.35 TB/s take longer than one add at the CUDA
    # cores' 67 Tops/s, so the bytes bound it. (The kernel's int8 one-hot
    # products are further below the bytes: 2.4 M mma.m16n8k32 per 2^23
    # rows at Q1's shape, 0.02 ms at 1979 Tops/s.)
    bytes_moved = 4 * n + 4 * L * n + 8 * L * G
    return {"name": name, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "max_abs_err": err,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "shape": {"n": n, "L": L, "G": G}}


# ---------------------------------------------------------- oracles

def _round_avg(s: int, c: int) -> int:
    q = (abs(s) + c // 2) // c
    return q if s >= 0 else -q


def q1_oracle(cols, dicts):
    """Per (returnflag, linestatus) group, in code order (the sorted
    dictionaries make it the ORDER BY order): exact int64 sums of cents."""
    ship = cols["l_shipdate"].astype(np.int64)
    live = ship <= SHIP_Q1
    rf = cols["l_returnflag"][live]
    ls = cols["l_linestatus"][live]
    q = cols["l_quantity"][live]
    p = cols["l_extendedprice"][live]
    d = cols["l_discount"][live]
    t = cols["l_tax"][live]
    dp = p * (100 - d)
    ch = dp * (100 + t)
    gid = rf * len(dicts["l_linestatus"]) + ls
    rows = []
    for r in range(len(dicts["l_returnflag"])):
        for s in range(len(dicts["l_linestatus"])):
            m = gid == r * len(dicts["l_linestatus"]) + s
            c = int(m.sum())
            if c == 0:
                continue
            rows.append({
                "l_returnflag": dicts["l_returnflag"][r],
                "l_linestatus": dicts["l_linestatus"][s],
                "sum_qty": int(q[m].sum()), "sum_base_price": int(p[m].sum()),
                "sum_disc_price": int(dp[m].sum()),
                "sum_charge": int(ch[m].sum()), "sum_disc": int(d[m].sum()),
                "qf": q[m] / 100.0, "pf": p[m] / 100.0, "df": d[m] / 100.0,
                "tf": t[m] / 100.0, "count_order": c,
            })
    return rows


def check_q1_cents(got, rows) -> None:
    check(len(got["count_order"]) == len(rows), "Q1 row count")
    scale = {"sum_qty": 2, "sum_base_price": 2, "sum_disc_price": 4,
             "sum_charge": 6}
    for i, row in enumerate(rows):
        for k in ("l_returnflag", "l_linestatus", "count_order"):
            check(got[k][i] == row[k], f"Q1 {k} row {i}")
        for k, s in scale.items():
            check(int(got[k][i].scaleb(s)) == row[k], f"Q1 {k} row {i}")
        c = row["count_order"]
        for k, src in (("avg_qty", "sum_qty"),
                       ("avg_price", "sum_base_price"),
                       ("avg_disc", "sum_disc")):
            check(int(got[k][i].scaleb(2)) == _round_avg(row[src], c),
                  f"Q1 {k} row {i}")


def check_q1_double(got, rows) -> None:
    check(len(got["count_order"]) == len(rows), "Q1 DOUBLE row count")
    for i, row in enumerate(rows):
        for k in ("l_returnflag", "l_linestatus", "count_order"):
            check(got[k][i] == row[k], f"Q1 DOUBLE {k} row {i}")
        qf, pf, df, tf = row["qf"], row["pf"], row["df"], row["tf"]
        dpf = pf * (1.0 - df)
        want = {"sum_qty": qf.sum(), "sum_base_price": pf.sum(),
                "sum_disc_price": dpf.sum(),
                "sum_charge": (dpf * (1.0 + tf)).sum(),
                "avg_qty": qf.mean(), "avg_price": pf.mean(),
                "avg_disc": df.mean()}
        for k, v in want.items():
            ok = abs(got[k][i] - v) <= RTOL * abs(v)
            check(ok, f"Q1 DOUBLE {k} row {i}: {got[k][i]} vs {v}")


def q6_oracle(cols) -> int:
    ship = cols["l_shipdate"].astype(np.int64)
    d = cols["l_discount"]
    m = ((ship >= Q6_LO) & (ship < Q6_HI) & (d >= 5) & (d <= 7)
         & (cols["l_quantity"] < 2400))
    return int((cols["l_extendedprice"][m] * d[m]).sum())


def _order_runs(tables):
    """Lineitem row index of each order's first line. The generator makes
    o_orderkey 1..N and customer keys 1..M, and lineitem ascends on
    l_orderkey with at least one line an order, so a key is its row + 1
    and per-order sums are ``np.add.reduceat`` over these starts."""
    okey = tables["orders"]["o_orderkey"]
    lkey = tables["lineitem"]["l_orderkey"]
    check(np.array_equal(okey, np.arange(1, len(okey) + 1)),
          "o_orderkey is not 1..N")
    check(np.array_equal(tables["customer"]["c_custkey"], np.arange(
        1, len(tables["customer"]["c_custkey"]) + 1)), "c_custkey not 1..M")
    starts = np.flatnonzero(np.diff(lkey, prepend=0))
    check(len(starts) == len(okey) and np.all(np.diff(lkey) >= 0),
          "lineitem does not ascend on l_orderkey with every order present")
    return starts


def q3_oracle(tables, dicts, starts):
    """Q3's 10 rows: exact revenue in scale-4 cents per order with a line
    shipped after the date, from a BUILDING customer's order placed before
    it; revenue DESC, o_orderdate, then o_orderkey (the order both plans
    feed their stable top-N in)."""
    li, o, c = tables["lineitem"], tables["orders"], tables["customer"]
    building = dicts["c_mktsegment"].index("BUILDING")
    odate = o["o_orderdate"].astype(np.int64)
    order_ok = (odate < Q3_DATE) & (
        c["c_mktsegment"][o["o_custkey"] - 1] == building)
    line_ok = ((li["l_shipdate"].astype(np.int64) > Q3_DATE)
               & order_ok[li["l_orderkey"] - 1])
    rev = np.where(line_ok, li["l_extendedprice"]
                   * (100 - li["l_discount"]), 0)
    rev = np.add.reduceat(rev, starts)
    live = np.flatnonzero(np.add.reduceat(line_ok.astype(np.int64),
                                          starts) > 0)
    top = live[np.lexsort((live, odate[live], -rev[live]))[:10]]
    return [{"l_orderkey": int(i + 1), "revenue": int(rev[i]),
             "o_orderdate": int(odate[i]), "o_shippriority":
             int(o["o_shippriority"][i])} for i in top]


def q18_oracle(tables, dicts, starts, by_customer: bool):
    """Q18's rows: orders whose lines' quantity sums past 300 (30000
    cents), o_totalprice DESC, o_orderdate, then the order the top-N sees
    ties in: order key (streaming plan) or customer name and order key
    (the generic aggregation's key order)."""
    li, o = tables["lineitem"], tables["orders"]
    qty = np.add.reduceat(li["l_quantity"], starts)
    big = np.flatnonzero(qty > Q18_MIN_QTY)
    ck = o["o_custkey"][big]
    tp = o["o_totalprice"][big]
    odate = o["o_orderdate"][big].astype(np.int64)
    ties = (big, ck) if by_customer else (big,)
    top = np.lexsort(ties + (odate, -tp))[:100]
    return [{"c_name": dicts["c_name"][ck[i] - 1], "c_custkey": int(ck[i]),
             "o_orderkey": int(big[i] + 1), "o_orderdate": int(odate[i]),
             "o_totalprice": int(tp[i]), "sum_qty": int(qty[big[i]])}
            for i in top]


def check_rows(got, rows, scales, money: str, what: str) -> None:
    """``got`` (run_plan's dict of lists) equal to the oracle ``rows``,
    row for row: ``scales`` names the money columns and their cents
    scale, compared exactly as decimals or to RTOL as DOUBLE; dates are
    days since 1970-01-01."""
    names = list(rows[0]) if rows else list(got)
    check(list(got) == names, f"{what}: columns {list(got)}")
    n = len(got[names[0]])
    check(n == len(rows), f"{what}: {n} rows, want {len(rows)}")
    epoch = datetime.date(1970, 1, 1)
    for i, row in enumerate(rows):
        for k, want in row.items():
            v = got[k][i]
            if k in scales and money == "double":
                w = want / 10 ** scales[k]
                ok = abs(v - w) <= RTOL * abs(w)
            elif k in scales:
                ok = int(v.scaleb(scales[k])) == want
            elif k == "o_orderdate":
                ok = (v - epoch).days == want
            else:
                ok = v == want
            check(ok, f"{what} {k} row {i}: {v!r}, want {want!r}")


Q3_SCALES = {"revenue": 4}
Q18_SCALES = {"o_totalprice": 2, "sum_qty": 2}


@contextlib.contextmanager
def probe_forms():
    """Count, over the runs inside, the join probe forms the operators
    call: the kArray table, the binary search, the flipped merge probe on
    a raw ascending lane and on a repaired one."""
    from velox_tpu_torch.exec import operators as ops

    names = {"table": "probe_join_table", "search": "probe_join_index",
             "merge": "probe_join_index_merge",
             "repair": "probe_join_index_merge_repair"}
    counts = dict.fromkeys(names, 0)
    saved = {k: getattr(ops, n) for k, n in names.items()}

    def counting(k):
        def call(*args, **kwargs):
            counts[k] += 1
            return saved[k](*args, **kwargs)
        return call

    for k, n in names.items():
        setattr(ops, n, counting(k))
    try:
        yield counts
    finally:
        for k, n in names.items():
            setattr(ops, n, saved[k])


def time_rank_forms(tables, card: str) -> dict:
    """The flipped merge probe ranks every build key into an ascending
    probe lane, left and right. Time its two forms at the merge join's
    shape: split 0's l_orderkey (2^23 rows, int32 as the key codec
    narrows it) against every 10th order key (1.5M, the size of Q3's
    orders build) and against all 15M. ``searchsorted`` is
    ``torch.searchsorted``; ``sort`` is ``_rank_in_sorted``, one stable
    sort of the concatenation with packed int32 keys. Both must give
    the same ranks."""
    import torch

    from velox_tpu_torch.ops.join import _rank_in_sorted

    pk = torch.from_numpy(tables["lineitem"]["l_orderkey"][:SPLIT_ROWS]
                          .astype(np.int32)).cuda()
    okey = tables["orders"]["o_orderkey"]
    key_range = (int(okey[0]), int(okey[-1]))
    out = {}
    for label, keys in (("1.5M", okey[::10]), ("15M", okey)):
        bk = torch.from_numpy(keys.astype(np.int32)).cuda()

        def search():
            return [torch.searchsorted(pk, bk, side=s)
                    for s in ("left", "right")]

        def sort():
            return [_rank_in_sorted(pk, bk, s, key_range)
                    for s in ("left", "right")]

        check(all(torch.equal(a, b) for a, b in zip(search(), sort())),
              f"rank forms differ at {label} build keys")
        out[label] = {"searchsorted_ms": cuda_ms(search),
                      "sort_ms": cuda_ms(sort)}
        log(f"rank forms, probe 2^23 x build {label} (left and right): "
            f"searchsorted {out[label]['searchsorted_ms']} ms, sort "
            f"{out[label]['sort_ms']} ms a call on {card}")
    return out


def run_join_queries(card: str, times: dict) -> dict:
    """Phases 4 and 5: Q3 and Q18 over the eight tables at SF10 against
    their oracles, both plan shapes and both money schemas, and the merge
    plans once more without kArray join tables (so the binary search and
    the flipped merge probe run); time them and profile them, and time
    the merge probe's two rank forms; between the cents and the DOUBLE
    runs, phase 5 (``run_more_queries``). Returns each run's host syncs,
    B1/B2 launches and probe forms, the rank forms' times and phase 5's
    counts and times."""
    import torch

    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.io.catalog import (
        drop_table, get_table, register_columns,
    )
    from velox_tpu_torch.io.tpch import (
        as_money_schema, table_dictionaries, tpch_columns,
    )
    from velox_tpu_torch.ops import grouped_sum as gs
    from velox_tpu_torch.tpch import tpch_plan
    from velox_tpu_torch.utils import syncs
    from velox_tpu_torch.utils.config import config

    counts = {}

    def run_checked(q: int, money: str, label: str, rows):
        syncs.reset()
        gs.reset_launches()
        with probe_forms() as forms:
            got = run_plan(tpch_plan(q))
            torch.cuda.synchronize()
        counts[label] = {"syncs": syncs.count, **gs.launches,
                         "probes": forms}
        check_rows(got, rows, Q3_SCALES if q == 3 else Q18_SCALES, money,
                   label)
        log(f"{label}: {len(rows)} rows equal to the oracle; host syncs "
            f"{syncs.count}, launches {dict(gs.launches)}, probe forms "
            f"{forms}")
        return forms

    # register_tpch_tables, step by step, to time each table's ingest
    # (the sorted string dictionaries are made there)
    t0 = time.perf_counter()
    tables, dicts = tpch_columns(SF, SEED)
    log(f"generated the eight TPC-H tables SF{SF}: "
        f"{(time.perf_counter() - t0):.3f} s")
    for name, columns in tables.items():
        t0 = time.perf_counter()
        cols, overrides = as_money_schema(columns, "cents")
        register_columns(name, cols, table_dictionaries(columns, dicts),
                         SPLIT_ROWS, overrides, "cuda")
        strings = {c: len(get_table(name).batches[0].columns[c].dictionary)
                   for c in cols if c in dicts}
        log(f"registered {name} (cents): "
            f"{sum(b.num_rows for b in get_table(name).batches)} rows, "
            f"{(time.perf_counter() - t0):.3f} s; distinct strings "
            f"{strings}")
    starts = _order_runs(tables)
    q3_rows = q3_oracle(tables, dicts, starts)
    q18_rows = {by: q18_oracle(tables, dicts, starts, by)
                for by in (False, True)}
    check(len(q3_rows) == 10 and len(q18_rows[False]) > 0,
          f"oracle sizes {len(q3_rows)}, {len(q18_rows[False])}")

    for optimize in (True, False):
        config.optimize_plans = optimize
        plan = "merge+streaming" if optimize else "hash+generic"
        run_checked(3, "cents", f"Q3 cents {plan}", q3_rows)
        run_checked(18, "cents", f"Q18 cents {plan}",
                    q18_rows[not optimize])
    config.optimize_plans = True
    span = config.karray_join_span
    config.karray_join_span = 0
    try:
        f3 = run_checked(3, "cents", "Q3 cents merge+streaming, no kArray",
                         q3_rows)
        f18 = run_checked(18, "cents", "Q18 cents merge+streaming, no kArray",
                          q18_rows[False])
    finally:
        config.karray_join_span = span
    check(f3["table"] + f18["table"] == 0 and f3["search"] > 0
          and f3["merge"] + f18["merge"] > 0,
          f"no-kArray probe forms: Q3 {f3}, Q18 {f18}")
    rank_ms = time_rank_forms(tables, card)
    for q in (3, 18):
        times[f"q{q}_cents"] = wall_ms(lambda: run_plan(tpch_plan(q)))
        device_breakdown(lambda: run_plan(tpch_plan(q)), f"q{q}_cents",
                         times[f"q{q}_cents"], card)

    more = run_more_queries(tables, dicts, card, times)
    t0 = time.perf_counter()
    scalar = run_scalar_families(tables, dicts, card, times)
    log(f"phase 9 (scalar functions): {(time.perf_counter() - t0):.3f} s")
    t0 = time.perf_counter()
    strings = run_string_families(tables, dicts, card, times)
    log(f"phase 10 (string functions): {(time.perf_counter() - t0):.3f} s")
    t0 = time.perf_counter()
    join_agg = run_join_agg(tables, dicts, card, times)
    log(f"phase 11 (joins and aggregates): "
        f"{(time.perf_counter() - t0):.3f} s")

    for t in tables:
        drop_table(t)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name in ("lineitem", "orders", "customer"):
        cols, _ = as_money_schema(
            {c: v for c, v in tables[name].items() if c in Q3_Q18_COLUMNS},
            "double")
        register_columns(name, cols, table_dictionaries(cols, dicts),
                         SPLIT_ROWS, None, "cuda")
    log(f"registered lineitem, orders, customer SF{SF} (double, Q3 and "
        f"Q18's columns): {(time.perf_counter() - t0):.3f} s")
    run_checked(3, "double", "Q3 double merge+streaming", q3_rows)
    run_checked(18, "double", "Q18 double merge+streaming", q18_rows[False])
    for t in ("lineitem", "orders", "customer"):
        drop_table(t)
    torch.cuda.empty_cache()
    return {"runs": counts, "rank_forms_ms": rank_ms, "more": more,
            "scalar": scalar, "strings": strings, "join_agg": join_agg}


#: the columns Q3 and Q18 read (the DOUBLE run registers only these)
Q3_Q18_COLUMNS = {
    "l_orderkey", "l_extendedprice", "l_discount", "l_shipdate",
    "l_quantity", "o_orderkey", "o_custkey", "o_orderdate",
    "o_shippriority", "o_totalprice", "c_custkey", "c_name",
    "c_mktsegment"}

#: the queries the fifth phase runs
MORE_QUERIES = [2, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 19, 20,
                21, 22]


def check_result(got: dict, want: dict, what: str) -> None:
    """Row for row: DOUBLE values to RTOL, everything else (decimals,
    integers, dates, strings, NULLs) exactly."""
    check(list(got) == list(want), f"{what}: columns {list(got)}")
    for c, wv in want.items():
        gv = got[c]
        check(len(gv) == len(wv), f"{what} {c}: {len(gv)} rows, want "
              f"{len(wv)}")
        for i, (g, w) in enumerate(zip(gv, wv)):
            if isinstance(w, float) and g is not None:
                ok = abs(g - w) <= RTOL * abs(w)
            else:
                ok = g == w
            check(ok, f"{what} {c} row {i}: {g!r}, want {w!r}")


def run_more_queries(tables, dicts, card: str, times: dict) -> dict:
    """Phase 5: the other 18 TPC-H queries at SF10 over the eight tables
    phase 4 registered (cents, narrow lanes, ``optimize_plans`` on). Each
    is checked against its numpy oracle (``velox_tpu_torch/tpch/
    oracle.py``, on the host from the generated arrays) with its host
    syncs and B1/B2 launches counted in that run, then timed (median of
    5 warm runs) and profiled once (device busy share). Returns the
    counts and times per query."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.tpch import tpch_plan
    from velox_tpu_torch.tpch.oracle import answer

    out = {}
    for q in MORE_QUERIES:
        t0 = time.perf_counter()
        want = answer(q, tables, dicts, SF)
        oracle_s = time.perf_counter() - t0
        got, run = _peak_run(lambda: run_plan(tpch_plan(q, SF)))
        check_result(got, want, f"Q{q}")
        wall = wall_ms(lambda: run_plan(tpch_plan(q, SF)))
        busy = device_breakdown(lambda: run_plan(tpch_plan(q, SF)),
                                f"q{q}_cents", wall, card, top=3)
        times[f"q{q}_cents"] = wall
        out[f"Q{q}"] = {**run, "wall_ms": wall, "busy_ms": busy,
                        "rows": len(next(iter(want.values())))}
        log(f"Q{q} cents: {out[f'Q{q}']['rows']} rows equal to the oracle "
            f"({oracle_s:.3f} s on the host); host syncs {run['syncs']}, "
            f"launches B1 {run['grouped_sum_i32']} B2 "
            f"{run['grouped_multi_sum_i32']}; warm wall {wall} ms, busy "
            f"{busy} ms (share {busy / wall}), first run "
            f"{run['first_run_ms']} ms; peak device memory "
            f"{run['peak_gb']:.3f} GiB ({run['above_tables_gb']:.3f} above "
            f"the tables) on {card}")
    return out


# ------------------------------------------------- scalar functions

#: the probability family against scipy: the tolerance stated in
#: tests/test_torch_scalar_prob.py (torch's gammaincc is within 4e-10)
PROB_TOL = {"rtol": 1e-9, "atol": 1e-9}
SCALAR_RTOL = 1e-12


def probability_oracle(part) -> dict:
    """``scalar_plans.PROBABILITY`` over ``part`` with scipy, from the
    generated arrays, in the plan's own order of IEEE operations for
    its derived arguments."""
    import scipy.stats as st
    from scipy.special import gammaincc

    key, size = part["p_partkey"], part["p_size"].astype(np.float64)
    pr = ((key % 9973).astype(np.float64) + 0.5) / 9973.0
    x = (key % 2000).astype(np.float64) / 100.0
    xs = x - 10.0
    s = size
    z2 = 1.96 * 1.96
    n = size + 20
    p = size / n
    center = p + z2 / (2.0 * n)
    spread = 1.96 * np.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    out = {
        "normal": st.norm.cdf(s, 25.0, 10.0),
        "cauchy": st.cauchy.cdf(xs, 0, 2),
        "chi2": st.chi2.cdf(x, size), "gamma": st.gamma.cdf(x, size,
                                                           scale=0.5),
        "laplace": st.laplace.cdf(xs, 0, 3),
        # Q(floor(k) + 1, lambda), which is the Poisson CDF at k >= 0
        "poisson": gammaincc((key % 60).astype(np.float64) + 1, size),
        "weibull": st.weibull_min.cdf(x, 1.5, scale=8.0),
        "beta": st.beta.cdf(pr, size, 3.5), "f": st.f.cdf(x, size, 7.0),
        "binomial": st.binom.cdf(key % 30, size + 10, 0.3),
        "t": st.t.cdf(xs, size),
        "wilson_lo": (center - spread) / (1.0 + z2 / n),
        "wilson_hi": (center + spread) / (1.0 + z2 / n),
        "inv_normal": st.norm.ppf(pr), "inv_cauchy": st.cauchy.ppf(pr, 0, 2),
        "inv_laplace": st.laplace.ppf(pr, 0, 3),
        "inv_weibull": st.weibull_min.ppf(pr, 1.5, scale=8.0),
        "inv_beta": st.beta.ppf(pr, size, 3.5),
        "inv_chi2": st.chi2.ppf(pr, size),
        "inv_gamma": st.gamma.ppf(pr, size, scale=0.5),
        "inv_f": st.f.ppf(pr, size, 7.0), "inv_t": st.t.ppf(pr, size),
        "inv_binomial": st.binom.ppf(pr, size + 10, 0.3).astype(np.int64),
        "inv_poisson": st.poisson.ppf(pr, size).astype(np.int64),
    }
    return {k: (v, None) for k, v in out.items()}


def chunked_oracle(oracle, columns: dict, parts: int = 8) -> dict:
    """A row-wise oracle over ``parts`` slices of ``columns`` in threads
    (numpy releases the interpreter lock), concatenated in row order."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(next(iter(columns.values())))
    bounds = np.linspace(0, n, parts + 1).astype(np.int64)
    pieces = [{c: v[lo:hi] for c, v in columns.items()}
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    with ThreadPoolExecutor(parts) as pool:
        outs = list(pool.map(oracle, pieces))
    return {k: (np.concatenate([o[k][0] for o in outs]),
                None if outs[0][k][1] is None
                else np.concatenate([o[k][1] for o in outs]))
            for k in outs[0]}


def run_scalar_families(tables, dicts, card: str, times: dict,
                        device: str = "cuda") -> dict:
    """Phase 9, over the TPC-H tables that phase 4 registered (cents,
    narrow lanes): each function family of
    ``velox_tpu_torch/tpch/scalar_plans.py`` projected over real columns,
    its result arrays checked element by element against the oracle
    computed on the host from the generated arrays (integers, dates,
    timestamps, booleans and NULL masks exactly; DOUBLE to
    ``SCALAR_RTOL``, the probability family to ``PROB_TOL`` against
    scipy), in a run whose host syncs and launches are counted, then
    timed (median of 5 warm runs, the batches drained on the card) and
    profiled once; then a seeded table of 2^24 ``datetime64[us]`` values
    registered through ``register_columns`` (a TIMESTAMP column), and the
    aggregation of ``scalar_plans.plan_aggregate`` through ``run_plan``,
    whose sums must equal the oracle's and which must launch B2 once per
    split of lineitem."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.io.catalog import (
        drop_table, get_table, register_columns,
    )
    from velox_tpu_torch.ops import grouped_sum as gs
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpcds.window_plans import compare, result_arrays
    from velox_tpu_torch.tpch import scalar_plans as sp

    def family(name, make, columns, oracle, tol):
        t0 = time.perf_counter()
        want = oracle()
        oracle_s = time.perf_counter() - t0
        plan = make(PlanBuilder).build()
        got, run = _peak_run(lambda: result_arrays(plan, columns))
        t0 = time.perf_counter()
        err = compare({c: got[c] for c in want}, want, **tol)
        compare_s = time.perf_counter() - t0
        check(err is None, f"scalar {name} differs from its oracle: {err}")
        if name == "nulls":
            err = sp.check_random(got)
            check(err is None, f"scalar nulls: {err}")
        rows = len(next(iter(got.values()))[0])
        nulls = sum(int((~m).sum()) for _, m in got.values() if m is not None)
        check(rows > 0, f"scalar {name}: no rows")
        del got, want

        def drain():
            for _ in Task(plan).run():
                pass

        t0 = time.perf_counter()
        wall = wall_ms(drain)
        timed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        busy = device_breakdown(drain, f"scalar_{name}", wall, card, top=5)
        profile_s = time.perf_counter() - t0
        times[f"scalar_{name}"] = wall
        log(f"scalar {name}: {rows} rows, {len(columns)} columns equal to "
            f"the oracle ({oracle_s:.3f} s on the host, compared in "
            f"{compare_s:.3f} s; timed runs {timed_s:.3f} s, profiled run "
            f"{profile_s:.3f} s), {nulls} NULLs; "
            f"host syncs {run['syncs']}; warm wall {wall} ms, busy {busy} "
            f"ms (share {busy / wall}); first checked run "
            f"{run['first_run_ms']} ms; peak device memory "
            f"{run['peak_gb']:.3f} GiB on {card}")
        return {"syncs": run["syncs"],
                **{k: run[k] for k in gs.launches},
                "wall_ms": wall, "busy_ms": busy,
                "rows": rows, "columns": len(columns), "nulls": nulls,
                "oracle_s": oracle_s, "compare_s": compare_s,
                "timed_s": timed_s, "profile_s": profile_s,
                "first_run_ms": run["first_run_ms"],
                "peak_gb": run["peak_gb"], "checks": "passed"}

    li = tables["lineitem"]
    out = {}
    for name, (make, columns) in sp.FAMILIES.items():
        if name == "probability":
            # scipy holds the interpreter lock: one thread
            oracle = (lambda: probability_oracle(  # noqa: E731
                tables["part"]))
            tol = PROB_TOL
        else:
            # the dates oracle is gathers, which hold the interpreter
            # lock: it runs in one thread
            oracle = (lambda o: lambda: o(li) if name == "dates"
                      else chunked_oracle(o, li))(sp.ORACLES[name])
            tol = {"rtol": SCALAR_RTOL}
        out[name] = family(name, make, columns, oracle, tol)

    ts_cols = sp.timestamp_table_columns(1 << 24, SEED)
    register_columns(sp.TIMESTAMP_TABLE, ts_cols, None, SPLIT_ROWS, None,
                     device)
    check(str(get_table(sp.TIMESTAMP_TABLE).schema.find_child("t"))
          == "TIMESTAMP", "a datetime64[us] column is not a TIMESTAMP")
    out["timestamp_table"] = family(
        "timestamp_table", sp.plan_timestamp_table,
        list(sp.TIMESTAMP_TABLE_EXPRS),
        lambda: chunked_oracle(sp.oracle_timestamp_table, ts_cols),
        {"rtol": SCALAR_RTOL})
    drop_table(sp.TIMESTAMP_TABLE)

    splits = len(get_table("lineitem").batches)
    want = sp.oracle_aggregate(li, dicts)
    got, run = _peak_run(lambda: run_plan(sp.plan_aggregate(PlanBuilder)))
    check_result(got, want, "scalar aggregate")
    check(run["grouped_multi_sum_i32"] == splits,
          f"scalar aggregate launched B2 {run['grouped_multi_sum_i32']} "
          f"times, want once per split ({splits})")
    wall = wall_ms(lambda: run_plan(sp.plan_aggregate(PlanBuilder)))
    busy = device_breakdown(lambda: run_plan(sp.plan_aggregate(PlanBuilder)),
                            "scalar_aggregate", wall, card, top=5)
    times["scalar_aggregate"] = wall
    out["aggregate"] = {**run, "wall_ms": wall, "busy_ms": busy,
                        "rows": len(want["n"]), "checks": "passed"}
    log(f"scalar aggregate: {len(want['n'])} groups equal to the oracle; "
        f"host syncs {run['syncs']}, launches B1 {run['grouped_sum_i32']} "
        f"B2 {run['grouped_multi_sum_i32']} ({splits} splits); warm wall "
        f"{wall} ms, busy {busy} ms (share {busy / wall}) on {card}")
    return out


def bind_plan(plan) -> float:
    """Bind every projection and filter of ``plan`` against its table's
    dictionaries and stats, as its operators do; returns the seconds.
    The host passes are kept with the dictionaries, so the plan's own
    run finds them done."""
    from velox_tpu_torch.exec.operator import batch_ranges, eval_dicts
    from velox_tpu_torch.expr.compiler import ExprSet
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan.nodes import (
        FilterNode, ProjectNode, TableScanNode,
    )

    chain, node = [], plan
    while not isinstance(node, TableScanNode):
        chain.append(node)
        node = node.source
    batch = get_table(node.table).batches[0]
    dicts, ranges = eval_dicts(batch), batch_ranges(batch)
    t0 = time.perf_counter()
    for n in chain:
        if isinstance(n, ProjectNode):
            ExprSet(n.exprs, n.source.output_type, dicts, ranges)
        elif isinstance(n, FilterNode):
            ExprSet([n.predicate], n.source.output_type, dicts, ranges)
    return time.perf_counter() - t0


def run_string_families(tables, dicts, card: str, times: dict) -> dict:
    """Phase 10, over the TPC-H tables that phase 4 registered (cents,
    narrow lanes, ``optimize_plans`` on): each family of
    ``velox_tpu_torch/tpch/string_plans.py`` bound on the host (timed
    alone), run once with its host syncs, launches and peak memory
    counted, every result array checked against the oracle computed on
    the host from the generated strings (string results through their
    result dictionaries, every row), then timed (median of 5 warm runs,
    the batches drained on the card) and profiled once; then the
    aggregation grouped by two transformed keys through ``run_plan``,
    exact against its oracle, which must launch B2 once per split."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpcds.window_plans import result_columns
    from velox_tpu_torch.tpch import string_plans as sp

    out = {}
    for name, (make, table, oracle) in sp.FAMILIES.items():
        plan = make(PlanBuilder).build()
        bind_s = bind_plan(plan)
        t0 = time.perf_counter()
        want = oracle(tables[table], dicts)
        oracle_s = time.perf_counter() - t0
        got, run = _peak_run(lambda: result_columns(plan, list(want)))
        t0 = time.perf_counter()
        err = sp.check(got, want)
        compare_s = time.perf_counter() - t0
        check(err is None, f"string {name} differs from its oracle: {err}")
        rows, columns = len(next(iter(got.values()))[0]), len(want)
        check(rows > 0, f"string {name}: no rows")
        del got, want

        def drain():
            for _ in Task(plan).run():
                pass

        wall = wall_ms(drain)
        busy = device_breakdown(drain, f"string_{name}", wall, card, top=5)
        times[f"string_{name}"] = wall
        first = bind_s * 1e3 + run["first_run_ms"]
        log(f"string {name}: {rows} rows, {columns} columns equal to the "
            f"oracle (oracle {oracle_s:.3f} s on the "
            f"host, compared in {compare_s:.3f} s); host bind {bind_s:.3f} "
            f"s, first run (bind plus run) {first} ms; host syncs "
            f"{run['syncs']}; launches B1 {run['grouped_sum_i32']} B2 "
            f"{run['grouped_multi_sum_i32']}; warm wall {wall} ms, busy "
            f"{busy} ms (share {busy / wall}); peak device memory "
            f"{run['peak_gb']:.3f} GiB on {card}")
        out[name] = {**{k: run[k] for k in (
            "syncs", "grouped_sum_i32", "grouped_multi_sum_i32", "peak_gb")},
            "rows": rows, "columns": columns, "bind_s": bind_s,
            "first_run_ms": first, "wall_ms": wall, "busy_ms": busy,
            "oracle_s": oracle_s, "compare_s": compare_s,
            "checks": "passed"}

    splits = len(get_table("lineitem").batches)
    plan = sp.plan_aggregate(PlanBuilder).build()
    bind_s = bind_plan(plan)
    want = sp.oracle_aggregate(tables["lineitem"], dicts)
    got, run = _peak_run(lambda: run_plan(plan))
    check_result(got, want, "string aggregate")
    check(run["grouped_multi_sum_i32"] == splits,
          f"string aggregate launched B2 {run['grouped_multi_sum_i32']} "
          f"times, want once per split ({splits})")
    wall = wall_ms(lambda: run_plan(plan))
    busy = device_breakdown(lambda: run_plan(plan), "string_aggregate",
                            wall, card, top=5)
    times["string_aggregate"] = wall
    out["aggregate"] = {**run, "bind_s": bind_s, "wall_ms": wall,
                        "busy_ms": busy, "rows": len(want["n"]),
                        "checks": "passed"}
    log(f"string aggregate: {len(want['n'])} groups equal to the oracle; "
        f"host bind {bind_s:.3f} s; host syncs {run['syncs']}, launches B1 "
        f"{run['grouped_sum_i32']} B2 {run['grouped_multi_sum_i32']} "
        f"({splits} splits); warm wall {wall} ms, busy {busy} ms (share "
        f"{busy / wall}); peak device memory {run['peak_gb']:.3f} GiB on "
        f"{card}")
    return out


# ------------------------------------------- joins and aggregates

_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over int64 values, in numpy uint64 (the
    oracle of ``checksum``, written apart from the port's hash)."""
    z = x.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * _SM_M1
        z = (z ^ (z >> np.uint64(27))) * _SM_M2
    return z ^ (z >> np.uint64(31))


def checksum_hashes(values: np.ndarray) -> np.ndarray:
    """Each value's splitmix64 as ``checksum`` hashes it: an integer as
    itself, a DOUBLE as ``trunc(x * 1e6)`` (every value here is finite
    and in range, where the cast's saturation never acts); a group's
    checksum is the wrapping sum of its rows' hashes."""
    if values.dtype.kind == "f":
        values = (values * 1e6).astype(np.int64)
    return splitmix64(values)


def bind_join_filter(plan) -> float:
    """Bind the filter of ``plan``'s first join against both sides'
    dictionaries and stats, as its probe does; returns the seconds."""
    from velox_tpu_torch.exec.operator import batch_ranges, eval_dicts
    from velox_tpu_torch.exec.operators import _join_filter_schema
    from velox_tpu_torch.expr.compiler import ExprSet
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan.nodes import HashJoinNode, TableScanNode

    def first_scan(n):
        while not isinstance(n, TableScanNode):
            n = n.sources[0]
        return get_table(n.table).batches[0]

    node = plan
    while not isinstance(node, HashJoinNode):
        node = node.sources[0]
    dicts, ranges = {}, {}
    for side in (node.left, node.right):
        b = first_scan(side)
        dicts.update(eval_dicts(b))
        ranges.update(batch_ranges(b))
    t0 = time.perf_counter()
    ExprSet([node.filter], _join_filter_schema(node), dicts, ranges)
    return time.perf_counter() - t0


def run_join_agg(tables, dicts, card: str, times: dict) -> dict:
    """Phase 11, over the TPC-H tables that phase 4 registered (cents,
    narrow lanes): ``velox_tpu_torch/tpch/join_agg_plans.py``'s joins in
    every form and its aggregates in three groupings. Each plan runs once
    with its host syncs, launches, probe forms and peak memory counted,
    is checked against its oracle, then timed (median of 5 warm runs)
    and profiled once. Returns, per plan label, the counts and times."""
    import torch

    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpch import join_agg_plans as ja
    from velox_tpu_torch.tpch.oracle import answer
    from velox_tpu_torch.tpcds.window_plans import result_columns
    from velox_tpu_torch.utils.config import config

    out = {}
    splits = len(get_table("lineitem").batches)

    def measure(label, plan, drain):
        wall = wall_ms(drain)
        busy = device_breakdown(drain, label, wall, card, top=3)
        times[label] = wall
        return {"wall_ms": wall, "busy_ms": busy}

    # J: the join family
    for name, (make, oracle, kinds) in ja.JOINS.items():
        for filtered in (False, True):
            want, seen = oracle(tables, dicts, filtered, SPLIT_ROWS)
            claimed = kinds + (ja.FILTERED_KINDS[name] if filtered else ())
            check(all(seen[k] > 0 for k in claimed),
                  f"join {name}: a claimed kind of row is empty: {seen}")
            if name == "right":
                check(seen["probe_splits_matched"] == splits,
                      f"right join: matches in {seen} of {splits} splits")
            for optimize in (True, False):
                config.optimize_plans = optimize
                label = (f"join {name}{' filtered' if filtered else ''} "
                         f"{'optimized' if optimize else 'unoptimized'}")
                plan = make(PlanBuilder, filtered).build()
                task = Task(plan)
                with probe_forms() as forms:
                    got, run = _peak_run(lambda: ja.run_rows(task))
                pushed = ja.pushed_filters(task)
                check_result(got, want, label)
                check(len(pushed) == 1, f"{label}: probes {pushed}")
                if name == "full":
                    check(pushed[0].endswith(": none"),
                          f"{label} pushed a filter: {pushed}")
                else:
                    check(not pushed[0].endswith(": none"),
                          f"{label} pushed nothing: {pushed}")
                out[label] = {**run, **measure(
                    label, plan, lambda: ja.run_rows(Task(plan))),
                    "probes": forms, "pushed": pushed, "kinds": seen,
                    "rows": len(next(iter(want.values())))}
                log(f"{label}: {out[label]['rows']} rows equal to the "
                    f"oracle; kinds {seen}; probe forms {forms}; pushed "
                    f"{pushed}; host syncs {run['syncs']}, launches B1 "
                    f"{run['grouped_sum_i32']} B2 "
                    f"{run['grouped_multi_sum_i32']}; warm wall "
                    f"{out[label]['wall_ms']} ms, busy "
                    f"{out[label]['busy_ms']} ms (share "
                    f"{out[label]['busy_ms'] / out[label]['wall_ms']}); "
                    f"peak device memory {run['peak_gb']:.3f} GiB on {card}")
    config.optimize_plans = True

    # J-left: Q13 with its predicate in the left join's filter
    plan = ja.plan_q13_join_filter(PlanBuilder).build()
    bind_s = bind_join_filter(plan)
    want = answer(13, tables, dicts, SF)
    seen = ja.q13_kinds(tables, dicts)
    check(seen["probe_only"] > 0 and seen["filtered_out"] > 0,
          f"J-left: a claimed kind of row is empty: {seen}")
    task = Task(plan)
    with probe_forms() as forms:
        got, run = _peak_run(lambda: ja.run_rows(task))
    check_result(got, want, "J-left (Q13, filtered left join)")
    label = "join left filtered (Q13)"
    out[label] = {**run, **measure(label, plan,
                                   lambda: ja.run_rows(Task(plan))),
                  "bind_s": bind_s, "probes": forms,
                  "pushed": ja.pushed_filters(task), "kinds": seen,
                  "rows": len(want["c_count"])}
    log(f"{label}: {len(want['c_count'])} rows equal to Q13's oracle; "
        f"kinds {seen}; filter bind {bind_s:.3f} s; probe forms {forms}; "
        f"host syncs {run['syncs']}; warm wall {out[label]['wall_ms']} ms, "
        f"busy {out[label]['busy_ms']} ms; peak device memory "
        f"{run['peak_gb']:.3f} GiB on {card}")

    # A: the aggregates in three groupings
    li = tables["lineitem"]
    args = ja.agg_arguments(li)
    hashes = {name: checksum_hashes(args[a])
              for part in ja.AGG_PARTS.values()
              for name, fn, a in part if fn == "checksum"}
    for grouping, keys in ja.GROUPINGS.items():
        t0 = time.perf_counter()
        want, (perm, starts) = ja.oracle_aggregates(li, grouping, args)
        checksums = {name: np.add.reduceat(h[perm], starts).view(np.int64)
                     for name, h in hashes.items()}
        oracle_s = time.perf_counter() - t0
        if grouping == "suppkey":
            # the formulas against numpy's and scipy's sample statistics
            # on well-conditioned groups (about 600 rows each)
            t0 = time.perf_counter()
            agree = ja.scipy_agreement(args, perm, starts)
            check(agree <= RTOL,
                  f"extract formulas against numpy/scipy: {agree}")
            log(f"aggregate formulas against numpy var/std and scipy "
                f"skew/kurtosis (bias=False) over 200 groups by "
                f"l_suppkey: largest relative difference {agree} "
                f"({(time.perf_counter() - t0):.3f} s)")
        if grouping == "orderkey":
            sk = want["sk_price"][1]
            check(sk.any() and not sk.all(),
                  "orderkey groups: the n >= 3 NULL rule is vacuous")
        for part, aggs in ja.AGG_PARTS.items():
            label = f"aggregate {part} by {grouping}"
            plan = ja.plan_aggregates(PlanBuilder, grouping, part).build()
            names = list(plan.output_type.names)
            task = Task(plan)
            got, run = _peak_run(lambda: result_columns(task, names))
            mode = ja.aggregation_mode(task)
            if "arb_mode" in got:
                check(list(got["arb_mode"][2].values)
                      == list(dicts["l_shipmode"]),
                      f"{label}: arbitrary(l_shipmode) lost its dictionary")
            got = {n: (v, m) for n, (v, m, d) in got.items()}
            err, stats = ja.check_aggregates(got, want, keys)
            check(err is None, f"{label}: {err}")
            order = np.lexsort([got[k][0] for k in reversed(keys)])
            for name in checksums:
                if name in got:
                    check(np.array_equal(got[name][0][order],
                                         checksums[name]),
                          f"{label}: {name} differs from splitmix64")
            expect = {"q1_keys": "kArray", "suppkey": "generic",
                      "orderkey": "streaming"}[grouping]
            check(mode == expect, f"{label} ran {mode}, want {expect}")
            rows = len(got[keys[0]][0])
            del got

            def drain():
                for _ in Task(plan).run():
                    pass

            out[label] = {**run, **measure(label, plan, drain),
                          "operator": mode, "rows": rows,
                          "oracle_s": oracle_s, "errors": stats}
            log(f"{label}: {rows} groups equal to the oracle through "
                f"{mode} ({oracle_s:.3f} s of oracle on the host); float "
                f"errors {stats}; host syncs {run['syncs']}, launches B1 "
                f"{run['grouped_sum_i32']} B2 "
                f"{run['grouped_multi_sum_i32']}; warm wall "
                f"{out[label]['wall_ms']} ms, busy {out[label]['busy_ms']} "
                f"ms (share {out[label]['busy_ms'] / out[label]['wall_ms']})"
                f"; peak device memory {run['peak_gb']:.3f} GiB on {card}")
        del want
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------- TPC-DS, windows

DS_SF = 10
DS_SEED = 7                        # the JAX package's default seed


def _peak_run(fn):
    """One run of ``fn``: its result, and its host syncs, B1/B2 launches,
    wall (``first_run_ms``) and peak device memory, also above what was
    allocated before it (GiB)."""
    import torch

    from velox_tpu_torch.ops import grouped_sum as gs
    from velox_tpu_torch.utils import syncs

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    syncs.reset()
    gs.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, {"syncs": syncs.count, **gs.launches,
                 "first_run_ms": (time.perf_counter() - t0) * 1e3,
                 "peak_gb": peak / 2**30,
                 "above_tables_gb": (peak - resident) / 2**30}


def run_tpcds_queries(card: str, times: dict):
    """Phase 7: generate the eight TPC-DS tables at SF10 (seed 7) and
    register them on the card in splits of 2^23 rows; run the 15
    ``SPEC_QUERIES`` with ``optimize_plans`` on, each checked against its
    numpy oracle (``velox_tpu_torch/tpcds/oracle.py``: integers, strings
    and row order exactly, DOUBLE to RTOL) in a run whose host syncs,
    B1/B2 launches and peak device memory are counted, then timed
    (median of 5 warm runs) and profiled once. Returns the generated
    arrays and the counts and times per query."""
    import torch

    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.io.catalog import get_table, register_columns
    from velox_tpu_torch.io.tpcds import TABLES, tpcds_columns
    from velox_tpu_torch.tpcds import SPEC_QUERIES, tpcds_plan
    from velox_tpu_torch.tpcds.oracle import answer
    from velox_tpu_torch.utils.config import config

    t0 = time.perf_counter()
    tables, dicts = tpcds_columns(DS_SF, DS_SEED)
    log(f"generated the eight TPC-DS tables SF{DS_SF} seed {DS_SEED}: "
        f"{(time.perf_counter() - t0):.3f} s")
    t0 = time.perf_counter()
    for name in TABLES:
        cols = tables[name]
        register_columns(name, cols, {c: dicts[c] for c in cols
                                      if c in dicts}, SPLIT_ROWS, None,
                         "cuda")
    torch.cuda.synchronize()
    ss = get_table("store_sales")
    log(f"registered the TPC-DS tables SF{DS_SF}: "
        f"{(time.perf_counter() - t0):.3f} s; store_sales "
        f"{ss.num_rows} rows in {len(ss.batches)} splits, "
        + ", ".join(f"{n} {get_table(n).num_rows}" for n in TABLES[:-1])
        + f"; device memory {torch.cuda.memory_allocated() / 2**30:.3f} "
        f"GiB")
    config.optimize_plans = True
    out = {}
    for q in SPEC_QUERIES:
        t0 = time.perf_counter()
        want = answer(q, tables, dicts)
        log(f"DS q{q} oracle: {(time.perf_counter() - t0):.3f} s on the "
            f"host")
        got, run = _peak_run(lambda: run_plan(tpcds_plan(q)))
        rows = len(next(iter(want.values())))
        if rows == 0:
            log(f"DS q{q}: the oracle is empty too")
        check_result(got, want, f"DS q{q}")
        wall = wall_ms(lambda: run_plan(tpcds_plan(q)))
        busy = device_breakdown(lambda: run_plan(tpcds_plan(q)),
                                f"ds_q{q}", wall, card, top=3)
        times[f"ds_q{q}"] = wall
        out[f"DS q{q}"] = {**run, "wall_ms": wall, "busy_ms": busy,
                           "rows": rows}
        log(f"DS q{q}: {rows} rows equal to the oracle; host syncs "
            f"{run['syncs']}, launches B1 {run['grouped_sum_i32']} B2 "
            f"{run['grouped_multi_sum_i32']}; warm wall {wall} ms, busy "
            f"{busy} ms (share {busy / wall}), first run "
            f"{run['first_run_ms']} ms; peak device memory "
            f"{run['peak_gb']:.3f} GiB ({run['above_tables_gb']:.3f} above "
            f"the tables) on {card}")
    return tables, out


def run_window_plans(store_sales, card: str, times: dict) -> dict:
    """Phase 8: the window family at full width over the 28.8M-row
    ``store_sales`` of phase 7 (``velox_tpu_torch/tpcds/window_plans.py``):
    W1 the blocking window with every function and frame, W2 the
    streaming window (the optimizer must choose ``StreamingWindowNode``),
    W3 TopNRowNumber, RowNumber with a limit, MarkDistinct with a count,
    GroupId with an aggregation and UnionAll with an aggregation. Each
    result, as numpy arrays from its batches, must equal its numpy oracle
    (integers exactly, DOUBLE to RTOL) before it is counted (host syncs,
    launches, peak device memory), timed (median of 5 warm runs, the
    batches drained on the card) and profiled once."""
    import torch

    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.plan.nodes import StreamingWindowNode
    from velox_tpu_torch.plan.optimizer import optimize_plan
    from velox_tpu_torch.tpcds.window_plans import (
        ORACLES, PLANS, compare, result_arrays,
    )

    node = optimize_plan(PLANS["W2"][0](PlanBuilder).build())
    check(type(node) is StreamingWindowNode,
          f"W2 runs as {type(node).__name__}, not StreamingWindowNode")
    log("W2: the optimizer chose StreamingWindowNode")
    out = {}
    for name, (make, columns) in PLANS.items():
        t0 = time.perf_counter()
        want = ORACLES[name](store_sales)
        log(f"{name} oracle: {(time.perf_counter() - t0):.3f} s on the host")
        plan = make(PlanBuilder).build()
        got = result_arrays(plan, columns)
        err = compare(got, want, RTOL)
        check(err is None, f"{name} differs from its oracle: {err}")
        rows = len(next(iter(want.values()))[0])
        check(rows > 0, f"{name}: no rows")

        def drain():
            for _ in Task(plan).run():
                pass

        # counted on a run that leaves the result on the card: the
        # checked run's copies to the host would add syncs of their own
        _, run = _peak_run(drain)
        wall = wall_ms(drain)
        busy = device_breakdown(drain, name, wall, card, top=5)
        times[name] = wall
        out[name] = {**run, "wall_ms": wall, "busy_ms": busy, "rows": rows}
        log(f"{name}: {rows} rows, {len(columns)} columns equal to the "
            f"oracle; host syncs {run['syncs']}, launches B1 "
            f"{run['grouped_sum_i32']} B2 {run['grouped_multi_sum_i32']}; "
            f"warm wall {wall} ms, busy {busy} ms (share {busy / wall}); "
            f"first counted run {run['first_run_ms']} ms; peak device "
            f"memory {run['peak_gb']:.3f} GiB ({run['above_tables_gb']:.3f} "
            f"above the tables) on {card}")
        del got
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "velox_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the velox_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))

    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.io.catalog import drop_table, get_table
    from velox_tpu_torch.io.tpch import register_tpch_lineitem
    from velox_tpu_torch.ops import grouped_sum as gs
    from velox_tpu_torch.tpch import tpch_plan
    from velox_tpu_torch.utils import cuda_build, syncs
    from velox_tpu_torch.utils.config import config

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    log(f"build: {(time.perf_counter() - t0):.3f} s for "
        f"{len(cuda_build.SOURCES)} source(s)")

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    check_kernels(gs)
    torch.cuda.synchronize()
    log(f"phase 2 (kernel checks): {(time.perf_counter() - t0):.3f} s")
    t_phase = time.perf_counter()

    # 3. the main path at SF10
    config.narrow_lanes = True
    t0 = time.perf_counter()
    cols, dicts = register_tpch_lineitem(SF, SEED, "cents", SPLIT_ROWS,
                                         device="cuda")
    splits = len(get_table("lineitem").batches)
    rows = sum(b.num_rows for b in get_table("lineitem").batches)
    log(f"registered lineitem SF{SF} (cents): {rows} rows, {splits} "
        f"splits, {(time.perf_counter() - t0):.3f} s")
    rows_q1 = q1_oracle(cols, dicts)
    rev6 = q6_oracle(cols)
    real_gids = q1_split0_gids(cols)
    check_real_gids(gs, real_gids)

    syncs.reset()
    gs.reset_launches()
    got = run_plan(tpch_plan(1))
    torch.cuda.synchronize()
    q1_counts = dict(gs.launches)
    main_syncs = {"Q1 cents": syncs.count}
    check(q1_counts == {"grouped_sum_i32": 0,
                        "grouped_multi_sum_i32": splits},
          f"decimal Q1 launches {q1_counts}, want B2 once per split")
    check_q1_cents(got, rows_q1)
    log(f"Q1 cents: exact; launches {q1_counts}, host syncs "
        f"{main_syncs['Q1 cents']}")

    syncs.reset()
    gs.reset_launches()
    got6 = run_plan(tpch_plan(6))
    torch.cuda.synchronize()
    q6_counts = dict(gs.launches)
    main_syncs["Q6 cents"] = syncs.count
    check(len(got6["revenue"]) == 1
          and int(got6["revenue"][0].scaleb(4)) == rev6, "Q6 revenue")
    log(f"Q6 cents: exact; launches {q6_counts}, host syncs "
        f"{main_syncs['Q6 cents']}")

    times = {"q1_cents": wall_ms(lambda: run_plan(tpch_plan(1))),
             "q6_cents": wall_ms(lambda: run_plan(tpch_plan(6)))}
    for q in (1, 6):
        device_breakdown(lambda: run_plan(tpch_plan(q)), f"q{q}_cents",
                         times[f"q{q}_cents"], card)

    drop_table("lineitem")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    register_tpch_lineitem(SF, SEED, "double", SPLIT_ROWS, device="cuda")
    log(f"registered lineitem SF{SF} (double): "
        f"{(time.perf_counter() - t0):.3f} s")
    syncs.reset()
    gs.reset_launches()
    gotd = run_plan(tpch_plan(1))
    torch.cuda.synchronize()
    qd_counts = dict(gs.launches)
    main_syncs["Q1 double"] = syncs.count
    check(qd_counts == {"grouped_sum_i32": splits,
                        "grouped_multi_sum_i32": 0},
          f"DOUBLE Q1 launches {qd_counts}, want B1 once per split")
    check_q1_double(gotd, rows_q1)
    log(f"Q1 double: within rtol={RTOL}; launches {qd_counts}, host "
        f"syncs {main_syncs['Q1 double']}")
    times["q1_double"] = wall_ms(lambda: run_plan(tpch_plan(1)))
    device_breakdown(lambda: run_plan(tpch_plan(1)), "q1_double",
                     times["q1_double"], card)
    drop_table("lineitem")
    del cols, rows_q1
    torch.cuda.empty_cache()

    log(f"phase 3 (Q1, Q6): {(time.perf_counter() - t_phase):.3f} s")

    # 4. the joins: Q3 and Q18; 5. the other 18 queries
    t0 = time.perf_counter()
    joins = run_join_queries(card, times)
    log(f"phases 4 and 5 (TPC-H joins, 18 more queries): "
        f"{(time.perf_counter() - t0):.3f} s")
    t_phase = time.perf_counter()

    # 6. timings
    for k, v in times.items():
        log(f"time {k}: {v} ms (median of 5 warm runs, SF{SF}, "
            f"{splits} splits) on {card}")
    b2 = time_kernel(gs, "grouped_multi_sum_i32", real_gids, 17, 12)
    b1 = time_kernel(gs, "grouped_sum_i32", real_gids, 1, 12)
    uniform = kernel_gids("uniform", SPLIT_ROWS, 128, 128)
    wide = [time_kernel(gs, "grouped_multi_sum_i32", uniform, 17, 128),
            time_kernel(gs, "grouped_sum_i32", uniform, 1, 128)]
    for k, gids_name in ((b2, "Q1's gids"), (b1, "Q1's gids"),
                         (wide[0], "uniform gids"), (wide[1], "uniform gids")):
        log(f"time {k['name']} {k['shape']} on {gids_name}: kernel "
            f"{k['ms']} ms a call from Python ({k['device_ms']} ms device "
            f"time, graph replay), plain {k['plain_ms']} ms, index_add_ "
            f"{k['library_ms']} ms, bound {k['bound_ms']} ms "
            f"({k['bound_by']}) on {card}")
    check(all(k["max_abs_err"] == 0 for k in wide), "kernel error")
    del uniform
    torch.cuda.empty_cache()
    log(f"phase 6 (kernel timings): {(time.perf_counter() - t_phase):.3f} s")

    # 7. TPC-DS at SF10; 8. the window family over its store_sales
    t0 = time.perf_counter()
    ds_tables, ds = run_tpcds_queries(card, times)
    log(f"phase 7 (TPC-DS): {(time.perf_counter() - t0):.3f} s")
    t0 = time.perf_counter()
    windows = run_window_plans(ds_tables["store_sales"], card, times)
    log(f"phase 8 (window plans): {(time.perf_counter() - t0):.3f} s")

    # report each kernel's launches in every query's checked run
    by_query = {"Q1 cents": q1_counts, "Q1 double": qd_counts,
                "Q6 cents": q6_counts}
    by_query.update({label: run for label, run in joins["runs"].items()})
    by_query.update({f"{q} cents": run for q, run in joins["more"].items()})
    by_query.update({f"scalar {n}": run
                     for n, run in joins["scalar"].items()})
    by_query.update({f"string {n}": run
                     for n, run in joins["strings"].items()})
    by_query.update(joins["join_agg"])
    by_query.update(ds)
    by_query.update(windows)
    more_b2 = sum(r["grouped_multi_sum_i32"] for r in joins["more"].values())
    check(more_b2 > 0, "no query of phase 5 launched B2")
    kernels = [
        dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
             launches=launches,
             launches_by_query={k: r[name] for k, r in by_query.items()},
             **{k: t[k] for k in ("max_abs_err", "ms", "device_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")})
        for name, replaces, launches, t in (
            ("grouped_sum_i32", "velox_tpu/ops/pallas_agg.py:32",
             qd_counts["grouped_sum_i32"], b1),
            ("grouped_multi_sum_i32", "velox_tpu/ops/pallas_agg.py:114",
             q1_counts["grouped_multi_sum_i32"], b2))]
    check(all(k["max_abs_err"] == 0 for k in kernels), "kernel error")
    print(json.dumps({"kernels": kernels, "query_ms": times,
                      "q1_q6_syncs": main_syncs,
                      "join_query_counts": joins["runs"],
                      "more_queries": joins["more"],
                      "scalar_functions": joins["scalar"],
                      "string_functions": joins["strings"],
                      "join_agg": joins["join_agg"],
                      "rank_forms_ms": joins["rank_forms_ms"],
                      "tpcds_queries": ds, "window_plans": windows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
