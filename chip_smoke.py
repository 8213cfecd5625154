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
   of 5 warm runs, one run alone past 250 ms) and profiled once (device
   busy share);
   B2 must launch in at least one of them; then phases 9 and 10 run over
   the same tables;
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
   Phases 9-15 read lineitem's first ``FAMILY_SPLITS`` (4) of its 8
   splits, 33.5M of 60M rows, for the time limit: their oracles, result
   copies and compares scale with the rows (the catalog's lineitem is
   cut to those splits for them, and each check reads the same rows,
   Q1's and Q6's oracles included).
9. (run right after phase 5, while the TPC-H tables are on the card)
   the scalar functions (``velox_tpu_torch/tpch/scalar_plans.py``): the
   date, timestamp, math, bitwise and hash, NULL-function and ``rand``
   families projected over lineitem's 60M rows and the probability
   family over 500,000 of part's 2M rows (for the time limit; it is not
   profiled), each result
   array checked element by element against its oracle computed on the
   host (numpy; scipy for
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
   are; the variance family by Q1's keys timed again through the
   scatters that one masked reduction a group replaces into few groups.
12. (right after phase 11, on the same tables) two-step and adaptive
   partial aggregation and the 17 multi-argument, bitwise, sketch and
   noisy aggregates (``velox_tpu_torch/tpch/agg_step_plans.py``): Q1 with
   PARTIAL and FINAL steps, equal to Q1's oracle, which must launch B2
   once a split in its PARTIAL step and never in its FINAL (the launches
   counted inside each operator's own calls in that run); Q6 in two
   steps; Q18's inner ``sum(l_quantity)`` by ``l_orderkey`` in two steps
   (its PARTIAL step must not abandon) and by the unique (``l_orderkey``,
   ``l_linenumber``) (it must abandon), each equal to its single step
   and to its oracle; the 17 aggregates in five families by Q1's keys
   (kArray), ``l_suppkey`` (generic), ``l_orderkey`` (streaming) and
   keyless, and two families in two steps by ``l_suppkey``, each value
   against its numpy oracle (the mode's ``min_by`` tie rule, a numpy
   HyperLogLog over the same hash, a float32 numpy copy of the noisy
   draw), ``approx_distinct`` also within 10% of the distinct count
   where a group holds at most 1024; each plan timed and profiled as
   the queries are. Phases 11 and 12 share each grouping's sort.
13. (right after phase 12, on the same tables) collect-mode aggregation,
   digests, set sketches and long decimals
   (``velox_tpu_torch/tpch/collect_plans.py``): the exact
   ``approx_percentile`` of ``l_extendedprice`` and ``l_quantity`` beside
   ``sum``/``avg``/``count(*)`` and ``approx_winsorized_mean`` by Q1's
   keys, ``l_suppkey`` and keyless, against numpy sorts at the float32
   position; the same percentiles in two steps through the digest lanes,
   each result's rank within n/64 of ``q (n - 1)``; ``tdigest_agg`` and
   ``qdigest_agg`` by ``l_suppkey``, every blob equal to
   ``functions/digest.py`` over the oracle's sorted runs, with
   ``value_at_quantile``, ``quantile_at_value``, ``trimmed_mean`` and
   ``scale_tdigest`` projected over them (equal to the same functions
   over those blobs and within the digest's error of the exact
   quantities; the readers' bind timed alone) and their ``merge`` by
   ``l_suppkey % 100``; ``approx_set(l_partkey)`` by ``l_suppkey`` (the
   first 2,000 suppliers, for the time limit) and
   keyless (``cardinality`` within 3 standard errors of the distinct
   count), ``make_set_digest`` by ``l_suppkey`` under ``l_shipmode =
   'AIR'`` and ``'RAIL'`` with ``intersection_cardinality`` and
   ``jaccard_index`` exact against numpy sets, ``merge`` and
   ``merge_set_digest`` by ``l_suppkey % 1000`` and ``khyperloglog_agg(
   ps_partkey, ps_suppkey)`` over partsupp with its readers and its
   ``merge_khll`` by ``ps_suppkey % 100``, each blob equal to
   ``functions/sketch.py`` built on the host over the same hash; a seeded
   2^22-row ``DECIMAL(38, 2)`` table (ingest timed) with ``sum``/``avg``/
   ``min``/``max``/``count`` by ``k``, keyless and in two steps and a
   filter against a literal past int64, exact against Python's ints.
   Every plan's B1/B2 launches must be 0; each is timed and profiled as
   the queries are, with its blob-building seconds.
14. (right after phase 13, on the same tables) the complex types
   (``velox_tpu_torch/tpch/complex_plans.py``, hash aggregations): P1
   ``array_agg``/``set_agg`` by ``l_orderkey`` (8.4M arrays over the
   first 4 splits' 33.5M rows)
   and one projection of ``cardinality``, ``array_sum``, ``contains``,
   ``element_at``, ``array_sort``, ``array_distinct``, ``transform``,
   ``any_match`` and ``filter``; P2 those arrays unnested WITH ORDINALITY
   and summed by ``l_orderkey`` (the direct sums); P3 ``map_agg`` by
   ``l_orderkey`` with ``map_keys``, ``map_values``, ``element_at`` and
   ``map_filter``; P4 Q1's filter, ``array_agg`` by Q1's keys, unnest
   and the sum by the same keys under narrow lanes (Q1's
   ``sum_base_price`` over the same rows; its B1/B2 launches recorded).
   P1-P3 are read as arrays (row lengths and flat elements in row order)
   and held against numpy exactly; each is timed and profiled as the
   queries are, with its host syncs and peak device memory.
15. (right after phase 14, on the same tables) the last collect kinds,
   the page form, a session time zone and the filter classes
   (``velox_tpu_torch/tpch/collect_rest_plans.py``): the six kinds and
   ``reduce_agg`` by Q1's keys and by ``l_suppkey % 1000`` against numpy
   (``reservoir_sample`` against the plain ``hash_i64`` priority order
   computed on the card); ``array_agg``/``map_agg`` by ``l_orderkey %
   100000`` in two steps (the PARTIAL page ``a$0``) exactly; orders'
   dates under ``session_timezone = "America/Los_Angeles"`` with
   ``hour``, ``minute``, ``timezone_hour``, ``at_timezone`` against the
   US daylight rule (it prints where the zone table came from); every
   filter class's mask over lineitem's first split. Each plan's first run
   is counted, then one warm run timed.
16. (right after phase 15, on the same tables; W1 at the end of phase 8)
   spill (``velox_tpu_torch/tpch/spill_plans.py``, ``optimize_plans``
   off): Q18 (also against its oracle), a generic aggregation by
   ``l_orderkey``, an OrderBy of orders, a full join of orders to
   lineitem and W1, each run unspilled (its buffered peak read) and
   under a device budget of half that peak, at most 2 GiB, where it must
   spill and equal its unspilled run (as a multiset, row for row for the
   OrderBy and W1, whose batches go to the host as they come) and hold
   less device memory: its peak above the tables must fall by at least
   half the bytes it spilled (``PEAK_BOUNDED``: the partitioned spills
   and, restored one key range at a time, the OrderBy and W1); the
   OrderBy a third time under a host budget of a quarter of its spilled
   bytes, where it must write page files to a temporary directory. It
   prints, per plan, the warm walls without and with the budget, the
   spill events and bytes to host and to files, the D2H and H2D GB/s
   (CUDA events) and the peak device memory above the tables in both
   runs.
17. (right after phase 16, on the same tables) the multi-fragment
   exchange (``velox_tpu_torch/tpch/exchange_plans.py``): F1, Q1 as a
   PARTIAL fragment shuffled by its keys into four FINAL tasks in
   memory, equal to phase 3's oracle after a sort by key, with B2 once a
   split in the producer; its FINAL step's inputs traced
   (``QueryTracer``) and replayed (``replay_operator``) to the same rows;
   F2, Q18's inner ``sum(l_quantity)`` by ``l_orderkey`` the same way as
   serialized pages with its consumer plan shipped through
   ``plan_to_json``/``plan_from_json``; F3, F2 streamed through an 8 MiB
   buffer in this process and over TCP on 127.0.0.1; F2 and F3 equal, as
   multisets, to the single-task run of the same two steps. Per run: the
   warm wall, host syncs, B1/B2 launches, pages and page bytes,
   serialize and deserialize seconds, fetches and GB/s.

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
    a run of 10^5 launches take minutes to collect; the raw device
    events are summed by kernel name here, as ``key_averages`` would sum
    them, without building its event tree (a tenth of the time). A
    trace that holds no device row at all (the tracer missed the run, as
    it once did for a run of a few dozen kernels) is taken once more."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() != DeviceType.CUDA
                    or getattr(e, "is_user_annotation", lambda: False)()):
                continue
            ms = (e.duration_ns() / 1e6 if hasattr(e, "duration_ns")
                  else e.duration_us() / 1e3)
            total, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (total + ms, count + 1)
        rows = [(ms, count, key) for key, (ms, count) in by_name.items()]
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


#: a warm run longer than this is the only timed run (the time limit's
#: room: with phases 15-16, timing the median of 5 runs, and of 3 past
#: this, the script took 1192-1230 s of its 1200 on one H100 80GB HBM3)
SLOW_RUN_MS = 250.0


def wall_ms(fn, reps: int = 5) -> float:
    """Median warm wall of ``fn`` over ``reps`` runs, or the first alone
    when it takes more than ``SLOW_RUN_MS`` (the time limit's room: a
    caller's figure past it is one sample)."""
    import torch

    times = []
    while len(times) < reps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if times[0] > SLOW_RUN_MS:
            reps = 1
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


def run_join_queries(card: str, times: dict, q1_q6) -> dict:
    """Phases 4 and 5: Q3 and Q18 over the eight tables at SF10 against
    their oracles, both plan shapes and both money schemas, and the merge
    plans once more without kArray join tables (so the binary search and
    the flipped merge probe run); time them and profile them, and time
    the merge probe's two rank forms; between the cents and the DOUBLE
    runs, phase 5 (``run_more_queries``). Returns each run's host syncs,
    B1/B2 launches and probe forms, the rank forms' times and phase 5's
    counts and times. ``q1_q6``: phase 3's Q1 and Q6 oracles, for phase
    12."""
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
    # phases 9-15 over lineitem's first FAMILY_SPLITS splits
    with lineitem_head(tables, FAMILY_SPLITS) as li:
        head = {**tables, "lineitem": li}
        q1_q6_head = (q1_oracle(li, dicts), q6_oracle(li))
        log(f"phases 9-15 read lineitem's first {FAMILY_SPLITS} splits: "
            f"{len(li['l_orderkey'])} rows")
        t0 = time.perf_counter()
        scalar = run_scalar_families(head, dicts, card, times)
        log(f"phase 9 (scalar functions): "
            f"{(time.perf_counter() - t0):.3f} s")
        t0 = time.perf_counter()
        strings = run_string_families(head, dicts, card, times)
        log(f"phase 10 (string functions): "
            f"{(time.perf_counter() - t0):.3f} s")
        t0 = time.perf_counter()
        row_cache = {}
        join_agg = run_join_agg(head, dicts, card, times, row_cache)
        log(f"phase 11 (joins and aggregates): "
            f"{(time.perf_counter() - t0):.3f} s")
        t0 = time.perf_counter()
        agg_steps = run_agg_steps(head, dicts, card, times, row_cache,
                                  q1_q6_head)
        log(f"phase 12 (two-step and multi-argument aggregation): "
            f"{(time.perf_counter() - t0):.3f} s")
        t0 = time.perf_counter()
        collect = run_collect(head, dicts, card, times, row_cache)
        del row_cache
        log(f"phase 13 (collect aggregation, sketches, long decimals): "
            f"{(time.perf_counter() - t0):.3f} s")
        t0 = time.perf_counter()
        complex_types = run_complex(head, card, times, q1_q6_head[0])
        log(f"phase 14 (complex types): {(time.perf_counter() - t0):.3f} s")
        t0 = time.perf_counter()
        collect_rest = run_collect_rest(head, dicts, card, times)
        del head
        log(f"phase 15 (collect kinds, page form, time zones, filters): "
            f"{(time.perf_counter() - t0):.3f} s")
    t0 = time.perf_counter()
    spilled = run_spill(card, times, q18_rows[True])
    log(f"phase 16 (spill, TPC-H): {(time.perf_counter() - t0):.3f} s")
    t0 = time.perf_counter()
    exchange = run_exchange(card, times, q1_q6[0])
    log(f"phase 17 (exchange): {(time.perf_counter() - t0):.3f} s")

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
            "scalar": scalar, "strings": strings, "join_agg": join_agg,
            "agg_steps": agg_steps, "collect": collect,
            "complex": complex_types, "collect_rest": collect_rest,
            "spill": spilled, "exchange": exchange}


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
    5 warm runs, one run alone past 250 ms) and profiled once (device busy
    share).
    Returns the counts and times per query."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.tpch import tpch_plan
    from velox_tpu_torch.tpch.oracle import answer

    out = {}
    oracles = oracles_side_by_side(
        {q: (lambda q: lambda: answer(q, tables, dicts, SF))(q)
         for q in MORE_QUERIES}, "phase 5")
    for q in MORE_QUERIES:
        want, oracle_s = oracles.pop(q)
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
    """``scalar_plans.PROBABILITY`` over the rows of ``part`` that the
    plan reads (``p_partkey <= PROBABILITY_PARTS``) with scipy, from the
    generated arrays, in the plan's own order of IEEE operations for
    its derived arguments."""
    import scipy.stats as st
    from scipy.special import gammaincc

    from velox_tpu_torch.tpch.scalar_plans import PROBABILITY_PARTS

    read = part["p_partkey"] <= PROBABILITY_PARTS
    key, size = part["p_partkey"][read], part["p_size"][read].astype(
        np.float64)
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


def oracles_side_by_side(jobs: dict, label: str) -> dict:
    """``{name: (result, seconds)}`` of each zero-argument oracle in
    ``jobs``, run side by side in threads (numpy releases the interpreter
    lock in its sorts, reductions and elementwise passes). A phase calls
    it before it runs any plan, so no timed run shares the host with an
    oracle. Logs the wall and the sum of the oracles' own seconds."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    t0 = time.perf_counter()
    workers = max(1, min(len(jobs), os.cpu_count() or 1, 8))
    with ThreadPoolExecutor(workers) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
    slowest = sorted(out.items(), key=lambda kv: -kv[1][1])[:3]
    log(f"{label} oracles: {time.perf_counter() - t0:.3f} s on the host in "
        f"{workers} threads ({sum(s for _, s in out.values()):.3f} s of "
        f"oracle time; slowest "
        f"{', '.join(f'{k} {v[1]:.1f} s' for k, v in slowest)})")
    return out


#: the lineitem splits (of 8) that phases 9-15 read: their host oracles,
#: result copies and compares scale with the rows, and the time limit
#: needs the room (the queries of phases 3-5 and phases 16-17 read all)
FAMILY_SPLITS = 4


@contextlib.contextmanager
def lineitem_head(tables, splits: int):
    """The catalog's lineitem cut to its first ``splits`` splits for the
    block; yields the same rows of the generated arrays."""
    from velox_tpu_torch.io.catalog import get_table

    table = get_table("lineitem")
    full = table.batches
    rows = sum(b.num_rows for b in full[:splits])
    table.batches = full[:splits]
    try:
        yield {c: v[:rows] for c, v in tables["lineitem"].items()}
    finally:
        table.batches = full


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
    timed (median of warm runs, the batches drained on the card) and
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

    def family(name, make, columns, oracle, tol, profile=True):
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
        busy = (device_breakdown(drain, f"scalar_{name}", wall, card, top=5)
                if profile else None)
        profile_s = time.perf_counter() - t0
        times[f"scalar_{name}"] = wall
        share = "not profiled" if busy is None else busy / wall
        log(f"scalar {name}: {rows} rows, {len(columns)} columns equal to "
            f"the oracle ({oracle_s:.3f} s on the host, compared in "
            f"{compare_s:.3f} s; timed runs {timed_s:.3f} s, profiled run "
            f"{profile_s:.3f} s), {nulls} NULLs; "
            f"host syncs {run['syncs']}; warm wall {wall} ms, busy {busy} "
            f"ms (share {share}); first checked run "
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
            # scipy holds the interpreter lock: one thread; its profiled
            # run (18 s, launch-bound) is left out for the time limit
            out[name] = family(
                name, make, columns,
                lambda: probability_oracle(tables["part"]), PROB_TOL,
                profile=False)
            continue
        # the dates oracle is gathers, which hold the interpreter lock:
        # it runs in one thread
        oracle = (lambda o: lambda: o(li) if name == "dates"
                  else chunked_oracle(o, li))(sp.ORACLES[name])
        out[name] = family(name, make, columns, oracle,
                           {"rtol": SCALAR_RTOL})

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
    result dictionaries, every row), then timed (median of warm runs,
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


def run_join_agg(tables, dicts, card: str, times: dict,
                 row_cache: dict) -> dict:
    """Phase 11, over the TPC-H tables that phase 4 registered (cents,
    narrow lanes): ``velox_tpu_torch/tpch/join_agg_plans.py``'s joins in
    every form and its aggregates in three groupings. Each plan runs once
    with its host syncs, launches, probe forms and peak memory counted,
    is checked against its oracle, then timed (median of warm runs)
    and profiled once. ``row_cache``: each grouping's rows in key order,
    made here once and shared with phase 12. Returns, per plan label,
    the counts and times."""
    import torch

    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpch import agg_step_plans as asp
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

    def grouping_oracle(grouping):
        want, (perm, starts) = ja.oracle_aggregates(
            li, grouping, args, rows=asp.m_rows(li, grouping, row_cache))
        return want, (perm, starts), {
            name: np.add.reduceat(h[perm], starts).view(np.int64)
            for name, h in hashes.items()}

    oracles = oracles_side_by_side(
        {g: (lambda g: lambda: grouping_oracle(g))(g)
         for g in ja.GROUPINGS}, "phase 11 aggregate")
    for grouping, keys in ja.GROUPINGS.items():
        (want, (perm, starts), checksums), oracle_s = oracles.pop(grouping)
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
            if label == "aggregate variance by q1_keys":
                # the same plan through the scatters that one masked
                # reduction a group replaces into few groups
                from velox_tpu_torch.functions import aggregates

                few, aggregates._FEW_GROUPS = aggregates._FEW_GROUPS, 0
                try:
                    out[label]["scatter_wall_ms"] = wall_ms(drain)
                finally:
                    aggregates._FEW_GROUPS = few
                log(f"{label} through the scatters: warm wall "
                    f"{out[label]['scatter_wall_ms']} ms against "
                    f"{out[label]['wall_ms']} ms a masked reduction a "
                    f"group, on {card}")
        del want
    torch.cuda.empty_cache()
    return out


def run_agg_steps(tables, dicts, card: str, times: dict,
                  row_cache: dict, q1_q6) -> dict:
    """Phase 12, over the TPC-H tables that phase 4 registered (cents,
    narrow lanes): ``velox_tpu_torch/tpch/agg_step_plans.py``'s two-step
    TPC-H plans and its 17 aggregates in five families by four
    groupings. Each plan runs once with its host syncs, launches and
    peak memory counted and is checked against its oracle, then timed
    (median of warm runs) and profiled once. ``row_cache``: each
    grouping's rows in key order, shared with phase 11; ``q1_q6``: phase
    3's Q1 rows and Q6 revenue (its lineitem's columns are these). Returns,
    per plan label, the counts and times."""
    import torch

    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpch import agg_step_plans as asp
    from velox_tpu_torch.tpch import join_agg_plans as ja
    from velox_tpu_torch.tpcds.window_plans import result_columns

    out = {}
    li = tables["lineitem"]
    splits = len(get_table("lineitem").batches)

    def drain(plan):
        for _ in Task(plan).run():
            pass

    def record(label, plan, run, note, **extra):
        wall = wall_ms(lambda: drain(plan))
        busy = device_breakdown(lambda: drain(plan), label, wall, card,
                                top=3)
        times[label] = wall
        out[label] = {**run, "wall_ms": wall, "busy_ms": busy, **extra}
        log(f"{label}: {note}; host syncs {run['syncs']}, launches B1 "
            f"{run['grouped_sum_i32']} B2 {run['grouped_multi_sum_i32']}; "
            f"abandoned {extra.get('abandoned')}; warm wall {wall} ms, "
            f"busy {busy} ms (share {busy / wall}); peak device memory "
            f"{run['peak_gb']:.3f} GiB on {card}")

    def abandoned(task) -> bool:
        ops = asp.partial_ops(task)
        check(len(ops) == 1, f"{len(ops)} PARTIAL operators")
        return ops[0].abandoned

    # the oracles, side by side before any plan runs: the S plans',
    # each grouping's arguments in group order and the sketch's hashes,
    # then every family's
    t0 = time.perf_counter()
    args = asp.m_arguments(li)
    hashes = {}
    okey, lnum = li["l_orderkey"], li["l_linenumber"]

    def q18_oracle():
        perm, starts, keys = asp.m_rows(li, "orderkey", row_cache)
        return (keys["l_orderkey"],
                np.add.reduceat(li["l_quantity"][perm], starts))

    def unique_order():
        return (None if np.all((okey[1:] > okey[:-1]) | (
            (okey[1:] == okey[:-1]) & (lnum[1:] > lnum[:-1])))
            else np.lexsort([lnum, okey]))

    def prepared(grouping):
        oracle = asp.GroupOracle(grouping, asp.m_rows(li, grouping,
                                                      row_cache),
                                 args, dicts, SPLIT_ROWS, hashes)
        oracle.prepare()
        return oracle

    def hashed(a):
        hashes[a] = asp.hll_bucket_rank(args[a])

    first = oracles_side_by_side(
        {"q18": q18_oracle, "unique": unique_order,
         **{("hash", a): (lambda a: lambda: hashed(a))(a)
            for a in ("l_partkey", "price")},
         **{g: (lambda g: lambda: prepared(g))(g)
            for g in asp.M_GROUPINGS}}, "phase 12 (rows and arguments)")
    groupings = {g: first.pop(g)[0] for g in asp.M_GROUPINGS}
    jobs = [(g, f, t) for g in asp.M_GROUPINGS for f in asp.FAMILIES
            for t in ((False, True) if g == "suppkey"
                      and f in asp.TWO_STEP_FAMILIES else (False,))]
    oracle_s = time.perf_counter() - t0

    # S: two-step TPC-H
    rows_q1, rev6 = q1_q6
    plan = asp.plan_q1(PlanBuilder).build()
    task = Task(plan)
    by_step = b2_by_step(task)
    got, run = _peak_run(lambda: pydict(task))
    check_q1_cents(got, rows_q1)
    b2 = (by_step.get("PARTIAL"), by_step.get("FINAL"))
    check(b2 == (splits, 0) and run["grouped_multi_sum_i32"] == splits
          and run["grouped_sum_i32"] == 0,
          f"two-step Q1: B2 launches (PARTIAL, FINAL) {b2} of "
          f"{run['grouped_multi_sum_i32']}, want ({splits}, 0) of {splits}")
    record("two-step Q1", plan, run, f"{len(rows_q1)} rows equal to Q1's "
           f"oracle; B2 {b2[0]} in the PARTIAL step, {b2[1]} in the FINAL",
           abandoned=False, partial_b2=b2[0], final_b2=b2[1])

    plan = asp.plan_q6(PlanBuilder).build()
    got, run = _peak_run(lambda: run_plan(plan))
    check(len(got["revenue"]) == 1
          and int(got["revenue"][0].scaleb(4)) == rev6, "two-step Q6")
    record("two-step Q6", plan, run, "equal to Q6's oracle",
           abandoned=False)

    want_keys, want = first.pop("q18")[0]
    plan = asp.plan_q18_inner(PlanBuilder).build()
    names = list(plan.output_type.names)
    task = Task(plan)
    got, run = _peak_run(lambda: result_columns(task, names))
    single = result_columns(asp.plan_q18_inner(PlanBuilder, False).build(),
                            names)
    for n in names:
        check(np.array_equal(got[n][0], single[n][0]),
              f"two-step Q18 inner: {n} differs from the single step")
    check(np.array_equal(got["l_orderkey"][0], want_keys)
          and np.array_equal(got["total_qty"][0], want),
          "two-step Q18 inner: differs from its oracle")
    check(not abandoned(task), "two-step Q18 inner: the partial abandoned")
    record("two-step Q18 inner", plan, run,
           f"{len(want)} groups equal to the single step and the oracle",
           abandoned=False)
    del got, single

    order = first.pop("unique")[0]

    def by_key(v):
        return v if order is None else v[order]

    plan = asp.plan_unique(PlanBuilder).build()
    names = list(plan.output_type.names)
    task = Task(plan)
    got, run = _peak_run(lambda: result_columns(task, names))
    check(abandoned(task) and asp.partial_ops(task)[0].runtime
          == {"abandoned_partial_agg": 1.0},
          "unique keys: the partial did not abandon")
    want = {"l_orderkey": by_key(okey), "l_linenumber": by_key(lnum),
            "sq": by_key(li["l_quantity"]),
            "n": np.ones(len(okey), np.int64),
            "mb": by_key(li["l_partkey"])}
    for n in names:
        check(np.array_equal(got[n][0], want[n]),
              f"two-step unique keys: {n} differs from its oracle")
    del got
    single = result_columns(asp.plan_unique(PlanBuilder, False).build(),
                            names)
    for n in names:
        check(np.array_equal(single[n][0], want[n]),
              f"single-step unique keys: {n} differs from its oracle")
    del single, want
    record("two-step unique keys", plan, run,
           f"{len(okey)} groups (one a row) equal to the single step and "
           f"the oracle", abandoned=True)
    torch.cuda.empty_cache()

    # M: the 17 aggregates
    t0 = time.perf_counter()
    wants = oracles_side_by_side(
        {**{(g, f, t): (lambda g, f, t: lambda: groupings[g].family(f, t))(
            g, f, t) for g, f, t in jobs},
         **{(g, "distinct"): (lambda g: lambda: exact_distinct(
             li, g, groupings[g]))(g) for g in asp.M_GROUPINGS
            if g != "orderkey"}}, "phase 12 (families)")
    oracle_s += time.perf_counter() - t0
    del groupings
    for grouping, family, two_step in jobs:
        keys = asp.M_GROUPINGS[grouping]
        expect = {"q1_keys": "kArray", "suppkey": "generic",
                  "orderkey": "streaming", "keyless": "generic"}[grouping]
        label = (f"aggregate {family} by {grouping}"
                 f"{' two-step' if two_step else ''}")
        want = wants.pop((grouping, family, two_step))[0]
        plan = asp.plan_family(PlanBuilder, grouping, family,
                               two_step).build()
        names = list(plan.output_type.names)
        task = Task(plan)
        got, run = _peak_run(lambda: result_columns(task, names))
        mode = ja.aggregation_mode(task)
        got = {n: (v, m) for n, (v, m, d) in got.items()}
        err, stats = ja.check_aggregates(got, want, keys)
        check(err is None, f"{label}: {err}")
        check(mode == expect, f"{label} ran {mode}, want {expect}")
        note = ""
        if "ad_pk" in got:
            # the estimate against the true distinct count
            ratio = approx_ratio(got, keys,
                                 *wants[(grouping, "distinct")][0])
            note = f"; approx_distinct / distinct {ratio}"
        rows = len(got[names[0]][0])
        del got, want
        record(label, plan, run,
               f"{rows} groups equal to the oracle through {mode}; "
               f"float errors {stats}{note}",
               abandoned=bool(two_step and abandoned(task)),
               operator=mode, rows=rows, errors=stats)
    log(f"phase 12 oracles: {oracle_s:.3f} s on the host")
    out["oracle_s"] = oracle_s
    torch.cuda.empty_cache()
    return out


def blob_strings(col) -> list:
    """A ``result_columns`` string column as Python strings (None where
    masked)."""
    vals, mask, d = col
    out = d.decode(vals)
    return [v if ok else None for v, ok in zip(out.tolist(), mask)]


def run_collect(tables, dicts, card: str, times: dict,
                row_cache: dict) -> dict:
    """Phase 13, over the TPC-H tables that phase 4 registered (cents,
    narrow lanes): ``velox_tpu_torch/tpch/collect_plans.py``'s collect
    mode plans (exact and two-step percentiles, digests and their readers,
    set sketches and their readers, merges) and a seeded long-decimal
    table. Each plan runs once with its host syncs, launches, peak memory
    and blob-building seconds counted and is checked against its oracle,
    then timed (median of warm runs) and profiled once. ``row_cache``:
    each grouping's rows in key order, shared with phases 11 and 12.
    Returns, per plan label, the counts and times."""
    import torch

    from velox_tpu_torch.exec import collect_agg
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.functions import sketch as SK
    from velox_tpu_torch.io.catalog import drop_table, register_columns
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpch import collect_plans as cp
    from velox_tpu_torch.tpcds.window_plans import result_columns

    out = {}
    li, ps = tables["lineitem"], tables["partsupp"]
    cols = ("l_extendedprice", "l_quantity")

    def drain(plan):
        for _ in Task(plan).run():
            pass

    def checked(label, make, pydict=False):
        plan = make(PlanBuilder).build()
        names = list(plan.output_type.names)
        collect_agg.reset_blob_seconds()
        got, run = _peak_run(lambda: run_plan(plan) if pydict
                             else result_columns(plan, names))
        run["blob_s"] = collect_agg.blob_seconds
        return plan, got, run

    def record(label, plan, run, note, **extra):
        wall = wall_ms(lambda: drain(plan))
        busy = device_breakdown(lambda: drain(plan), label, wall, card,
                                top=3)
        times[label] = wall
        out[label] = {**run, "wall_ms": wall, "busy_ms": busy, **extra}
        log(f"{label}: {note}; host syncs {run['syncs']}, launches B1 "
            f"{run['grouped_sum_i32']} B2 {run['grouped_multi_sum_i32']}; "
            f"blob building {run['blob_s']:.3f} s; first run "
            f"{run['first_run_ms']:.1f} ms, warm wall {wall} ms, busy "
            f"{busy} ms (share {busy / wall}); peak device memory "
            f"{run['peak_gb']:.3f} GiB on {card}")

    # the oracles, side by side before any plan runs
    t0 = time.perf_counter()
    for g in ("q1_keys", "suppkey"):
        if g not in row_cache:
            row_cache[g] = group_rows_of(li, g)
    first = oracles_side_by_side(
        {**{("runs", g, c): (lambda g, c: lambda: cp.sorted_runs(
            li, g, c, row_cache))(g, c)
            for g in cp.GROUPINGS for c in cols},
         "pairs": lambda: cp.supplier_parts(li, ps, row_cache["suppkey"]),
         "masked": lambda: cp.masked_sets(li, row_cache["suppkey"], dicts),
         "sketches": lambda: cp.sketch_oracles(li, ps),
         "wide": lambda: cp.wide_columns(SEED)}, "phase 13 (runs)")
    runs = {k[1:]: v[0] for k, v in first.items() if k[0] == "runs"}
    wide_cols = first["wide"][0]
    sk = first["sketches"][0]
    # the digest plans read the first SUPPLIER_CUT suppliers
    supp = row_cache["suppkey"][2]["l_suppkey"]
    cut = np.nonzero(supp <= cp.SUPPLIER_CUT)[0]
    sample = {c: cp.sampled(runs[("suppkey", c)], cut) for c in cols}
    second = oracles_side_by_side(
        {"td": lambda: cp.digest_oracle(sample[cols[0]], "TD1"),
         "qd": lambda: cp.digest_oracle(sample[cols[1]], "QD1"),
         "sets": lambda: cp.supplier_sets(first["pairs"][0], sk),
         "wide_k": lambda: cp.wide_oracle(wide_cols, True),
         "wide_all": lambda: cp.wide_oracle(wide_cols, False),
         "wide_filter": lambda: cp.wide_filter_oracle(wide_cols)},
        "phase 13 (blobs, long decimals)")
    td, qd = second["td"][0], second["qd"][0]
    merged = list(range(100))
    third = oracles_side_by_side(
        {"readers": lambda: cp.reader_oracle(td, qd),
         "merge_td": lambda: cp.merge_oracle(td, supp[cut], 100, merged),
         "merge_qd": lambda: cp.merge_oracle(qd, supp[cut], 100, merged)},
        "phase 13 (readers, merges)")
    oracle_s = time.perf_counter() - t0

    # exact percentiles, with scalar aggregates beside them
    for grouping in cp.GROUPINGS:
        label = f"collect percentiles by {grouping}"
        plan, got, run = checked(
            label, lambda pb: cp.plan_percentiles(pb, grouping))
        rp, rq = runs[(grouping, cols[0])], runs[(grouping, cols[1])]
        moved = {}
        for (name, _c, q), r in zip(cp.PERCENTILES, (rp, rq)):
            want, moved[name] = cp.percentile_oracle(r, q)
            check(np.array_equal(got[name][0], want) and got[name][1].all(),
                  f"{label}: {name} differs from the oracle")
        _k, starts, counts, qv = rq
        check(np.array_equal(got["n"][0], counts), f"{label}: count(*)")
        check(np.array_equal(got["sum_qty"][0],
                             np.add.reduceat(qv, starts)), f"{label}: sum")
        perm = (np.arange(len(li["l_discount"])) if grouping == "keyless"
                else row_cache[grouping][0])
        ds = np.add.reduceat(li["l_discount"][perm].astype(np.int64), starts)
        check(np.array_equal(got["avg_disc"][0], np.array(
            [_round_avg(int(s), int(c)) for s, c in zip(ds, counts)])),
            f"{label}: avg")
        err = None
        if "w_price" in got:
            want = cp.winsorized_oracle(rp, *cp.WINSOR)
            err = float(np.max(np.abs(got["w_price"][0] - want)
                               / np.abs(want)))
            check(err <= RTOL, f"{label}: winsorized mean error {err}")
        record(label, plan, run,
               f"{len(counts)} groups equal to the oracle (float32 "
               f"positions; a float64 position would move {moved} "
               f"groups); winsorized rel err {err}",
               groups=len(counts), float64_moves=moved, winsor_err=err)

    # two steps through the digest lanes
    for grouping in cp.GROUPINGS:
        label = f"two-step percentiles by {grouping}"
        plan, got, run = checked(
            label, lambda pb: cp.plan_two_step(pb, grouping))
        worst = {}
        for (name, _c, q), c in zip(cp.PERCENTILES, cols):
            r = runs[(grouping, c)]
            err, exact_ok = cp.rank_errors(r, got[name][0], q)
            counts = r[2]
            check(np.all(err <= counts / cp.RANK_BOUND) and exact_ok.all(),
                  f"{label}: {name} rank error beyond n/{cp.RANK_BOUND} "
                  f"({float(np.max(err / counts))} of n) or a small group "
                  f"not exact")
            worst[name] = {"ranks": float(err.max()),
                           "of_n": float(np.max(err / counts)),
                           "beyond_n_64": int((err > counts / 64).sum()),
                           "small_groups": int((counts <= 64).sum())}
        record(label, plan, run, f"rank errors within "
               f"n/{cp.RANK_BOUND}: {worst}", rank_errors=worst)

    # digests and their readers
    label = f"digests by suppkey <= {cp.SUPPLIER_CUT} with readers"
    plan, got, run = checked(label, cp.plan_digests)
    check(np.array_equal(got["l_suppkey"][0], supp[cut])
          and blob_strings(got["td"]) == td and blob_strings(got["qd"]) == qd,
          f"{label}: blobs differ from digest.py over the oracle's runs")
    want = third["readers"][0]
    check(blob_strings(got["sc"]) == want["sc"],
          f"{label}: scale_tdigest differs")
    for name in ("v50", "qv", "tm", "q90"):
        check(got[name][1].all() and np.array_equal(
            got[name][0], np.array(want[name], dtype=np.float64)),
            f"{label}: {name} differs from digest.py over the oracle blobs")
    errs = cp.reader_errors(sample[cols[0]], sample[cols[1]],
                            {n: got[n][0] for n in cp.READER_TOL})
    check(all(errs[n] <= tol for n, tol in cp.READER_TOL.items()),
          f"{label}: reader errors {errs} beyond {cp.READER_TOL}")
    t_bind = bind_over_result(plan)
    record(label, plan, run, f"{len(td)} groups: blobs and readers equal "
           f"to digest.py over the oracle; worst reader errors {errs}; "
           f"bind {t_bind:.3f} s", reader_errors=errs, bind_s=t_bind)

    label = "merge of digests by suppkey % 100"
    plan, got, run = checked(label, cp.plan_digest_merge)
    check(got["g"][0].tolist() == merged
          and blob_strings(got["mt"]) == third["merge_td"][0]
          and blob_strings(got["mq"]) == third["merge_qd"][0],
          f"{label}: merged blobs differ from merge_digests")
    record(label, plan, run, "100 merged blobs equal to merge_digests "
           "over the oracle's blobs in key order")

    # set sketches
    sets = second["sets"][0]
    stderr = 1.04 / np.sqrt(1 << SK.HLL_LOG2M)
    for grouping in ("suppkey", "keyless"):
        label = f"approx_set by {grouping}"
        plan, got, run = checked(
            label, lambda pb: cp.plan_approx_set(pb, grouping))
        cut = len(got["card"][0])      # the first SUPPLIER_CUT suppliers
        want = sets["hs"][:cut] if grouping == "suppkey" else [sk["hs"]]
        truth = (sets["distinct"][:cut] if grouping == "suppkey"
                 else np.array([sk["distinct"]]))
        check(grouping == "keyless" or (
            cut <= cp.SUPPLIER_CUT
            and got["l_suppkey"][0].tolist() == list(range(1, cut + 1))),
            f"{label}: the suppliers are not the first {cut}")
        check(blob_strings(got["hs"]) == want and got["card"][0].tolist()
              == [SK.sketch_cardinality(b) for b in want],
              f"{label}: blobs or cardinality differ from the registers "
              f"built on the host over the same hash")
        rel = np.abs(got["card"][0] / truth - 1)
        beyond = int((rel > 3 * stderr).sum())
        if grouping == "keyless":
            check(beyond == 0, f"{label}: cardinality {got['card'][0]} "
                  f"beyond 3 standard errors of {truth}")
        record(label, plan, run, f"blobs equal to the host's; cardinality "
               f"within {rel.max()} of the distinct counts, {beyond} of "
               f"{len(rel)} groups past 3 standard errors ({3 * stderr})",
               max_rel_err=float(rel.max()), beyond_3_stderr=beyond)

    label = f"make_set_digest by suppkey <= {cp.SUPPLIER_CUT}, AIR, RAIL"
    plan, got, run = checked(label, cp.plan_set_digests)
    m = first["masked"][0]
    check(max(m["air"].max(), m["rail"].max()) < SK.SD_K,
          f"{label}: a supplier holds 2048 distinct parts")
    check(np.array_equal(got["ic"][0], m["both"]),
          f"{label}: intersection_cardinality differs from the exact sets")
    jj = m["both"] / np.maximum(m["union"], 1)
    live = m["union"] > 0
    check(np.allclose(got["jj"][0][live], jj[live], rtol=1e-12, atol=0),
          f"{label}: jaccard_index differs from the exact sets")
    record(label, plan, run, f"{len(m['both'])} suppliers: intersection "
           "and jaccard equal to the exact sets")

    label = "merge and merge_set_digest of l_suppkey % 1000"
    plan, got, run = checked(label, cp.plan_set_merges)
    check(blob_strings(got["mh"]) == [sk["hs"]]
          and blob_strings(got["md"]) == [sk["sd"]],
          f"{label}: merged sketches differ from the keyless sketches")
    record(label, plan, run, "equal to the keyless sketches built on the "
           "host")

    label = "khyperloglog_agg over partsupp"
    plan, got, run = checked(label, cp.plan_khll)
    kh = sk["kh"]
    check(blob_strings(got["kh"]) == [kh]
          and blob_strings(got["ud"]) == [SK.uniqueness_distribution(kh)]
          and got["rp"][0].tolist() == [SK.reidentification_potential(kh,
                                                                     10)]
          and got["card"][0].tolist() == [SK.sketch_cardinality(kh)],
          f"{label}: blob or readers differ from sketch.py over the hash")
    record(label, plan, run, f"blob and readers equal to sketch.py on "
           f"the host (reidentification_potential "
           f"{got['rp'][0].tolist()})")

    label = "merge_khll of ps_suppkey % 100"
    plan, got, run = checked(label, cp.plan_khll_merge)
    check(blob_strings(got["mk"]) == [kh],
          f"{label}: merged sketch differs from the keyless one")
    record(label, plan, run, "equal to the keyless sketch")

    # long decimals
    t0 = time.perf_counter()
    register_columns("wide", wide_cols, None, 1 << 20, {"x": (38, 2)},
                     "cuda")
    ingest_s = time.perf_counter() - t0
    log(f"registered wide ({len(wide_cols['k'])} rows, DECIMAL(38, 2) as "
        f"three digit lanes): {ingest_s:.3f} s")
    for label, make, want in (
            ("long decimals by k", lambda pb: cp.plan_wide(pb, ["k"]),
             second["wide_k"][0]),
            ("long decimals keyless", lambda pb: cp.plan_wide(pb, []),
             second["wide_all"][0]),
            ("long decimals two-step by k",
             lambda pb: cp.plan_wide(pb, ["k"], True), second["wide_k"][0]),
            ("long decimals filter past int64", cp.plan_wide_filter,
             second["wide_filter"][0])):
        plan, got, run = checked(label, make, pydict=True)
        check(got == want, f"{label}: differs from Python's ints")
        record(label, plan, run, f"{len(next(iter(got.values())))} rows "
               "equal to Python's ints", ingest_s=ingest_s)
    drop_table("wide")
    log(f"phase 13 oracles: {oracle_s:.3f} s on the host")
    out["oracle_s"] = oracle_s
    torch.cuda.empty_cache()
    return out


def run_complex(tables, card: str, times: dict, q1_rows) -> dict:
    """Phase 14, over the lineitem that phase 4 registered (cents,
    narrow lanes): ``velox_tpu_torch/tpch/complex_plans.py``'s plans as
    hash aggregations. P1-P3 are read as arrays and held against their
    numpy oracles exactly; P4 against ``q1_rows`` (Q1's oracle over the
    same lineitem rows).
    Each plan runs once with its host syncs, launches and peak memory
    counted, then is timed (median of warm runs) and profiled once.
    Returns, per plan, the counts and times."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpch import complex_plans as cx
    from velox_tpu_torch.utils.config import config

    li = tables["lineitem"]
    t0 = time.perf_counter()
    runs = cx.order_runs(li)
    oracles = oracles_side_by_side(
        {"P1 arrays": lambda: cx.arrays_oracle(li, runs),
         "P2 unnest": lambda: cx.unnest_oracle(li, runs),
         "P3 maps": lambda: cx.maps_oracle(li, runs)}, "phase 14")
    log(f"phase 14 oracles: {time.perf_counter() - t0:.3f} s on the host "
        f"({len(runs[2])} orders)")
    out = {}
    optimize, narrow = config.optimize_plans, config.narrow_lanes
    config.optimize_plans, config.narrow_lanes = False, True
    try:
        for label, make in cx.PLANS.items():
            plan = make(PlanBuilder).build()
            if label == "P4 Q1 unnest":
                got, run = _peak_run(lambda: run_plan(plan))
                check(len(got["n"]) == len(q1_rows), f"{label}: row count")
                for i, row in enumerate(q1_rows):
                    check(got["l_returnflag"][i] == row["l_returnflag"]
                          and got["l_linestatus"][i] == row["l_linestatus"]
                          and got["n"][i] == row["count_order"]
                          and int(got["sum_base_price"][i].scaleb(2))
                          == row["sum_base_price"],
                          f"{label}: row {i} differs from Q1's oracle")
                note = (f"{len(q1_rows)} groups equal to Q1's "
                        "sum_base_price and count")
            else:
                got, run = _peak_run(lambda: cx.complex_result(plan))
                want = oracles[label][0]
                bad = cx.same_result(got, want)
                check(not bad, f"{label}: {bad} differ from the oracle")
                lens = {n: int(w[1].sum()) for n, w in want.items()
                        if w[0] == "nested"}
                note = (f"{len(want['l_orderkey'][1])} rows equal to the "
                        f"oracle; elements {lens}")

            def drain():
                for _ in Task(plan).run():
                    pass

            wall = wall_ms(drain, reps=3)
            busy = device_breakdown(drain, label, wall, card, top=5)
            times[label] = wall
            out[label] = {**run, "wall_ms": wall, "busy_ms": busy}
            log(f"{label}: {note}; host syncs {run['syncs']}, launches B1 "
                f"{run['grouped_sum_i32']} B2 "
                f"{run['grouped_multi_sum_i32']}; first run "
                f"{run['first_run_ms']:.1f} ms, warm wall {wall} ms, busy "
                f"{busy} ms (share {busy / wall}); peak device memory "
                f"{run['peak_gb']:.3f} GiB ({run['above_tables_gb']:.3f} "
                f"above the tables) on {card}")
    finally:
        config.optimize_plans, config.narrow_lanes = optimize, narrow
    return out


def run_collect_rest(tables, dicts, card: str, times: dict) -> dict:
    """Phase 15, over the TPC-H tables that phase 4 registered (cents,
    narrow lanes, ``optimize_plans`` off): ``velox_tpu_torch/tpch/
    collect_rest_plans.py``. The six collect kinds and ``reduce_agg`` by
    Q1's keys and by ``l_suppkey % 1000`` against numpy (exact; DOUBLE to
    RTOL; ``reservoir_sample`` by its sizes and against the plain
    ``hash_i64`` priority order computed here on the card); the page form
    of ``array_agg``/``map_agg`` by ``l_orderkey % 100000`` exactly; the
    session-zone projection over orders against the US daylight rule;
    every filter class's mask, ``null_allowed`` both ways, against numpy.
    Each plan's first run is counted (host syncs, launches, peak memory),
    then one warm run is timed. Returns, per plan, the counts and
    times."""
    import velox_tpu_torch.types as T
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpch import collect_rest_plans as cr
    from velox_tpu_torch.tpch.complex_plans import complex_result
    from velox_tpu_torch.utils import tz
    from velox_tpu_torch.utils.config import config

    li, orders = tables["lineitem"], tables["orders"]
    oracles = oracles_side_by_side({
        **{f"K {g}": (lambda g=g: cr.kinds_oracle(li, g))
           for g in cr.GROUPINGS},
        **{f"T {k}": (lambda k=k: cr.two_step_oracle(li, k))
           for k in ("array", "map")},
        "Z": lambda: cr.zone_oracle(orders)}, "phase 15")
    out = {}

    def counted(label, plan, read, note_of):
        got, run = _peak_run(read)
        note = note_of(got)

        def drain():
            for _ in Task(plan).run():
                pass

        wall = wall_ms(drain, reps=3)
        times[label] = wall
        out[label] = {**run, "wall_ms": wall}
        log(f"{label}: {note}; host syncs {run['syncs']}, launches B1 "
            f"{run['grouped_sum_i32']} B2 {run['grouped_multi_sum_i32']}; "
            f"first run {run['first_run_ms']:.1f} ms, warm wall {wall} ms; "
            f"peak device memory {run['peak_gb']:.3f} GiB "
            f"({run['above_tables_gb']:.3f} above the tables) on {card}")

    optimize = config.optimize_plans
    config.optimize_plans = False
    try:
        for g in cr.GROUPINGS:
            plan = cr.plan_kinds(PlanBuilder, g).build()
            want = oracles[f"K {g}"][0]
            rs_want = reservoir_plain(get_table("lineitem"), g, li)

            def note_of(got, g=g, want=want, rs_want=rs_want):
                check_collect_kinds(got, want, rs_want, f"K {g}")
                return (f"{len(got['n'])} groups equal to numpy; "
                        f"reservoir samples equal to the plain priority "
                        f"order")

            counted(f"K kinds by {g}", plan, lambda p=plan: run_plan(p),
                    note_of)
        for kind in ("array", "map"):
            plan = cr.plan_two_step(PlanBuilder, kind).build()
            lens, keys, vals = oracles[f"T {kind}"][0]

            def note_of(got, lens=lens, keys=keys, vals=vals, kind=kind):
                col = got["a"]
                check(col[0] == "nested" and np.array_equal(col[1], lens)
                      and bool(col[2].all()), f"T {kind}: lengths")
                check(np.array_equal(col[3][0][0], keys),
                      f"T {kind}: elements")
                if vals is not None:
                    check(np.array_equal(col[3][1][0], vals),
                          f"T {kind}: map values")
                return (f"{len(lens)} groups, {int(lens.sum())} elements "
                        "equal to numpy")

            counted(f"T two-step {kind}_agg", plan,
                    lambda p=plan: complex_result(p), note_of)
        zone = config.session_timezone
        config.session_timezone = cr.ZONE
        try:
            plan = cr.plan_zone(PlanBuilder).build()
            want = oracles["Z"][0]

            def note_of(got):
                for c, w in want.items():
                    check(np.array_equal(got[c][1], w), f"Z {c} differs")
                return (f"{len(want['h'])} rows equal to the US daylight "
                        f"rule; zone table from {tz.zone_source(cr.ZONE)}")

            counted("Z session zone", plan,
                    lambda p=plan: complex_result(p), note_of)
        finally:
            config.session_timezone = zone
    finally:
        config.optimize_plans = optimize
    t0 = time.perf_counter()
    checked = check_filters(get_table("lineitem"), li, cr.filter_cases(T))
    log(f"F filters: {checked} masks over split 0 equal to numpy, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return out


def check_collect_kinds(got, want, rs_want, label) -> None:
    """Phase 15's kinds against their oracle, group by group."""
    n = len(want["n"])
    check(got["n"] == want["n"], f"{label}: counts")
    for c in ("mf", "vs", "rsum", "rmax"):
        check([list(v) if isinstance(v, (list, tuple)) else v
               for v in got[c]] == [list(v) if isinstance(v, (list, tuple))
                                    else v for v in want[c]],
              f"{label}: {c} differs")
    for i in range(n):
        g, w = got["nh"][i], want["nh"][i]
        check(len(g) == len(w) and all(
            gc == wc and abs(gk - wk) <= RTOL * abs(wk)
            for (gk, gc), (wk, wc) in zip(g, w)),
            f"{label}: numeric_histogram of group {i}")
        for c in ("cp", "cf"):
            check(all(abs(a - b) <= RTOL * abs(b)
                      for a, b in zip(got[c][i], want[c][i]))
                  and len(got[c][i]) == len(want[c][i]),
                  f"{label}: {c} of group {i}")
    check([len(r) for r in got["rs"]] == want["rs_size"],
          f"{label}: reservoir sizes")
    check(got["rs"] == rs_want, f"{label}: reservoir samples differ from "
          "the plain priority order")


def reservoir_plain(table, grouping: str, li) -> list:
    """reservoir_sample(l_partkey, k) by the plain rule, on the card: each
    live row's priority is ``hash_i64`` of its place in the concatenation
    of the table's splits (as the collect mode concatenates them), and a
    group's sample is its k rows of least priority (ties by place)."""
    import torch

    from velox_tpu_torch.ops.hash import _shr, hash_i64
    from velox_tpu_torch.tpch import collect_rest_plans as cr

    g_host, G = cr.group_ids(li, grouping)
    places, offset = [], 0
    for b in table.batches:
        places.append(offset + torch.nonzero(b.sel).reshape(-1))
        offset += b.capacity
    place = torch.cat(places)
    dev = place.device
    g = torch.from_numpy(g_host).to(dev)
    pk = torch.from_numpy(li["l_partkey"].astype(np.int64)).to(dev)
    pri = _shr(hash_i64(place), 33)
    order = torch.sort(g * (1 << 31) + pri, stable=True)[1]
    gs = g.index_select(0, order)
    first = torch.ones_like(gs, dtype=torch.bool)
    first[1:] = gs[1:] != gs[:-1]
    start = torch.cummax(torch.where(first, torch.arange(
        len(gs), device=dev), torch.zeros_like(gs)), 0)[0]
    rank = torch.arange(len(gs), device=dev) - start
    keep = rank < cr.RS_K
    sg = gs[keep].cpu().numpy()
    sv = pk.index_select(0, order)[keep].cpu().numpy()
    out = [[] for _ in range(G)]
    for gi, v in zip(sg.tolist(), sv.tolist()):
        out[gi].append(v)
    return out


def check_filters(table, li, cases) -> int:
    """Each filter class's mask over lineitem's first split on the card
    (2^23 rows), with a validity (``l_linenumber != 7``) and
    ``null_allowed`` off and on, against numpy's comparisons of the same
    arrays (the numpy side in threads, one a case). Returns the count."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import torch

    split = table.batches[0]
    rows = slice(0, split.num_rows)
    valid_np = li["l_linenumber"][rows] != 7
    lanes = {col: li[col][rows].astype(np.int64) for _, _, col, _ in cases}

    def wanted(case):
        name, _, col, test = case
        base = (np.ones(len(valid_np), bool) if test is None
                else test(lanes[col]))
        if name in ("AlwaysTrue", "AlwaysFalse"):
            return base, base
        if name in ("IsNull", "IsNotNull"):
            m = ~valid_np if name == "IsNull" else valid_np
            return m, m
        return base & valid_np, np.where(valid_np, base, True)

    with ThreadPoolExecutor(8) as pool:
        wants = list(pool.map(wanted, cases))
    checked = 0
    for (name, f, col, _), want in zip(cases, wants):
        for null_allowed in (False, True):
            f2 = dataclasses.replace(f, null_allowed=null_allowed)
            vals = split.column(col).values
            if name == "DoubleRange":
                vals = vals.to(torch.float64) / 100.0
            valid = split.column("l_linenumber").values != 7
            got = f2.mask(vals, valid)[:split.num_rows]
            check(np.array_equal(got.cpu().numpy(), want[null_allowed]),
                  f"filter {name} null_allowed={null_allowed}")
            checked += 1
    return checked


#: the most device memory a spilled run's buffers may hold: half the
#: plan's own buffered peak, at most 2 GiB (a plan whose buffers stay
#: under 2 GiB would not spill under 2 GiB)
SPILL_BUDGET = 2 << 30
#: the host budget of the run whose spilled batches go on to files
SPILL_HOST_BUDGET = 1 << 30


#: the spilled plans that hold one part of their state on the card at a
#: time: a generic aggregation's partials and a hash build by hash part,
#: the OrderBy and W1 by key range (``exec/spill.py`` RangeRestore). Under
#: the budget their peak above the tables must fall by at least half the
#: bytes the spill moved to the host.
PEAK_BOUNDED = ("Q18 hash", "G agg by l_orderkey", "O orderby orders",
                "J full join", "W1 window spill")


def spill_run(label: str, drain, read, compare, card: str,
              file_run: bool = False) -> dict:
    """Phase 16's measure of one plan: a counted run whose buffered peak
    is read (under a budget that never binds), a run under the budget,
    which must spill and equal the first (``compare(got, want)`` lists
    what differs) and, for the ``PEAK_BOUNDED`` plans, hold less device
    memory; the warm walls of each (median of 3, one run past
    ``SLOW_RUN_MS``; the spilled runs' host copies timed by CUDA
    events), and with ``file_run`` a run whose spilled batches go on to
    page files in a temporary directory."""
    import shutil
    import tempfile

    from velox_tpu_torch.exec import memory, spill
    from velox_tpu_torch.utils.config import config
    from velox_tpu_torch.utils.metrics import reporter

    names = ("velox_tpu.spilled_bytes", "velox_tpu.spill_events",
             "velox_tpu.spill_file_bytes")

    @contextlib.contextmanager
    def settings(device=None, host=None, spill_dir=None):
        config.spill_memory_budget_bytes = device
        config.spill_host_budget_bytes = host
        config.spill_dir = spill_dir
        try:
            yield
        finally:
            config.spill_memory_budget_bytes = None
            config.spill_host_budget_bytes = None
            config.spill_dir = None

    memory.root_pool.peak = 0
    with settings(1 << 62):
        want, base = _peak_run(read)
    buffered = memory.root_pool.peak
    budget = min(SPILL_BUDGET, buffered // 2)
    check(budget > 0, f"{label}: no buffered state ({buffered} bytes)")

    def spilled(**kw):
        before = dict(reporter.counters)
        spill.transfer_stats()
        with settings(budget, **kw):
            got, run = _peak_run(read)
        moved = {n.split(".")[1]: reporter.counters[n] - before.get(n, 0)
                 for n in names}
        check(moved["spill_events"] > 0,
              f"{label}: did not spill under {budget} bytes")
        bad = compare(got, want)
        check(not bad, f"{label}: the spilled run differs: {bad}")
        return run, moved, spill.transfer_stats()

    run, moved, _ = spilled()
    if label in PEAK_BOUNDED:
        fell = base["above_tables_gb"] - run["above_tables_gb"]
        check(fell * 2**30 >= moved["spilled_bytes"] / 2,
              f"{label}: the spilled run's peak above the tables fell "
              f"{fell:.3f} GiB, less than half the "
              f"{moved['spilled_bytes'] / 2**30:.3f} GiB it spilled")
    wall = wall_ms(drain, reps=3)
    spill.transfer_stats()
    with settings(budget):
        wall_spilled = wall_ms(drain, reps=3)
    xfer = spill.transfer_stats()
    rate = {d: (n / s / 1e9 if s else None) for d, (n, s) in xfer.items()}
    res = {"buffered_peak_bytes": buffered, "budget_bytes": budget,
           "wall_ms": wall, "spilled_wall_ms": wall_spilled,
           "unspilled": base, "spilled": run, "moved": moved,
           "gb_per_s": rate, "transfers": xfer}
    log(f"{label}: equal unspilled and spilled; buffers held "
        f"{buffered / 2**30:.3f} GiB, budget {budget / 2**30:.3f} GiB; "
        f"warm wall {wall} ms, spilled {wall_spilled} ms; spilled "
        f"{moved['spilled_bytes'] / 2**30:.3f} GiB in "
        f"{moved['spill_events']:.0f} events; D2H/H2D GB/s {rate} "
        f"({xfer}); peak above the tables {base['above_tables_gb']:.3f} "
        f"GiB unspilled, {run['above_tables_gb']:.3f} spilled; host syncs "
        f"{base['syncs']} / {run['syncs']} on {card}")
    if file_run:
        d = tempfile.mkdtemp(prefix="velox-spill-")
        host = min(SPILL_HOST_BUDGET, int(moved["spilled_bytes"]) // 4)
        try:
            frun, fmoved, _ = spilled(host=host, spill_dir=d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        check(fmoved["spill_file_bytes"] > 0,
              f"{label}: no page file under a host budget of {host} bytes")
        res["file_run"] = {"run": frun, "moved": fmoved, "host_budget": host}
        log(f"{label} (host budget {host / 2**30:.3f} GiB): "
            f"equal; {fmoved['spill_file_bytes'] / 2**30:.3f} GiB to page "
            f"files, first run {frun['first_run_ms']:.1f} ms on {card}")
    return res


def run_spill(card: str, times: dict, q18_rows) -> dict:
    """Phase 16 (TPC-H part), over the tables phase 4 registered, with
    ``optimize_plans`` off: Q18 (its result also against ``q18_rows``,
    its oracle), the generic aggregation by ``l_orderkey``, the OrderBy
    of orders (row for row; its third run under a host budget of a
    quarter of its spilled bytes writes page files) and the full join
    (as multisets), each through ``spill_run``."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.tpch import spill_plans as sp
    from velox_tpu_torch.tpch import tpch_plan
    from velox_tpu_torch.utils.config import config

    out = {}
    optimize = config.optimize_plans
    config.optimize_plans = False
    try:
        q18 = tpch_plan(18)
        q18 = q18.build() if hasattr(q18, "build") else q18

        def read_q18():
            got = run_plan(q18)
            check_rows(got, q18_rows, Q18_SCALES, "cents", "Q18 spill")
            return got

        def drain_of(plan):
            def drain():
                for _ in Task(plan).run():
                    pass
            return drain

        out["Q18 hash"] = spill_run(
            "Q18 hash", drain_of(q18), read_q18,
            lambda g, w: [] if g == w else ["rows"], card)
        for label, (make, ordered) in sp.PLANS.items():
            plan = make(PlanBuilder).build()
            out[label] = spill_run(
                label, drain_of(plan),
                lambda p=plan: sp.device_rows(Task(p)),
                lambda g, w, o=ordered: sp.same_rows(g, w, o), card,
                file_run=label.startswith("O"))
    finally:
        config.optimize_plans = optimize
    for label, r in out.items():
        times[f"{label} spilled"] = r["spilled_wall_ms"]
    return out


#: the exchange's counters a phase-17 run reads
EXCHANGE_COUNTERS = {
    "pages": "velox_tpu.exchange_pages",
    "page_bytes": "velox_tpu.exchange_bytes",
    "serialize_s": "velox_tpu.exchange_serialize_s",
    "deserialize_s": "velox_tpu.exchange_deserialize_s",
    "fetches": "velox_tpu.exchange_fetches",
    "fetch_bytes": "velox_tpu.exchange_fetch_bytes",
    "fetch_s": "velox_tpu.exchange_fetch_s",
}


def run_exchange(card: str, times: dict, q1_rows) -> dict:
    """Phase 17, over the TPC-H tables of phase 4 (cents, narrow lanes):
    the multi-fragment exchange (``velox_tpu_torch/tpch/exchange_plans.py``,
    ``exec/fragments.py``). F1 runs Q1 as a PARTIAL fragment shuffled by
    its keys into four FINAL tasks, in memory: its rows, sorted by key,
    must equal phase 3's oracle, and B2 must launch once a split (in the
    producer). F2 runs Q18's inner aggregation the same way through
    serialized pages, its consumer plan shipped through
    ``plan_to_json``/``plan_from_json``; F3 streams F2 through an 8 MiB
    ``StreamingBufferManager``, once in this process and once over TCP on
    127.0.0.1 (``ExchangeServer``, ``RemoteExchangeSource``): each must
    equal the single-task run of the same two steps as a multiset. A
    ``QueryTracer`` records F1's FINAL inputs, and ``replay_operator``
    must give its rows again. Each run: its warm wall (median of 5, one
    run past ``SLOW_RUN_MS``), host syncs, B1/B2 launches, pages and page
    bytes, serialize and deserialize seconds, fetches and their GB/s."""
    import shutil
    import tempfile

    import torch

    from velox_tpu_torch.exec import fragments as fr
    from velox_tpu_torch.exec.task import Task, collect_result
    from velox_tpu_torch.io.catalog import get_table
    from velox_tpu_torch.plan import PlanBuilder
    from velox_tpu_torch.plan.serde import plan_from_json, plan_to_json
    from velox_tpu_torch.tpch import agg_step_plans as asp
    from velox_tpu_torch.tpch import exchange_plans as xp
    from velox_tpu_torch.tpch.spill_plans import batch_rows, same_rows
    from velox_tpu_torch.utils.metrics import reporter
    from velox_tpu_torch.utils.trace import QueryTracer, replay_operator

    out = {}

    def measured(label, run, verify, note):
        before = reporter.snapshot()
        got, counted = _peak_run(run)
        moved = {k: reporter.counters[n] - before.get(n, 0)
                 for k, n in EXCHANGE_COUNTERS.items()}
        verify(got)
        del got
        wall = wall_ms(run)
        times[f"exchange {label}"] = wall
        rate = {k: (moved[b] / moved[s] / 1e9 if moved[s] else None)
                for k, b, s in (("serialize_gb_s", "page_bytes",
                                 "serialize_s"),
                                ("deserialize_gb_s", "page_bytes",
                                 "deserialize_s"),
                                ("fetch_gb_s", "fetch_bytes", "fetch_s"))}
        out[label] = {**counted, **moved, **rate, "wall_ms": wall}
        log(f"{label}: {note}; warm wall {wall} ms; host syncs "
            f"{counted['syncs']}, launches B1 {counted['grouped_sum_i32']} "
            f"B2 {counted['grouped_multi_sum_i32']}; pages "
            f"{moved['pages']:.0f}, page bytes {moved['page_bytes']:.0f}, "
            f"serialize {moved['serialize_s']:.3f} s, deserialize "
            f"{moved['deserialize_s']:.3f} s, fetches {moved['fetches']:.0f} "
            f"({moved['fetch_bytes']:.0f} bytes in {moved['fetch_s']:.3f} s), "
            f"GB/s {rate}; first run {counted['first_run_ms']:.1f} ms, peak "
            f"above the tables {counted['above_tables_gb']:.3f} GiB on {card}")
        return counted

    # F1: Q1 in memory, against phase 3's oracle
    f1 = xp.q1_fragments(PlanBuilder)
    keys = ["l_returnflag", "l_linestatus"]

    def by_key(got):
        order = sorted(range(len(got["count_order"])),
                       key=lambda i: tuple(got[k][i] for k in keys))
        return {c: [v[i] for i in order] for c, v in got.items()}

    splits = len(get_table("lineitem").batches)
    counted = measured(
        "F1 Q1 in memory", lambda: fr.run_fragments(f1),
        lambda got: check_q1_cents(by_key(got), q1_rows),
        f"{len(q1_rows)} groups equal to Q1's oracle after a sort by key")
    check(counted["grouped_multi_sum_i32"] == splits
          and counted["grouped_sum_i32"] == 0,
          f"F1: B2 launched {counted['grouped_multi_sum_i32']} times, B1 "
          f"{counted['grouped_sum_i32']}; want B2 once a split ({splits})")

    # the trace of F1's FINAL step, replayed
    d = tempfile.mkdtemp(prefix="velox-trace-")
    try:
        final = f1[1].plan
        tracer = QueryTracer(d, [final.id])
        t0 = time.perf_counter()
        traced = fr.run_fragments(f1, tracer=tracer)
        record_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replayed = collect_result(replay_operator(d, final),
                                  final.output_type.names)
        replay_s = time.perf_counter() - t0
        inputs = len(tracer.recorded_inputs(final.id))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check_q1_cents(by_key(traced), q1_rows)
    check(by_key(replayed) == by_key(traced),
          "F1 trace: the replayed FINAL step differs from the traced run")
    out["F1 trace"] = {"inputs": inputs, "record_s": record_s,
                       "replay_s": replay_s}
    log(f"F1 trace: {inputs} FINAL inputs recorded ({record_s:.3f} s "
        f"with the tracer), replayed to the same {len(q1_rows)} rows in "
        f"{replay_s:.3f} s on {card}")

    # F2, F3: Q18's inner aggregation against its single-task run
    want = batch_rows(Task(asp.plan_q18_inner(PlanBuilder).build()).run())
    groups = int(want["l_orderkey"][0].shape[0])

    def same_as_single(label):
        def verify(batches):
            bad = same_rows(batch_rows(batches), want, ordered=False)
            check(not bad, f"{label}: differs from the single-task run: "
                  f"{bad}")
        return verify

    f2 = xp.q18_inner_fragments(PlanBuilder)
    t0 = time.perf_counter()
    shipped = plan_from_json(plan_to_json(f2[1].plan))
    ship_s = time.perf_counter() - t0
    check(plan_to_json(shipped) == plan_to_json(f2[1].plan),
          "F2: the shipped consumer plan differs")
    f2 = [f2[0], fr.Fragment("B", shipped, num_tasks=f2[1].num_tasks,
                             exchange_sources=f2[1].exchange_sources)]
    measured("F2 Q18 inner as pages",
             lambda: fr.fragment_batches(f2, serialize_pages=True),
             same_as_single("F2"),
             f"{groups} groups equal to the single-task run as a multiset; "
             f"consumer plan shipped as JSON in {ship_s:.4f} s")
    for transport in ("local", "tcp"):
        label = f"F3 Q18 inner streamed ({transport})"
        measured(label,
                 lambda t=transport: fr.streaming_fragment_batches(
                     f2, 8 << 20, transport=t),
                 same_as_single(label),
                 f"{groups} groups equal to the single-task run as a "
                 f"multiset through an 8 MiB buffer")
    del want
    torch.cuda.empty_cache()
    return out


def bind_over_result(plan) -> float:
    """Seconds to bind the projection at the top of ``plan`` against a
    fresh run of the plan below it (its dictionaries new, so nothing of
    their host passes is kept yet): the readers' host work."""
    from velox_tpu_torch.exec.operator import batch_ranges, eval_dicts
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.expr.compiler import ExprSet

    batch = next(iter(Task(plan.source).run()))
    dicts, ranges = eval_dicts(batch), batch_ranges(batch)
    t0 = time.perf_counter()
    ExprSet(plan.exprs, plan.source.output_type, dicts, ranges)
    return time.perf_counter() - t0


def group_rows_of(li, grouping):
    from velox_tpu_torch.tpch.join_agg_plans import group_rows

    return group_rows(li, grouping)


def b2_by_step(task) -> dict:
    """The B2 launches made inside each aggregation operator's own calls
    while ``task`` runs, by step (``{"PARTIAL": n, "FINAL": m}``, filled
    in as it runs): each call that the task's loop makes to a pipeline
    operator that is or holds a ``HashAggregationOp`` reads the launch
    counter before and after."""
    from velox_tpu_torch.exec.fused import FusedScanAggOp
    from velox_tpu_torch.exec.operators import HashAggregationOp
    from velox_tpu_torch.ops import grouped_sum as gs

    by_step = {}
    for p in task.planner.pipelines:
        for op in p.operators:
            agg = op.agg if isinstance(op, FusedScanAggOp) else op
            if not isinstance(agg, HashAggregationOp):
                continue
            by_step[agg.step.name] = 0
            for name in ("add_input", "no_more_input", "get_output",
                         "is_finished", "needs_input"):
                def counted(*args, _call=getattr(op, name),
                            _step=agg.step.name):
                    before = gs.launches["grouped_multi_sum_i32"]
                    try:
                        return _call(*args)
                    finally:
                        by_step[_step] += (gs.launches["grouped_multi_sum_i32"]
                                           - before)
                setattr(op, name, counted)
    return by_step


def pydict(task) -> dict:
    """``run_plan``'s ``{column: [values]}`` of a ``Task``."""
    out = {n: [] for n in task.plan.output_type.names}
    for b in task.run():
        for n, vals in b.to_pydict().items():
            out[n].extend(vals)
    return out


def exact_distinct(li, grouping, oracle):
    """The true distinct count of ``l_partkey`` per group of ``oracle``
    (by ``l_suppkey``: the first 10,000 suppliers, a tenth of the rows:
    one sort), and which groups were counted."""
    pk = li["l_partkey"].astype(np.int64)
    span = int(pk.max()) + 1
    if grouping == "suppkey":
        sk = li["l_suppkey"].astype(np.int64)
        keys_s = oracle.keys["l_suppkey"]
        first = sk <= keys_s[min(9999, len(keys_s) - 1)]
        comb = np.unique(sk[first] * span + pk[first])
        exact = np.bincount(np.searchsorted(keys_s, comb // span),
                            minlength=len(keys_s))
        return exact, exact > 0
    seen = np.zeros(len(oracle.starts) * span, bool)
    seen[oracle.gids() * span + oracle.sorted("l_partkey")] = True
    return seen.reshape(len(oracle.starts), span).sum(axis=1), slice(None)


def approx_ratio(got, keys, exact, pick):
    """approx_distinct(l_partkey) over the true distinct count
    (``exact_distinct``), per group: (min, max) over the groups of at
    most 1024 distinct values (one a register: the estimate stays in its
    linear-counting range) and over the rest, and how many of the first
    lie beyond 10%. Those are held within 10%, but for the sketch's own
    tail: at 80 values in 1024 registers its spread is a few percent,
    and over 10^5 groups a few land 10-15% low, so at least 99.9% within
    10% and all within 20%. The reference's rank, which the port keeps,
    runs one above the leading-zero count of its 53-bit remainder, so
    past that range the estimate is about twice the count (capped at the
    group's rows)."""
    order = (np.lexsort([got[k][0] for k in reversed(keys)]) if keys
             else np.arange(1))
    exact = exact[pick]
    r = got["ad_pk"][0][order][pick] / exact
    small = exact <= 1024
    off = np.abs(r[small] - 1)
    check((off > 0.1).sum() <= 0.001 * len(off) and np.all(off <= 0.2),
          f"approx_distinct in the linear-counting range: "
          f"{r[small][off > 0.1]}")
    return {"linear": (float(r[small].min()), float(r[small].max()))
            if small.any() else None,
            "linear_groups": int(small.sum()),
            "linear_beyond_10pct": int((off > 0.1).sum()),
            "raw": (float(r[~small].min()), float(r[~small].max()))
            if (~small).any() else None}


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
    (median of warm runs) and profiled once. Returns the generated
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
    launches, peak device memory), timed (median of warm runs, the
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
    oracles = oracles_side_by_side(
        {name: (lambda o: lambda: o(store_sales))(ORACLES[name])
         for name in PLANS}, "phase 8")
    out = {}
    for name, (make, columns) in PLANS.items():
        want, oracle_s = oracles.pop(name)
        log(f"{name} oracle: {oracle_s:.3f} s on the host")
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

    # phase 16's W1: the window's buffer under a device budget, row for
    # row equal to its unspilled run (which equals its oracle, above),
    # restored one range of ss_store_sk at a time
    make, columns = PLANS["W1"]
    plan = make(PlanBuilder).build()

    def drain():
        for _ in Task(plan).run():
            pass

    from velox_tpu_torch.tpch.spill_plans import host_rows, same_rows

    # its batches go to the host as they come: the peak is the window's
    out["W1 spill"] = spill_run(
        "W1 window spill", drain, lambda: host_rows(Task(plan)),
        lambda g, w: same_rows(g, w, ordered=True), card)
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
    del cols
    torch.cuda.empty_cache()

    log(f"phase 3 (Q1, Q6): {(time.perf_counter() - t_phase):.3f} s")

    # 4. the joins: Q3 and Q18; 5. the other 18 queries
    t0 = time.perf_counter()
    joins = run_join_queries(card, times, (rows_q1, rev6))
    del rows_q1
    log(f"phases 4 and 5 (TPC-H joins, 18 more queries): "
        f"{(time.perf_counter() - t0):.3f} s")
    t_phase = time.perf_counter()

    # 6. timings
    for k, v in times.items():
        log(f"time {k}: {v} ms (median of 5 warm runs, of 3 in phases "
            f"14-16, one run alone past {SLOW_RUN_MS:.0f} ms, SF{SF}, "
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
    spill_runs = {}
    by_query = {"Q1 cents": q1_counts, "Q1 double": qd_counts,
                "Q6 cents": q6_counts}
    by_query.update({label: run for label, run in joins["runs"].items()})
    by_query.update({f"{q} cents": run for q, run in joins["more"].items()})
    by_query.update({f"scalar {n}": run
                     for n, run in joins["scalar"].items()})
    by_query.update({f"string {n}": run
                     for n, run in joins["strings"].items()})
    by_query.update(joins["join_agg"])
    by_query.update({k: r for k, r in joins["agg_steps"].items()
                     if isinstance(r, dict)})
    by_query.update({k: r for k, r in joins["collect"].items()
                     if isinstance(r, dict)})
    by_query.update(joins["complex"])
    by_query.update(joins["collect_rest"])
    by_query.update({k: r for k, r in joins["exchange"].items()
                     if "grouped_sum_i32" in r})
    for label, r in list(joins["spill"].items()) + [
            ("W1 window", windows.pop("W1 spill"))]:
        by_query[f"{label} unspilled"] = r["unspilled"]
        by_query[f"{label} spilled"] = r["spilled"]
        spill_runs[label] = r
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
                      "agg_steps": joins["agg_steps"],
                      "collect": joins["collect"],
                      "complex": joins["complex"],
                      "collect_rest": joins["collect_rest"],
                      "spill": spill_runs,
                      "exchange": joins["exchange"],
                      "rank_forms_ms": joins["rank_forms_ms"],
                      "tpcds_queries": ds, "window_plans": windows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
