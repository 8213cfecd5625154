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
4. time each query (median of 5 warm runs) and each kernel at Q1's shape
   on Q1's gids of split 0 and at G = 128 on uniform gids: ``ms`` is a
   call from Python between CUDA events, ``device_ms`` the device time of
   a call from CUDA graph replay (no host cost), beside its plain
   version, one ``index_add_`` over the same bins, and its bound (bytes
   moved / 3.35 TB/s);
5. print the kernels as one JSON line, the card line, and last the
   device line ``{"ok": true, "device": {...}}``.

It needs a CUDA card and the repository beside it; without either it
exits nonzero and prints no result.
"""

from __future__ import annotations

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


def device_breakdown(fn, label: str, wall: float, card: str) -> None:
    """One profiled run of ``fn``: device time by kernel (top 8) and the
    device busy share of the unprofiled median wall. Only the CUDA kernel
    rows count; the aten operator rows that launched them would count
    the same time twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile {label}: device busy {busy} ms of {wall} ms wall "
        f"(busy share {busy / wall}) on {card}")
    for ms, count, key in rows[:8]:
        log(f"profile {label}:   {ms} ms  x{count}  {key[:90]}")


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
    from velox_tpu_torch.utils import cuda_build
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
    check_kernels(gs)
    torch.cuda.synchronize()

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

    gs.reset_launches()
    got = run_plan(tpch_plan(1))
    torch.cuda.synchronize()
    q1_counts = dict(gs.launches)
    check(q1_counts == {"grouped_sum_i32": 0,
                        "grouped_multi_sum_i32": splits},
          f"decimal Q1 launches {q1_counts}, want B2 once per split")
    check_q1_cents(got, rows_q1)
    log(f"Q1 cents: exact; launches {q1_counts}")

    gs.reset_launches()
    got6 = run_plan(tpch_plan(6))
    torch.cuda.synchronize()
    q6_counts = dict(gs.launches)
    check(len(got6["revenue"]) == 1
          and int(got6["revenue"][0].scaleb(4)) == rev6, "Q6 revenue")
    log(f"Q6 cents: exact; launches {q6_counts}")

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
    gs.reset_launches()
    gotd = run_plan(tpch_plan(1))
    torch.cuda.synchronize()
    qd_counts = dict(gs.launches)
    check(qd_counts == {"grouped_sum_i32": splits,
                        "grouped_multi_sum_i32": 0},
          f"DOUBLE Q1 launches {qd_counts}, want B1 once per split")
    check_q1_double(gotd, rows_q1)
    log(f"Q1 double: within rtol={RTOL}; launches {qd_counts}")
    times["q1_double"] = wall_ms(lambda: run_plan(tpch_plan(1)))
    device_breakdown(lambda: run_plan(tpch_plan(1)), "q1_double",
                     times["q1_double"], card)
    drop_table("lineitem")
    del cols, rows_q1
    torch.cuda.empty_cache()

    # 4. timings
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

    # 5. report
    kernels = [
        dict(name="grouped_sum_i32", route="cuda", source=SOURCE,
             replaces="velox_tpu/ops/pallas_agg.py:32",
             launches=qd_counts["grouped_sum_i32"],
             **{k: b1[k] for k in ("max_abs_err", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}),
        dict(name="grouped_multi_sum_i32", route="cuda", source=SOURCE,
             replaces="velox_tpu/ops/pallas_agg.py:114",
             launches=q1_counts["grouped_multi_sum_i32"],
             **{k: b2[k] for k in ("max_abs_err", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}),
    ]
    check(all(k["max_abs_err"] == 0 for k in kernels), "kernel error")
    print(json.dumps({"kernels": kernels, "query_ms": times}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
