#!/usr/bin/env python3
"""Every TPC-H query through ``run_plan_distributed`` against the serial
``run_plan``: the strategy each takes, whether the results agree, and the
walls of both.

    python3 -m velox_tpu_torch.tools.distributed_rehearsal \
        [--sf 0.01] [--shards 8] [--device cpu] [--out PATH]

Registers the eight seeded TPC-H tables at ``--sf`` (decimal cents,
narrow lanes, splits of 2^14 rows, or 2^23 on a card) on ``--device``
(default: the CUDA card), makes a mesh of ``--shards`` shards there and
runs the 22 queries, each serial, then distributed, compared by
``tpch/dist_plans.same_result``. It prints one line a query and a JSON
summary, or writes the summary to ``--out``; the JAX package's own
record (``DISTRIBUTED_REHEARSAL.json``) is never touched. A query whose
distributed run raises is recorded with its error.
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from velox_tpu_torch import resolve_device
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.io.tpch import register_tpch_tables
    from velox_tpu_torch.parallel import make_mesh, runner
    from velox_tpu_torch.tpch import tpch_plan
    from velox_tpu_torch.tpch.dist_plans import STRATEGY, same_result
    from velox_tpu_torch.utils.config import config

    device = resolve_device(args.device)
    config.narrow_lanes = True
    split = 1 << 23 if device.type == "cuda" else 1 << 14
    register_tpch_tables(args.sf, 20240601, "cents", split, device=device)
    mesh = make_mesh(args.shards, device=device)

    report = {}
    for q in range(1, 23):
        t0 = time.perf_counter()
        want = run_plan(tpch_plan(q, args.sf))
        serial_ms = (time.perf_counter() - t0) * 1e3
        runner.last_strategy = ""
        t0 = time.perf_counter()
        try:
            got = runner.run_plan_distributed(tpch_plan(q, args.sf), mesh)
            dist_ms = (time.perf_counter() - t0) * 1e3
            how, bad = same_result(got, want, tpch_plan(q, args.sf).build())
            status = how if not bad else f"MISMATCH: {bad}"
            strategy = runner.last_strategy
        except Exception as e:   # noqa: BLE001 -- recorded, then go on
            dist_ms = (time.perf_counter() - t0) * 1e3
            strategy, status = "ERROR", f"{type(e).__name__}: {e}"[:200]
        rows = len(next(iter(want.values()), []))
        report[f"q{q}"] = {"strategy": strategy,
                           "reference_strategy": STRATEGY[q],
                           "status": status, "rows": rows,
                           "serial_ms": serial_ms, "dist_ms": dist_ms}
        print(f"q{q:>2}: {strategy:22s} (reference {STRATEGY[q]}) {status} "
              f"({rows} rows, serial {serial_ms:.1f} ms, distributed "
              f"{dist_ms:.1f} ms)", flush=True)
    summary = {
        "sf": args.sf, "shards": args.shards, "device": str(device),
        "queries_distributed": sum(
            r["strategy"] not in ("serial_fallback", "ERROR")
            for r in report.values()),
        "queries_matching_serial": sum(
            not r["status"].startswith(("MISMATCH", "ERROR"))
            and r["strategy"] != "ERROR" for r in report.values()),
        "strategies_as_reference": sum(
            r["strategy"] == r["reference_strategy"]
            for r in report.values()),
        "queries": report}
    text = json.dumps(summary, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    ok = summary["queries_matching_serial"] == 22
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
