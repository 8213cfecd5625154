#!/usr/bin/env python3
"""Where a TPC-H query's warm wall time goes: host functions, host syncs
and the device's busy share, on one CUDA card.

    python3 -m velox_tpu_torch.tools.query_profile [--sf 10] \
        [--queries 3,18] [--plans on,off] [--top 25]

Registers the eight TPC-H tables at ``--sf`` on the card (decimal
cents, narrow lanes, splits of 2^23 rows, the seed ``chip_smoke.py``
uses); ``--queries`` takes any of the 22. For each query and plan shape (``on``: ``optimize_plans``, merge
joins and streaming aggregation; ``off``: hash joins and the generic
aggregation) it runs the query once to warm up, then:

1. the warm wall and the device breakdown, by ``chip_smoke.py``'s own
   ``wall_ms`` and ``device_breakdown``, with the host syncs of one run;
2. one run under ``cProfile``: the ``--top`` host functions by own time.
   A sync's wait for the device shows as own time of the torch call that
   read a device value (``item``, ``nonzero``, ``cpu``).

Each number is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time

from velox_tpu_torch.tools.grouped_sum_report import smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--queries", default="3,18")
    ap.add_argument("--plans", default="on,off")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch

    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.io.tpch import register_tpch_tables
    from velox_tpu_torch.tpch import tpch_plan
    from velox_tpu_torch.utils import syncs
    from velox_tpu_torch.utils.config import config

    if not torch.cuda.is_available():
        raise SystemExit("query_profile: no CUDA device is available")
    timing = smoke()
    card = timing.card_line()
    config.narrow_lanes = True
    t0 = time.perf_counter()
    register_tpch_tables(args.sf, timing.SEED, "cents", timing.SPLIT_ROWS,
                         device="cuda")
    print(f"registered SF{args.sf:g}: {time.perf_counter() - t0:.3f} s",
          flush=True)
    for plan in args.plans.split(","):
        config.optimize_plans = plan == "on"
        for q in (int(x) for x in args.queries.split(",")):
            label = f"Q{q} SF{args.sf:g} optimize_plans={plan}"

            def run():
                return run_plan(tpch_plan(q, args.sf))

            run()
            syncs.reset()
            run()
            n_syncs = syncs.count
            wall = timing.wall_ms(run)
            busy = timing.device_breakdown(run, label, wall, card)
            print(f"{label}: warm wall {wall} ms (median of 5), device "
                  f"busy {busy} ms (share {busy / wall}), host syncs "
                  f"{n_syncs}, on {card}", flush=True)
            prof = cProfile.Profile()
            prof.enable()
            run()
            torch.cuda.synchronize()
            prof.disable()
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime") \
                .print_stats(args.top)
            print(f"{label}: host functions by own time\n{out.getvalue()}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
