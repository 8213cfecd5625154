"""Time the 84 TPC-DS ``FULL_QUERIES`` on one device.

    python3 -m velox_tpu_torch.tools.tpcds_full_times --sf 1 --device cpu

Generates the 24 tables of ``velox_tpu_torch.io.tpcds_full`` (seed 7),
registers them on ``--device`` in splits of 2^23 rows, and runs each
query once (``FULL_PARAMS``, the default session config with
``optimize_plans`` on), printing its rows and wall ms (host clock; on a
card, ending in a synchronize), then the seconds of generation and
registration and the queries' total. Chip_smoke's phase 20 runs these
plans twice, on the card and over CPU copies; this is how the scale of
its CPU side was chosen.
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    import torch

    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.io.tpcds_full import register_full
    from velox_tpu_torch.tpcds import FULL_PARAMS, FULL_QUERIES, tpcds_plan
    from velox_tpu_torch.utils.config import config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args()
    on_card = args.device is None or str(args.device).startswith("cuda")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config.optimize_plans = True
    t0 = time.perf_counter()
    register_full(args.sf, 1 << 23, args.seed, device=args.device)
    sync()
    print(f"generated and registered SF{args.sf:g} on "
          f"{args.device or 'cuda'}: {time.perf_counter() - t0:.3f} s",
          flush=True)
    total = 0.0
    for q in FULL_QUERIES:
        t = time.perf_counter()
        got = run_plan(tpcds_plan(q, **FULL_PARAMS.get(q, {})))
        sync()
        ms = (time.perf_counter() - t) * 1e3
        total += ms
        print(f"q{q}: {len(next(iter(got.values())))} rows, {ms:.2f} ms",
              flush=True)
    print(f"total: {total / 1e3:.3f} s for {len(FULL_QUERIES)} queries")


if __name__ == "__main__":
    main()
