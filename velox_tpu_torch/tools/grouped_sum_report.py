#!/usr/bin/env python3
"""Registers, spills and a timing against an earlier version of the
grouped-sum kernel (``csrc/grouped_sum.cu``), on one CUDA card.

    python3 -m velox_tpu_torch.tools.grouped_sum_report [--parent DIR]

1. Compiles ``csrc/grouped_sum.cu`` with ``nvcc -Xptxas -v`` (the flags of
   ``cuda_build`` plus ``-Xptxas -v``) and prints, per kernel, its
   registers a thread, spill bytes and stack frame.
2. With ``--parent DIR``, DIR an unpacked checkout of an earlier commit
   (``git archive``), times the kernels of that checkout and of this one
   in turns (parent, current, current, parent), each turn a process of
   its own that imports ``velox_tpu_torch`` from its checkout and calls
   that checkout's wrappers ``grouped_multi_sum_i32`` (L = 17) and
   ``grouped_sum_i32`` (L = 1), so each version runs with its own C entry
   and host code. Each result is checked against the plain version.
   Shapes: n = 2^23 rows; G = 12 on TPC-H Q1's gids (the generator's
   lineitem at SF2, first 2^23 rows, code rf + 4 ls, sentinel 12 where
   l_shipdate > 1998-09-02), G = 12 on a synthetic skew (98% of rows in 4
   groups) and G = 128 on uniform gids over [-3, G]. Two times a call, as
   ``chip_smoke.py`` takes them: ``ms``, calls from Python between CUDA
   events, and ``device_ms``, calls captured in a CUDA graph and
   replayed; each beside the card's name and power limit.
3. The host cost of a call of this checkout's B1 wrapper: the host clock
   over 500 calls on 4096 rows (too few for the device to hold the host
   back), and B1's ``ms`` and ``device_ms`` on Q1's gids, first in a fresh
   process and then after one ``torch.profiler`` session in it, as
   ``chip_smoke.py`` times its kernels after its profiles.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 20240601
ROWS = 1 << 23
SHIP_Q1 = 10471  # DATE '1998-12-01' - 90 days
REPO = Path(__file__).resolve().parents[2]
SHAPES = (("q1", 17, 12), ("q1", 1, 12), ("skew", 17, 12), ("skew", 1, 12),
          ("uniform", 17, 128), ("uniform", 1, 128))


def smoke():
    """``chip_smoke.py`` of this checkout, for its timing helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timing",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report() -> None:
    from velox_tpu_torch.utils import cuda_build

    with tempfile.TemporaryDirectory() as tmp:
        done = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(Path(tmp) / "lib.so"),
             str(cuda_build.CSRC / "grouped_sum.cu")],
            capture_output=True, text=True, check=True)
    text = done.stdout + done.stderr
    name = frame = stores = loads = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.sub(r"^_ZN\w*?(grouped_sum_mma|sum_partials)", r"\1",
                          m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame, stores, loads = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"ptxas {name}: {m.group(1)} registers, stack frame "
                  f"{frame} B, spill stores {stores} B, spill loads "
                  f"{loads} B", flush=True)


def save_q1_gids(path: Path) -> None:
    import numpy as np

    from velox_tpu_torch.io.tpch import lineitem_columns

    cols, _ = lineitem_columns(2, SEED)
    ship = cols["l_shipdate"][:ROWS].astype(np.int64)
    gid = (cols["l_returnflag"][:ROWS] + 4 * cols["l_linestatus"][:ROWS])
    np.save(path, np.where(ship <= SHIP_Q1, gid, 12).astype(np.int32))


def gid_mix(mix: str, G: int, q1_path: Path):
    import numpy as np
    import torch

    if mix == "q1":
        return torch.from_numpy(np.load(q1_path)).cuda()
    g = torch.Generator(device="cuda").manual_seed(G)
    if mix == "uniform":
        return torch.randint(-3, G + 1, (ROWS,), generator=g, device="cuda",
                             dtype=torch.int32)
    heavy = min(G, 4)
    w = torch.full((G + 1,), 0.02 / max(G + 1 - heavy, 1), device="cuda")
    w[:heavy] = 0.98 / heavy
    gids = torch.multinomial(w, ROWS, replacement=True,
                             generator=g).to(torch.int32)
    gids[::97] = -1
    return gids


def worker(root: Path, q1_path: Path) -> None:
    """Time the wrappers of the checkout at ``root``; one JSON line a
    shape."""
    import torch

    sys.path.insert(0, str(root))
    from velox_tpu_torch.ops import grouped_sum as gs

    assert Path(gs.__file__).resolve().is_relative_to(root.resolve())
    timing = smoke()
    top = 2 ** 31 - 1
    for mix, L, G in SHAPES:
        gids = gid_mix(mix, G, q1_path)
        g = torch.Generator(device="cuda").manual_seed(L)
        vals = torch.randint(-top, top, (L, ROWS), generator=g,
                             device="cuda", dtype=torch.int64
                             ).to(torch.int32).contiguous()
        if L == 1:
            v1 = vals[0]
            fn = lambda: gs.grouped_sum_i32(gids, v1, G)          # noqa: E731
            want = gs.grouped_sum_i32_plain(gids, v1, G)
        else:
            fn = lambda: gs.grouped_multi_sum_i32(gids, vals, G)  # noqa: E731
            want = gs.grouped_multi_sum_i32_plain(gids, vals, G)
        if not torch.equal(fn(), want):
            raise SystemExit(f"kernel of {root} differs from plain at "
                             f"{mix} L={L} G={G}")
        print(json.dumps({"mix": mix, "L": L, "G": G,
                          "ms": timing.cuda_ms(fn),
                          "device_ms": timing.graph_ms(fn)}), flush=True)


def host_cost(q1_path: Path, card: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from velox_tpu_torch.ops import grouped_sum as gs

    timing = smoke()
    small_g = torch.zeros(4096, dtype=torch.int32, device="cuda")
    small_v = torch.ones(4096, dtype=torch.int32, device="cuda")
    gids = gid_mix("q1", 12, q1_path)
    g = torch.Generator(device="cuda").manual_seed(1)
    vals = torch.randint(-2 ** 31 + 1, 2 ** 31 - 1, (ROWS,), generator=g,
                         device="cuda", dtype=torch.int64).to(torch.int32)

    def host_us(calls: int = 500) -> float:
        for _ in range(10):
            gs.grouped_sum_i32(small_g, small_v, 12)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            gs.grouped_sum_i32(small_g, small_v, 12)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def b1():
        return gs.grouped_sum_i32(gids, vals, 12)

    for state in ("fresh process", "after a torch.profiler session"):
        if state != "fresh process":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                b1()
                torch.cuda.synchronize()
        print(f"host B1 ({state}): {host_us()} us a call on 4096 rows; "
              f"n={ROWS} L=1 G=12 on Q1's gids: ms {timing.cuda_ms(b1)}, "
              f"device_ms {timing.graph_ms(b1)} on {card}", flush=True)


def compare(parent: Path, q1_path: Path, card: str) -> None:
    runs = []
    for root in (parent, REPO, REPO, parent):
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root.resolve()), "--q1-gids", str(q1_path)],
            capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"timing {root} failed:\n{done.stdout}\n"
                             f"{done.stderr}")
        runs.append([json.loads(line) for line in done.stdout.splitlines()
                     if line.startswith("{")])
    for i, (mix, L, G) in enumerate(SHAPES):
        t = [run[i] for run in runs]
        for key, what in (("ms", "a call from Python"),
                          ("device_ms", "device time, graph replay")):
            print(f"time {mix} L={L} G={G} n={ROWS} ({key}, {what}): parent "
                  f"{t[0][key]} {t[3][key]} ms, current {t[1][key]} "
                  f"{t[2][key]} ms on {card}", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="unpacked checkout of an earlier commit to time")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--q1-gids", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grouped_sum_report: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        worker(args.worker, args.q1_gids)
        return 0
    card = smoke().card_line()
    print(f"card: {card}", flush=True)
    ptxas_report()
    with tempfile.TemporaryDirectory() as tmp:
        q1_path = Path(tmp) / "q1_gids.npy"
        save_q1_gids(q1_path)
        if args.parent:
            compare(args.parent, q1_path, card)
        host_cost(q1_path, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
