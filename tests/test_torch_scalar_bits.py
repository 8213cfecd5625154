"""The bitwise functions and device hashes of the port's scalar surface
against the JAX package, on one small hand-made table with NULLs and the
int32 and int64 extremes: ``bitwise_and``/``or``/``xor``/``not``, every
shift name at every shift amount from -1 to 70 over INTEGER and BIGINT
lanes, the windowed shifts at widths 1 to 64, ``bit_count``, and
``xxhash64_internal``/``combine_hash_internal`` bit for bit, over int64
extremes and floats including -0.0, NaN and +-inf, and against a plain
Python XXH64 of the value's 8 little-endian bytes. Every result must be
equal. The JAX rows are computed once per module."""

import struct

import numpy as np
import pytest

from torch_tpch_data import assert_same, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

N = 144                                 # 2 rows for each shift -1..70
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)
SHIFT_NAMES = ["bitwise_left_shift", "bitwise_right_shift",
               "bitwise_arithmetic_shift_right",
               "bitwise_right_shift_arithmetic"]

PROJECTIONS = {
    "logic": {
        "and_i": "bitwise_and(i, k)", "or_i": "bitwise_or(i, k)",
        "xor_i": "bitwise_xor(i, k)", "not_i": "bitwise_not(i)",
        "and_j": "bitwise_and(j, 255)", "or_j": "bitwise_or(j, q)",
        "xor_j": "bitwise_xor(j, q)", "not_j": "bitwise_not(j)",
        "and_ij": "bitwise_and(i, j)",
    },
    "shifts_bigint": {f"{n}_i": f"{n}(i, s)" for n in SHIFT_NAMES},
    "shifts_integer": {f"{n}_j": f"{n}(j, t)" for n in SHIFT_NAMES},
    "shifts_windowed": {
        "lsr_bits": "bitwise_logical_shift_right(i, s, w)",
        "lsr_64": "bitwise_logical_shift_right(k, t, 64)",
        "shl_bits": "bitwise_shift_left(i, s, w)",
        "shl_j": "bitwise_shift_left(j, t, w)",
    },
    "bit_count": {
        "bc_i": "bit_count(i, 64)", "bc_j": "bit_count(j, 32)",
        "bc_k": "bit_count(k, w)",
    },
    "hashes": {
        "xx_i": "xxhash64_internal(i)", "xx_j": "xxhash64_internal(j)",
        "xx_f": "xxhash64_internal(f)", "xx_k": "xxhash64_internal(k)",
        "combine": "combine_hash_internal(xxhash64_internal(i), "
                   "xxhash64_internal(f))",
        "combine_ij": "combine_hash_internal(i, j)",
    },
}


def _columns():
    rng = np.random.default_rng(20240613)
    i = rng.integers(I64.min, I64.max, N, endpoint=True)
    i[:8] = [0, -1, 1, I64.max, I64.min, I64.min + 1, 5, -5]
    j = rng.integers(I32.min, I32.max, N, endpoint=True).astype(np.int32)
    j[:6] = [0, -1, 1, I32.max, I32.min, -5]
    f = rng.normal(0, 1e6, N)
    f[:8] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 5e-324]
    cols = {
        "i": i, "j": j, "f": f,
        "k": rng.integers(-1000, 1000, N),
        "q": rng.integers(-7, 8, N).astype(np.int32),
        # every shift amount from -1 to 70, twice
        "s": np.tile(np.arange(-1, 71), 2),
        "t": np.tile(np.arange(-1, 71), 2).astype(np.int32),
        "w": rng.integers(1, 65, N),
    }
    cols["w"][:3] = [64, 1, 63]
    nulls = {"k": rng.random(N) < 0.15, "q": rng.random(N) < 0.15}
    return cols, nulls


@pytest.fixture(scope="module")
def rows():
    cols, nulls = _columns()
    batches = values_in_both(cols, nulls)
    cache = {}

    def plan(builder, which, group):
        return builder().values(batches[which]).project(
            [f"{e} AS {n}" for n, e in PROJECTIONS[group].items()])

    def get(group):
        if group not in cache:
            cache[group] = jax_run_plan(
                plan(JaxPlanBuilder, 0, group).build()).to_pydict()
        return cache[group], torch_run_plan(plan(TorchPlanBuilder, 1, group))

    get.columns = cols
    return get


#: the row of ``f`` that holds the subnormal 5e-324
SUBNORMAL = 7


@pytest.mark.parametrize("group", list(PROJECTIONS))
def test_bitwise_matches_jax(rows, group):
    exp, got = rows(group)
    if group == "hashes":
        # XLA on the CPU flushes the subnormal double to zero before the
        # JAX package hashes it; the port hashes its bits, as velox does
        # (held against plain XXH64 below). Every other row is equal.
        exp = dict(exp)
        for c in ("xx_f", "combine"):
            assert got[c][SUBNORMAL] != exp[c][SUBNORMAL]
            exp[c] = (exp[c][:SUBNORMAL] + [got[c][SUBNORMAL]]
                      + exp[c][SUBNORMAL + 1:])
    assert_same(got, exp, group)


def _xxh64_8(v: int) -> int:
    """XXH64 of the 8 little-endian bytes of ``v`` (seed 0), as a signed
    int64, in plain Python integers."""
    mask = (1 << 64) - 1
    p1, p2, p3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    p4, p5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & mask

    k1 = rotl((v & mask) * p2 & mask, 31) * p1 & mask
    h = ((p5 + 8) & mask) ^ k1
    h = (rotl(h, 27) * p1 + p4) & mask
    h = (h ^ (h >> 33)) * p2 & mask
    h = (h ^ (h >> 29)) * p3 & mask
    h ^= h >> 32
    return h - (1 << 64) if h >> 63 else h


def test_hashes_against_plain_xxh64(rows):
    """The port's hashes are XXH64 itself: integers hash their int64
    value, doubles their bits with -0.0 taken as 0.0."""
    _, got = rows("hashes")
    cols = rows.columns
    assert got["xx_i"] == [_xxh64_8(int(v)) for v in cols["i"]]
    assert got["xx_j"] == [_xxh64_8(int(v)) for v in cols["j"]]
    bits = [struct.unpack("<q", struct.pack("<d", 0.0 if v == 0 else v))[0]
            for v in cols["f"]]
    assert got["xx_f"] == [_xxh64_8(b) for b in bits]
    assert got["xx_f"][0] == got["xx_f"][1]          # -0.0 hashes as 0.0
    assert cols["f"][SUBNORMAL] == 5e-324 and bits[SUBNORMAL] == 1
