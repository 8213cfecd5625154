"""The port's ``ops/hash.py`` against the JAX package's, bit for bit, on
the CPU: the splitmix64 finalizer over every lane type the engine hashes
(int32, int64, bool, float32, float64; 0, -1, the int64 extremes, +-0.0,
NaN of either sign, the infinities), the row hash of several columns with
NULLs, the order-dependent combine, the partition of hashes above 2^63
(an unsigned modulo), and the Hive bucket hash. The JAX package returns
uint64 where the port returns int64: the bits are compared.

XLA on the CPU flushes a subnormal double to zero before it hashes; the
port hashes the double's own bits, held against a plain-Python
splitmix64 (the float inputs here are otherwise normal or zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu.ops import hash as jax_hash
from velox_tpu_torch.ops import hash as torch_hash

I64 = np.iinfo(np.int64)
rng = np.random.default_rng(20240617)

FLOATS = np.concatenate([
    [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0, -1.0, 1.5e300,
     -2.5e-300, np.finfo(np.float64).max, np.finfo(np.float64).tiny],
    rng.standard_normal(500) * 1e6])
INTS = np.concatenate([
    [0, -1, 1, I64.min, I64.max, I64.min + 1, 2 ** 31, -2 ** 31 - 1],
    rng.integers(I64.min, I64.max, 500, dtype=np.int64)])

with np.errstate(over="ignore"):    # 1.5e300 is +inf as a float32
    VALUES = {
        "int64": INTS,
        "int32": INTS.astype(np.int32),
        "bool": INTS % 3 == 0,
        "float64": FLOATS,
        "float32": FLOATS.astype(np.float32),
    }


def _jax_bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _port(fn, *arrays, **kw):
    return fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
              **kw).numpy()


@pytest.mark.parametrize("dtype", list(VALUES))
def test_hash_i64_matches_jax(dtype):
    x = VALUES[dtype]
    got = _port(torch_hash.hash_i64, x)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, _jax_bits(jax_hash.hash_i64(jnp.asarray(x))))


def _splitmix64(v: int) -> int:
    """The finalizer in plain Python integers, on 64-bit patterns."""
    m = (1 << 64) - 1
    z = v & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    z = z ^ (z >> 31)
    return z - (1 << 64) if z >> 63 else z


def test_subnormal_doubles_hash_their_bits():
    """Where the JAX package (XLA on the CPU) hashes a subnormal as 0,
    the port hashes its bits; every other double equals plain Python."""
    x = np.concatenate([np.array([5e-324, -5e-324, 1e-310, 2.2e-308]),
                        FLOATS[~np.isnan(FLOATS)]])
    got = _port(torch_hash.hash_i64, x)
    bits = np.where(x == 0, 0.0, x).view(np.int64)
    assert got.tolist() == [_splitmix64(int(b)) for b in bits]
    jax_sub = _jax_bits(jax_hash.hash_i64(jnp.asarray(x[:2])))
    assert jax_sub.tolist() == [0, 0]     # flushed to +0.0


def test_hash_columns_and_combine_match_jax_with_nulls():
    n = len(INTS)
    cols = [(INTS, rng.random(n) < 0.8), (FLOATS[:n], None),
            (INTS.astype(np.int32), rng.random(n) < 0.5),
            (INTS % 2 == 0, None)]
    for k in range(1, len(cols) + 1):
        got = torch_hash.hash_columns([
            (torch.from_numpy(v), None if m is None else torch.from_numpy(m))
            for v, m in cols[:k]]).numpy()
        want = jax_hash.hash_columns([
            (jnp.asarray(v), None if m is None else jnp.asarray(m))
            for v, m in cols[:k]])
        np.testing.assert_array_equal(got, _jax_bits(want), f"{k} columns")
    # a NULL row hashes as 0 whatever its value
    v = np.array([7, 7], np.int64)
    assert torch_hash.hash_columns([(torch.from_numpy(v), torch.tensor(
        [False, True]))]).tolist()[0] == 0
    # the combine alone, over hashes of either sign
    h = _port(torch_hash.hash_i64, INTS)
    h2 = _port(torch_hash.hash_i64, INTS[::-1].copy())
    got = torch_hash.combine_hash(torch.from_numpy(h),
                                  torch.from_numpy(h2)).numpy()
    want = jax_hash.combine_hash(jnp.asarray(h.view(np.uint64)),
                                 jnp.asarray(h2.view(np.uint64)))
    np.testing.assert_array_equal(got, _jax_bits(want))


def test_partition_ids_unsigned_above_2_63():
    h = _port(torch_hash.hash_i64, INTS)
    h = np.concatenate([h, [-1, I64.min, I64.max, 0]]).astype(np.int64)
    assert (h < 0).sum() > 100        # hashes above 2^63 as unsigned
    for parts in (1, 2, 3, 7, 8, 1000, 65537, 2 ** 31 - 1):
        got = torch_hash.partition_ids(torch.from_numpy(h), parts).numpy()
        want = np.asarray(jax_hash.partition_ids(
            jnp.asarray(h.view(np.uint64)), parts))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, f"{parts} partitions")
        assert np.array_equal(got, (h.view(np.uint64) % np.uint64(parts))
                              .astype(np.int32))


@pytest.mark.parametrize("dtype", ["int64", "int32", "bool", "float64"])
def test_hive_hash_and_buckets_match_jax(dtype):
    """Integers by value ((v >> 32) ^ v for 64 bits), a DOUBLE through
    its float32 bits (the JAX package's choice), NULLs as 0, combined by
    31 * h + h2; buckets (h & MAX_INT) % n."""
    x = VALUES[dtype]
    if dtype == "float64":
        x = x[np.isfinite(x) & (np.abs(x) < 1e30)]
    valid = rng.random(len(x)) < 0.7
    cols_t = [(torch.from_numpy(x), torch.from_numpy(valid)),
              (torch.from_numpy(INTS[:len(x)]), None)]
    cols_j = [(jnp.asarray(x), jnp.asarray(valid)),
              (jnp.asarray(INTS[:len(x)]), None)]
    np.testing.assert_array_equal(torch_hash.hive_hash_columns(cols_t).numpy(),
                                  np.asarray(jax_hash.hive_hash_columns(cols_j)))
    for buckets in (1, 16, 1000):
        np.testing.assert_array_equal(
            torch_hash.hive_bucket_ids(cols_t, buckets).numpy(),
            np.asarray(jax_hash.hive_bucket_ids(cols_j, buckets)))
