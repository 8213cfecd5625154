"""64-bit mixing hashes for partitioning and shuffle, over torch.

The port of the JAX package's ``ops/hash.py`` (velox's VectorHasher and
HashPartitionFunction analog). Hashing never serves lookup here (joins
and group-by use sorted indices): it scatters rows across partitions, so
only avalanche matters, and splitmix64's finalizer gives it.

Every result equals the JAX package's bit for bit. torch's ``uint64``
lacks shifts and remainders, so the hashes live in ``int64``: two's-
complement multiplication wraps to the same bits as the unsigned one, a
logical right shift is an arithmetic shift masked to its low
``64 - s`` bits, and the constants above 2^63 are written as the signed
values with the same bits. ``hash_i64`` and ``hash_columns`` return those
int64 bits where the reference returns uint64.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _signed(u: int) -> int:
    """The int64 with the same 64 bits as the unsigned ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)
_GOLDEN = _signed(0x9E3779B97F4A7C15)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _u64(x: torch.Tensor) -> torch.Tensor:
    """The value's 64 hash bits: integers sign-extended, floats by their
    bits after -0.0 and NaN are made canonical (a float32 through its
    32 bits, sign-extended)."""
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    if x.dtype.is_floating_point:
        # normalize -0.0/+0.0 and NaNs so equal SQL values hash equal
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = torch.where(x == 0, zero, x)
        x = torch.where(torch.isnan(x), zero + float("nan"), x)
        width = torch.int32 if x.dtype == torch.float32 else torch.int64
        x = x.view(width)
    return x.to(torch.int64)


def hash_i64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer; the uint64 result's bits as int64."""
    z = _u64(x)
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def combine_hash(h: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Order-dependent combine (boost::hash_combine shape)."""
    return h ^ (h2 + _GOLDEN + (h << 6) + _shr(h, 2))


def hash_columns(
    cols: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
) -> torch.Tensor:
    """Row hash over several (values, valid) columns; nulls hash as 0."""
    out = None
    for values, valid in cols:
        if valid is not None:
            values = torch.where(valid, values, torch.zeros_like(values))
        h = hash_i64(values)
        if valid is not None:
            h = torch.where(valid, h, torch.zeros_like(h))
        out = h if out is None else combine_hash(out, h)
    if out is None:
        raise ValueError("hash_columns takes at least one column")
    return out


def partition_ids(row_hash: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """hash -> partition in [0, num_partitions) (int32), the hash read as
    unsigned: a negative int64 ``h`` stands for ``h + 2^64``."""
    p = int(num_partitions)
    r = torch.remainder(row_hash, p)
    wrapped = torch.remainder(r + (1 << 64) % p, p)
    return torch.where(row_hash < 0, wrapped, r).to(torch.int32)


def hive_hash_columns(
    cols: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
) -> torch.Tensor:
    """Hive-compatible bucket hash (velox/connectors/hive/HivePartition
    Function.h): an integer hashes to its own value (Java hashCode), a
    64-bit one to ``(v >> 32) ^ v``, a floating value to the bits of its
    float32 (as the JAX package does; Java hashes a double's 64 bits);
    combined by ``31 * h + h2`` in int32; nulls contribute 0."""
    out = None
    for values, valid in cols:
        v = values.to(torch.int32) if values.dtype == torch.bool else values
        if not v.dtype.is_floating_point:
            if v.element_size() > 4:
                v64 = v.to(torch.int64)
                h = ((v64 >> 32) ^ v64).to(torch.int32)
            else:
                h = v.to(torch.int32)
        else:
            h = v.to(torch.float32).view(torch.int32)
        if valid is not None:
            h = torch.where(valid, h, torch.zeros_like(h))
        out = h if out is None else out * 31 + h
    if out is None:
        raise ValueError("hive_hash_columns takes at least one column")
    return out


def hive_bucket_ids(cols, num_buckets: int) -> torch.Tensor:
    """(hash & Integer.MAX_VALUE) % buckets: Hive's bucket function."""
    h = hive_hash_columns(cols)
    return (h & 0x7FFFFFFF) % int(num_buckets)
