"""Bloom-filter bitmask for dynamic join filters (the port of the JAX
package's ``ops/bloom.py``).

The words are built on the host with numpy (uint64) and probed on the
device with torch. Both sides hash with one function, two murmur3 fmix64
rounds. torch has no uint64 arithmetic, so the device side runs it on
int64: a multiply keeps the same low 64 bits, and a logical right shift
is an arithmetic one masked to the bits that came from the value.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = np.uint64(0xFF51AFD7ED558CCD)
_C2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix64_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(33)
    x *= _C1
    x ^= x >> np.uint64(33)
    x *= _C2
    x ^= x >> np.uint64(33)
    return x


def build_bloom(values: np.ndarray, bits_per_key: int = 16) -> np.ndarray:
    """uint64 word array with two bits set per distinct value."""
    n = max(len(values), 1)
    nbits = 1 << int(np.ceil(np.log2(max(n * bits_per_key, 128))))
    h = _mix64_np(values.astype(np.int64).view(np.uint64)
                  if values.dtype != np.uint64 else values)
    mask = np.uint64(nbits - 1)
    # bit b of the filter is bit (b & 63) of word b >> 6: set the bits in
    # a byte-per-bit array and pack it little-endian, which is that layout
    # (a scattered ``np.bitwise_or.at`` into the words took 65-190 ms for
    # TPC-H Q3's two SF10 builds, 1.75M keys)
    bits = np.zeros(nbits, dtype=np.bool_)
    for shift in (np.uint64(0), np.uint64(32)):
        bits[((h >> shift) & mask).astype(np.int64)] = True
    return np.packbits(bits, bitorder="little").view("<u8").astype(
        np.uint64)


def _signed(c: np.uint64) -> int:
    return int(np.array(c, dtype=np.uint64).view(np.int64))


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def bloom_contains_device(v: torch.Tensor,
                          words: torch.Tensor) -> torch.Tensor:
    """Device membership test (two bits; false positives only).
    ``words`` is the uint64 word array viewed as int64, on ``v``'s
    device."""
    x = v.to(torch.int64)
    x = x ^ _lsr(x, 33)
    x = x * _signed(_C1)
    x = x ^ _lsr(x, 33)
    x = x * _signed(_C2)
    x = x ^ _lsr(x, 33)
    nbits = words.shape[0] * 64
    out = None
    for shift in (0, 32):
        b = _lsr(x, shift) & (nbits - 1) if shift else x & (nbits - 1)
        w = words.index_select(0, b >> 6)
        hit = (w >> (b & 63)) & 1
        out = hit if out is None else out & hit
    return out != 0
