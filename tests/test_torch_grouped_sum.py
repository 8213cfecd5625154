"""Grouped-sum kernels B1/B2: the port's plain torch versions against the
JAX package's Pallas kernels (interpret mode on the CPU), exactly.

On a CPU tensor the port's wrappers run the plain version; the CUDA
kernels themselves are checked against it on the card by chip_smoke.py.
A numpy model of the kernel's integer arithmetic checks its exactness
argument here.
"""

import ctypes
import re
from contextlib import nullcontext
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu.ops.pallas_agg import grouped_multi_sum_i32 as jax_multi
from velox_tpu.ops.pallas_agg import grouped_sum_i32 as jax_single
from velox_tpu_torch.ops import grouped_sum as gs

N = 70_000
I32_MAX = 2 ** 31 - 1


def _inputs(seed: int, L: int, G: int):
    """gids with sentinels (G and negatives), values spanning the whole
    domain, every 7th row at +-(2^31 - 1)."""
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, G + 1, N).astype(np.int32)
    gids[::97] = -1
    vals = rng.integers(-I32_MAX, I32_MAX, (L, N), endpoint=True
                        ).astype(np.int32)
    vals[:, ::7] = I32_MAX
    vals[:, 3::7] = -I32_MAX
    return gids, vals


def _exact(gids, vals, G):
    return np.stack([vals[:, gids == g].astype(np.int64).sum(axis=1)
                     for g in range(G)], axis=1)


@pytest.mark.parametrize("G", [2, 12, 128])
@pytest.mark.parametrize("L", [1, 5, 17])
def test_multi_sum_matches_pallas(G, L):
    gids, vals = _inputs(1000 * G + L, L, G)
    ref = np.asarray(jax_multi(jnp.asarray(gids), jnp.asarray(vals), G,
                               interpret=True))
    got = gs.grouped_multi_sum_i32(torch.from_numpy(gids),
                                   torch.from_numpy(vals), G)
    assert got.dtype == torch.int64 and tuple(got.shape) == (L, G)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, _exact(gids, vals, G))


@pytest.mark.parametrize("G", [2, 12, 128])
def test_single_sum_matches_pallas(G):
    gids, vals = _inputs(G, 1, G)
    ref = np.asarray(jax_single(jnp.asarray(gids), jnp.asarray(vals[0]), G,
                                interpret=True))
    got = gs.grouped_sum_i32(torch.from_numpy(gids),
                             torch.from_numpy(vals[0]), G)
    assert got.dtype == torch.int64 and tuple(got.shape) == (G,)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_tensors_take_the_plain_version():
    gids, vals = _inputs(5, 3, 12)
    gs.reset_launches()
    got = gs.grouped_multi_sum_i32(torch.from_numpy(gids),
                                   torch.from_numpy(vals), 12)
    plain = gs.grouped_multi_sum_i32_plain(torch.from_numpy(gids),
                                           torch.from_numpy(vals), 12)
    assert torch.equal(got, plain)
    assert gs.launches == {"grouped_sum_i32": 0, "grouped_multi_sum_i32": 0}


class _FakeLibrary:
    """Stands in for the built CUDA library: records the launches and
    returns a fixed CUDA error code."""

    def __init__(self, err: int):
        self.err = err
        self.calls = []

    def vt_grouped_sum_i32(self, *args):
        self.calls.append(args)
        return self.err


@pytest.mark.parametrize("case", ["empty", "launched", "launch_error"])
def test_launch_counter_counts_only_kernel_launches(case, monkeypatch):
    """``launches`` rises by one where the kernel launched, and not for an
    empty input (nothing launched) or a failed launch."""
    lib = _FakeLibrary(err=1 if case == "launch_error" else 0)
    monkeypatch.setattr(gs, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), {
                            "multi_processor_count": 132}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    n = 0 if case == "empty" else 1000
    gids = torch.zeros(n, dtype=torch.int32)
    vals = torch.ones((3, n), dtype=torch.int32)
    gs.reset_launches()
    if case == "launch_error":
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            gs._launch(gids, vals, 12, "grouped_multi_sum_i32")
    else:
        out = gs._launch(gids, vals, 12, "grouped_multi_sum_i32")
        assert tuple(out.shape) == (3, 12) and out.dtype == torch.int64
    want = 1 if case == "launched" else 0
    assert gs.launches == {"grouped_sum_i32": 0,
                           "grouped_multi_sum_i32": want}
    assert len(lib.calls) == (0 if case == "empty" else 1)
    if lib.calls:
        # n, L, G, then scratch for at most 4 blocks per SM and the SMs
        assert lib.calls[0][2:5] == (n, 3, 12)
        assert lib.calls[0][6:8] == (4 * 132, 132)
    gs.reset_launches()


class _CopyingLibrary(_FakeLibrary):
    """Also copies the gids and (L, n) contributions the kernel would read,
    from the CPU addresses it is given."""

    def vt_grouped_sum_i32(self, gids, contribs, n, L, *args):
        self.seen = (
            np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(gids)
                                  ).copy(),
            np.ctypeslib.as_array((ctypes.c_int32 * (L * n)).from_address(
                contribs)).reshape(L, n).copy(), gids, contribs)
        return super().vt_grouped_sum_i32(gids, contribs, n, L, *args)


@pytest.mark.parametrize("case", ["ragged", "misaligned"])
def test_launch_pads_to_whole_quads(case, monkeypatch):
    """The kernel's bulk copies take n % 4 == 0 and 16-byte aligned
    tensors: the wrapper pads other input with sentinel gids (-1) and zero
    values, which the sums drop."""
    lib = _CopyingLibrary(err=0)
    monkeypatch.setattr(gs, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), {
                            "multi_processor_count": 132}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    gids, vals = _inputs(3, 3, 12)
    if case == "ragged":
        n = 1001
        g, v = torch.from_numpy(gids[:n]), torch.from_numpy(vals[:, :n].copy())
    else:
        n = 1000
        flat = torch.from_numpy(np.concatenate([[0], vals[:, :n].ravel()]
                                               ).astype(np.int32))
        g = torch.from_numpy(np.concatenate([[0], gids[:n]]
                                            ).astype(np.int32))[1:]
        v = flat[1:].view(3, n)
        assert v.data_ptr() % 16 and g.data_ptr() % 16
    gs._launch(g, v, 12, "grouped_multi_sum_i32")
    seen_g, seen_v, gp, vp = lib.seen
    n4 = -(-n // 4) * 4
    assert lib.calls[0][2] == n4 and gp % 16 == 0 and vp % 16 == 0
    np.testing.assert_array_equal(seen_g[:n], gids[:n])
    np.testing.assert_array_equal(seen_v[:, :n], vals[:, :n])
    assert (seen_g[n:] == -1).all() and (seen_v[:, n:] == 0).all()
    gs.reset_launches()


@pytest.mark.parametrize("bad", [
    "float_values", "int64_gids", "length_mismatch", "one_group",
    "too_many_groups", "strided"])
def test_wrapper_rejects(bad):
    gids = torch.zeros(256, dtype=torch.int32)
    vals = torch.zeros((2, 256), dtype=torch.int32)
    G = 12
    if bad == "float_values":
        vals = vals.float()
    elif bad == "int64_gids":
        gids = gids.long()
    elif bad == "length_mismatch":
        vals = vals[:, :128]
    elif bad == "one_group":
        G = 1
    elif bad == "too_many_groups":
        G = 129
    elif bad == "strided":
        vals = torch.zeros((256, 2), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        gs.grouped_multi_sum_i32(gids, vals, G)


# ----------------------------------------------- the kernel's arithmetic

_CU = Path(gs.__file__).resolve().parent.parent / "csrc" / "grouped_sum.cu"


def _flush_rows() -> int:
    """kFlushRows of the kernel source: rows between int64 flushes."""
    m = re.search(r"kFlushRows = 1 << (\d+);", _CU.read_text())
    return 1 << int(m.group(1))


def _kernel_model(gids, vals, G, flush_rows):
    """The kernel's arithmetic in numpy: a one-hot of the gids holding 128
    where a row is in a group (sentinels and padding match no group) times
    the biased u8 digits and a count column of ones, int32 accumulators
    folded into int64 every ``flush_rows`` rows, then
    sum_d 2^(8d) S_d - 2^31 C with S_d and C the folded cells over 128.
    Returns the sums and the largest int32 accumulator seen."""
    L, n = vals.shape
    u = vals.view(np.uint32) ^ np.uint32(0x80000000)
    live = (gids >= 0) & (gids < G)
    cols = np.concatenate([((u >> np.uint32(8 * d)) & np.uint32(0xFF))
                           for d in range(4)]).astype(np.int64)
    cols = np.concatenate([cols, np.ones((1, n), np.int64)])  # (4L+1, n)
    cells = np.zeros((4 * L + 1, G), np.int64)
    top = 0
    for lo in range(0, n, flush_rows):
        g = gids[lo:lo + flush_rows]
        ok = live[lo:lo + flush_rows]
        part = np.stack([np.bincount(g[ok], weights=c[lo:lo + flush_rows][ok],
                                     minlength=G) for c in cols])
        part = 128 * part.astype(np.int64)
        top = max(top, int(part.max()))
        assert top <= 2 ** 31 - 1, "an int32 accumulator would overflow"
        cells += part
    digits = cells[:4 * L].reshape(4, L, G) >> 7
    weights = np.array([1 << (8 * d) for d in range(4)], np.int64)
    sums = ((weights[:, None, None] * digits).sum(axis=0)
            - ((cells[-1] >> 7) << 31))
    return sums, top


@pytest.mark.parametrize("case", ["all_max_one_group", "all_min_one_group",
                                  "random", "max_at_flush_length"])
def test_kernel_arithmetic_is_exact(case):
    """Bias, u8 digits, the one-hot's 128, the count column and the int32
    flush length give the exact int64 sums and keep every int32
    accumulator in range, at the extremes of the domain and at the flush
    length itself."""
    flush = _flush_rows()
    assert 128 * 255 * flush <= 2 ** 31 - 1
    L, G = 3, 13
    n = flush if case == "max_at_flush_length" else N
    if case == "random":
        gids, vals = _inputs(77, L, G)
    else:
        gids = np.zeros(n, np.int32)
        sign = -1 if case == "all_min_one_group" else 1
        vals = np.full((L, n), sign * I32_MAX, np.int32)
    got, top = _kernel_model(gids, vals, G, flush)
    np.testing.assert_array_equal(got, _exact(gids, vals, G))
    if case == "max_at_flush_length":
        # every digit of 2^32 - 1 is 255: one window reaches the most an
        # accumulator can hold between flushes
        assert top == 128 * 255 * flush
