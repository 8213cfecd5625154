"""Grouped-sum kernels B1/B2: the port's plain torch versions against the
JAX package's Pallas kernels (interpret mode on the CPU), exactly.

On a CPU tensor the port's wrappers run the plain version; the CUDA
kernels themselves are checked against it on the card by chip_smoke.py.
"""

from contextlib import nullcontext

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
        # n, L, G and a grid of whole blocks, at most 8 per SM
        assert lib.calls[0][2:5] == (n, 3, 12)
        assert lib.calls[0][6] == 4
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
