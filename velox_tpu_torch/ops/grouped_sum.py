"""Exact grouped int64 sums of int32 contributions (kernels B1 and B2).

The port of ``velox_tpu/ops/pallas_agg.py``: ``grouped_sum_i32`` (one
contribution lane) and ``grouped_multi_sum_i32`` (L lanes in one launch)
compute, per group g in [0, G), the exact int64 sum of the contributions
of the rows whose gid is g; gids outside [0, G) are dropped. The domain
is the reference's: 2 <= G <= 128 and |v| <= 2^31 - 1 (INT32_MIN is
excluded because the reference negates it).

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/grouped_sum.cu`` (built with nvcc at first use) or raises; on a
CPU tensor it runs the plain torch version beside it. Nothing falls back
from one to the other. Each wrapper counts its kernel launches in
``launches`` so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

#: kernel launches per wrapper since the last ``reset_launches()``
launches: Dict[str, int] = {"grouped_sum_i32": 0,
                            "grouped_multi_sum_i32": 0}

_MAX_GROUPS = 128
#: static shared-memory limit of a block; the L x G int64 accumulators
#: of one block must fit
_SMEM_LIMIT = 48 * 1024
#: threads per block: ``kThreads`` of csrc/grouped_sum.cu
_THREADS = 256
#: resident blocks per SM the grid is sized for
_BLOCKS_PER_SM = 8


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain torch

def grouped_multi_sum_i32_plain(gids: torch.Tensor, contribs: torch.Tensor,
                                num_groups: int) -> torch.Tensor:
    """(L, G) int64 sums: sentinel gids go to bin G, which is dropped."""
    G = num_groups
    g = torch.where((gids >= 0) & (gids < G), gids,
                    torch.full_like(gids, G)).long()
    out = torch.zeros((contribs.shape[0], G + 1), dtype=torch.int64,
                      device=contribs.device)
    out.index_add_(1, g, contribs.long())
    return out[:, :G]


def grouped_sum_i32_plain(gids: torch.Tensor, contrib: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """(G,) int64 sums of one contribution lane."""
    return grouped_multi_sum_i32_plain(gids, contrib[None], num_groups)[0]


# ----------------------------------------------------------------- kernel

def _library():
    from velox_tpu_torch.utils.cuda_build import load

    lib = load("grouped_sum")
    fn = lib.vt_grouped_sum_i32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(gids: torch.Tensor, contribs: torch.Tensor, num_groups: int,
            counter: str) -> torch.Tensor:
    """Run the CUDA kernel on (L, n) contributions; returns (L, G).
    Adds one to ``launches[counter]`` when the kernel was launched."""
    L, n = contribs.shape
    if 8 * L * num_groups > _SMEM_LIMIT:
        raise ValueError(
            f"grouped sum: {L} lanes x {num_groups} groups of int64 "
            f"accumulators exceed {_SMEM_LIMIT} bytes of shared memory")
    out = torch.zeros((L, num_groups), dtype=torch.int64,
                      device=contribs.device)
    if n == 0:
        return out
    lib = _library()
    sms = torch.cuda.get_device_properties(
        contribs.device).multi_processor_count
    blocks = min(-(-n // _THREADS), sms * _BLOCKS_PER_SM)
    # the launch runs on the CUDA runtime's current device
    with torch.cuda.device(contribs.device):
        stream = torch.cuda.current_stream(contribs.device).cuda_stream
        err = lib.vt_grouped_sum_i32(
            gids.data_ptr(), contribs.data_ptr(), n, L, num_groups,
            out.data_ptr(), blocks, stream)
    if err != 0:
        raise RuntimeError(f"grouped_sum kernel launch failed: CUDA error "
                           f"{err}")
    launches[counter] += 1
    return out


def _check(gids: torch.Tensor, contribs: torch.Tensor, num_groups: int,
           ndim: int) -> None:
    if not 2 <= num_groups <= _MAX_GROUPS:
        raise ValueError(f"grouped sum takes 2 <= G <= {_MAX_GROUPS} "
                         f"groups, got {num_groups}")
    if gids.dtype != torch.int32 or contribs.dtype != torch.int32:
        raise TypeError(f"grouped sum takes int32 gids and contributions, "
                        f"got {gids.dtype} and {contribs.dtype}")
    if gids.ndim != 1 or contribs.ndim != ndim \
            or contribs.shape[-1] != gids.shape[0]:
        raise ValueError(f"grouped sum shapes: gids {tuple(gids.shape)}, "
                         f"contributions {tuple(contribs.shape)}")
    if gids.device != contribs.device:
        raise ValueError(f"grouped sum: gids on {gids.device}, "
                         f"contributions on {contribs.device}")
    if not (gids.is_contiguous() and contribs.is_contiguous()):
        raise ValueError("grouped sum takes contiguous tensors")
    if gids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped sum: no kernel for {gids.device}")


def grouped_sum_i32(gids: torch.Tensor, contrib: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """Exact (G,) int64 per-group sums of one int32 lane (kernel B1)."""
    _check(gids, contrib, num_groups, 1)
    if gids.device.type == "cpu":
        return grouped_sum_i32_plain(gids, contrib, num_groups)
    return _launch(gids, contrib[None], num_groups, "grouped_sum_i32")[0]


def grouped_multi_sum_i32(gids: torch.Tensor, contribs: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Exact (L, G) int64 per-group sums of L int32 lanes in one launch
    (kernel B2). ``contribs`` is (L, n)."""
    _check(gids, contribs, num_groups, 2)
    if gids.device.type == "cpu":
        return grouped_multi_sum_i32_plain(gids, contribs, num_groups)
    return _launch(gids, contribs, num_groups, "grouped_multi_sum_i32")
