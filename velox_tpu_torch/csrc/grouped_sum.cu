// Exact grouped int64 sums of int32 contributions, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of velox_tpu/ops/pallas_agg.py:
//   * _kernel        behind grouped_sum_i32        (one contribution lane)
//   * _multi_kernel  behind grouped_multi_sum_i32  (L lanes in one launch)
// Both compute, for every lane l and group g in [0, G),
//     out[l][g] = sum of contribs[l][i] over rows i with gids[i] == g,
// exactly, in int64; rows whose gid lies outside [0, G) are dropped.
//
// The TPU version splits each value into 3 x 14-bit digits and runs f32
// one-hot matmuls on the MXU only because that unit has no int64. Hopper
// has native 64-bit integer adds, so this kernel sign-extends each int32
// contribution and adds it to an unsigned 64-bit accumulator: the two's
// complement wrap makes the unsigned sum the exact signed sum. Integer
// addition is associative, so the result is exact and the same on every
// run whatever order the atomics land in.
//
// Bound: the bytes read, (4 + 4 L) n (gids once, each lane once), at
// 3.35 TB/s; at TPC-H Q1's shape (n = 2^23, L = 17) that is ~0.18 ms.
// Design against it: one pass over the rows, grid-stride, coalesced
// reads of each lane row; the L x G accumulators of a block live in
// shared memory (8 L G bytes, 17.4 KB at L = 17, G = 128) so device
// memory sees only the reads plus one atomic flush of L G values per
// block into the zeroed output.
//
// Known cost left for later: Q1 puts nearly all rows into 4 of its 12
// groups, so the shared-memory atomics of a warp collide on few
// addresses and serialise. Per-warp privatised accumulators would cure
// that; this first version keeps one accumulator set per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// threads per block; ops/grouped_sum.py sizes the grid with the same
// number (_THREADS)
constexpr int kThreads = 256;

__global__ void grouped_sum_kernel(const int32_t* __restrict__ gids,
                                   const int32_t* __restrict__ contribs,
                                   int64_t n, int num_lanes, int num_groups,
                                   unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];
  const int cells = num_lanes * num_groups;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) acc[k] = 0ull;
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int g = gids[i];
    if ((unsigned)g >= (unsigned)num_groups) continue;
    unsigned long long* row = acc + g;
    const int32_t* lane = contribs + i;
    for (int l = 0; l < num_lanes; ++l) {
      const int32_t v = lane[(int64_t)l * n];
      if (v != 0) {
        atomicAdd(row + l * num_groups,
                  (unsigned long long)(long long)v);
      }
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const unsigned long long s = acc[k];
    if (s != 0ull) atomicAdd(out + k, s);
  }
}

}  // namespace

// gids (n,) int32; contribs (L, n) int32 row-major; out (L, G) int64,
// zeroed by the caller. Launches on `stream`, allocates nothing, does
// not synchronise. Returns cudaGetLastError() after the launch.
extern "C" int vt_grouped_sum_i32(const void* gids, const void* contribs,
                                  int64_t n, int num_lanes, int num_groups,
                                  void* out, int blocks, void* stream) {
  const size_t smem =
      (size_t)num_lanes * (size_t)num_groups * sizeof(unsigned long long);
  grouped_sum_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(contribs), n, num_lanes, num_groups,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
