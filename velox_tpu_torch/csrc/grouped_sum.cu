// Exact grouped int64 sums of int32 contributions, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of velox_tpu/ops/pallas_agg.py:
//   * _kernel        (:32)  behind grouped_sum_i32        (one lane, B1)
//   * _multi_kernel  (:114) behind grouped_multi_sum_i32  (L lanes, B2)
// Both compute, for every lane l and group g in [0, G),
//     out[l][g] = sum of contribs[l][i] over rows i with gids[i] == g,
// exactly, in int64; rows whose gid lies outside [0, G) are dropped.
//
// The design: a split-K integer GEMM on the tensor cores, no atomics.
// Read the op as C (G x N) = onehot (G x K) . D (K x N), with K the rows:
//   * Bias every value, u = (uint32)v ^ 0x80000000 = v + 2^31, so its four
//     bytes u_0..u_3 are unsigned digits. Column (l, d) of D holds digit d
//     of lane l; one more column is all ones (the count column).
//   * Row g of the one-hot holds 128 in the columns (rows of the table)
//     whose gid is g. A sentinel gid (outside [0, G), or a padding row past
//     n) matches no row of it, so it drops out of every column of C, the
//     count column included.
//   * Then, with S_{d,g} = C[g][(l, d)] / 128 and C_g = C[g][count] / 128,
//     exactly in int64,
//         sum_g(l) = sum_d 2^(8d) S_{d,g} - 2^31 C_g,
//     where sum_d 2^(8d) S_{d,g} <= (2^32 - 1) n < 2^63 for any n < 2^31.
// N = 4L + 1 columns: 69 (nine n8 tiles) for TPC-H Q1's L = 17, five (one
// tile) for B1. Lanes go through in passes of at most kLanesPerPass
// (blockIdx.y), so any L is one launch.
//
// Fragments of mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 (PTX ISA,
// "Matrix fragments for mma.m16n8k32"), with thread lane = 4 grp + tig:
//   A (one-hot): a0 = group grp,   rows 4tig..4tig+3;  a1 = group grp+8,
//      same rows;  a2 = group grp, rows 16+4tig..+3;   a3 = group grp+8,
//      rows 16+4tig..+3  (groups counted from the tile's first);
//   B (digits):  b0 = rows 4tig..4tig+3, column grp;  b1 = rows
//      16+4tig..+3, column grp;
//   C: c0, c1 = group grp, columns 2tig, 2tig+1; c2, c3 = group grp+8.
// Each register holds 4 u8 values, the lowest row in the lowest byte.
//   * The gids of 4 rows pack into one word, a byte each: the gid where
//     it is below 128, else 0x80. An A word is then 3 integer operations,
//     an exact byte-wise compare of that word against the group: 0x80 in
//     the bytes that are equal and below 0x80, 0 elsewhere.
//   * A 16-byte read of rows 4tig..4tig+3 of one lane is, after a byte
//     transpose (__byte_perm), the B word of each of the lane's 4 digits.
//     So the columns of whole octets of lanes (lanes 8o..8o+7) go
//     digit-major, n-tile 4o+d holding digit d of lane 8o+grp in column
//     grp, and one read feeds 4 tiles. The lanes left over (fewer than 8)
//     go 4 columns each (column 4j+d) into the tail tiles; the count
//     column is the last column of the last tile.
//
// Exactness: a cell of C gains at most 128 * 255 = 32,640 per row, so an
// int32 fragment is safe for (2^31 - 1) / 32,640 = 65,793 rows. Each warp
// folds its fragments into int64 shared-memory cells after at most
// kFlushRows = 2^16 rows, as the TPU kernel flushed its int32 block per
// 64 K rows. The fold combines the 4 digits of each lane (the digits of
// a tail lane sit in two neighbouring threads: one shuffle), so a block
// keeps one int64 cell per (group, lane) and one count per group.
//
// Two layouts of the same product (the one-hot of gids beyond 127 is
// never needed: G <= 128):
//   * X (OctetTiles): as above; a warp holds one group tile by all NT
//     column tiles of one lane pass. Where G > 16, ngr warp groups of a
//     block split the group tiles, each building the same B. NT is 1 (one
//     lane: B1), 9 (up to 17 lanes: B2 at Q1's shape), or, for the lane
//     counts no query of the port issues, the next of 2 and 10 above the
//     need; the extra columns are zero. Seven kernel instances in all.
//   * H (HiTiles), for one lane and more than 16 groups: g = 16 H + lo.
//     The A tile is the one-hot of lo (16 values), the same for every
//     group; an n-tile is one digit or the count, and its column grp keeps
//     only the rows with H = grp (a byte mask). One warp holds all 128
//     groups in 5 tiles and builds each A word and mask once. No query of
//     the port sums one lane over more than 16 groups yet.
// The 8 / ngr k-slices of a block work on different 32-row steps.
//
// Bound: the bytes read, (4 + 4 L) n (gids once, each lane once), at
// 3.35 TB/s; 0.18 ms at Q1's shape (n = 2^23, L = 17). The product issues
// ceil(G/16) NT mma.sync per 32 rows in layout X (2.4 M at Q1's shape,
// 0.02 ms at the card's 1979 int8 Tops/s, 16,384 operations an mma) and
// 5 in layout H: below the bytes, so mma.sync is enough. wgmma (64-row
// tiles read from shared memory) would buy nothing here: both operands
// are built in registers. At L = 17, G = 128 (18.9 M mma, 0.16 ms) the
// tensor cores come close to the bytes.
//
// Streaming: a persistent grid (blocks per SM from the occupancy of the
// kernel at its shared memory) walks chunks of 256 R rows (stages of
// about 16 KB) through a ring of kStages shared-memory stages. Thread 0
// fills a stage with one bulk copy (TMA) a lane, completing on the
// stage's mbarrier, which the block waits on with the stage's phase
// parity; three chunks stay in flight while the tensor cores work on the
// fourth. Bulk copies take 16-byte aligned sources, so the C entry takes
// n % 4 == 0 and 16-byte aligned tensors only: the wrapper pads any other
// input to whole quads of rows. No caller passes one (the capacity of
// every split is a multiple of 128 rows).
//
// Preparation: where several threads read the same quad of rows (layout
// H, the tail tiles of NT = 1 and 2, warp groups sharing a B), prepare()
// turns a landed stage, in place and once a block, into packed gid words
// and digit words. Where each quad has one reader (NT = 9 or 10 with one
// warp group, as at Q1's shape) the tiles transpose the raw rows
// themselves.
//
// Each block writes its (L, G) int64 partial sums to a scratch buffer;
// a second small kernel adds them in a fixed order. The result does not
// depend on scheduling.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;
constexpr int kStepRows = 32;          // k of one mma.m16n8k32
constexpr int kUnroll = 4;             // steps a warp runs back to back
constexpr int kLanesPerPass = 19;      // 4 * 19 + 1 = 77 columns: 10 tiles
constexpr int kFlushRows = 1 << 16;    // rows a warp adds between flushes
constexpr int kLanePad = 64;           // keeps 16-byte reads of 2 lanes
                                       // in different banks
constexpr int kSmemPerBlock = 232448;  // H100: 227 KB

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

// the one arrival of a phase, which then waits for ``bytes`` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one bulk (TMA) copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) that completes on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 rows of one lane -> the word of each biased digit d (byte j = row j)
__device__ __forceinline__ void digits4(int4 v, unsigned (&d)[4]) {
  const unsigned t0 = __byte_perm(v.x, v.y, 0x5140);
  const unsigned t1 = __byte_perm(v.x, v.y, 0x7362);
  const unsigned t2 = __byte_perm(v.z, v.w, 0x5140);
  const unsigned t3 = __byte_perm(v.z, v.w, 0x7362);
  d[0] = __byte_perm(t0, t2, 0x5410);
  d[1] = __byte_perm(t0, t2, 0x7632);
  d[2] = __byte_perm(t1, t3, 0x5410);
  d[3] = __byte_perm(t1, t3, 0x7632) ^ 0x80808080u;  // the bias
}

// 4 rows of one lane -> the word of one digit; sel = d | (d + 4) << 4,
// flip = 0x80808080 for d = 3 (the bias), else 0
__device__ __forceinline__ unsigned digit1(int4 v, unsigned sel,
                                           unsigned flip) {
  const unsigned lo = __byte_perm(v.x, v.y, sel);
  const unsigned hi = __byte_perm(v.z, v.w, sel);
  return __byte_perm(lo, hi, 0x5410) ^ flip;
}

// 4 gids -> 4 bytes: the gid where it is below 128, else 0x80. Gids in
// [G, 128) only meet columns of C that are never written out.
__device__ __forceinline__ unsigned pack_gids(int4 g) {
  const unsigned x = min((unsigned)g.x, 0x80u);
  const unsigned y = min((unsigned)g.y, 0x80u);
  const unsigned z = min((unsigned)g.z, 0x80u);
  const unsigned w = min((unsigned)g.w, 0x80u);
  return __byte_perm(__byte_perm(x, y, 0x0040), __byte_perm(z, w, 0x0040),
                     0x5410);
}

// byte j of the result is 0x80 where byte j of ``packed`` equals the
// group (``group`` holds it, below 128, in all 4 bytes), else 0: the low
// 7 bits agree and the packed byte's high bit (a sentinel) is clear
__device__ __forceinline__ unsigned onehot(unsigned packed, unsigned group) {
  const unsigned t = ((packed ^ group) & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
  return ~(t | packed) & 0x80808080u;
}

// byte j of the result is 0x80 where the low nibbles of byte j of
// ``packed`` and of ``low`` agree, else 0 (layout H: the sentinels drop
// out through high_mask)
__device__ __forceinline__ unsigned onehot_lo(unsigned packed, unsigned low) {
  return ~(((packed ^ low) & 0x0F0F0F0Fu) + 0x7F7F7F7Fu) & 0x80808080u;
}

// byte j of the result is 0xFF where byte j of ``packed`` is a gid whose
// high 3 bits equal those of ``high`` (16 H in all 4 bytes), else 0; a
// sentinel byte (high bit set) never matches. The last step copies the
// sign bit of each byte over it (prmt with sign replication).
__device__ __forceinline__ unsigned high_mask(unsigned packed,
                                              unsigned high) {
  const unsigned u = ((packed ^ high) & 0xF0F0F0F0u) >> 4;  // 0 on a match
  const unsigned v = 0x80808080u - u;  // high bit of a byte set on a match
  unsigned m;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(m) : "r"(v));
  return m;
}

struct Args {
  const int32_t* gids;
  const int32_t* contribs;
  long long* partials;  // (gridDim.x, L, G)
  int64_t n;            // a multiple of 4
  int num_lanes, num_groups;
  int ngr;         // warp groups of a block, each on its own group tile
  int cell_rows;   // groups the int64 cells of a block hold
  int chunk_rows;  // rows of one stage, 256 R
  int lane_pass;   // lanes of a full pass: min(L, kLanesPerPass)
};

// thread 0 queues the bulk copies of one chunk (gids, then each lane)
// into ``stage``; rows past n are not read: their gids become sentinels
// once the chunk has landed
__device__ __forceinline__ void load_chunk(unsigned char* stage,
                                           uint64_t* bar, const Args& p,
                                           const int32_t* lanes, int cnt,
                                           int64_t row0) {
  if (threadIdx.x != 0) return;
  const int rows = p.chunk_rows;
  const int lane_bytes = 4 * rows + kLanePad;
  const int bytes = 4 * (int)min((int64_t)rows, p.n - row0);
  mbar_expect(bar, (cnt + 1) * bytes);
  bulk_copy(stage, p.gids + row0, bytes, bar);
  for (int l = 0; l < cnt; ++l)
    bulk_copy(stage + 4 * rows + l * lane_bytes,
              lanes + (int64_t)l * p.n + row0, bytes, bar);
}

// Turn a landed chunk, in place, into the words the fragments take: each
// quad (4 rows) of gids into one packed word (pack_gids; rows past n, which
// no copy wrote, become sentinels), each quad of a lane into its 4 biased
// digit words (digits4). Done once a block where several threads read a
// quad: layout H, the tail tiles (4 threads a lane) and warp groups that
// share their B.
__device__ __forceinline__ void prepare(unsigned char* st, int rows,
                                        int lane_bytes, int cnt,
                                        int64_t left) {
  const int shift = 29 - __clz(rows);  // quads a segment: rows / 4
  const int quads = rows >> 2;
  for (int i = threadIdx.x; i < (cnt + 1) * quads; i += kThreads) {
    const int seg = i >> shift;  // 0: gids, 1 + l: lane l
    const int q = i & (quads - 1);
    unsigned char* at =
        st + 16 * q + (seg == 0 ? 0 : 4 * rows + (seg - 1) * lane_bytes);
    const int4 v = *reinterpret_cast<const int4*>(at);
    if (seg == 0) {
      // n % 4 == 0: a quad exists whole or not at all
      *reinterpret_cast<unsigned*>(at) =
          4 * q < left ? pack_gids(v) : 0x80808080u;
    } else {
      unsigned d[4];
      digits4(v, d);
      *reinterpret_cast<uint4*>(at) = make_uint4(d[0], d[1], d[2], d[3]);
    }
  }
  // order these writes before the bulk copies that refill the stage
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// what a thread's tiles need to know of their block
struct Ctx {
  int grp, tig;    // the thread's place in the fragment layout
  int gg;          // its warp group: which group tile it holds
  int cnt;         // lanes of this pass
  int lane_pass;   // lanes of a full pass; the count is cell lane_pass
  int rows;        // rows of a stage
  int lane_bytes;  // bytes between two lanes of a stage
};

// Layout X: an A tile is 16 groups (group 16 gg + grp + 8 h), a B tile 8
// (lane, digit) columns: octets of lanes digit-major, then the tail
// lanes 4 columns each, and the count in the last column of the last
// tile. A warp holds its group tile by all NT column tiles.
template <int NT, bool Prepared>
struct OctetTiles {
  static constexpr bool kPrepared = Prepared;
  static constexpr int FO = (NT - 1) / 4;  // octets of lanes, 4 tiles each
  static constexpr int TT = NT - 4 * FO;   // tail tiles
  Ctx c;
  int acc[NT][4];
  // where this thread's B columns come from: byte offsets in a stage
  // (of a lane, or of one digit word of a tail lane where the stage holds
  // digit words; -1: a zero column, -2: the count column)
  int ooff[FO > 0 ? FO : 1];
  int toff[TT];
  unsigned tsel[TT], tflip[TT];
  unsigned group[2];
  int tail;  // lanes in the tail tiles

  __device__ explicit OctetTiles(const Ctx& ctx) : c(ctx) {
    tail = max(c.cnt - 8 * FO, 0);
#pragma unroll
    for (int o = 0; o < FO; ++o) {
      const int li = 8 * o + c.grp;
      ooff[o] = li < c.cnt ? 4 * c.rows + li * c.lane_bytes : -1;
    }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const int col = 8 * tt + c.grp;  // digit col & 3 of tail lane col / 4
      const unsigned d = col & 3;
      toff[tt] = (col >> 2) < tail
                     ? 4 * c.rows + (8 * FO + (col >> 2)) * c.lane_bytes +
                           (Prepared ? 4 * d : 0)
                 : col == 8 * TT - 1 ? -2
                                     : -1;
      tsel[tt] = d | ((d + 4) << 4);
      tflip[tt] = d == 3 ? 0x80808080u : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      group[h] = (unsigned)(16 * c.gg + c.grp + 8 * h) * 0x01010101u;
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  }

  // one 32-row step at row ``base`` of stage ``st``
  __device__ __forceinline__ void step(const unsigned char* st, int base) {
    unsigned a[4], b[NT][2];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int q = 4 * (base + 16 * kh + 4 * c.tig);  // its quad's bytes
      unsigned packed;
      if constexpr (Prepared)
        packed = *reinterpret_cast<const unsigned*>(st + q);
      else
        packed = pack_gids(*reinterpret_cast<const int4*>(st + q));
      a[2 * kh] = onehot(packed, group[0]);
      a[2 * kh + 1] = onehot(packed, group[1]);
#pragma unroll
      for (int o = 0; o < FO; ++o) {
        unsigned d[4] = {0u, 0u, 0u, 0u};
        if (ooff[o] >= 0) {
          const int4 v = *reinterpret_cast<const int4*>(st + ooff[o] + q);
          if constexpr (Prepared) {
            d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
          } else {
            digits4(v, d);
          }
        }
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) b[4 * o + dd][kh] = d[dd];
      }
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        const unsigned char* at = st + max(toff[tt], 0) + q;
        const unsigned w =
            Prepared
                ? *reinterpret_cast<const unsigned*>(at)
                : digit1(*reinterpret_cast<const int4*>(at), tsel[tt],
                         tflip[tt]);
        b[4 * FO + tt][kh] = toff[tt] >= 0    ? w
                             : toff[tt] == -2 ? 0x01010101u
                                              : 0u;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_u8(acc[nt], a, b[nt][0], b[nt][1]);
  }

  // add the fragments, digits combined per lane, to the cells; clear them
  __device__ __forceinline__ void fold(long long* cells, int cstride) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      long long* row = cells + (16 * c.gg + c.grp + 8 * h) * cstride;
#pragma unroll
      for (int o = 0; o < FO; ++o)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          long long v = 0;
#pragma unroll
          for (int d = 0; d < 4; ++d)
            v += (long long)(acc[4 * o + d][2 * h + e] >> 7) << (8 * d);
          const int li = 8 * o + 2 * c.tig + e;
          if (li < c.cnt) row[li] += v;
        }
      // tail: this thread holds digits 2 (tig & 1), +1 of lane tig / 2
      // of each tail tile, its neighbour in the quad the other two
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        long long v = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v += (long long)(acc[4 * FO + tt][2 * h + e] >> 7)
               << (8 * (2 * (c.tig & 1) + e));
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        const int j = 2 * tt + (c.tig >> 1);
        if ((c.tig & 1) == 0 && j < tail) row[8 * FO + j] += v;
      }
      // the count column is the last: register 2h+1 of thread tig 3
      if (c.tig == 3) row[c.lane_pass] += acc[NT - 1][2 * h + 1] >> 7;
    }
    clear();
  }
};

// Layout H, for one lane and more than 16 groups: group g = 16 H + lo.
// An A tile is the one-hot of lo (16 values: lo = grp + 8 h); a B tile is
// one digit of all rows, or the count, and its column grp keeps only the
// rows with H = grp (a byte mask). One warp holds all 128 groups in 5
// tiles, and builds each A word and each mask once for all of them.
struct HiTiles {
  static constexpr bool kPrepared = true;
  Ctx c;
  int acc[5][4];
  unsigned lo[2], hi;

  __device__ explicit HiTiles(const Ctx& ctx) : c(ctx) {
    lo[0] = (unsigned)c.grp * 0x01010101u;
    lo[1] = (unsigned)(c.grp + 8) * 0x01010101u;
    hi = (unsigned)(16 * c.grp) * 0x01010101u;
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int nt = 0; nt < 5; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  }

  __device__ __forceinline__ void step(const unsigned char* st, int base) {
    unsigned a[4], b[5][2];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int q = 4 * (base + 16 * kh + 4 * c.tig);  // its quad's bytes
      const unsigned packed = *reinterpret_cast<const unsigned*>(st + q);
      a[2 * kh] = onehot_lo(packed, lo[0]);
      a[2 * kh + 1] = onehot_lo(packed, lo[1]);
      const unsigned keep = high_mask(packed, hi);
      const uint4 d = *reinterpret_cast<const uint4*>(st + 4 * c.rows + q);
      b[0][kh] = d.x & keep;
      b[1][kh] = d.y & keep;
      b[2][kh] = d.z & keep;
      b[3][kh] = d.w & keep;
      b[4][kh] = keep & 0x01010101u;
    }
#pragma unroll
    for (int nt = 0; nt < 5; ++nt) mma_u8(acc[nt], a, b[nt][0], b[nt][1]);
  }

  // a fragment cell is group 16 (2 tig + e) + grp + 8 h, the column's H
  // being 2 tig + e: the 4 digits of the lane sit in one thread
  __device__ __forceinline__ void fold(long long* cells, int cstride) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      long long* row =
          cells + (16 * (2 * c.tig + (i & 1)) + c.grp + 8 * (i >> 1)) * cstride;
      long long v = 0;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        v += (long long)(acc[d][i] >> 7) << (8 * d);
      row[0] += v;
      row[c.lane_pass] += acc[4][i] >> 7;
    }
    clear();
  }
};

template <class Tiles, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    grouped_sum_mma(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int ks = warp / p.ngr;
  const int kslices = kWarps / p.ngr;
  const int lo = blockIdx.y * kLanesPerPass;
  Ctx ctx;
  ctx.grp = (threadIdx.x & 31) >> 2;
  ctx.tig = threadIdx.x & 3;
  ctx.gg = warp % p.ngr;
  ctx.cnt = min(kLanesPerPass, p.num_lanes - lo);
  ctx.lane_pass = p.lane_pass;
  ctx.rows = p.chunk_rows;
  ctx.lane_bytes = 4 * p.chunk_rows + kLanePad;
  const int32_t* lanes = p.contribs + (int64_t)lo * p.n;
  const int rows = p.chunk_rows;
  const int stage_bytes = 4 * rows + p.lane_pass * ctx.lane_bytes;
  // int64 sums of this block: per group, one cell per lane of the pass
  // and the count last
  const int cstride = p.lane_pass + 1;
  long long* cells =
      reinterpret_cast<long long*>(smem + kStages * stage_bytes);
  for (int i = threadIdx.x; i < p.cell_rows * cstride; i += kThreads)
    cells[i] = 0;
  // one barrier a stage: a phase completes when its bulk copies landed
  uint64_t* bars = reinterpret_cast<uint64_t*>(cells + p.cell_rows * cstride);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Tiles tiles(ctx);

  // fold the int32 fragments into the int64 cells; the k-slices of a
  // block take turns, so every cell has one writer at a time
  auto flush = [&]() {
    for (int turn = 0; turn < kslices; ++turn) {
      __syncthreads();
      if (ks == turn) tiles.fold(cells, cstride);
    }
  };

  const int64_t chunks = (p.n + rows - 1) / rows;
  const int64_t mine =
      chunks > blockIdx.x ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps_per_warp = rows / kStepRows / kslices;
  const int flush_every = max(1, kFlushRows / (kStepRows * steps_per_warp));
  auto chunk_row = [&](int64_t i) {
    return ((int64_t)blockIdx.x + i * gridDim.x) * rows;
  };

#pragma unroll 1
  for (int s = 0; s < kStages - 1 && s < mine; ++s)
    load_chunk(smem + s * stage_bytes, bars + s, p, lanes, ctx.cnt,
               chunk_row(s));
#pragma unroll 1
  for (int64_t i = 0; i < mine; ++i) {
    const int64_t next = i + kStages - 1;
    if (next < mine)
      load_chunk(smem + (next % kStages) * stage_bytes,
                 bars + next % kStages, p, lanes, ctx.cnt, chunk_row(next));
    mbar_wait(bars + i % kStages, (unsigned)(i / kStages) & 1u);

    unsigned char* st = smem + (i % kStages) * stage_bytes;
    const int64_t left = p.n - chunk_row(i);  // rows of the chunk that exist
    if constexpr (Tiles::kPrepared) {
      prepare(st, rows, ctx.lane_bytes, ctx.cnt, left);
      __syncthreads();
    } else if (left < rows) {
      // no copy wrote the rows past n: make their gids sentinels (this is
      // the table's last chunk; nothing refills the stage after it)
      for (int r = (int)left + threadIdx.x; r < rows; r += kThreads)
        reinterpret_cast<int32_t*>(st)[r] = -1;
      __syncthreads();
    }
    if (left >= rows && steps_per_warp % kUnroll == 0) {
      // kUnroll steps with nothing between them: their reads overlap
#pragma unroll 1
      for (int j = 0; j < steps_per_warp; j += kUnroll)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          tiles.step(st, (ks + (j + u) * kslices) * kStepRows);
    } else {
#pragma unroll 1
      for (int j = 0; j < steps_per_warp; ++j) {
        const int base = (ks + j * kslices) * kStepRows;
        if (base >= left) break;
        tiles.step(st, base);
      }
    }
    __syncthreads();  // the stage is refilled next iteration
    if ((i + 1) % flush_every == 0) flush();
  }
  flush();
  __syncthreads();

  // this block's exact int64 partial sums: remove the bias
  for (int idx = threadIdx.x; idx < ctx.cnt * p.num_groups; idx += kThreads) {
    const int li = idx / p.num_groups;
    const int g = idx - li * p.num_groups;
    const long long* row = cells + g * cstride;
    p.partials[((int64_t)blockIdx.x * p.num_lanes + lo + li) * p.num_groups +
               g] = row[li] - (row[p.lane_pass] << 31);
  }
}

// out[c] = sum over blocks b of partials[b][c], in a fixed order
__global__ void sum_partials(const long long* __restrict__ partials,
                             int blocks, int cells,
                             long long* __restrict__ out) {
  __shared__ long long part[kWarps];
  const int c = blockIdx.x;
  long long s = 0;
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    s += partials[(int64_t)b * cells + c];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += part[w];
    out[c] = t;
  }
}

// MinBlocks, the blocks an SM must hold, sets the registers a thread may
// take: 4 (64 registers) for layout H and NT <= 2, 2 (128) for NT = 9 and
// 10, so that no instance spills
template <class Tiles, int MinBlocks>
int launch(const Args& p, int sms, int max_blocks, int passes,
           cudaStream_t stream, int* blocks) {
  const int stage_bytes =
      4 * p.chunk_rows + p.lane_pass * (4 * p.chunk_rows + kLanePad);
  const int smem = kStages * stage_bytes +
                   p.cell_rows * (p.lane_pass + 1) * (int)sizeof(long long) +
                   kStages * (int)sizeof(uint64_t);
  if (smem > kSmemPerBlock) return (int)cudaErrorInvalidConfiguration;
  auto kernel = grouped_sum_mma<Tiles, MinBlocks>;
  // the shared-memory attribute and the blocks an SM holds, set and asked
  // once for each device and size (kept per host thread)
  static thread_local int known_device = -1, known_smem = -1, per_sm = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != known_device || smem != known_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    known_device = device;
    known_smem = smem;
  }
  const int64_t chunks = (p.n + p.chunk_rows - 1) / p.chunk_rows;
  const int64_t want = min((int64_t)max(1, per_sm * sms / passes), chunks);
  *blocks = (int)min((int64_t)max_blocks, want);
  kernel<<<dim3(*blocks, passes), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// gids (n,) int32; contribs (L, n) int32 row-major; n % 4 == 0 and both
// 16-byte aligned; partials: scratch of at least max_blocks * L * G int64;
// out (L, G) int64. Launches on `stream` (the partial-sum kernel, then the
// reduction into out), allocates nothing, does not synchronise. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a misaligned input.
extern "C" int vt_grouped_sum_i32(const void* gids, const void* contribs,
                                  int64_t n, int num_lanes, int num_groups,
                                  void* partials, int max_blocks, int sms,
                                  void* out, void* stream) {
  if (n % 4 != 0 || ((reinterpret_cast<uintptr_t>(gids) |
                      reinterpret_cast<uintptr_t>(contribs)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.gids = static_cast<const int32_t*>(gids);
  p.contribs = static_cast<const int32_t*>(contribs);
  p.partials = static_cast<long long*>(partials);
  p.n = n;
  p.num_lanes = num_lanes;
  p.num_groups = num_groups;
  p.lane_pass = min(num_lanes, kLanesPerPass);
  // stages of ~16 KB: 256 R rows with R = 8 at one lane, 1 from 7 lanes
  int r = 1;
  while (2 * r * (p.lane_pass + 1) <= 16) r *= 2;
  p.chunk_rows = 256 * r;
  const int gt = (num_groups + 15) / 16;  // group tiles
  const int passes = (num_lanes + kLanesPerPass - 1) / kLanesPerPass;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0, err = 0;
  if (p.lane_pass == 1 && gt > 1) {
    // layout H: one warp holds all 128 groups
    p.ngr = 1;
    p.cell_rows = 128;
    err = launch<HiTiles, 4>(p, sms, max_blocks, passes, s, &blocks);
  } else {
    // layout X: one group tile a warp group
    p.ngr = 1;
    while (p.ngr < gt) p.ngr *= 2;
    p.cell_rows = 16 * p.ngr;
    const int nt = (4 * p.lane_pass + 1 + 7) / 8;  // column tiles needed
    // raw stages where each quad has one reader: lanes in octets, one
    // warp group
    const bool raw = nt > 2 && p.ngr == 1;
    if (nt == 1)
      err = launch<OctetTiles<1, true>, 4>(p, sms, max_blocks, passes, s,
                                           &blocks);
    else if (nt == 2)
      err = launch<OctetTiles<2, true>, 4>(p, sms, max_blocks, passes, s,
                                           &blocks);
    else if (nt <= 9 && raw)
      err = launch<OctetTiles<9, false>, 2>(p, sms, max_blocks, passes, s,
                                            &blocks);
    else if (nt <= 9)
      err = launch<OctetTiles<9, true>, 2>(p, sms, max_blocks, passes, s,
                                           &blocks);
    else if (raw)
      err = launch<OctetTiles<10, false>, 2>(p, sms, max_blocks, passes, s,
                                             &blocks);
    else
      err = launch<OctetTiles<10, true>, 2>(p, sms, max_blocks, passes, s,
                                            &blocks);
  }
  if (err != 0) return err;
  const int cells = num_lanes * num_groups;
  sum_partials<<<cells, kThreads, 0, s>>>(p.partials, blocks, cells,
                                          static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
