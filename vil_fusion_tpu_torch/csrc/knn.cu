// k-nearest-neighbour kernels for Hopper (sm_90a), bound with ctypes from
// vil_fusion_tpu_torch/ops/cuda/knn_cuda.py through vil_knn_launch() (dense)
// and vil_knn_sparse_launch() (sparse).
//
// Replaces the Pallas TPU kernels of
// vil_fusion_tpu/ops/pallas/knn_pallas.py:
//   K1  _knn_kernel_grouped (:202-272): per 128-column group of the database
//       keep the two nearest columns, return the top-k of the union of those
//       candidates (lidar odometry's association, knn(approx=True)).
//   K2  _knn_kernel (:53-133), packed=True, mxu=True: exact top-k (ICP loop
//       verification, knn(approx=False)). The TPU kernel packed distance bits
//       and column into one int32 key, quantizing the distance to 2^-idx_bits
//       relative; here the keys are exact (float distance, int index) pairs,
//       ordered by distance and then by the lower index.
//   K3  _sparse_knn_kernel (:290-366) as deployed (mxu=False, unpacked
//       merge): both sides Morton-sorted by the caller, a (query tile,
//       database tile) block is skipped when the gap between the tiles'
//       bounding boxes exceeds the radius; exact within the radius.
//   The mxu=False distance form (_pair_dist2 :45-49) is the DIFF variant of
//   the K1/K2 kernel and K3's only form.
//
// Semantics and rounding. Squared distances in float32 on the CUDA cores, in
// one of two forms: the expanded form of the mxu=True path,
// |q|^2 + |d|^2 - 2 q.d, or the difference form,
// ((qx-dx)^2 + (qy-dy)^2) + (qz-dz)^2. Every product and sum of a distance
// that can reach the result is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction) in the order of the plain PyTorch version in ops/knn.py,
// so kernel and plain version agree bit for bit on every distance (K1 / K2
// first sieve the columns with a contracted lower bound, see below). K3's box test (per axis max(dlo - qhi,
// qlo - dhi, 0), squared, summed in x, y, z order, <= radius^2) is rounded
// the same way, so kernel and plain version skip the same blocks. Host
// contract: rows ascending, ties to the lower index, distances clamped at
// >= 0, +inf and index 0 for a missing neighbour, invalid database points
// never selected.
//
// What bounds K1 and K2. Not bytes: the database (0.2-1.5 MB) is read from
// L2 by every block and from device memory once. Not the FP32 peak either:
// the bound counts 8 operations a pair at the FMA rate (4 instruction slots), but
// separately rounded arithmetic needs 7 (expanded) or 8 (difference) float
// instructions a pair, each one slot, and compares, selects, min and
// max run at half that rate. The first port ran 13.75 (K2, k = 1) to
// 19.5 (K1) instructions a pair, one LDS.128 among them, at about three
// quarters of the schedulers' instruction rate: bound by the count of
// instructions, not by latency.
//
// Design for this card. A TPU grid walks the database tiles of one query
// tile in order and carries the running best in VMEM scratch; Hopper's
// blocks run in no order and carry nothing between them. So:
//   * One thread owns one query and keeps its top-k (and K1's top-2 of the
//     group) in registers; a block of 128 queries walks one contiguous chunk
//     of the database in 128-column groups from shared memory (broadcast
//     LDS.128).
//   * Scan, then update. The exact arithmetic is spent only on columns that
//     can matter. A group is scanned with a lower bound of the distance that
//     costs 4 FMAs a pair (scan_bound: FMA contraction is allowed there
//     because the bound decides nothing by itself; it is shrunk by 2^-18 of
//     |q|^2 + |d|^2 so that it never exceeds either exact form) against a
//     limit fixed for 32 columns; the scan sets one bit for four columns,
//     with no branch. The set bits are worked off afterwards: each column
//     against the limit as it stands by then, and the survivors get the
//     exact, separately rounded distance and the update ordered by
//     (distance, index). The result is bit for bit the plain version's,
//     ties to the lower index included.
//   * K1's top-2 of a group is seeded with the list's k-th best: a column
//     at or beyond it can neither enter the list nor displace a candidate
//     that could, so the outcome is that of an unseeded top-2, and K1 runs
//     the same scan as K2.
//   * A group is staged deinterleaved, as four stride-4 samples of 32
//     columns, and the limit is renewed after each sample: on a database in
//     scan order (ICP clouds, the depth sphere), where distances fall
//     monotonically along a ring and every column would be a new best, the
//     first sample sets the limit for the other three.
//   * K2 at k = 1 (ICP) does not scan: a running best with a clamp, a
//     compare and two selects a pair (12.4 instructions) beat the scan on the
//     ICP clouds.
//   * Overlapped staging. Two shared-memory buffers. While a group is
//     consumed, each thread already holds the next group's column in
//     registers (plain global loads started before the arithmetic, which
//     hides their latency), then transforms and stores it into the other
//     buffer: one __syncthreads a group. cp.async cannot transform on the
//     way, and TMA is not worth a descriptor for a 1.5 KB group of a
//     database that lives in L2. Tensor cores are not used: the product has
//     depth 3 and must be full float32.
//   * The split and its merge. The database is cut into n_split chunks of
//     whole groups over gridDim.y (K1's groups never straddle a chunk, and
//     the top-k of a union is the top-k of the parts' top-k, so the split
//     changes no result). Every chunk fills its list anew and until then
//     sends every column to the update, so the wrapper's plan makes chunks
//     no shorter than that warm-up plus one group. With n_split == 1 the
//     kernel writes the result itself and no merge is launched. Otherwise
//     every (query, chunk) writes its list to scratch and knn_merge_kernel
//     gives each query `lanes` threads of a warp (a power of two <= 32): a
//     lane folds its own run of chunks with independent loads, then
//     log2(lanes) shuffle rounds fold neighbouring lanes' lists, ordered by
//     (distance, index), so the order of the folds does not matter.
//   * K3 keeps its own partial kernel and strict helpers, and shares the
//     merge. It deals the database tiles to the gridDim.y blocks round-robin
//     (tile t goes to block t % n_split): the tiles near a query tile are
//     Morton-neighbours, so contiguous chunks would leave most blocks with
//     nothing. Every thread of a block evaluates the same box test on the
//     same values (block-uniform branch); a block whose tiles are all far
//     writes an empty list and ends. K3 on a lidar map skips about 99% of
//     its blocks, so the box tests and the wrapper's tensor code are what
//     is left there.
// Tried on the card and dropped (PERF.md, section 6): several queries a thread
// (2 and 4 register lists: fewer LDS, but at an equal number of blocks the
// chunks get shorter and the lists' warm-up eats the gain; never faster);
// a branch on the threshold for every pair (three control instructions a
// pair cost more than they save); a branch-free select form of K1's top-2
// (9 half-rate instructions a pair); sub-blocks of 16 and 64 columns (within
// 4% of 32); k = 1 through the scan (slower than the running best on the
// ICP clouds); FMA in the exact difference form (faster, but no longer the
// plain version's bits, so not kept).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kGroup = 128;    // database columns per staged group (== K1 group)

constexpr int kSub = 32;       // columns a sub-block of the dense scan
constexpr int kSubs = kGroup / kSub;  // sub-blocks a group

// Kernels enqueued by this library since it was loaded: one is added beside
// every <<<>>> below, so that a caller can read how many kernels one call of
// an entry point cost (vil_knn_kernels_enqueued).
std::atomic<long long> g_enqueued{0};

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Insert (d, i) into the ascending register list. With LEX the list is
// ordered by (distance, index) whatever the order of the calls (the merge).
// Without it the early-out is strict on the distance alone: callers feed
// candidates in increasing index order relative to every equal-distance
// entry already in the list, so ties keep the lower index. Displaced
// entries bubble down in (distance, index) order.
template <int K, bool LEX = false>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
  if (!(d < bd[K - 1] || (LEX && d == bd[K - 1] && i < bi[K - 1]))) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bool lt = d < bd[s] || (d == bd[s] && i < bi[s]);
    if (lt) {
      float td = bd[s];
      int ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

// ---------------------------------------------------------------------------
// K1 / K2
// ---------------------------------------------------------------------------

// A database column as the dense kernels stage it. Expanded form:
// (2x, 2y, 2z, |d|^2), w = +inf for an invalid column, which makes the whole
// distance +inf. Difference form: (x, y, z, unused), all +inf for an invalid
// column ((q - inf)^2 = +inf).
template <bool DIFF>
__device__ __forceinline__ float4 dense_column(float x, float y, float z, bool ok) {
  if (DIFF) {
    return ok ? make_float4(x, y, z, 0.0f) : make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
  }
  return ok ? make_float4(__fmul_rn(2.0f, x), __fmul_rn(2.0f, y), __fmul_rn(2.0f, z),
                          sqnorm3(x, y, z))
            : make_float4(0.0f, 0.0f, 0.0f, INFINITY);
}

// Squared distance of a query to a staged column, before the clamp.
// Expanded: (|q|^2 + |d|^2) - ((qx 2dx + qy 2dy) + qz 2dz), bitwise the plain
// version's (|q|^2 + |d|^2) - 2 ((qx dx + qy dy) + qz dz): scaling by 2 is
// exact. Difference: ((qx-dx)^2 + (qy-dy)^2) + (qz-dz)^2, never negative.
template <bool DIFF>
__device__ __forceinline__ float dense_dist2(float qx, float qy, float qz, float qn,
                                             float4 d) {
  if (DIFF) {
    const float dx = __fsub_rn(qx, d.x), dy = __fsub_rn(qy, d.y), dz = __fsub_rn(qz, d.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
  const float dot2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, d.x), __fmul_rn(qy, d.y)),
                               __fmul_rn(qz, d.z));
  return __fsub_rn(__fadd_rn(qn, d.w), dot2);
}

// The scan's view of a column, for both forms: (2x, 2y, 2z, |d|^2), and
// (0, 0, 0, +inf) for an invalid one.
__device__ __forceinline__ float4 scan_column(float x, float y, float z, bool ok) {
  return dense_column<false>(x, y, z, ok);
}

// A lower bound of the exact distance of either form, in 4 instructions:
// (|q|^2 + |d|^2) (1 - 2^-18) - q.2d, contracted into FMAs (qs is
// |q|^2 (1 - 2^-18)). The exact expanded form is within 6 ulp of |q|^2 + |d|^2
// of the real value, the exact difference form within 13, this chain within
// 9 of the shrunk one, and the shrink is 64 ulp: the bound never exceeds the
// exact value, so no column under a threshold is missed; one within
// 2^-18 (|q|^2 + |d|^2) over it is looked at in vain. +inf for an invalid column.
constexpr float kShrink = 1.0f - 1.0f / 262144.0f;
__device__ __forceinline__ float scan_bound(float qx, float qy, float qz, float qs, float4 d) {
  return fmaf(-qz, d.z, fmaf(-qy, d.y, fmaf(-qx, d.x, fmaf(d.w, kShrink, qs))));
}

// The exact distance to a valid column staged by scan_column, clamped at 0:
// bit for bit the plain version's. In the difference form q - x is taken as
// fma(-0.5, 2x, q), which rounds once, like the plain q - x.
template <bool DIFF>
__device__ __forceinline__ float scan_exact(float qx, float qy, float qz, float qn, float4 d) {
  if (DIFF) {
    const float dx = fmaf(-0.5f, d.x, qx), dy = fmaf(-0.5f, d.y, qy), dz = fmaf(-0.5f, d.z, qz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
  return fmaxf(dense_dist2<false>(qx, qy, qz, qn, d), 0.0f);
}

// The least float above x >= 0, and +inf for +inf: s < above(x) exactly when
// s <= x, and never for s = +inf (an invalid column).
__device__ __forceinline__ float above(float x) {
  return x < INFINITY ? __int_as_float(__float_as_int(x) + 1) : x;
}

// Block (x, y): queries [128 x, 128 (x+1)), one a thread; database columns
// [y chunk, (y+1) chunk). Writes each row's ascending list to
// dst[(row n_split + y) K ..], which is the result itself when n_split == 1.
//
// K2 at k = 1 keeps a running best with a compare and two selects a pair,
// columns in order. Every other instance scans: a group of 128 columns lies
// in shared memory as kSubs sub-blocks of kSub columns, column c of the group
// at position (c % kSubs) kSub + c / kSubs, so that every sub-block is a
// stride-kSubs sample of the whole group. A sub-block is scanned with
// scan_bound against a limit fixed at its start (K2: the list's k-th best;
// K1: the group's second best, seeded with the list's k-th best); the scan
// only sets a bit where one of four columns may pass. The set bits are then
// worked off: each column once more against the limit as it stands by
// then, and those that still pass get the exact distance and the real
// update, ordered by (distance, column). Limits tighten from sub-block to
// sub-block, so also a database in scan order, where distances fall
// monotonically along a ring, sends few columns to the update.
template <int K, bool GROUPED, bool DIFF>
__global__ void __launch_bounds__(kThreads)
knn_dense_kernel(const float* __restrict__ q, const float* __restrict__ db,
                 const unsigned char* __restrict__ valid, int nq, int nd, int chunk,
                 int n_split, float* __restrict__ dst_d, int* __restrict__ dst_i) {
  __shared__ float4 tile[2][kGroup];
  constexpr bool kBest1 = K == 1 && !GROUPED;
  const int t = threadIdx.x;
  // where this thread's column is staged
  const int slot = kBest1 ? t : (t % kSubs) * kSub + t / kSubs;
  const int row = blockIdx.x * kThreads + t;
  const int split = blockIdx.y;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (row < nq) {
    qx = q[3 * row];
    qy = q[3 * row + 1];
    qz = q[3 * row + 2];
  }
  const float qn = sqnorm3(qx, qy, qz);
  const float qs = __fmul_rn(qn, kShrink);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, nd);
  {
    const int col = c0 + t;
    const bool in = col < c1;
    const float x = in ? db[3 * col] : 0.0f, y = in ? db[3 * col + 1] : 0.0f;
    const float z = in ? db[3 * col + 2] : 0.0f;
    const bool ok = in && valid[col];
    tile[0][slot] = kBest1 ? dense_column<DIFF>(x, y, z, ok) : scan_column(x, y, z, ok);
  }
  __syncthreads();
  int buf = 0;
  // block-uniform loop bounds: every thread reaches each __syncthreads
  for (int g0 = c0; g0 < c1; g0 += kGroup) {
    // the next group's column: loads in flight during this group's arithmetic
    const int nxt = g0 + kGroup + t;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    bool nok = false;
    if (nxt < c1) {
      nok = valid[nxt];
      nx = db[3 * nxt];
      ny = db[3 * nxt + 1];
      nz = db[3 * nxt + 2];
    }
    const float4* cur = tile[buf];
    if constexpr (kBest1) {
#pragma unroll 16
      for (int c = 0; c < kGroup; ++c) {
        const float s = dense_dist2<DIFF>(qx, qy, qz, qn, cur[c]);
        const float v = DIFF ? s : fmaxf(s, 0.0f);
        const bool lt = v < bd[0];  // strict: a tie keeps the lower column
        bd[0] = lt ? v : bd[0];
        bi[0] = lt ? g0 + c : bi[0];
      }
    } else {
      // K1: the group's two best by (distance, column), seeded with the
      // list's k-th best under column -1. A column at or beyond the seed can
      // neither enter the list (whose entries have lower indices) nor
      // displace from the top-2 anything that could, so the result is that
      // of an unseeded top-2; a seed that stays is refused by insert().
      float d1 = bd[K - 1], d2 = bd[K - 1];
      int i1 = -1, i2 = -1;
      for (int sb = 0; sb < kSubs; ++sb) {
        const float4* sub = cur + sb * kSub;
        float lim = above(GROUPED ? d2 : bd[K - 1]);
        unsigned hits = 0u;  // bit b: one of columns 4 b .. 4 b + 3 of the sub-block may pass
#pragma unroll
        for (int b = 0; b < kSub / 4; ++b) {
          bool any = false;
#pragma unroll
          for (int u = 0; u < 4; ++u) any |= scan_bound(qx, qy, qz, qs, sub[4 * b + u]) < lim;
          if (any) hits |= 1u << b;
        }
        for (; hits != 0u; hits &= hits - 1u) {
          const int b = __ffs(hits) - 1;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = 4 * b + u;
            const float4 d = sub[p];
            // against the limit as it stands now; +inf for an invalid column
            if (!(scan_bound(qx, qy, qz, qs, d) < lim)) continue;
            const float v = scan_exact<DIFF>(qx, qy, qz, qn, d);
            const int c = p * kSubs + sb;  // column inside the group
            if (GROUPED) {
              if (v < d1 || (v == d1 && c < i1)) {
                d2 = d1;
                i2 = i1;
                d1 = v;
                i1 = c;
              } else if (v < d2 || (v == d2 && c < i2)) {
                d2 = v;
                i2 = c;
              }
              lim = above(d2);
            } else {
              insert<K, true>(bd, bi, v, g0 + c);
              lim = above(bd[K - 1]);
            }
          }
        }
      }
      if (GROUPED) {
        insert<K>(bd, bi, d1, g0 + i1);
        insert<K>(bd, bi, d2, g0 + i2);
      }
    }
    // nobody reads the other buffer: its group was consumed before the last barrier
    tile[buf ^ 1][slot] = kBest1 ? dense_column<DIFF>(nx, ny, nz, nok)
                                 : scan_column(nx, ny, nz, nok);
    __syncthreads();
    buf ^= 1;
  }
  if (row < nq) {
    const size_t base = ((size_t)row * n_split + split) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      dst_d[base + s] = bd[s];
      dst_i[base + s] = isinf(bd[s]) ? 0 : bi[s];
    }
  }
}

// ---------------------------------------------------------------------------
// K3 (strict helpers of its own: its plain version is matched bit for bit)
// ---------------------------------------------------------------------------

// ((qx-dx)^2 + (qy-dy)^2) + (qz-dz)^2, plus d.w = 0 for a valid column
// (adding +0 changes no bit of a sum >= 0) or +inf for an invalid one.
__device__ __forceinline__ float sparse_dist2(float qx, float qy, float qz, float4 d) {
  const float dx = __fsub_rn(qx, d.x), dy = __fsub_rn(qy, d.y), dz = __fsub_rn(qz, d.z);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return __fadd_rn(s, d.w);
}

// Stage database column `col` as (x, y, z, 0), w = +inf for an invalid or
// out-of-range column.
__device__ __forceinline__ float4 sparse_column(const float* __restrict__ db,
                                                const unsigned char* __restrict__ valid,
                                                int col, int nd) {
  float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
  if (col < nd && valid[col]) {
    v = make_float4(db[3 * col], db[3 * col + 1], db[3 * col + 2], 0.0f);
  }
  return v;
}

// K3. Block (x, y) owns query tile x (kThreads Morton-consecutive queries)
// and the database tiles y, y + n_split, ...; q_lo/q_hi (n_q_tiles, 3) and
// d_lo/d_hi (n_db_tiles, 3) are the tiles' boxes. nq and nd are whole tiles.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_sparse_partial_kernel(const float* __restrict__ q, const float* __restrict__ db,
                          const unsigned char* __restrict__ valid,
                          const float* __restrict__ q_lo, const float* __restrict__ q_hi,
                          const float* __restrict__ d_lo, const float* __restrict__ d_hi,
                          int nd, int db_tile, int n_db_tiles, int n_split,
                          float radius2, float* __restrict__ part_d,
                          int* __restrict__ part_i) {
  __shared__ float4 tile[kGroup];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int split = blockIdx.y;
  const float qx = q[3 * row], qy = q[3 * row + 1], qz = q[3 * row + 2];
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = q_lo[3 * blockIdx.x + c];
    hi[c] = q_hi[3 * blockIdx.x + c];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  for (int t = split; t < n_db_tiles; t += n_split) {
    float d2box = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = fmaxf(fmaxf(__fsub_rn(d_lo[3 * t + c], hi[c]),
                                  __fsub_rn(lo[c], d_hi[3 * t + c])), 0.0f);
      d2box = __fadd_rn(d2box, __fmul_rn(g, g));
    }
    if (!(d2box <= radius2)) continue;  // the same for every thread of the block
    const int c0 = t * db_tile;
    for (int g0 = c0; g0 < c0 + db_tile; g0 += kGroup) {
      __syncthreads();  // the previous group has been consumed
      tile[threadIdx.x] = sparse_column(db, valid, g0 + threadIdx.x, nd);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kGroup; ++c) {
        insert<K>(bd, bi, sparse_dist2(qx, qy, qz, tile[c]), g0 + c);
      }
    }
  }
  const size_t base = ((size_t)row * n_split + split) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    part_d[base + s] = bd[s];
    part_i[base + s] = bi[s];
  }
}

// Merge of the chunks' lists: part_* (nq, n_split, K) -> out_* (nq, K). A
// query has `lanes` neighbouring threads of one warp (a power of two <= 32,
// so a block of 128 threads holds whole queries). Lane l folds chunks
// [l per, (l+1) per) into a register list, reading each list with K
// independent loads; then lane l takes the list of lane l + o for
// o = 1, 2, ..., lanes / 2. Lanes that are no multiple of 2 o fold garbage
// from beyond their query and are never read again. Lane 0 writes the row.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                 int nq, int n_split, int lanes, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int row = tid / lanes, lane = tid % lanes;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  if (row < nq) {
    const int per = (n_split + lanes - 1) / lanes;
    const int sp1 = min((lane + 1) * per, n_split);
    for (int sp = lane * per; sp < sp1; ++sp) {
      const size_t base = ((size_t)row * n_split + sp) * K;
      float ld[K];
      int li[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        ld[s] = part_d[base + s];
        li[s] = part_i[base + s];
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K, true>(bd, bi, ld[s], li[s]);
    }
  }
  // every thread of the warp takes part in every shuffle: no early exit above
  for (int o = 1; o < lanes; o <<= 1) {
    float pd[K];
    int pi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      pd[s] = __shfl_down_sync(0xffffffffu, bd[s], o);
      pi[s] = __shfl_down_sync(0xffffffffu, bi[s], o);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) insert<K, true>(bd, bi, pd[s], pi[s]);
  }
  if (row < nq && lane == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[(size_t)row * K + s] = bd[s];
      out_i[(size_t)row * K + s] = isinf(bd[s]) ? 0 : bi[s];
    }
  }
}

template <int K>
void launch_merge(const float* part_d, const int* part_i, int nq, int n_split,
                  float* out_d, int* out_i, cudaStream_t stream) {
  int lanes = 1;
  while (lanes < n_split && lanes < 32) lanes <<= 1;
  const long long threads = (long long)nq * lanes;
  knn_merge_kernel<K><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part_d, part_i, nq, n_split, lanes, out_d, out_i);
  g_enqueued.fetch_add(1, std::memory_order_relaxed);
}

// n_split == 1: the dense kernel writes out_* itself and part_* is not read.
template <int K>
void launch_dense(const float* q, const float* db, const unsigned char* valid, int nq,
                  int nd, bool grouped, bool diff, int chunk, int n_split, float* part_d,
                  int* part_i, float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, n_split);
  float* dst_d = n_split == 1 ? out_d : part_d;
  int* dst_i = n_split == 1 ? out_i : part_i;
#define VIL_KNN_DENSE(G, D)                                \
  knn_dense_kernel<K, G, D><<<grid, kThreads, 0, stream>>>( \
      q, db, valid, nq, nd, chunk, n_split, dst_d, dst_i)
  if (grouped) {
    if (diff) VIL_KNN_DENSE(true, true); else VIL_KNN_DENSE(true, false);
  } else {
    if (diff) VIL_KNN_DENSE(false, true); else VIL_KNN_DENSE(false, false);
  }
#undef VIL_KNN_DENSE
  g_enqueued.fetch_add(1, std::memory_order_relaxed);
  if (n_split > 1) launch_merge<K>(part_d, part_i, nq, n_split, out_d, out_i, stream);
}

template <int K>
void launch_sparse(const float* q, const float* db, const unsigned char* valid,
                   const float* q_lo, const float* q_hi, const float* d_lo,
                   const float* d_hi, int nq, int nd, int db_tile, int n_split,
                   float radius2, float* part_d, int* part_i, float* out_d,
                   int* out_i, cudaStream_t stream) {
  const dim3 grid(nq / kThreads, n_split);
  knn_sparse_partial_kernel<K><<<grid, kThreads, 0, stream>>>(
      q, db, valid, q_lo, q_hi, d_lo, d_hi, nd, db_tile, nd / db_tile, n_split,
      radius2, part_d, part_i);
  g_enqueued.fetch_add(1, std::memory_order_relaxed);
  launch_merge<K>(part_d, part_i, nq, n_split, out_d, out_i, stream);
}

}  // namespace

// q (nq, 3) f32, db (nd, 3) f32, valid (nd,) bool, all contiguous on the
// current device; chunk is a multiple of 128 and n_split * chunk >= nd;
// out_* hold (nq, k) and, where n_split > 1, part_* (nq, n_split, k) (not
// read otherwise: one kernel then, two with the merge). diff != 0 selects
// the difference form. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError().
extern "C" int vil_knn_launch(const void* q, const void* db, const void* valid,
                              int nq, int nd, int k, int grouped, int diff,
                              int chunk, int n_split, void* part_d, void* part_i,
                              void* out_d, void* out_i, void* stream) {
  if (nq <= 0 || n_split <= 0 || chunk <= 0 || chunk % kGroup != 0 ||
      (long long)n_split * chunk < nd) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  const unsigned char* vb = static_cast<const unsigned char*>(valid);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool g = grouped != 0, df = diff != 0;
  switch (k) {
#define VIL_KNN_CASE(KK)                                                        \
  case KK:                                                                      \
    launch_dense<KK>(qf, dbf, vb, nq, nd, g, df, chunk, n_split, pd, pi, od, oi, s); \
    break;
    VIL_KNN_CASE(1)
    VIL_KNN_CASE(2)
    VIL_KNN_CASE(3)
    VIL_KNN_CASE(4)
    VIL_KNN_CASE(5)
    VIL_KNN_CASE(6)
    VIL_KNN_CASE(7)
    VIL_KNN_CASE(8)
#undef VIL_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernels that vil_knn_launch and vil_knn_sparse_launch have enqueued since
// the library was loaded, counted at the launch sites.
extern "C" long long vil_knn_kernels_enqueued() {
  return g_enqueued.load(std::memory_order_relaxed);
}

// K3. q (nq, 3) and db (nd, 3) f32 in Morton order, nq a multiple of 128 (the
// query tile) and nd of db_tile, itself a multiple of 128; valid (nd,) bool;
// q_lo/q_hi (nq / 128, 3) and d_lo/d_hi (nd / db_tile, 3) f32 boxes;
// radius2 the squared radius; part_* hold (nq, n_split, k), out_* (nq, k)
// with indices into the sorted database. Launches on `stream`, allocates
// nothing, does not synchronise. Returns cudaGetLastError().
extern "C" int vil_knn_sparse_launch(const void* q, const void* db, const void* valid,
                                     const void* q_lo, const void* q_hi,
                                     const void* d_lo, const void* d_hi, int nq,
                                     int nd, int k, int db_tile, int n_split,
                                     float radius2, void* part_d, void* part_i,
                                     void* out_d, void* out_i, void* stream) {
  if (nq <= 0 || nq % kThreads != 0 || db_tile <= 0 || db_tile % kGroup != 0 ||
      nd <= 0 || nd % db_tile != 0 || n_split <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  const unsigned char* vb = static_cast<const unsigned char*>(valid);
  const float* ql = static_cast<const float*>(q_lo);
  const float* qh = static_cast<const float*>(q_hi);
  const float* dl = static_cast<const float*>(d_lo);
  const float* dh = static_cast<const float*>(d_hi);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define VIL_KNN_CASE(KK)                                                       \
  case KK:                                                                     \
    launch_sparse<KK>(qf, dbf, vb, ql, qh, dl, dh, nq, nd, db_tile, n_split,   \
                      radius2, pd, pi, od, oi, s);                             \
    break;
    VIL_KNN_CASE(1)
    VIL_KNN_CASE(2)
    VIL_KNN_CASE(3)
    VIL_KNN_CASE(4)
    VIL_KNN_CASE(5)
    VIL_KNN_CASE(6)
    VIL_KNN_CASE(7)
    VIL_KNN_CASE(8)
#undef VIL_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
