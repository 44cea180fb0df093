// k-nearest-neighbour kernels for Hopper (sm_90a), bound with ctypes from
// vil_fusion_tpu_torch/ops/cuda/knn_cuda.py through vil_knn_launch() (dense),
// vil_knn_sparse() (sparse) and vil_morton_keys() (the sparse search's sort
// keys).
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
//       merge), with what knn_pallas_sparse (:397-493) does around it in
//       XLA: tile boxes (_tile_aabb :369), padding and the finishing step.
//       Both sides in Morton order, a (query tile, database tile) block is
//       skipped when the gap between the tiles' bounding boxes exceeds the
//       radius; exact within the radius. The Morton keys of morton_sort
//       (:379, _morton_keys :284) are two kernels here; the sort stays a
//       library sort (torch.argsort), as the reference sorts outside its
//       kernel.
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
//   * K3 is a whole call in two kernels and nothing else (a side the
//     caller did not sort adds its two Morton-key kernels and the sort).
//     On a lidar map it skips about 99% of its blocks, so what bounds it is
//     neither bytes nor operations but what surrounds the few near blocks:
//     in the first port a call was ~24 kernels, 20 of them PyTorch's tensor
//     code for boxes, padding and finishing (85% of the call's host time),
//     and the search kernel walked its database tiles' boxes one after the
//     other with dependent loads. So: knn_sparse_box_kernel computes every
//     database tile's box once (a warp a tile, shuffle min / max);
//     knn_sparse_kernel gives a query tile n_split blocks of 8 groups of
//     128 threads (n_split by the wrapper's plan, from shapes and the SM
//     count: the host never reads a list). Each block computes the tile's
//     box, tests all database tiles in parallel (a thread a tile, coalesced
//     box loads) and compacts the near ones in order into shared memory
//     (ballot and a prefix over the warps); the tile's n_split x 8 groups
//     deal that list out round robin, the blocks taking turns first, so
//     that a short list spreads over SMs. Each group holds the tile's 128
//     queries and searches its share of the near tiles, as the dense
//     kernels do: a tile's 128 columns are staged as four stride-4 samples
//     of 32, each scored branch-free against the list's k-th best fixed at
//     the sample's start (one hit bit a column), and only the hits go
//     through the (distance, index)-ordered insert, written without
//     branches (insert_select). Inserting every column in order sends most
//     columns of a Morton-sorted tile through the insert, since distances
//     fall along the curve as it nears the query. With n_split > 1 the
//     groups write their lists to scratch and the tile's last block to
//     finish (an atomic count a tile) folds them: the split stays inside
//     the search kernel, no merge kernel. The block's groups' lists then
//     merge in shared memory, ordered by (distance, index). Padding is by
//     index (a query row past nq reads row nq - 1, a column past nd is
//     invalid), and a side the caller did not sort is read through its
//     permutation, so nothing is copied; the finishing step (row back to
//     the caller's place, index through the database permutation, int32,
//     +inf and 0 for a missing neighbour) is the search kernel's epilogue.
//   * The Morton keys: one kernel takes each block's least valid
//     coordinates, the next folds them into the origin and writes the
//     30-bit keys, in the plain version's rounding (two launches instead of
//     ~55 elementwise ones).
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

#include <algorithm>
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

// Column `col` of the sorted database (read through `perm` where the caller
// did not sort, perm[col] being its place in the caller's order) as
// (x, y, z, 0); w = +inf for an invalid column and for one at or beyond nd
// (the plain version pads the database with invalid points).
__device__ __forceinline__ float4 sparse_column(const float* __restrict__ db,
                                                const unsigned char* __restrict__ valid,
                                                const long long* __restrict__ perm, int col,
                                                int nd) {
  float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
  if (col < nd) {
    const long long c = perm ? perm[col] : col;
    if (valid[c]) v = make_float4(db[3 * c], db[3 * c + 1], db[3 * c + 2], 0.0f);
  }
  return v;
}

// (lo, hi) of (x, y, z) over the 32 lanes of a warp, in every lane.
__device__ __forceinline__ void warp_box(float (&lo)[3], float (&hi)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], o));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], o));
    }
  }
}

// K3, first kernel: box[2 t] = lo and box[2 t + 1] = hi (w unused) of the
// valid columns of database tile t, one warp a tile; (+inf, -inf) for a
// tile without valid columns. The plain version's _tile_aabb up to the
// sign of a zero (fminf / fmaxf may return either zero of a tie), which no
// box test can see: a gap is squared.
__global__ void __launch_bounds__(kThreads)
knn_sparse_box_kernel(const float* __restrict__ db, const unsigned char* __restrict__ valid,
                      const long long* __restrict__ perm, int nd, int db_tile, int n_tiles,
                      float4* __restrict__ box) {
  const int tile = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (tile >= n_tiles) return;  // a whole warp
  const int lane = threadIdx.x % 32;
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int col = tile * db_tile + lane; col < (tile + 1) * db_tile; col += 32) {
    const float4 v = sparse_column(db, valid, perm, col, nd);
    if (v.w == 0.0f) {
      lo[0] = fminf(lo[0], v.x), lo[1] = fminf(lo[1], v.y), lo[2] = fminf(lo[2], v.z);
      hi[0] = fmaxf(hi[0], v.x), hi[1] = fmaxf(hi[1], v.y), hi[2] = fmaxf(hi[2], v.z);
    }
  }
  warp_box(lo, hi);
  if (lane == 0) {
    box[2 * tile] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    box[2 * tile + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
}

// insert<K, true> without a branch: the entries that (d, i) precedes in
// (distance, index) order form a suffix of the ascending list; each moves
// down a slot and (d, i) takes the first. Two compares and four selects a
// slot, where the branchy form took ~96 instructions a call in K3's update.
template <int K>
__device__ __forceinline__ void insert_select(float (&bd)[K], int (&bi)[K], float d, int i) {
  bool prev = false;  // (d, i) precedes entry s - 1
  float pd = 0.0f;
  int pi = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool lt = d < bd[s] || (d == bd[s] && i < bi[s]);
    const float od = bd[s];
    const int oi = bi[s];
    bd[s] = lt ? (prev ? pd : d) : od;
    bi[s] = lt ? (prev ? pi : i) : oi;
    prev = lt;
    pd = od;
    pi = oi;
  }
}

// K3's blocks: kSparseGroups groups of 128 threads, each holding the query
// tile's 128 queries, one a thread.
constexpr int kSparseGroups = 8;

// The 128 threads of group g wait for each other (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kThreads) : "memory");
}

// K3's shared memory: the groups' staged columns, or, once the search is
// over, the lists that half of the groups hand to the other half.
template <int K>
union SparseShared {
  float4 stage[kSparseGroups][kGroup];
  struct {
    float d[kSparseGroups / 2][K][kThreads];
    int i[kSparseGroups / 2][K][kThreads];
  } merge;
};

// K3, second kernel. Block (x, y) is share y of query tile x: rows
// [128 x, 128 (x+1)) of the sorted queries (through q_perm where the caller
// did not sort), a row at or beyond nq reading row nq - 1 and writing
// nothing (the plain version's padding with the last sorted query). Its S
// groups of 128 threads hold the same 128 queries, one a thread. The block
// computes its tile's box, then walks the database tiles in windows of
// S x 128: every thread tests one tile's box (rounded as sparse_near), and
// the near tiles of the window are compacted in order into near[] by
// ballots and a prefix over the warps. The tile's n_split x S groups deal
// the list out round robin, the blocks first: group g of block y takes the
// entries p with p % (n_split S) == g n_split + y. A group stages each of its tiles' columns 128
// at a time as four stride-4 samples of 32; a sample is scanned against the
// list's k-th best, and only the columns at or under it are inserted,
// ordered by (distance, index). With n_split > 1 every group writes its
// list to part_*, and the tile's last block to finish (counter[x], which
// it sets back to 0 for the next call) folds the tile's n_split x S lists,
// group g those of groups g, g + S, ... Then log2(S) rounds merge the
// block's groups' lists in shared memory, ordered by (distance, index), and
// group 0 finishes each row as sparse_finish does: written at the caller's
// row, indices through d_perm, int32, +inf and index 0 for a missing
// neighbour, distances clamped at 0.
template <int K>
__global__ void __launch_bounds__(kSparseGroups * kThreads, 1)
knn_sparse_kernel(const float* __restrict__ q, const long long* __restrict__ q_perm, int nq,
                  const float* __restrict__ db, const unsigned char* __restrict__ valid,
                  const long long* __restrict__ d_perm, int nd, int db_tile, int n_tiles,
                  const float4* __restrict__ box, float radius2, float* __restrict__ part_d,
                  int* __restrict__ part_i, unsigned* __restrict__ counter,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int S = kSparseGroups, kBlock = S * kThreads, kWarps = kBlock / 32;
  __shared__ SparseShared<K> sh;
  __shared__ int near[kBlock];
  __shared__ int count[kWarps];
  __shared__ float qbox[kThreads / 32][6];
  __shared__ int last;
  const int t = threadIdx.x, g = t / kThreads, l = t % kThreads;
  const int lane = t % 32, warp = t / 32;
  // the blocks of a tile take turns first: a short list spreads over SMs
  const int n_split = gridDim.y, n_groups = n_split * S, gid = g * n_split + blockIdx.y;
  const int row = blockIdx.x * kThreads + l;
  const int src_row = min(row, nq - 1);
  const long long src = q_perm ? q_perm[src_row] : src_row;
  const float qx = q[3 * src], qy = q[3 * src + 1], qz = q[3 * src + 2];

  if (g == 0) {  // the query tile's box, from group 0's four warps
    float lo[3] = {qx, qy, qz}, hi[3] = {qx, qy, qz};
    warp_box(lo, hi);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        qbox[warp][c] = lo[c];
        qbox[warp][3 + c] = hi[c];
      }
    }
  }
  __syncthreads();
  float qlo[3], qhi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    qlo[c] = qbox[0][c];
    qhi[c] = qbox[0][3 + c];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      qlo[c] = fminf(qlo[c], qbox[w][c]);
      qhi[c] = fmaxf(qhi[c], qbox[w][3 + c]);
    }
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  float4* stage = sh.stage[g];
  int listed = 0;  // near tiles of the earlier windows
  // block-uniform loop: every thread reaches each __syncthreads
  for (int w0 = 0; w0 < n_tiles; w0 += kBlock) {
    const int tile = w0 + t;
    bool is_near = false;
    if (tile < n_tiles) {
      const float4 lo = box[2 * tile], hi = box[2 * tile + 1];
      const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qhi[0]), __fsub_rn(qlo[0], hi.x)), 0.0f);
      const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qhi[1]), __fsub_rn(qlo[1], hi.y)), 0.0f);
      const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qhi[2]), __fsub_rn(qlo[2], hi.z)), 0.0f);
      is_near = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz))
                <= radius2;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, is_near);
    if (lane == 0) count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = count[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (is_near) near[base + __popc(ballot & ((1u << lane) - 1u))] = tile;
    __syncthreads();
    // group-uniform loops: the group's 128 threads reach each group_sync
    for (int e = ((gid - listed) % n_groups + n_groups) % n_groups; e < total; e += n_groups) {
      const int c0 = near[e] * db_tile;
      for (int g0 = c0; g0 < c0 + db_tile; g0 += kGroup) {
        group_sync(g);  // the group's previous columns have been consumed
        stage[(l % kSubs) * kSub + l / kSubs] = sparse_column(db, valid, d_perm, g0 + l, nd);
        group_sync(g);
        // scan, then update, as the dense kernels do: run r holds columns
        // g0 + 4 p + r, a stride-4 sample of the 128, and is scored
        // branch-free against the list's k-th best as it stands at the
        // run's start, one bit a column at or under it; the marked columns
        // then go through the insert ordered by (distance, index). The k-th
        // best only falls, so no column of the final list is left unmarked,
        // and the order of the inserts does not matter: the list is the
        // (distance, index)-least k of all columns, as the plain version's.
#pragma unroll
        for (int r = 0; r < kSubs; ++r) {
          const float4* run = stage + r * kSub;
          const float lim = bd[K - 1];
          unsigned hits = 0u;
#pragma unroll
          for (int p = 0; p < kSub; ++p) {
            hits |= (sparse_dist2(qx, qy, qz, run[p]) <= lim ? 1u : 0u) << p;
          }
          for (; hits != 0u; hits &= hits - 1u) {
            const int p = __ffs(hits) - 1;
            insert_select<K>(bd, bi, sparse_dist2(qx, qy, qz, run[p]), g0 + p * kSubs + r);
          }
        }
      }
    }
    listed += total;
    __syncthreads();  // near[] and count[] are rewritten by the next window
  }

  if (n_split > 1) {
    // hand the group's list over; the tile's last block to finish goes on
    const size_t tile_lists = (size_t)blockIdx.x * n_groups;
    const size_t mine = (tile_lists + gid) * K * kThreads + l;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[mine + s * kThreads] = bd[s];
      part_i[mine + s * kThreads] = bi[s];
    }
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&counter[blockIdx.x], 1u) == (unsigned)n_split - 1u;
    __syncthreads();
    if (!last) return;  // block-uniform
    __threadfence();
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = INFINITY;
      bi[s] = 0;
    }
    for (int j = g; j < n_groups; j += S) {
      const size_t at = (tile_lists + j) * K * kThreads + l;
      // from L2: the other blocks' writes never passed through this SM's L1
      for (int s = 0; s < K; ++s) {
        const float d = __ldcg(part_d + at + s * kThreads);
        const int i = __ldcg(part_i + at + s * kThreads);
        // a list is ascending: once an entry stays out, so do the rest
        // (a group that found nothing hands over +inf only)
        if (!(d < bd[K - 1] || (d == bd[K - 1] && i < bi[K - 1]))) break;
        insert_select<K>(bd, bi, d, i);
      }
    }
    if (t == 0) counter[blockIdx.x] = 0u;
  }

  // group g + h hands its list to group g, h = S/2, ..., 1 (the staged
  // columns are dead: every group has passed the last barrier above)
#pragma unroll
  for (int h = S / 2; h >= 1; h /= 2) {
    if (g >= h && g < 2 * h) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        sh.merge.d[g - h][s][l] = bd[s];
        sh.merge.i[g - h][s][l] = bi[s];
      }
    }
    __syncthreads();
    if (g < h) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        insert_select<K>(bd, bi, sh.merge.d[g][s][l], sh.merge.i[g][s][l]);
      }
    }
    __syncthreads();
  }
  if (g == 0 && row < nq) {
    const long long dst = (q_perm ? q_perm[row] : row) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool miss = isinf(bd[s]);
      out_d[dst + s] = miss ? bd[s] : fmaxf(bd[s], 0.0f);
      out_i[dst + s] = miss ? 0 : d_perm ? (int)d_perm[bi[s]] : bi[s];
    }
  }
}

// ---------------------------------------------------------------------------
// Morton keys (morton_sort's keys; the sort itself stays torch.argsort, as
// the reference sorts outside its kernel)
// ---------------------------------------------------------------------------

constexpr int kMortonThreads = 256;
constexpr int kMortonMaxPartials = 256;  // blocks of the origin kernel at most

// The least (x, y, z) over the block, in thread 0; `part` holds a warp's.
__device__ __forceinline__ void block_min3(float (&m)[3], float (*part)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) m[c] = fminf(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) part[threadIdx.x / 32][c] = m[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kMortonThreads / 32; ++w) {
#pragma unroll
      for (int c = 0; c < 3; ++c) m[c] = fminf(m[c], part[w][c]);
    }
  }
}

// partial[3 b + c]: the least coordinate c of the valid points of block b's
// grid-stride share (+inf where it has none). valid == nullptr: all valid.
__global__ void __launch_bounds__(kMortonThreads)
morton_origin_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                     int n, float* __restrict__ partial) {
  __shared__ float part[kMortonThreads / 32][3];
  float m[3] = {INFINITY, INFINITY, INFINITY};
  for (int i = blockIdx.x * kMortonThreads + threadIdx.x; i < n; i += gridDim.x * kMortonThreads) {
    if (valid == nullptr || valid[i]) {
#pragma unroll
      for (int c = 0; c < 3; ++c) m[c] = fminf(m[c], pts[3 * i + c]);
    }
  }
  block_min3(m, part);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) partial[3 * blockIdx.x + c] = m[c];
  }
}

// Interleave the low 10 bits of x with two zero bits (ops/knn.py:_spread3).
__device__ __forceinline__ unsigned spread3(unsigned x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// keys[i]: the 30-bit Morton key of point i, 0x7FFFFFFF for an invalid
// one. Every block folds the n_partial minima into the origin (the least
// valid coordinate minus 1e-3, a float32 subtraction as the plain
// version's tensor minus a Python float). A cell coordinate is
// (p - origin) / cell rounded once each, truncated toward zero
// (__float2int_rz, which saturates as PyTorch's CUDA cast does) and clamped
// to 0..1023. For a cell that is a power of two (2.0 throughout the port)
// the division equals the multiplication by the reciprocal that PyTorch's
// CUDA kernel does for a tensor divided by a Python float.
__global__ void __launch_bounds__(kMortonThreads)
morton_key_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid, int n,
                  const float* __restrict__ partial, int n_partial, float cell,
                  int* __restrict__ keys) {
  __shared__ float part[kMortonThreads / 32][3];
  __shared__ float origin[3];
  float m[3] = {INFINITY, INFINITY, INFINITY};
  for (int p = threadIdx.x; p < n_partial; p += kMortonThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) m[c] = fminf(m[c], partial[3 * p + c]);
  }
  block_min3(m, part);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) origin[c] = __fsub_rn(m[c], 1e-3f);
  }
  __syncthreads();
  for (int i = blockIdx.x * kMortonThreads + threadIdx.x; i < n; i += gridDim.x * kMortonThreads) {
    int key = 0x7FFFFFFF;
    if (valid == nullptr || valid[i]) {
      unsigned cc[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int v = __float2int_rz(__fdiv_rn(__fsub_rn(pts[3 * i + c], origin[c]), cell));
        cc[c] = (unsigned)min(max(v, 0), 1023);
      }
      key = (int)(spread3(cc[0]) | (spread3(cc[1]) << 1) | (spread3(cc[2]) << 2));
    }
    keys[i] = key;
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

// The box kernel where the database has a tile, then the search over an
// (n_q_tiles, n_split) grid.
template <int K>
void launch_sparse(const float* q, const long long* q_perm, int nq, const float* db,
                   const unsigned char* valid, const long long* d_perm, int nd, int db_tile,
                   int n_split, float radius2, float4* box, float* part_d, int* part_i,
                   unsigned* counter, float* out_d, int* out_i, cudaStream_t stream) {
  const int n_tiles = (nd + db_tile - 1) / db_tile;
  if (n_tiles > 0) {
    constexpr int kTilesPerBlock = kThreads / 32;
    knn_sparse_box_kernel<<<(n_tiles + kTilesPerBlock - 1) / kTilesPerBlock, kThreads, 0,
                            stream>>>(db, valid, d_perm, nd, db_tile, n_tiles, box);
    g_enqueued.fetch_add(1, std::memory_order_relaxed);
  }
  const dim3 grid((nq + kThreads - 1) / kThreads, n_split);
  knn_sparse_kernel<K><<<grid, kSparseGroups * kThreads, 0, stream>>>(
      q, q_perm, nq, db, valid, d_perm, nd, db_tile, n_tiles, box, radius2, part_d, part_i,
      counter, out_d, out_i);
  g_enqueued.fetch_add(1, std::memory_order_relaxed);
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

// Kernels that vil_knn_launch, vil_knn_sparse and vil_morton_keys have enqueued since
// the library was loaded, counted at the launch sites.
extern "C" long long vil_knn_kernels_enqueued() {
  return g_enqueued.load(std::memory_order_relaxed);
}

// K3. q (nq, 3) and db (nd, 3) f32, valid (nd,) bool, as the caller holds
// them; q_perm (nq,) / d_perm (nd,) int64 the Morton order of a side the
// caller did not sort (nullptr for a side in Morton order already). Any
// nq >= 1 and nd >= 0; db_tile a multiple of 128; radius2 the squared
// radius; n_split >= 1 blocks a query tile. scratch: 32 B a database tile
// for the boxes, then, where n_split > 1, 8 B an entry of the (query tile,
// n_split x 8 groups, k, 128 rows) lists; counter (n_q_tiles,) uint32, all
// 0 (the kernel leaves them 0). out_* (nq, k) in the caller's row order
// with indices into the caller's database. Enqueues the box kernel (none
// without a database tile) and the search on `stream`; allocates nothing,
// does not synchronise. Returns cudaGetLastError().
extern "C" int vil_knn_sparse(const void* q, const void* q_perm, int nq, const void* db,
                              const void* valid, const void* d_perm, int nd, int k,
                              int db_tile, int n_split, float radius2, void* scratch,
                              void* counter, void* out_d, void* out_i, void* stream) {
  if (nq <= 0 || nd < 0 || db_tile <= 0 || db_tile % kGroup != 0 || k < 1 || k > 8 ||
      n_split < 1 || n_split > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const long long* qp = static_cast<const long long*>(q_perm);
  const float* dbf = static_cast<const float*>(db);
  const unsigned char* vb = static_cast<const unsigned char*>(valid);
  const long long* dp = static_cast<const long long*>(d_perm);
  float4* bx = static_cast<float4*>(scratch);
  const size_t n_tiles = (nd + db_tile - 1) / db_tile;
  const size_t lists = (size_t)((nq + kThreads - 1) / kThreads) * n_split * kSparseGroups * k *
                       kThreads;
  float* pd = reinterpret_cast<float*>(bx + 2 * n_tiles);
  int* pi = reinterpret_cast<int*>(pd + lists);
  unsigned* cnt = static_cast<unsigned*>(counter);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define VIL_KNN_CASE(KK)                                                                      \
  case KK:                                                                                    \
    launch_sparse<KK>(qf, qp, nq, dbf, vb, dp, nd, db_tile, n_split, radius2, bx, pd, pi, cnt, \
                      od, oi, s);                                                             \
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
  }
  return (int)cudaGetLastError();
}

// Morton keys of pts (n, 3) f32 with valid (n,) bool (nullptr: all valid)
// into keys (n,) int32, n >= 1; partial is scratch of 3 KB. Two kernels
// on `stream`: the blocks' minima, then the origin and the keys.
extern "C" int vil_morton_keys(const void* pts, const void* valid, int n, float cell,
                               void* partial, void* keys, void* stream) {
  if (n <= 0 || !(cell > 0.0f)) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pts);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8 points a thread to find the minima, 4 to write the keys
  const int n_partial =
      std::min(kMortonMaxPartials, (n + 8 * kMortonThreads - 1) / (8 * kMortonThreads));
  const int key_blocks = std::min(1024, (n + 4 * kMortonThreads - 1) / (4 * kMortonThreads));
  morton_origin_kernel<<<n_partial, kMortonThreads, 0, s>>>(p, v, n, part);
  g_enqueued.fetch_add(1, std::memory_order_relaxed);
  morton_key_kernel<<<key_blocks, kMortonThreads, 0, s>>>(p, v, n, part, n_partial, cell,
                                                          static_cast<int*>(keys));
  g_enqueued.fetch_add(1, std::memory_order_relaxed);
  return (int)cudaGetLastError();
}
