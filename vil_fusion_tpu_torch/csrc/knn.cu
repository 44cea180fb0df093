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
// Semantics and rounding. Squared distances in float32 on the CUDA cores (no
// tensor cores, no TF32: with a depth of 3 a matrix product buys nothing),
// in one of two forms: the expanded form of the mxu=True path,
// |q|^2 + |d|^2 - 2 q.d, or the difference form,
// ((qx-dx)^2 + (qy-dy)^2) + (qz-dz)^2. Every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn, no FMA contraction) in the order of the
// plain PyTorch version in ops/knn.py, so kernel and plain version agree bit
// for bit on every distance. K3's box test (per axis max(dlo - qhi,
// qlo - dhi, 0), squared, summed in x, y, z order, <= radius^2) is rounded
// the same way, so kernel and plain version skip the same blocks. Host
// contract: rows ascending, distances clamped at >= 0, +inf and index 0 for
// a missing neighbour, invalid database points never selected.
//
// Design for this card. A TPU grid walks the database tiles of one query
// tile in order and carries the running best in VMEM scratch; Hopper's
// blocks run in no order and carry nothing between them. So:
//   * one thread owns one query and keeps its running top-k (k <= 8; K1's
//     per-group top-2 too) in registers, unrolled over a compile-time K;
//   * a block of 128 threads (128 queries) walks one contiguous chunk of
//     the database, one 128-column group at a time staged in shared memory
//     as float4 (x, y, z, |d|^2 or +inf if invalid); every thread reads the
//     same element at the same time, so shared-memory reads are broadcasts;
//   * the database is split into chunks over gridDim.y so that a few
//     thousand queries still fill the 132 SMs; each (query, chunk) writes
//     its partial top-k, and a second kernel merges the chunks' lists in
//     chunk order. Top-k of a union is the top-k of the parts' top-k, and
//     K1's groups never straddle a chunk (chunks are whole groups), so the
//     split changes no result.
//   * K3 keeps that split, but deals the database tiles to the gridDim.y
//     blocks round-robin (tile t goes to block t % n_split): the tiles near a
//     query tile are Morton-neighbours, so contiguous chunks would leave most
//     blocks with nothing and a few with everything. Every thread of a block
//     evaluates the same box test on the same values (block-uniform branch);
//     a block whose tiles are all far writes an empty list and ends.
// What bounds it: the distance arithmetic (~12 instructions per pair on the
// CUDA cores); database traffic is one read per block from L2. K3 on a
// lidar map skips about 99% of its blocks, so there the box tests (one per
// database tile and block, read through L1) and the two launches are what
// is left. cp.async/TMA staging, several queries per thread and a list of
// near tile pairs built before the launch are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kGroup = 128;    // database columns per staged group (== K1 group)

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// DIFF: ((qx-dx)^2 + (qy-dy)^2) + (qz-dz)^2, plus d.w = 0 for a valid column
// (adding +0 changes no bit of a sum >= 0) or +inf for an invalid one.
// Otherwise |q|^2 + |d|^2 - 2 q.d clamped at 0; d.w = |d|^2, or +inf for an
// invalid column, which makes the whole expression +inf.
template <bool DIFF>
__device__ __forceinline__ float pair_dist2(float qx, float qy, float qz,
                                            float qn, float4 d) {
  if (DIFF) {
    const float dx = __fsub_rn(qx, d.x), dy = __fsub_rn(qy, d.y), dz = __fsub_rn(qz, d.z);
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    return __fadd_rn(s, d.w);
  }
  float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, d.x), __fmul_rn(qy, d.y)),
                        __fmul_rn(qz, d.z));
  float s = __fsub_rn(__fadd_rn(qn, d.w), __fmul_rn(2.0f, dot));
  return fmaxf(s, 0.0f);
}

// Insert (d, i) into the ascending register list. Callers feed candidates in
// increasing index order relative to every equal-distance entry already in
// the list, so the strict early-out keeps the lower index on ties; displaced
// entries bubble down in (distance, index) order.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
  if (!(d < bd[K - 1])) return;
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

// Stage database column `col` as (x, y, z, w): w is |d|^2 (expanded form) or
// 0 (difference form), +inf for an invalid or out-of-range column.
template <bool DIFF>
__device__ __forceinline__ float4 stage_column(const float* __restrict__ db,
                                               const unsigned char* __restrict__ valid,
                                               int col, int nd) {
  float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
  if (col < nd && valid[col]) {
    const float x = db[3 * col], y = db[3 * col + 1], z = db[3 * col + 2];
    v = make_float4(x, y, z, DIFF ? 0.0f : sqnorm3(x, y, z));
  }
  return v;
}

template <int K, bool GROUPED, bool DIFF>
__global__ void __launch_bounds__(kThreads)
knn_partial_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const unsigned char* __restrict__ valid, int nq, int nd,
                   int chunk, int n_split, float* __restrict__ part_d,
                   int* __restrict__ part_i) {
  __shared__ float4 tile[kGroup];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int split = blockIdx.y;
  const bool active = row < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * row];
    qy = q[3 * row + 1];
    qz = q[3 * row + 2];
  }
  const float qn = sqnorm3(qx, qy, qz);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, nd);
  // block-uniform loop bounds: every thread reaches each __syncthreads
  for (int g0 = c0; g0 < c1; g0 += kGroup) {
    __syncthreads();  // the previous group has been consumed
    tile[threadIdx.x] = stage_column<DIFF>(db, valid, g0 + threadIdx.x, nd);
    __syncthreads();
    if (GROUPED) {
      float d1 = INFINITY, d2 = INFINITY;
      int i1 = 0, i2 = 0;
#pragma unroll 8
      for (int c = 0; c < kGroup; ++c) {
        const float d = pair_dist2<DIFF>(qx, qy, qz, qn, tile[c]);
        if (d < d2) {
          if (d < d1) {
            d2 = d1;
            i2 = i1;
            d1 = d;
            i1 = g0 + c;
          } else {
            d2 = d;
            i2 = g0 + c;
          }
        }
      }
      insert<K>(bd, bi, d1, i1);
      insert<K>(bd, bi, d2, i2);
    } else {
#pragma unroll 8
      for (int c = 0; c < kGroup; ++c) {
        insert<K>(bd, bi, pair_dist2<DIFF>(qx, qy, qz, qn, tile[c]), g0 + c);
      }
    }
  }
  if (active) {
    const size_t base = ((size_t)row * n_split + split) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[base + s] = bd[s];
      part_i[base + s] = bi[s];
    }
  }
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
      tile[threadIdx.x] = stage_column<true>(db, valid, g0 + threadIdx.x, nd);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kGroup; ++c) {
        insert<K>(bd, bi, pair_dist2<true>(qx, qy, qz, 0.0f, tile[c]), g0 + c);
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

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                 int nq, int n_split, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= nq) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  const size_t base = (size_t)row * n_split * K;
  for (int sp = 0; sp < n_split; ++sp) {  // insert() orders ties by index
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float d = part_d[base + (size_t)sp * K + s];
      if (!(d < bd[K - 1])) break;  // each partial list is ascending
      insert<K>(bd, bi, d, part_i[base + (size_t)sp * K + s]);
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_d[(size_t)row * K + s] = bd[s];
    out_i[(size_t)row * K + s] = isinf(bd[s]) ? 0 : bi[s];
  }
}

template <int K>
void launch(const float* q, const float* db, const unsigned char* valid, int nq,
            int nd, bool grouped, bool diff, int chunk, int n_split, float* part_d,
            int* part_i, float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, n_split);
#define VIL_KNN_PARTIAL(G, D)                                  \
  knn_partial_kernel<K, G, D><<<grid, kThreads, 0, stream>>>(  \
      q, db, valid, nq, nd, chunk, n_split, part_d, part_i)
  if (grouped) {
    if (diff) VIL_KNN_PARTIAL(true, true); else VIL_KNN_PARTIAL(true, false);
  } else {
    if (diff) VIL_KNN_PARTIAL(false, true); else VIL_KNN_PARTIAL(false, false);
  }
#undef VIL_KNN_PARTIAL
  knn_merge_kernel<K><<<(nq + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_d, part_i, nq, n_split, out_d, out_i);
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
  knn_merge_kernel<K><<<nq / kThreads, kThreads, 0, stream>>>(
      part_d, part_i, nq, n_split, out_d, out_i);
}

}  // namespace

// q (nq, 3) f32, db (nd, 3) f32, valid (nd,) bool, all contiguous on the
// current device; chunk is a multiple of 128 and n_split * chunk >= nd;
// part_* hold (nq, n_split, k), out_* (nq, k). diff != 0 selects the
// difference form. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError().
extern "C" int vil_knn_launch(const void* q, const void* db, const void* valid,
                              int nq, int nd, int k, int grouped, int diff,
                              int chunk, int n_split, void* part_d, void* part_i,
                              void* out_d, void* out_i, void* stream) {
  if (nq <= 0 || n_split <= 0 || chunk <= 0 || chunk % kGroup != 0) {
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
#define VIL_KNN_CASE(KK)                                                  \
  case KK:                                                                \
    launch<KK>(qf, dbf, vb, nq, nd, g, df, chunk, n_split, pd, pi, od, oi, s); \
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
