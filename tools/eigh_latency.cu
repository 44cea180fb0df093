// Latency microbenchmarks behind csrc/eigh.cu's design, on one CUDA card.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/eigh_latency tools/eigh_latency.cu
//   build/eigh_latency
//
// Prints the SM clocks an iteration of a dependent chain takes (one thread):
// DFMA, DMUL, DADD, FFMA, double rsqrt / sqrt / division, a float <-> double
// round trip, a shared-memory load chain; the throughput of float -> double
// conversions and of DFMA with 1-32 warps; and the clocks a rotation of the
// QL producer's loop (csrc/eigh.cu ql_producer's chain on synthetic data,
// one warp): as the kernel runs it, on one lane, without its stores,
// without its shared loads, and with the library's 1 / sqrt.
#include <cstdio>
#include <cuda_runtime.h>
__device__ long long out_c[32];
__device__ double sink[32];
__global__ void lat(double x0, int iters) {
  __shared__ double sh[1024];
  __shared__ int shi[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) { sh[i] = 1.0 + i * 1e-9; shi[i] = (i * 7 + 1) & 1023; }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double x = x0; long long t;
  float xf = (float)x0;
  // 0 dfma chain
  t = clock64(); for (int i = 0; i < iters; ++i) x = fma(x, 0.999999, 1e-7); out_c[0] = (clock64() - t); sink[0] = x;
  // 1 dmul chain
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) x = x * 1.0000001; out_c[1] = (clock64() - t); sink[1] = x;
  // 2 rsqrt chain
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) x = rsqrt(x) + 0.5; out_c[2] = (clock64() - t); sink[2] = x;
  // 3 sqrt chain
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) x = sqrt(x) + 0.5; out_c[3] = (clock64() - t); sink[3] = x;
  // 4 div chain
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) x = 1.5 / x + 0.5; out_c[4] = (clock64() - t); sink[4] = x;
  // 5 f2f round trip
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) x = (double)(float)x + 1e-3; out_c[5] = (clock64() - t); sink[5] = x;
  // 6 lds chain (int pointer chase)
  int k = 1; t = clock64(); for (int i = 0; i < iters; ++i) k = shi[k]; out_c[6] = (clock64() - t); sink[6] = k;
  // 7 float-seeded rsqrt + 1 newton in double
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) { double y = (double)rsqrtf((float)x); y = y * fma(-0.5 * x * y, y, 1.5); x = y + 0.5; } out_c[7] = (clock64() - t); sink[7] = x;
  // 8 MUFU.RSQ64H-based: __drcp_rn chain
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) x = __drcp_rn(x) + 0.5; out_c[8] = (clock64() - t); sink[8] = x;
  // 9 dadd chain
  x = x0; t = clock64(); for (int i = 0; i < iters; ++i) x = x + 1e-9; out_c[9] = (clock64() - t); sink[9] = x;
  // 10 ffma chain
  t = clock64(); for (int i = 0; i < iters; ++i) xf = fmaf(xf, 0.999f, 1e-3f); out_c[10] = (clock64() - t); sink[10] = xf;
  // 11 lds.64 double chase via value
  x = 0; t = clock64(); for (int i = 0; i < iters; ++i) x = sh[(int)x & 511] * 0.0; out_c[11] = (clock64() - t); sink[11] = x;
  // 12 rsqrt via approximate intrinsic? (__frsqrt_rn float) chain
  t = clock64(); for (int i = 0; i < iters; ++i) xf = rsqrtf(xf) + 0.5f; out_c[12] = (clock64() - t); sink[12] = xf;
}
// throughput of F2F and DFMA with many warps
__global__ void thr(float* a, int iters, long long* outc) {
  float x = a[threadIdx.x]; double acc = 0;
  long long t = clock64();
  #pragma unroll 8
  for (int i = 0; i < iters; ++i) { acc += (double)x; x += 1.0f; }
  long long c1 = clock64() - t;
  double y = acc; t = clock64();
  #pragma unroll 8
  for (int i = 0; i < iters; ++i) { y = fma(y, 1.0000001, 1e-9); }
  long long c2 = clock64() - t;
  if (threadIdx.x == 0) { outc[0] = c1; outc[1] = c2; }
  a[threadIdx.x] = (float)(acc + y);
}
__device__ long long outc_chain[8];
__device__ double sinkd[8];
__device__ __forceinline__ double rsqrt_normal(double x) {
  double y; asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  const double e = fma(-x * y, y, 1.0);
  return fma(y * e, fma(e, 0.375, 0.5), y);
}
template <int MODE>
__global__ void chain(int n, int reps) {
  __shared__ double d[256], e[256];
  __shared__ double2 rcs[2048]; __shared__ int ridx[2048];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) { d[i] = 2.0 + 0.001 * i; e[i] = 0.5 + 0.0001 * i; }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (MODE == 1 && lane != 0) return;
  long long t0 = clock64();
  double g = 0.3, s = 1.0, c = 1.0, p = 0.0; int pos = 0;
  for (int r = 0; r < reps; ++r) {
    double ei = e[n - 1], di = d[n - 1], di1 = d[n];
    for (int i = n - 1; i >= 0; --i) {
      double en = 0.0, dn = 0.0;
      if (MODE != 3) { en = i > 0 ? e[i - 1] : 0.0; dn = i > 0 ? d[i - 1] : 0.0; }
      else { en = ei * 0.999; dn = di * 1.001; }
      const double f = s * ei, b = c * ei;
      const double q = fma(f, f, g * g);
      const double gt = di1 - p;
      const double X = fma(di - gt, f, 2.0 * g * b);
      const double inv = (MODE == 4) ? 1.0 / sqrt(q) : rsqrt_normal(q), w = inv * inv;
      s = f * inv; c = g * inv;
      p = (f * X) * w;
      g = fma(g * X, w, -b);
      if (MODE != 2) {
        e[i + 1] = q * inv; d[i + 1] = gt + p;
        const int slot = pos & 2047; ridx[slot] = i; rcs[slot] = make_double2(c, s);
      }
      ++pos; ei = en; di1 = di; di = dn;
    }
    g = 0.3 + g * 1e-300; s = 1.0 + s * 1e-300; c = 1.0; p = 0.0;
  }
  long long t = clock64() - t0;
  if (threadIdx.x == 0) { outc_chain[MODE] = t; sinkd[MODE] = g + s + c + p; }
}
int main() {
  const int iters = 10000;
  lat<<<1, 32>>>(1.7, iters);
  cudaDeviceSynchronize();
  long long c[32];
  cudaMemcpyFromSymbol(c, out_c, sizeof(c));
  const char* names[] = {"dfma", "dmul", "rsqrt(double) + dadd", "sqrt(double) + dadd",
                         "div(double) + dadd", "f2f round trip + dadd", "lds int chase",
                         "rsqrtf seed + 1 newton (double) + dadd", "__drcp_rn + dadd", "dadd",
                         "ffma", "lds.64 chase + f2i + dmul", "rsqrtf + fadd"};
  for (int i = 0; i < 13; ++i) printf("%-40s %8.2f clocks an iteration\n", names[i], (double)c[i] / iters);
  float* a;
  long long* oc;
  cudaMalloc(&a, 1024 * 4);
  cudaMemset(a, 0, 4096);
  cudaMalloc(&oc, 16);
  for (int warps = 1; warps <= 32; warps *= 2) {
    thr<<<1, 32 * warps>>>(a, iters, oc);
    cudaDeviceSynchronize();
    long long h[2];
    cudaMemcpy(h, oc, 16, cudaMemcpyDeviceToHost);
    printf("warps %2d: F2F.F64.F32 + DADD loop %8.2f, DFMA loop %8.2f clocks an iteration\n", warps,
           (double)h[0] / iters, (double)h[1] / iters);
  }
  const int n = 150, reps = 100;
  chain<0><<<1, 32>>>(n, reps);
  chain<1><<<1, 32>>>(n, reps);
  chain<2><<<1, 32>>>(n, reps);
  chain<3><<<1, 32>>>(n, reps);
  chain<4><<<1, 32>>>(n, reps);
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(c, outc_chain, 8 * sizeof(long long));
  const char* nm[] = {"QL chain: one warp, as the kernel", "QL chain: one lane", "QL chain: no stores",
                      "QL chain: no shared loads", "QL chain: library 1 / sqrt"};
  for (int m = 0; m < 5; ++m) printf("%-40s %8.1f clocks a rotation\n", nm[m], (double)c[m] / (n * reps));
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
