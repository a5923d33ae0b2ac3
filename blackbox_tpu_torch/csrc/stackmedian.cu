// Stack median (K9) for Hopper: ops/stats.median along a short leading
// axis (N <= 32) on the card.
//
// Replaces no TPU kernel.  The JAX package's stack median is XLA's
// jnp.median (blackbox_tpu/pipeline/masters.py:29, :66), which the
// port's plain route computes with torch.sort along the axis: for the
// 20-deep bias cube of the masters it writes 8.92 GB of sorted values
// and 17.84 GB of int64 indices that nothing reads, pads each column to
// 32 for a bitonic sort, and reads the cube once more for the NaN test.
//
// What bounds it on the H100: memory traffic.  The (N, M) stack is read
// once and the (M,) median written once, (N + 1) * M * 4 bytes: 2.80 ms
// for a bias (20 x 16 x 5280 x 1320) and 2.13 ms for a flat (N 15) at
// 3.35 TB/s.  The design:
//   layout     a thread owns V adjacent columns (V = 4 through float4
//              loads where M and the pointers allow, else 1) and loads
//              row n = 0..N-1 of them, coalesced across the warp; the N
//              loads are independent, so N * V * 4 bytes a thread are in
//              flight before the first compare.  The loads are streaming
//              (ld.global.cs): the stack is read once.
//   NaN        a flag a column, from isnan of each value.
//   selection  StackMedian<N> (stack_median_networks.cuh, generated by
//              ops/filters.stack_median_source): odd-even merges up a
//              balanced tree, forgetting after each merge the ranks that
//              can be neither middle value, pruned to the comparators
//              that feed ranks (N-1)/2 and N/2; in registers, 128
//              min/max a column at N 20 and 84 at N 15, below the time
//              the column's loads take.
//   output     NaN (0x7fc00000, the constant the sort route writes) if
//              the flag is set, else (lo + hi) * 0.5 rounded as
//              jnp.median rounds it (no FMA), for odd N too (lo = hi:
//              near FLT_MAX the sum overflows to inf, as there).
//
// Measured on one H100 80GB HBM3 at 700 W (CUDA events, chip_smoke.py):
// 3.13 ms at the bias cube and 2.39 ms at the flat, 89 % of the bound,
// with 90 and 74 registers a thread (V = 4) and no spills; the sort
// route took 140.1 and 110.3 ms.
//
// Launcher contract: `in` is an (N, M) contiguous float32 array on the
// device and `out` an (M,) one, 1 <= N <= 32, M >= 1.  One kernel
// launch on `stream`; it allocates nothing, does not synchronise, and
// returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stack_median_networks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 32;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void unpack(float x, float* o) { o[0] = x; }
__device__ __forceinline__ void unpack(float4 x, float* o) {
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void store(float* p, const float* r) { *p = r[0]; }
__device__ __forceinline__ void store(float4* p, const float* r) {
  *p = make_float4(r[0], r[1], r[2], r[3]);
}

template <int N, int V>
__global__ void __launch_bounds__(kThreads)
    stack_median_kernel(const float* __restrict__ in, float* __restrict__ out,
                        long long cols) {
  using T = typename Vec<V>::T;
  // cols = M / V vectors of V columns; thread g owns vector g
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= cols) return;
  const T* src = reinterpret_cast<const T*>(in) + g;
  float v[V][N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float t[V];
    unpack(__ldcs(src + n * cols), t);
#pragma unroll
    for (int c = 0; c < V; ++c) v[c][n] = t[c];
  }
  float r[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    bool nan = false;
#pragma unroll
    for (int n = 0; n < N; ++n) nan |= isnan(v[c][n]);
    float lo, hi;
    StackMedian<N>::select(v[c], lo, hi);
    r[c] = nan ? __int_as_float(0x7fc00000)
               : __fmul_rn(__fadd_rn(lo, hi), 0.5f);
  }
  store(reinterpret_cast<T*>(out) + g, r);
}

template <int N, int V>
cudaError_t launch_n(const float* in, float* out, long long M,
                     cudaStream_t st) {
  const long long cols = M / V;
  const long long blocks = (cols + kThreads - 1) / kThreads;
  stack_median_kernel<N, V><<<(unsigned)blocks, kThreads, 0, st>>>(in, out,
                                                                   cols);
  return cudaGetLastError();
}

template <int V, int N = 1>
cudaError_t launch(int n, const float* in, float* out, long long M,
                   cudaStream_t st) {
  if (n == N) return launch_n<N, V>(in, out, M, st);
  if constexpr (N < kMaxN) {
    return launch<V, N + 1>(n, in, out, M, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bbt_stack_median(const void* in, void* out, int N, int M,
                                void* stream) {
  if (N < 1 || N > kMaxN || M < 1) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)in;
  float* y = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec4 = M % 4 == 0 && (uintptr_t)in % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  return (int)(vec4 ? launch<4>(N, x, y, M, st) : launch<1>(N, x, y, M, st));
}
