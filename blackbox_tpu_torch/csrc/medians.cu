// k x k median filter (k = 3, 5, 7) for Hopper.
//
// Replaces the TPU kernel blackbox_tpu/pallas/medians.py::_median_kernel
// (wrapper median_filter_pallas): the exact k*k//2-th order statistic of
// every k x k window of a float32 image; the outer k//2 border keeps the
// input value.  Any correct selection network with NaN-propagating
// min/max gives NaN exactly where the window holds a NaN and the exact
// order statistic elsewhere, so this kernel runs its own comparator
// program and still equals the plain version
// (blackbox_tpu_torch/ops/filters.py::_median_plain) bit for bit, up to
// the sign of a zero.
//
// What bounds it on the H100: min/max instructions, one each
// (min.NaN.f32 / max.NaN.f32): 19.5, 67.25 and 148.25 a pixel for
// k = 3, 5, 7 in this design, against one read and one write of the
// frame.  The design cuts the instructions: each thread owns a 2 x 4
// tile of outputs and runs the tile program of median_networks.cuh
// (MedianTile<K>, generated by filters.tile_median_ops) on the
// (k+1) x (k+3) patch under it in registers.  The program sorts the
// pixels that the tile's windows share once, merges each window's own
// pixels into copies, forgets at every merge the ranks that cannot be
// the median, and is pruned jointly for the 8 outputs (A. Adams, "Fast
// Median Filters Using Separable Sorting Networks", ACM TOG 40(4),
// 2021).  A block stages its 32 x 64 output tile plus the halo in
// shared memory with 16-byte loads, all in flight at once; the rows are
// skewed by one bank a row pair, so that the 8 x 4 threads of a warp
// read 32 distinct banks; each thread writes each of its rows as one
// float4.
//
// Launcher contract: `in` and `out` are distinct (H, W) float32 frames
// on the device.  It allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "median_networks.cuh"

namespace {

constexpr int kThreads = 256;       // 8 warps of 8 x 4 threads, as 2 x 4
constexpr int kHalo = 4;            // staged columns left and right: >= k/2

template <int K>
struct Geometry {
  static constexpr int P = K / 2;
  static constexpr int TH = MedianTile<K>::TH;
  static constexpr int TW = MedianTile<K>::TW;
  static constexpr int BH = 16 * TH;                // output rows a block
  static constexpr int BW = 16 * TW;                // output columns
  static constexpr int SH = BH + 2 * P;             // staged rows
  static constexpr int SW = BW + 2 * kHalo;         // staged columns
  static constexpr int RS = (SW + 31) / 32 * 32;    // row stride, 0 mod 32
  // row r starts at r * RS + r / 2: a row pair shifts one bank
  static constexpr int SMEM = SH * RS + SH / 2;
};

template <int K>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
              int W, int vec) {
  using G = Geometry<K>;
  constexpr int TH = G::TH, TW = G::TW, P = G::P, RS = G::RS;
  __shared__ float tile[G::SMEM];
  const int by = blockIdx.y * G::BH;
  const int bx = blockIdx.x * G::BW;

  // stage rows by-P .. by+BH+P-1 and columns bx-4 .. bx+BW+3, four
  // columns at a time; taps outside the frame repeat its edge (they
  // feed only border outputs, which keep the input anyway)
  // (a thread starts all its loads before it stores the first)
  constexpr int QW = G::SW / 4;
  constexpr int NQ = (G::SH * QW + kThreads - 1) / kThreads;
  float4 q4[NQ];
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int i = threadIdx.x + n * kThreads;
    if (i < G::SH * QW) {
      const int r = i / QW;
      const int gy = min(max(by - P + r, 0), H - 1);
      const int gx = bx - kHalo + 4 * (i - r * QW);
      const float* row = in + (size_t)gy * W;
      if (vec && gx >= 0 && gx + 3 < W) {
        q4[n] = __ldg(reinterpret_cast<const float4*>(row + gx));
      } else {
        q4[n].x = __ldg(row + min(max(gx, 0), W - 1));
        q4[n].y = __ldg(row + min(max(gx + 1, 0), W - 1));
        q4[n].z = __ldg(row + min(max(gx + 2, 0), W - 1));
        q4[n].w = __ldg(row + min(max(gx + 3, 0), W - 1));
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int i = threadIdx.x + n * kThreads;
    if (i < G::SH * QW) {
      const int r = i / QW;
      float* s = tile + r * RS + (r >> 1) + 4 * (i - r * QW);
      s[0] = q4[n].x;
      s[1] = q4[n].y;
      s[2] = q4[n].z;
      s[3] = q4[n].w;
    }
  }
  __syncthreads();

  // this thread's 2 x 4 outputs: a warp is 8 threads across, 4 down
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = ((warp >> 1) * 4 + (lane >> 3)) * TH;   // even
  const int tx = ((warp & 1) * 8 + (lane & 7)) * TW;
  const int gy0 = by + ty;
  const int gx0 = bx + tx;
  if (gy0 >= H || gx0 >= W) return;
  // patch pixel (y, x) is staged at row ty + y, column tx + 4 - P + x
  const float* base = tile + ty * RS + (ty >> 1) + tx + kHalo - P;
  auto ld = [base](int y, int x) { return base[y * RS + (y >> 1) + x]; };
  float med[TH * TW];
  MedianTile<K>::run(ld, med);

#pragma unroll
  for (int t = 0; t < TH; ++t) {
    const int gy = gy0 + t;
    if (gy >= H) break;
    const bool row_border = gy < P || gy >= H - P;
    float o[TW];
#pragma unroll
    for (int u = 0; u < TW; ++u) {
      const int gx = gx0 + u;
      o[u] = (row_border || gx < P || gx >= W - P) ? ld(t + P, u + P)
                                                   : med[t * TW + u];
    }
    float* dst = out + (size_t)gy * W + gx0;
    if (vec && gx0 + TW <= W) {
      static_assert(TW == 4, "one float4 a row");
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < TW; ++u) {
        if (gx0 + u < W) dst[u] = o[u];
      }
    }
  }
}

template <int K>
cudaError_t launch(const float* in, float* out, int H, int W,
                   cudaStream_t stream) {
  using G = Geometry<K>;
  // 16-byte rows: float4 loads and stores
  const int vec = (W % 4 == 0) && ((uintptr_t)in % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  dim3 grid((W + G::BW - 1) / G::BW, (H + G::BH - 1) / G::BH);
  median_kernel<K><<<grid, kThreads, 0, stream>>>(in, out, H, W, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bbt_median_filter(const void* in, void* out, int H, int W,
                                 int k, void* stream) {
  const float* src = (const float*)in;
  float* dst = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  switch (k) {
    case 3: return (int)launch<3>(src, dst, H, W, s);
    case 5: return (int)launch<5>(src, dst, H, W, s);
    case 7: return (int)launch<7>(src, dst, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
