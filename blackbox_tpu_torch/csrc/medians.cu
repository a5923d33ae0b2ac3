// k x k median filter (k = 3, 5, 7) for Hopper.
//
// Replaces the TPU kernel blackbox_tpu/pallas/medians.py::_median_kernel
// (wrapper median_filter_pallas): the exact k*k//2-th order statistic of
// every k x k window of a float32 image; the outer k//2 border keeps the
// input value.  It runs the same comparator program as the plain
// version (blackbox_tpu_torch/ops/filters.py): each k-tall column is
// sorted by an odd-even transposition network, and the pruned
// sorted-column merge network of median_networks.cuh picks the median
// from the k sorted columns.  min/max propagate NaN like torch.minimum,
// so the result equals the plain version bit for bit, NaN included.
//
// What bounds it on the H100: integer/float ALU work (about 14, 82 and
// 205 min/max pairs per pixel for k = 3, 5, 7, after the column sorts)
// and, far behind it, memory traffic (one read and one write of the
// frame; the plain version instead makes a frame-strip pass per
// comparator).  The design keeps every comparator on registers and
// shared memory: a block stages its 16 x 64 output tile plus a k//2
// halo in shared memory, sorts each column once there (a sorted column
// is shared by the k windows beside it), and each thread then runs the
// merge network for its pixels on k*k registers.
//
// Launcher contract: `in` and `out` are distinct (H, W) float32 frames
// on the device.  It allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "median_networks.cuh"

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 64;
constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ in, float* __restrict__ out,
              int H, int W) {
  constexpr int P = K / 2;
  constexpr int RH = kTileH + 2 * P;   // staged rows
  constexpr int RW = kTileW + 2 * P;   // staged columns
  __shared__ float raw[RH][RW];
  __shared__ float cols[K][kTileH][RW];
  const int by = blockIdx.y * kTileH;
  const int bx = blockIdx.x * kTileW;

  // stage the haloed tile; out-of-frame taps repeat the edge (they feed
  // only border outputs, which keep the input anyway)
  for (int i = threadIdx.x; i < RH * RW; i += kThreads) {
    const int ty = i / RW;
    const int tx = i - ty * RW;
    const int gy = min(max(by - P + ty, 0), H - 1);
    const int gx = min(max(bx - P + tx, 0), W - 1);
    raw[ty][tx] = in[(size_t)gy * W + gx];
  }
  __syncthreads();

  // sorted columns: cols[r][y][x] = rank r of raw rows y .. y+K-1 at x
  for (int i = threadIdx.x; i < kTileH * RW; i += kThreads) {
    const int ty = i / RW;
    const int tx = i - ty * RW;
    float c[K];
#pragma unroll
    for (int r = 0; r < K; ++r) c[r] = raw[ty + r][tx];
#pragma unroll
    for (int pass = 0; pass < K; ++pass) {
#pragma unroll
      for (int j = pass % 2; j < K - 1; j += 2) bbt_ce(c[j], c[j + 1]);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) cols[r][ty][tx] = c[r];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int gy = by + ty;
    const int gx = bx + tx;
    if (gy >= H || gx >= W) continue;
    float res;
    if (gy < P || gy >= H - P || gx < P || gx >= W - P) {
      res = raw[ty + P][tx + P];
    } else {
      float v[K * K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
#pragma unroll
        for (int r = 0; r < K; ++r) v[dx * K + r] = cols[r][ty][tx + dx];
      }
      res = MedianNet<K>::select(v);
    }
    out[(size_t)gy * W + gx] = res;
  }
}

template <int K>
cudaError_t launch(const float* in, float* out, int H, int W,
                   cudaStream_t stream) {
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  median_kernel<K><<<grid, kThreads, 0, stream>>>(in, out, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bbt_median_filter(const void* in, void* out, int H, int W,
                                 int k, void* stream) {
  const float* src = (const float*)in;
  float* dst = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 3: return (int)launch<3>(src, dst, H, W, s);
    case 5: return (int)launch<5>(src, dst, H, W, s);
    case 7: return (int)launch<7>(src, dst, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
