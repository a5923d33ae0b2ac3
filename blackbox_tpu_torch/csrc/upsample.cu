// Background-mesh upsample (K3) for Hopper: out = Wy @ mesh @ Wx.T for
// each of n meshes.
//
// Replaces the TPU kernel blackbox_tpu/pallas/upsample.py::_up_kernel
// (wrapper upsample_mesh_pallas), which evaluates the two small dots per
// output tile.  Both sums run in ascending index order from 0 with every
// multiply and add rounded on its own (no FMA contraction), as the plain
// version does (blackbox_tpu_torch/ops/upsample.py::_upsample_plain).
//
// What bounds it on the H100: the output write, 446 MB per 10560^2
// plane (0.133 ms at 3.35 TB/s).  The Catmull-Rom weights have at most
// 4 nonzero, contiguous entries a row, so of the nx = 41 terms a pixel
// sums, 37 are 0 * m = +-0.  Adding +-0 leaves a nonzero sum unchanged
// and a zero one zero, so a sum over the band [lo, hi] of nonzero
// weights, in ascending order, equals the dense sum up to the sign of a
// zero -- while the summands are finite: 0 * inf is NaN.  So every
// sum whose other factor holds an inf or a NaN takes the full range.
// Two launches:
//
//   1. up_kernel: up = Wy @ mesh into an (n, H, nx) scratch, once per
//      mesh, and the band of every row of Wx into a (W, 2) int scratch,
//      in extra blocks (one warp a row; the band by warp ballot; for
//      up, the full range where the mesh is not all finite).
//   2. out_kernel: a block owns 64 rows x 512 columns of one plane; it
//      stages those rows of up in shared memory and notes whether all
//      are finite.  A thread owns 4 adjacent columns: it loads their
//      weights over the union of their bands (zeros between the bands
//      sum as the dense sum does) into registers once, then writes 32
//      rows, each as one float4 streaming store (__stcs: the plane is
//      larger than L2).  A union band wider than 8, or a block whose up
//      rows are not all finite, reads the weights of its range from
//      global memory instead (dense weights are right, only slower).
//
// Launcher contract: meshes (n, ny, nx), Wy (H, ny), Wx (W, nx) and
// out (n, H, W) are float32 device arrays, up an (n, H, nx) float32 and
// bands a (W, 2) int32 scratch.  It allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kUpRows = 32;        // rows of up (or of Wx) a block
constexpr int kThreads = 256;
constexpr int kRows = 64;          // out rows a block of out_kernel
constexpr int kCols = 512;         // out columns: 128 threads x 4
constexpr int kBand = 8;           // widest union band held in registers

__device__ __forceinline__ float mul_add(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// the band [lo, hi] of nonzero entries of a row of n weights (a NaN
// counts as nonzero; a row of zeros gives lo > hi), by one warp
__device__ __forceinline__ int2 warp_band(const float* w, int n, int lane) {
  int lo = n, hi = -1;
  for (int c = 0; c < n; c += 32) {
    const unsigned nz =
        __ballot_sync(0xffffffffu, c + lane < n && w[c + lane] != 0.f);
    if (nz) {
      lo = min(lo, c + __ffs(nz) - 1);
      hi = c + 31 - __clz(nz);
    }
  }
  return make_int2(lo, hi);
}

__global__ void __launch_bounds__(kThreads)
up_kernel(const float* __restrict__ meshes, const float* __restrict__ Wy,
          const float* __restrict__ Wx, float* __restrict__ up,
          int2* __restrict__ bands, int n_up_blocks, int H, int W, int ny,
          int nx) {
  const int lane = threadIdx.x & 31;
  if ((int)blockIdx.x >= n_up_blocks) {
    const int x0 = (blockIdx.x - n_up_blocks) * kUpRows;
    for (int x = x0 + (threadIdx.x >> 5); x < min(x0 + kUpRows, W);
         x += kThreads / 32) {
      const int2 b = warp_band(Wx + (size_t)x * nx, nx, lane);
      if (lane == 0) bands[x] = b;
    }
    return;
  }
  const int blocks_per_mesh = (H + kUpRows - 1) / kUpRows;
  const int m = blockIdx.x / blocks_per_mesh;
  const int y0 = (blockIdx.x - m * blocks_per_mesh) * kUpRows;
  const float* mesh = meshes + (size_t)m * ny * nx;
  int bad = 0;
  for (int i = threadIdx.x; i < ny * nx; i += kThreads)
    bad |= !isfinite(mesh[i]);
  bad = __syncthreads_or(bad);

  for (int y = y0 + (threadIdx.x >> 5); y < min(y0 + kUpRows, H);
       y += kThreads / 32) {
    const float* wy = Wy + (size_t)y * ny;
    const int2 b = bad ? make_int2(0, ny - 1) : warp_band(wy, ny, lane);
    const int lo = b.x, hi = b.y;
    float* dst = up + ((size_t)m * H + y) * nx;
    for (int j = lane; j < nx; j += 32) {
      float acc = 0.f;
      for (int i = lo; i <= hi; ++i)
        acc = mul_add(acc, wy[i], mesh[i * nx + j]);
      dst[j] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
out_kernel(const float* __restrict__ up, const float* __restrict__ Wx,
           const int2* __restrict__ bands, float* __restrict__ out, int H,
           int W, int nx, int vec) {
  extern __shared__ float rows[];            // kRows x nx
  const int m = blockIdx.z;
  const int y0 = blockIdx.y * kRows;
  const int nrows = min(kRows, H - y0);
  const float* src = up + ((size_t)m * H + y0) * nx;
  int bad = 0;
  for (int i = threadIdx.x; i < nrows * nx; i += kThreads) {
    const float v = src[i];
    rows[i] = v;
    bad |= !isfinite(v);
  }
  bad = __syncthreads_or(bad);

  const int x0 = blockIdx.x * kCols + 4 * (threadIdx.x & 127);
  if (x0 >= W) return;
  const int ncol = min(4, W - x0);
  int lo = 0, hi = nx - 1;
  if (!bad) {
    lo = nx;
    hi = -1;
    for (int c = 0; c < ncol; ++c) {
      const int2 b = bands[x0 + c];
      if (b.x <= b.y) {
        lo = min(lo, b.x);
        hi = max(hi, b.y);
      }
    }
  }
  const int nb = hi - lo + 1;                // may be <= 0: all zeros
  const bool fast = nb <= kBand;
  const bool wide = vec && ncol == 4;
  // weight of column x0 + c at mesh column lo + t: Wx[x0 + c, lo + t]
  const float* wx = Wx + (size_t)x0 * nx;
  float w[kBand][4];
  if (fast) {
#pragma unroll
    for (int t = 0; t < kBand; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (t < nb) w[t][c] = c < ncol ? __ldg(wx + c * nx + lo + t) : 0.f;
      }
    }
  }
  float* plane = out + (size_t)m * H * W;
  for (int r = threadIdx.x >> 7; r < nrows; r += kThreads / 128) {
    const float* u = rows + r * nx;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (fast) {
#pragma unroll
      for (int t = 0; t < kBand; ++t) {
        if (t < nb) {
          const float v = u[lo + t];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = mul_add(acc[c], v, w[t][c]);
        }
      }
    } else {
      for (int j = lo; j <= hi; ++j) {
        const float v = u[j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < ncol) acc[c] = mul_add(acc[c], v, __ldg(wx + c * nx + j));
        }
      }
    }
    float* dst = plane + (size_t)(y0 + r) * W + x0;
    if (wide) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
    } else {
      for (int c = 0; c < ncol; ++c) __stcs(dst + c, acc[c]);
    }
  }
}

}  // namespace

extern "C" int bbt_upsample_mesh(const void* meshes, const void* Wy,
                                 const void* Wx, void* out, void* up,
                                 void* bands, int n, int H, int W, int ny,
                                 int nx, void* stream) {
  if (n <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kRows * nx * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_up_blocks = n * ((H + kUpRows - 1) / kUpRows);
  const int n_band_blocks = (W + kUpRows - 1) / kUpRows;
  up_kernel<<<n_up_blocks + n_band_blocks, kThreads, 0, s>>>(
      (const float*)meshes, (const float*)Wy, (const float*)Wx, (float*)up,
      (int2*)bands, n_up_blocks, H, W, ny, nx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 16-byte rows: float4 stores
  const int vec = (W % 4 == 0) && ((uintptr_t)out % 16 == 0);
  dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, n);
  out_kernel<<<grid, kThreads, smem, s>>>((const float*)up, (const float*)Wx,
                                          (const int2*)bands, (float*)out, H,
                                          W, nx, vec);
  return (int)cudaGetLastError();
}
