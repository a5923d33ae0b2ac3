// Background-mesh upsample (K3) for Hopper: out = Wy @ mesh @ Wx.T for
// each of n meshes.
//
// Replaces the TPU kernel blackbox_tpu/pallas/upsample.py::_up_kernel
// (wrapper upsample_mesh_pallas), which evaluates the two small dots per
// output tile.  Here a block owns UR output rows and 256 columns: it
// first computes its rows of up = Wy @ mesh (UR x nx, each an ny-term
// sum) into shared memory, then each thread writes its column of those
// rows as nx-term sums, neighbouring threads on neighbouring columns
// (Wx is passed transposed, (nx, W), so its reads coalesce).  Both sums
// run in ascending index order from 0 with every multiply and add
// rounded on its own (no FMA contraction), as the plain version does
// (blackbox_tpu_torch/ops/upsample.py::_upsample_plain), so the two
// agree bit for bit.
//
// What bounds it on the H100: the output write (446 MB per 10560^2
// plane, ~0.13 ms at 3.35 TB/s) against ~2 nx float operations per
// pixel (~82 at MeerLICHT's 41-node mesh): the two are about equal.
//
// Launcher contract: meshes (n, ny, nx), Wy (H, ny), WxT (nx, W) and
// out (n, H, W) are float32 device arrays.  It allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int UR = 8;     // output rows per block
constexpr int UT = 256;   // threads = output columns per block

__global__ void __launch_bounds__(UT)
upsample_kernel(const float* __restrict__ meshes, const float* __restrict__ Wy,
                const float* __restrict__ WxT, float* __restrict__ out, int H,
                int W, int ny, int nx) {
  extern __shared__ float up[];           // UR x nx
  const float* mesh = meshes + (size_t)blockIdx.z * ny * nx;
  const int y0 = blockIdx.y * UR;
  for (int t = threadIdx.x; t < UR * nx; t += UT) {
    const int r = t / nx;
    const int j = t - r * nx;
    const float* wy = Wy + (size_t)min(y0 + r, H - 1) * ny;
    float acc = 0.f;
    for (int i = 0; i < ny; ++i)
      acc = __fadd_rn(acc, __fmul_rn(wy[i], mesh[i * nx + j]));
    up[t] = acc;
  }
  __syncthreads();
  const int x = blockIdx.x * UT + threadIdx.x;
  if (x >= W) return;
  float acc[UR];
#pragma unroll
  for (int r = 0; r < UR; ++r) acc[r] = 0.f;
  for (int j = 0; j < nx; ++j) {
    const float w = WxT[(size_t)j * W + x];
#pragma unroll
    for (int r = 0; r < UR; ++r)
      acc[r] = __fadd_rn(acc[r], __fmul_rn(up[r * nx + j], w));
  }
  float* o = out + (size_t)blockIdx.z * H * W;
#pragma unroll
  for (int r = 0; r < UR; ++r) {
    if (y0 + r < H) o[(size_t)(y0 + r) * W + x] = acc[r];
  }
}

}  // namespace

extern "C" int bbt_upsample_mesh(const void* meshes, const void* Wy,
                                 const void* WxT, void* out, int n, int H,
                                 int W, int ny, int nx, void* stream) {
  const size_t smem = (size_t)UR * nx * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((W + UT - 1) / UT, (H + UR - 1) / UR, n);
  upsample_kernel<<<grid, UT, smem, (cudaStream_t)stream>>>(
      (const float*)meshes, (const float*)Wy, (const float*)WxT, (float*)out,
      H, W, ny, nx);
  return (int)cudaGetLastError();
}
