// Per-source window gather for Hopper.
//
// Replaces the TPU kernel blackbox_tpu/pallas/gather.py::_gather_kernel
// (wrapper gather_windows): copies a size x size window from each of up
// to three (H, W) 4-byte images (float32 or int32; the copy is bitwise)
// at every slot's start (y0, x0), clipped to [0, H-size] x [0, W-size]
// like lax.dynamic_slice.  Slots at or past n_active are written as
// zeros; n_active is a device int32 the kernel reads itself, so the
// caller never waits for the count to reach the host.
//
// What bounds it on the H100: latency.  The windows are small (4 KB at
// 32², 36 KB at 96²) and scattered, so each is a few dependent trips to
// device memory, not a bandwidth stream.  The design puts one block on
// each slot, so thousands of windows are in flight at once and the card
// hides one window's latency behind the others; the threads of a block
// copy consecutive pixels of a window row, so each row is read in
// coalesced segments.  Dead slots skip their reads.
//
// Launcher contract: in1/in2 and out1/out2 may be null when n_img < 3;
// y0, x0 are (N,) int32; n_active is null (all slots live) or one
// int32.  It allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint32_t* __restrict__ in0,
              const uint32_t* __restrict__ in1,
              const uint32_t* __restrict__ in2, uint32_t* __restrict__ out0,
              uint32_t* __restrict__ out1, uint32_t* __restrict__ out2,
              int n_img, const int* __restrict__ y0,
              const int* __restrict__ x0, const int* __restrict__ n_active,
              int N, int H, int W, int size) {
  const int slot = blockIdx.x;
  const bool live = slot < (n_active ? *n_active : N);
  const int y = live ? min(max(y0[slot], 0), H - size) : 0;
  const int x = live ? min(max(x0[slot], 0), W - size) : 0;
  const int area = size * size;
  for (int k = 0; k < n_img; ++k) {
    const uint32_t* src = k == 0 ? in0 : (k == 1 ? in1 : in2);
    uint32_t* dst = (k == 0 ? out0 : (k == 1 ? out1 : out2))
                    + (size_t)slot * area;
    for (int i = threadIdx.x; i < area; i += kThreads) {
      const int r = i / size;
      const int c = i - r * size;
      dst[i] = live ? src[(size_t)(y + r) * W + (x + c)] : 0u;
    }
  }
}

}  // namespace

extern "C" int bbt_gather_windows(const void* in0, const void* in1,
                                  const void* in2, void* out0, void* out1,
                                  void* out2, int n_img, const void* y0,
                                  const void* x0, const void* n_active,
                                  int N, int H, int W, int size,
                                  void* stream) {
  if (n_img < 1 || n_img > 3 || size < 1 || size > H || size > W)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  gather_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in0, (const uint32_t*)in1, (const uint32_t*)in2,
      (uint32_t*)out0, (uint32_t*)out1, (uint32_t*)out2, n_img,
      (const int*)y0, (const int*)x0, (const int*)n_active, N, H, W, size);
  return (int)cudaGetLastError();
}
