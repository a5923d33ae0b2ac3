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
// What bounds it on the H100: the bytes (each live window read once,
// every window written once), but the reads are rows of 104-384 B
// scattered over the frame at any column, and the card does not stream
// them at its copy rate: this design and the one before it both reach
// about 65% of the bound with the card kept busy (PERF.md §6).
//
// This design cuts each slot's windows into bands of about kBandPixels
// pixels an image and gives a block one band of every image of a slot
// (10 blocks a slot at 96², one at 32²).  On the catalog's own calls
// most slots are dead (about 80% of the 20000 small windows, 96% of the
// 1024 big ones): a block that finds its slot dead writes zeros, 16
// bytes at a time, and frees its SM at once, and the few live big
// windows spread over many SMs, which makes the big-window call about a
// fifth faster than one block a slot; at 32² the two designs are within
// 2% of each other.  In a band the 256 threads take consecutive pixels,
// so a warp reads 32 consecutive pixels of a row and writes 128
// contiguous bytes; a thread's (row, column) is stepped without a
// division; 8 blocks an SM keep all 2048 threads resident.
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
constexpr int kBandPixels = 1024;   // pixels of an image a block copies

__global__ void __launch_bounds__(kThreads, 8)
gather_kernel(const uint32_t* __restrict__ in0,
              const uint32_t* __restrict__ in1,
              const uint32_t* __restrict__ in2, uint32_t* __restrict__ out0,
              uint32_t* __restrict__ out1, uint32_t* __restrict__ out2,
              int n_img, const int* __restrict__ y0,
              const int* __restrict__ x0, const int* __restrict__ n_active,
              int N, int H, int W, int size) {
  // a block copies one band of rows of a slot's windows
  const int rows = max(1, kBandPixels / size);
  const int bands = (size + rows - 1) / rows;
  const int slot = blockIdx.x / bands;
  const int rb = (blockIdx.x - slot * bands) * rows;
  const int nrow = min(rows, size - rb);
  const int area = size * size;
  const int band = nrow * size;
  const bool live = slot < (n_active ? *n_active : N);
  if (!live) {
    // 16-byte stores where every band starts 16-byte aligned
    const bool vec = area % 4 == 0 && (rows * size) % 4 == 0;
    const int nvec = vec ? band / 4 : 0;
    for (int k = 0; k < n_img; ++k) {
      uint32_t* dst = (k == 0 ? out0 : (k == 1 ? out1 : out2))
                      + (size_t)slot * area + (size_t)rb * size;
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (int i = threadIdx.x; i < nvec; i += kThreads)
        d4[i] = make_uint4(0u, 0u, 0u, 0u);
      for (int i = 4 * nvec + threadIdx.x; i < band; i += kThreads)
        dst[i] = 0u;
    }
    return;
  }
  const int y = min(max(y0[slot], 0), H - size) + rb;
  const int x = min(max(x0[slot], 0), W - size);
  // pixel i = r * size + c of the thread, and the step of kThreads
  // pixels as whole rows plus columns
  const int r0 = threadIdx.x / size, c0 = threadIdx.x - r0 * size;
  const int dr = kThreads / size, dc = kThreads - dr * size;
  for (int k = 0; k < n_img; ++k) {
    const uint32_t* src = (k == 0 ? in0 : (k == 1 ? in1 : in2))
                          + (size_t)y * W + x;
    uint32_t* dst = (k == 0 ? out0 : (k == 1 ? out1 : out2))
                    + (size_t)slot * area + (size_t)rb * size;
    int r = r0, c = c0;
#pragma unroll 4
    for (int i = threadIdx.x; i < band; i += kThreads) {
      dst[i] = __ldg(src + (size_t)r * W + c);
      r += dr;
      c += dc;
      if (c >= size) {
        c -= size;
        ++r;
      }
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
  const int rows = kBandPixels / size > 1 ? kBandPixels / size : 1;
  const long long grid = (long long)N * ((size + rows - 1) / rows);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(int)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in0, (const uint32_t*)in1, (const uint32_t*)in2,
      (uint32_t*)out0, (uint32_t*)out1, (uint32_t*)out2, n_img,
      (const int*)y0, (const int*)x0, (const int*)n_active, N, H, W, size);
  return (int)cudaGetLastError();
}
