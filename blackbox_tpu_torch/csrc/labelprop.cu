// Bounded min-label propagation (8-connected components) for Hopper.
//
// Replaces the TPU kernel blackbox_tpu/pallas/labelprop.py::_prop_kernel
// (wrapper label_propagate_pallas): `steps` synchronous (Jacobi) steps of
// a 3x3 min over int32 labels, where background pixels hold the BIG
// sentinel (H*W + 2) and never change, and pixels outside the frame
// count as BIG.  The number of steps bounds the geodesic radius over
// which labels merge, so blobs wider than the bound split: the result is
// NOT the connected-component labelling a union-find would give, and an
// in-place (Gauss-Seidel) update that carries a label more than one
// pixel per step would give different labels too.
//
// What bounds it on the H100: memory traffic.  One read of the int32
// frame and one write, 8 bytes a pixel: 0.266 ms at 10560^2 and 3.35
// TB/s (one H100 80GB HBM3 at 700 W); the mins, 8 a step on each
// foreground pixel, are a few microseconds on the thresholded frames of
// the main path, where under 1% of the pixels (the star field) or
// about 1e-5 (the |Scorr| > 6 map) are set.  So the design makes a
// pixel of background cost its read and write and nothing else, and
// spends the steps on the foreground alone, in two launches:
//   1. scan_tiles, one block per strip of T rows and 128 columns (16-byte
//      loads and stores; 32 columns and 4-byte ones where rows do not
//      start on 16 bytes): a tile that holds no foreground pixel is
//      written all BIG at once; otherwise the tile's index goes on a
//      work list (one atomic a tile, in device memory, so the host
//      never waits).
//   2. prop_tiles (labelprop_tiles.cuh, shared with K5's detect.cu),
//      persistent blocks that take the listed tiles: each loads its
//      tile with a `steps`-wide halo into shared memory, lists its
//      foreground, and steps the listed pixels within reach of the
//      interior until a step changes nothing.
// Up to 64 steps go in one launch (T = 32 to 60 steps, 16 above; at 48
// steps, the transient map's, S = 128 and the two buffers and the list
// take 160 KB, one block to an SM, which the few listed tiles do not
// mind).  The whole schedule (tiles, halo, region, stop rule) has a
// plain PyTorch model in tests/test_torch_labeling.py held against the
// plain version.  Measured on that card (kernel_profile.py): the
// 10560^2 star field at 32 steps (6923 of 108900 tiles listed) 0.62 ms,
// scan_tiles 0.29 and prop_tiles 0.31; the transient map at 48 steps
// (58 tiles listed) 0.33 ms, nearly all of it scan_tiles.
//
// Launcher contract: `in` and `out` are distinct (H, W) int32 frames on
// the device; `work` is int32 scratch of at least 1 + ceil(H/16) *
// ceil(W/16) entries; 1 <= steps <= 64 (the caller chains launches for
// more).  It allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "labelprop_tiles.cuh"

namespace {

constexpr int kScanX = 32, kScanY = 8;     // scan_tiles block

// prop_tiles' seeds and sink for K1: int32 labels in (clamped to BIG),
// int32 labels out
struct LabelSeeds {
  const int* __restrict__ in;
  int W, big;
  __device__ int operator()(int gy, int gx) const {
    return min(in[(size_t)gy * W + gx], big);
  }
};

struct LabelSink {
  static constexpr bool kRoots = false;
  int* __restrict__ out;
  int W;
  __device__ int put(int gy, int gx, int v) const {
    out[(size_t)gy * W + gx] = v;
    return 0;
  }
  __device__ void roots(int) const {}
};

// One block per strip of T rows and 32 * VEC columns (32 * VEC / T
// tiles): lane x reads VEC adjacent columns (one int4 when VEC == 4),
// rows threadIdx.y + kScanY * i.  A tile's lanes OR their findings
// into a shared flag; an empty tile's pixels are written BIG, a tile
// with foreground goes on the work list.
template <int VEC>
__global__ void __launch_bounds__(kScanX * kScanY)
scan_tiles(const int* __restrict__ in, int* __restrict__ out,
           int* __restrict__ work, int H, int W, int T, int big) {
  __shared__ int flag[kScanX * 4 / 16];
  const int lane = threadIdx.x;
  const int gy0 = blockIdx.y * T;
  const int gx = blockIdx.x * (kScanX * VEC) + lane * VEC;
  const int per_tile = T / VEC;                // lanes a tile
  const int p = lane / per_tile;               // the lane's tile
  if (threadIdx.y == 0 && lane < kScanX * VEC / T) flag[lane] = 0;
  __syncthreads();
  int any = 0;
  for (int y = threadIdx.y; y < T; y += kScanY) {
    const int gy = gy0 + y;
    if (gy >= H || gx >= W) continue;
    const int* src = in + (size_t)gy * W + gx;
    if (VEC == 4) {
      const int4 v = *reinterpret_cast<const int4*>(src);
      any |= (v.x < big) | (v.y < big) | (v.z < big) | (v.w < big);
    } else {
      any |= *src < big;
    }
  }
  const unsigned bal = __ballot_sync(0xffffffffu, any);
  const unsigned mine = per_tile == 32 ? 0xffffffffu
                                       : ((1u << per_tile) - 1u)
                                             << (p * per_tile);
  if (lane == p * per_tile && (bal & mine)) atomicOr(&flag[p], 1);
  __syncthreads();
  const int tx = blockIdx.x * (kScanX * VEC / T) + p;
  if (flag[p]) {
    if (threadIdx.y == 0 && lane == p * per_tile && tx * T < W)
      work[1 + atomicAdd(work, 1)] = blockIdx.y * ((W + T - 1) / T) + tx;
    return;
  }
  for (int y = threadIdx.y; y < T; y += kScanY) {
    const int gy = gy0 + y;
    if (gy >= H || gx >= W) continue;
    int* dst = out + (size_t)gy * W + gx;
    if (VEC == 4)
      *reinterpret_cast<int4*>(dst) = make_int4(big, big, big, big);
    else
      *dst = big;
  }
}

}  // namespace

extern "C" int bbt_label_propagate(const void* in, void* out, void* work,
                                   int H, int W, int steps, int big,
                                   void* stream) {
  if (steps < 1 || steps > kMaxSteps || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int T = tile_for(steps);
  const int tiles_y = (H + T - 1) / T;
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  // 16-byte rows when every row starts on a 16-byte boundary
  if (W % 4 == 0 && ((size_t)in | (size_t)out) % 16 == 0)
    scan_tiles<4><<<dim3((W + 4 * kScanX - 1) / (4 * kScanX), tiles_y),
                    dim3(kScanX, kScanY), 0, st>>>(
        (const int*)in, (int*)out, (int*)work, H, W, T, big);
  else
    scan_tiles<1><<<dim3((W + kScanX - 1) / kScanX, tiles_y),
                    dim3(kScanX, kScanY), 0, st>>>(
        (const int*)in, (int*)out, (int*)work, H, W, T, big);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  return (int)launch_prop_tiles(LabelSeeds{(const int*)in, W, big},
                                LabelSink{(int*)out, W}, (const int*)work,
                                H, W, steps, big, st);
}

extern "C" const char* bbt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
