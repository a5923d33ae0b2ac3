// The listed-tile label steps shared by K1 (labelprop.cu) and K5
// (detect.cu): `steps` synchronous 3x3 min-label steps (8-connected,
// background BIG = H*W + 2 never changes, pixels outside the frame count
// as BIG) on the T x T tiles a scan put on a device work list.
//
// prop_tiles runs persistent blocks that take the listed tiles: each
// loads its tile with a `steps`-wide halo (S = T + 2*steps on a side)
// into shared memory, two buffers, and while loading compacts the
// positions of its foreground pixels into a list (warp ballots, one
// shared atomic a warp).  A step then visits the list alone, and only
// the entries within steps - 1 - s of the interior at step s: a pixel
// farther out cannot reach the interior in the steps left, and the
// region it reads from is the region of the step before, so the values
// it reads are exact and never come from beyond the loaded tile (no
// bounds tests; the list holds (y << 8) | x).  A step that changes
// nothing in its region ends the tile: every later step would read the
// same values and change nothing either.  Both buffers start equal, so
// an entry a step skips is never read stale.
//
// The kernel is templated on where its seeds come from and where its
// labels go:
//   Seeds: `int operator()(gy, gx)` gives the start label of an
//     in-frame pixel (at most BIG);
//   Sink: `int put(gy, gx, label)` writes an interior pixel's label and
//     returns 1 if it is a root (0 where the sink counts none), and
//     `kRoots` says whether `roots(n)` adds a block's roots to a
//     device count.
// Up to 64 steps go in one launch (T = 32 up to 60 steps, 16 above; at
// 56 steps S = 144 and the two buffers and the list take 207 KB).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxSteps = 64;
constexpr int kPropX = 32, kPropY = 16;    // prop_tiles block
constexpr int kPropThreads = kPropX * kPropY;
// warp-wide chunks of the widest haloed row (S = 32 + 2 * 60)
constexpr int kRowChunks = (32 + 2 * 60 + kPropX - 1) / kPropX;

__host__ __device__ constexpr int tile_for(int steps) {
  return steps <= 60 ? 32 : 16;
}

__host__ __device__ constexpr size_t prop_smem(int steps) {
  // two int32 label buffers and a uint16 position list, S^2 each
  return (size_t)(tile_for(steps) + 2 * steps) *
         (tile_for(steps) + 2 * steps) * 10;
}

template <class Seeds, class Sink>
__global__ void __launch_bounds__(kPropThreads)
prop_tiles(Seeds seeds, Sink sink, const int* __restrict__ work, int H,
           int W, int T, int tiles_x, int steps, int big) {
  extern __shared__ int smem[];
  __shared__ int nlist;
  __shared__ int block_roots;
  const int S = T + 2 * steps;
  unsigned short* list = (unsigned short*)(smem + 2 * S * S);
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kPropX + lane;
  const int count = work[0];
  int roots = 0;
  if (Sink::kRoots && tid == 0) block_roots = 0;

  for (int w = blockIdx.x; w < count; w += gridDim.x) {
    const int tile = work[1 + w];
    const int ty = tile / tiles_x;
    const int gy0 = ty * T - steps;
    const int gx0 = (tile - ty * tiles_x) * T - steps;
    int* a = smem;
    int* b = smem + S * S;
    if (tid == 0) nlist = 0;
    __syncthreads();

    // load the haloed tile (BIG outside the frame) into both buffers
    // and list its foreground: a row's loads are all issued before the
    // first is used; the chunk loop is uniform across a warp, so every
    // lane takes part in each ballot
    for (int y = threadIdx.y; y < S; y += kPropY) {
      const int gy = gy0 + y;
      const bool row = gy >= 0 && gy < H;
      int vs[kRowChunks];
#pragma unroll
      for (int k = 0; k < kRowChunks; ++k) {
        const int x = k * kPropX + lane;
        const int gx = gx0 + x;
        vs[k] = (row && x < S && gx >= 0 && gx < W) ? seeds(gy, gx) : big;
      }
#pragma unroll
      for (int k = 0; k < kRowChunks; ++k) {
        if (k * kPropX >= S) break;
        const int x = k * kPropX + lane;
        const int v = vs[k];
        if (x < S) {
          a[y * S + x] = v;
          b[y * S + x] = v;
        }
        const bool fg = v < big;
        const unsigned bal = __ballot_sync(0xffffffffu, fg);
        if (bal) {
          const int leader = __ffs(bal) - 1;
          int base = 0;
          if (lane == leader) base = atomicAdd(&nlist, __popc(bal));
          base = __shfl_sync(0xffffffffu, base, leader);
          if (fg)
            list[base + __popc(bal & ((1u << lane) - 1u))] =
                (unsigned short)((y << 8) | x);
        }
      }
    }
    __syncthreads();
    const int n = nlist;

    for (int s = 0; s < steps; ++s) {
      // the region of step s: within steps - 1 - s of the interior
      const int lo = s + 1;
      const int hi = S - 2 - s;
      int changed = 0;
      for (int i = tid; i < n; i += kPropThreads) {
        const int p = list[i];
        const int y = p >> 8;
        const int x = p & 255;
        if (y < lo || y > hi || x < lo || x > hi) continue;
        const int* r = a + (y - 1) * S + x;
        const int c = r[S];
        int v = min(min(r[-1], r[0]), r[1]);
        v = min(v, min(min(r[S - 1], c), r[S + 1]));
        v = min(v, min(min(r[2 * S - 1], r[2 * S]), r[2 * S + 1]));
        b[y * S + x] = v;
        changed |= (v != c);
      }
      // the barrier also separates this step's reads of `a` from the
      // next step's writes into it
      const int any = __syncthreads_or(changed);
      int* t = a;
      a = b;
      b = t;
      if (!any) break;
    }

    for (int y = threadIdx.y; y < T; y += kPropY) {
      const int gy = gy0 + steps + y;
      for (int x = lane; x < T; x += kPropX) {
        const int gx = gx0 + steps + x;
        if (gy < H && gx < W)
          roots += sink.put(gy, gx, a[(y + steps) * S + x + steps]);
      }
    }
    // the next tile's load overwrites the buffers and the list
    __syncthreads();
  }

  if constexpr (Sink::kRoots) {
    // one shared atomic a warp, one device atomic a block
    for (int o = 16; o > 0; o >>= 1)
      roots += __shfl_down_sync(0xffffffffu, roots, o);
    if (lane == 0 && roots) atomicAdd(&block_roots, roots);
    __syncthreads();
    if (tid == 0 && block_roots) sink.roots(block_roots);
  }
}

// Launch prop_tiles on `stream` with as many persistent blocks as fit
// on the card; 0 <= steps <= kMaxSteps.
template <class Seeds, class Sink>
cudaError_t launch_prop_tiles(Seeds seeds, Sink sink, const int* work,
                              int H, int W, int steps, int big,
                              cudaStream_t stream) {
  auto kernel = prop_tiles<Seeds, Sink>;
  const int T = tile_for(steps);
  const size_t smem = prop_smem(steps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPropThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  kernel<<<sms * per_sm, dim3(kPropX, kPropY), smem, stream>>>(
      seeds, sink, work, H, W, T, (W + T - 1) / T, steps, big);
  return cudaGetLastError();
}

}  // namespace
