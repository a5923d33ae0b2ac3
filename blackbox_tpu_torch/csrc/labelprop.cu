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
//   2. prop_tiles, persistent blocks that take the listed tiles: each
//      loads the tile with a `steps`-wide halo (S = T + 2*steps on a
//      side) into shared memory, two buffers, and while loading compacts
//      the positions of its foreground pixels into a list (warp ballots,
//      one shared atomic a warp).  A step then visits the list alone,
//      and only the entries within steps - 1 - s of the interior at
//      step s: a pixel farther out cannot reach the interior in the
//      steps left, and the region it reads from is the region of the
//      step before, so the values it reads are exact and never come
//      from beyond the loaded tile (no bounds tests, and the i / S of
//      a flat loop is gone: the list holds (y << 8) | x).  A step that
//      changes nothing in its region ends the tile: every later step
//      would read the same values and change nothing either.
// Up to 64 steps go in one launch (T = 32 to 60 steps, 16 above; at 48
// steps, the transient map's, S = 128 and the two buffers and the list
// take 160 KB, one block to an SM, which the few listed tiles do not
// mind).  The whole schedule (tiles, halo, region, stop rule) has a
// plain PyTorch model in tests/test_torch_labeling.py held against the
// plain version.  Measured on that card (kernel_profile.py): the
// 10560^2 star field at 32 steps (6923 of 108900 tiles listed) 0.66 ms,
// scan_tiles 0.29 and prop_tiles 0.35; the transient map at 48 steps
// (58 tiles listed) 0.34 ms, nearly all of it scan_tiles.
//
// Launcher contract: `in` and `out` are distinct (H, W) int32 frames on
// the device; `work` is int32 scratch of at least 1 + ceil(H/16) *
// ceil(W/16) entries; 1 <= steps <= 64 (the caller chains launches for
// more).  It allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxSteps = 64;
constexpr int kScanX = 32, kScanY = 8;     // scan_tiles block
constexpr int kPropX = 32, kPropY = 16;    // prop_tiles block
constexpr int kPropThreads = kPropX * kPropY;

__host__ __device__ constexpr int tile_for(int steps) {
  return steps <= 60 ? 32 : 16;
}

__host__ __device__ constexpr size_t prop_smem(int steps) {
  // two int32 label buffers and a uint16 position list, S^2 each
  return (size_t)(tile_for(steps) + 2 * steps) *
         (tile_for(steps) + 2 * steps) * 10;
}

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

__global__ void __launch_bounds__(kPropThreads)
prop_tiles(const int* __restrict__ in, int* __restrict__ out,
           const int* __restrict__ work, int H, int W, int T, int tiles_x,
           int steps, int big) {
  extern __shared__ int smem[];
  __shared__ int nlist;
  const int S = T + 2 * steps;
  unsigned short* list = (unsigned short*)(smem + 2 * S * S);
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kPropX + lane;
  const int count = work[0];

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
    // and list its foreground; the x loop is uniform across a warp, so
    // every lane takes part in each ballot
    for (int y = threadIdx.y; y < S; y += kPropY) {
      const int gy = gy0 + y;
      for (int x0 = 0; x0 < S; x0 += kPropX) {
        const int x = x0 + lane;
        const int gx = gx0 + x;
        int v = big;
        if (x < S && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = min(in[(size_t)gy * W + gx], big);
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
          out[(size_t)gy * W + gx] = a[(y + steps) * S + x + steps];
      }
    }
    // the next tile's load overwrites the buffers and the list
    __syncthreads();
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
  const int tiles_x = (W + T - 1) / T;
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

  const size_t smem = prop_smem(steps);
  err = cudaFuncSetAttribute(prop_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prop_tiles, kPropThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = sms * per_sm;
  prop_tiles<<<blocks, dim3(kPropX, kPropY), smem, st>>>(
      (const int*)in, (int*)out, (const int*)work, H, W, T, tiles_x, steps,
      big);
  return (int)cudaGetLastError();
}

extern "C" const char* bbt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
