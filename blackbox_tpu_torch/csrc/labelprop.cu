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
// What bounds it on the H100: memory traffic and integer ALU work.  The
// plain version reads and writes the 446 MB label frame twice per step
// (64 frame passes at 32 steps).  Here each block loads a 32x32 interior
// tile with a `steps`-wide halo into shared memory once, runs every step
// there between two buffers (a 96x96 int32 tile at 32 steps: 72 KB of
// dynamic shared memory, three blocks per SM), and writes the interior
// once: one haloed read and one write of the frame.  A value that is
// wrong because its neighbours lie outside the tile travels one pixel
// per step, so after `steps` steps only the halo is wrong.  A block
// stops as soon as a step changes nothing in its tile (every later step
// would be a no-op), so background tiles cost one step.
//
// Launcher contract: `in` and `out` are distinct (H, W) int32 frames on
// the device; steps <= 32 (the caller chains launches for more).  It
// allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;       // interior tile side
constexpr int kMaxSteps = 32;   // steps (= halo) per launch
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
labelprop_kernel(const int* __restrict__ in, int* __restrict__ out,
                 int H, int W, int steps, int big) {
  extern __shared__ int smem[];
  const int S = kTile + 2 * steps;
  int* a = smem;
  int* b = smem + S * S;
  const int gy0 = blockIdx.y * kTile - steps;
  const int gx0 = blockIdx.x * kTile - steps;

  for (int i = threadIdx.x; i < S * S; i += kThreads) {
    const int ty = i / S;
    const int tx = i - ty * S;
    const int gy = gy0 + ty;
    const int gx = gx0 + tx;
    a[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
               ? in[(size_t)gy * W + gx] : big;
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    int changed = 0;
    for (int i = threadIdx.x; i < S * S; i += kThreads) {
      const int c = a[i];
      int v = c;
      if (c < big) {
        const int ty = i / S;
        const int tx = i - ty * S;
        const int ylo = ty > 0 ? ty - 1 : 0;
        const int yhi = ty < S - 1 ? ty + 1 : S - 1;
        const int xlo = tx > 0 ? tx - 1 : 0;
        const int xhi = tx < S - 1 ? tx + 1 : S - 1;
        // neighbours beyond the tile edge are skipped (taken as BIG):
        // only the halo can be affected, see the note above
        for (int y = ylo; y <= yhi; ++y)
          for (int x = xlo; x <= xhi; ++x) v = min(v, a[y * S + x]);
      }
      b[i] = v;
      changed |= (v != c);
    }
    // the barrier also separates this step's reads of `a` from the next
    // step's writes into it
    const int any = __syncthreads_or(changed);
    int* t = a;
    a = b;
    b = t;
    if (!any) break;
  }

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ty = i / kTile;
    const int tx = i - ty * kTile;
    const int gy = blockIdx.y * kTile + ty;
    const int gx = blockIdx.x * kTile + tx;
    if (gy < H && gx < W)
      out[(size_t)gy * W + gx] = a[(ty + steps) * S + tx + steps];
  }
}

}  // namespace

extern "C" int bbt_label_propagate(const void* in, void* out, int H, int W,
                                   int steps, int big, void* stream) {
  if (steps < 1 || steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  const int S = kTile + 2 * steps;
  const size_t smem = 2 * (size_t)S * S * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      labelprop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  labelprop_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, H, W, steps, big);
  return (int)cudaGetLastError();
}

extern "C" const char* bbt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
