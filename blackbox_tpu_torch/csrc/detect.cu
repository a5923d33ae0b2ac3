// Fused source detection for Hopper: matched filter -> threshold ->
// exclusion -> bounded min-label propagation -> segment map + root count.
//
// Replaces the TPU kernel blackbox_tpu/pallas/detect.py::_detect_kernel
// (wrapper fused_detect_pallas).  Per pixel of an (H, W) f32 image:
// optional separable filter with `ntaps` taps (zero outside the frame;
// first along rows, then along columns, each tap sum started from 0 and
// taken in tap order), optional |x|, then det = x > nsigma * max(std,
// 1e-6) (NaN std propagates) or x > nsigma without a std map, minus the
// excluded pixels, gated to the frame.  Detections are seeded with their
// global flat index + 1, background with BIG = H*W + 2, and `iters`
// synchronous 3x3 min steps run as in labelprop.cu.  Out: seg = label on
// detections, 0 elsewhere; count += the number of roots (detections
// whose label is their own index).  Every float step is a separately
// rounded f32 operation (no FMA contraction), in the order of the plain
// version blackbox_tpu_torch/ops/detection.py::_fused_detect_plain, so
// the two agree bit for bit.
//
// What bounds it on the H100: memory traffic.  The unfused chain
// writes and reads the filtered frame, the detection map, the seed
// labels and the propagated labels (each a 446 MB pass at 10560²);
// here each input is read once (4 + 4 + 1 B a pixel) and seg written
// once (4 B), 1.45 GB at 10560², 0.43 ms at 3.35 TB/s.  Each block
// takes a T x T interior tile with an `iters` halo of labels (S = T +
// 2*iters).  With taps it stages the (S + 2r)² image region in shared
// memory with one coalesced read, filters it along columns into an
// S x (S + 2r) buffer and along rows from there (every tap read comes
// from shared memory); it then forms the detection map of its S x S
// region and runs every label step in shared memory between two int32
// buffers that alias the filter's buffers, stopping when a step changes
// nothing (background tiles cost one step).  A value beyond the tile
// travels one pixel per step, so after `iters` steps only the halo is
// wrong.  The root count is a per-block sum added atomically to one
// device int32: exact, and it stays on the device.  T = 64 when the
// buffers fit in 227 KB of shared memory, else 32 (smem_bytes).
//
// Launcher contract: img, seg are (H, W) f32 / int32 on the device;
// std (f32) and excl (uint8, 0/1) may be null; taps points to `ntaps`
// floats in HOST memory (copied into the launch's parameters), null
// when ntaps == 0; count is one device int32 the caller zeroed.  It
// allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTaps = 31;
constexpr int kMaxSmem = 232448;

struct Taps {
  float t[kMaxTaps];
};

// Bytes at the front of shared memory: the two int32 label buffers, or
// the filter's column-filtered and image buffers when they are larger.
__host__ __device__ inline size_t front_bytes(int S, int r, int ntaps) {
  const size_t labels = 8 * (size_t)S * S;
  if (ntaps == 0) return labels;
  const size_t SV = (size_t)S + 2 * r;
  const size_t filter = 4 * ((size_t)S * SV + SV * SV);
  return labels > filter ? labels : filter;
}

inline size_t smem_bytes(int T, int iters, int r, int ntaps) {
  const int S = T + 2 * iters;
  return front_bytes(S, r, ntaps) + (size_t)S * S;
}

__device__ __forceinline__ float clamp_min_nan(float s, float lo) {
  return (s != s) ? s : fmaxf(s, lo);   // torch.clamp: NaN propagates
}

__global__ void __launch_bounds__(kThreads)
detect_kernel(const float* __restrict__ img, const float* __restrict__ std_,
              const uint8_t* __restrict__ excl, Taps taps, int ntaps,
              float nsigma, int absval, int iters, int T, int H, int W,
              int* __restrict__ seg, int* __restrict__ count) {
  extern __shared__ int smem[];
  const int L = iters;
  const int S = T + 2 * L;
  const int r = ntaps > 0 ? (ntaps - 1) / 2 : 0;
  const int SV = S + 2 * r;
  const int big = H * W + 2;
  // labels a, b and the filter's buffers share the front of smem; the
  // detection map follows them (see smem_bytes)
  int* a = smem;
  int* b = smem + S * S;
  float* vcol = (float*)smem;          // S x SV column-filtered values
  float* raw = vcol + S * SV;          // SV x SV image region
  uint8_t* det = (uint8_t*)smem + front_bytes(S, r, ntaps);
  const int gy0 = blockIdx.y * T - L;  // frame row of tile row 0
  const int gx0 = blockIdx.x * T - L;  // frame column of tile column 0
  __shared__ int roots;
  __shared__ float tap[kMaxTaps];
  if (threadIdx.x == 0) roots = 0;
  if (threadIdx.x < ntaps) tap[threadIdx.x] = taps.t[threadIdx.x];

  if (ntaps > 0) {
    // the image region the filter reads, zero outside the frame
    for (int i = threadIdx.x; i < SV * SV; i += kThreads) {
      const int ry = i / SV;
      const int gy = gy0 - r + ry;
      const int gx = gx0 - r + (i - ry * SV);
      raw[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? img[(size_t)gy * W + gx] : 0.f;
    }
    __syncthreads();
    // filter along columns (axis 0) for the S x SV region
    for (int i = threadIdx.x; i < S * SV; i += kThreads) {
      const int ty = i / SV;
      const int c = i - ty * SV;
      float acc = 0.f;
      for (int q = 0; q < ntaps; ++q)
        acc = __fadd_rn(acc, __fmul_rn(tap[q], raw[(ty + q) * SV + c]));
      vcol[i] = acc;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < S * S; i += kThreads) {
    const int ty = i / S;
    const int tx = i - ty * S;
    const int gy = gy0 + ty;
    const int gx = gx0 + tx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float x;
    if (ntaps > 0) {
      float acc = 0.f;
      for (int q = 0; q < ntaps; ++q)
        acc = __fadd_rn(acc, __fmul_rn(tap[q], vcol[ty * SV + tx + q]));
      x = acc;
    } else {
      x = inside ? img[(size_t)gy * W + gx] : 0.f;
    }
    if (absval) x = fabsf(x);
    bool d = false;
    if (inside) {
      const size_t o = (size_t)gy * W + gx;
      const float thr = std_ ? __fmul_rn(nsigma, clamp_min_nan(std_[o], 1e-6f))
                             : nsigma;
      d = x > thr;
      if (excl && excl[o]) d = false;
    }
    det[i] = d;
  }
  __syncthreads();     // the filtered values are dead: a and b are free

  for (int i = threadIdx.x; i < S * S; i += kThreads) {
    const int ty = i / S;
    const int tx = i - ty * S;
    a[i] = det[i] ? (gy0 + ty) * W + (gx0 + tx) + 1 : big;
  }
  __syncthreads();

  for (int s = 0; s < iters; ++s) {
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
        for (int y = ylo; y <= yhi; ++y)
          for (int x = xlo; x <= xhi; ++x) v = min(v, a[y * S + x]);
      }
      b[i] = v;
      changed |= (v != c);
    }
    const int any = __syncthreads_or(changed);
    int* t = a;
    a = b;
    b = t;
    if (!any) break;
  }

  int mine = 0;
  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    const int ty = i / T;
    const int tx = i - ty * T;
    const int gy = blockIdx.y * T + ty;
    const int gx = blockIdx.x * T + tx;
    if (gy >= H || gx >= W) continue;
    const int j = (ty + L) * S + tx + L;
    const int lab = det[j] ? a[j] : 0;
    seg[(size_t)gy * W + gx] = lab;
    mine += (det[j] && lab == gy * W + gx + 1);
  }
  if (mine) atomicAdd(&roots, mine);
  __syncthreads();
  if (threadIdx.x == 0 && roots) atomicAdd(count, roots);
}

}  // namespace

extern "C" int bbt_fused_detect(const void* img, const void* std_,
                                const void* excl, const void* taps_host,
                                int ntaps, float nsigma, int absval,
                                int iters, int H, int W, void* seg,
                                void* count, void* stream) {
  if (ntaps < 0 || ntaps > kMaxTaps || (ntaps > 0 && ntaps % 2 == 0) ||
      iters < 0 || H < 1 || W < 1 || (long long)H * W + 2 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Taps taps = {};
  for (int q = 0; q < ntaps; ++q) taps.t[q] = ((const float*)taps_host)[q];
  const int r = ntaps > 0 ? (ntaps - 1) / 2 : 0;
  int T = 64;
  while (T >= 16 && smem_bytes(T, iters, r, ntaps) > (size_t)kMaxSmem)
    T /= 2;
  if (T < 16) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, iters, r, ntaps);
  cudaError_t err = cudaFuncSetAttribute(
      detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + T - 1) / T, (H + T - 1) / T);
  detect_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)std_, (const uint8_t*)excl, taps,
      ntaps, nsigma, absval, iters, T, H, W, (int*)seg, (int*)count);
  return (int)cudaGetLastError();
}
