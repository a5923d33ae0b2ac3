// Fused source detection for Hopper: matched filter -> threshold ->
// exclusion -> bounded min-label propagation -> segment map + root count.
//
// Replaces the TPU kernel blackbox_tpu/pallas/detect.py::_detect_kernel
// (wrapper fused_detect_pallas).  Per pixel of an (H, W) f32 image:
// optional separable filter with `ntaps` taps (zero outside the frame;
// first along columns (axis 0), then along rows (axis 1), each tap sum
// started from 0 and taken in tap order), optional |x|, then det = x >
// nsigma * max(std, 1e-6) (NaN std propagates) or x > nsigma without a
// std map, minus the excluded pixels.  Detections are seeded with their
// global flat index + 1, background with BIG = H*W + 2, and `iters`
// synchronous 3x3 min steps run as in labelprop.cu.  Out: seg = label on
// detections, 0 elsewhere; count += the number of roots (detections
// whose label is their own index).  Every float step is a separately
// rounded f32 operation (no FMA contraction), in the order of the plain
// version blackbox_tpu_torch/ops/detection.py::_fused_detect_plain, so
// the two agree bit for bit.
//
// What bounds it on the H100: memory traffic.  Each input is read once
// (image, std and exclusion: 4 + 4 + 1 B a pixel), a 1-byte detection
// map is written once and seg (4 B) once: about 1.56 GB at 10560^2,
// 0.47 ms at 3.35 TB/s; the filter's 36 operations a pixel and the
// label steps, which touch only the detections (under 1% of the pixels
// of a star field), are far below that.  The first design gave each
// 64^2 tile a block with an `iters`-wide halo: it filtered the whole
// haloed region (4.25x the pixels at 32 steps), held one 512-thread
// block to an SM (160-230 KB of shared memory) and swept every pixel of
// the haloed tile at every step wherever a detection lay in reach (15.2
// ms at 32 steps on the star field).  This design runs two launches:
//   1. detect_scan, one block per strip of T rows and 128 columns
//      (16-byte loads of the image where rows start on 16 bytes): it
//      stages the strip with the filter's r-pixel halo in shared memory,
//      filters along columns and then along rows there, thresholds,
//      applies the exclusion, and writes the 1-byte detection map.  A
//      T x T tile with no detection gets seg = 0 at once; any other goes
//      on a device work list (one atomic a tile: the host never waits).
//   2. prop_tiles of labelprop_tiles.cuh on the listed tiles, seeded
//      from the detection map (no int32 seed frame goes through device
//      memory); it writes seg on its tiles and adds their roots to the
//      device count (one atomic a block).
// T = 32 up to 60 steps and 16 above, as in K1; up to 64 steps run in
// one call.  The schedule has a plain PyTorch model in
// tests/test_torch_transients.py held against the plain version.
// Measured on one H100 80GB HBM3 at 700 W (kernel_profile.py) at
// 10560^2: the detection form (star field, 9 taps, 32 steps, 6843 of
// 108900 tiles listed) about 1.1 ms, detect_scan 0.74 and prop_tiles
// 0.30; the transient form (|x|, 48 steps, 5549 tiles listed) about
// 1.0 ms, prop_tiles 0.47 (one 160 KB block an SM) and detect_scan 0.44.
//
// Launcher contract: img, seg are (H, W) f32 / int32 on the device;
// std (f32) and excl (uint8, 0/1) may be null; det is (H, W) uint8
// scratch; work is int32 scratch of at least 1 + ceil(H/16) *
// ceil(W/16) entries; taps points to `ntaps` floats in HOST memory
// (copied into the launch's parameters), null when ntaps == 0; count is
// one device int32 the caller zeroed; 0 <= iters <= 64.  It allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "labelprop_tiles.cuh"

namespace {

constexpr int kMaxTaps = 31;
constexpr int kScanX = 32, kScanY = 8;     // detect_scan block
constexpr int kStripW = 128;               // columns of a strip

struct Taps {
  float t[kMaxTaps];
};

__device__ __forceinline__ float clamp_min_nan(float s, float lo) {
  return (s != s) ? s : fmaxf(s, lo);   // torch.clamp: NaN propagates
}

// Staged columns each side of the strip: the filter's radius, rounded
// up to a multiple of 4 so that 16-byte loads stay aligned.
__host__ __device__ inline int stage_halo(int r) { return (r + 3) & ~3; }

// sum over q of tap[q] * src[q * stride], from 0 in tap order, each
// product and sum rounded on its own (the plain version's _conv1d)
template <int NTAP>
__device__ __forceinline__ float tap_sum(const float* tap, const float* src,
                                         int stride, int nt) {
  float acc = 0.f;
  if constexpr (NTAP > 0) {
#pragma unroll
    for (int q = 0; q < NTAP; ++q)
      acc = __fadd_rn(acc, __fmul_rn(tap[q], src[q * stride]));
  } else {
    for (int q = 0; q < nt; ++q)
      acc = __fadd_rn(acc, __fmul_rn(tap[q], src[q * stride]));
  }
  return acc;
}

inline size_t scan_smem(int T, int r) {
  if (r < 0) return 0;
  const size_t SW = kStripW + 2 * stage_halo(r);
  return 4 * ((T + 2 * (size_t)r) * SW + (size_t)T * SW);
}

// One strip: NTAP is the number of taps when known at compile time, 0
// without a filter, -1 for any odd count up to kMaxTaps.  VEC == 4
// loads the image region as float4 and writes seg zeros as int4.
template <int VEC, int NTAP>
__global__ void __launch_bounds__(kScanX * kScanY)
detect_scan(const float* __restrict__ img, const float* __restrict__ std_,
            const uint8_t* __restrict__ excl, Taps taps, int ntaps,
            float nsigma, int absval, int H, int W, int T,
            uint8_t* __restrict__ det, int* __restrict__ seg,
            int* __restrict__ work) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float tap[kMaxTaps];
  __shared__ unsigned flags;                 // bit p: tile p has a detection
  const int nt = NTAP >= 0 ? NTAP : ntaps;
  const int r = nt > 0 ? (nt - 1) / 2 : 0;
  const int R = stage_halo(r);
  const int SW = kStripW + 2 * R;            // staged columns
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kScanX + lane;
  const int gy0 = blockIdx.y * T;
  const int gx0 = blockIdx.x * kStripW;
  if (tid == 0) flags = 0u;
  if (tid < nt) tap[tid] = taps.t[tid];
  __syncthreads();
  float* raw = smem;                         // (T + 2r) x SW image region
  float* vcol = smem + (T + 2 * r) * SW;     // T x SW column-filtered

  if (nt > 0) {
    // the image region the filter reads, zero outside the frame
    const int SH = T + 2 * r;
    if (VEC == 4) {
      const int n4 = SW / 4;
      for (int i = tid; i < SH * n4; i += kScanX * kScanY) {
        const int ry = i / n4;
        const int gy = gy0 - r + ry;
        const int gx = gx0 - R + 4 * (i - ry * n4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = *reinterpret_cast<const float4*>(img + (size_t)gy * W + gx);
        reinterpret_cast<float4*>(raw)[i] = v;
      }
    } else {
      for (int i = tid; i < SH * SW; i += kScanX * kScanY) {
        const int ry = i / SW;
        const int gy = gy0 - r + ry;
        const int gx = gx0 - R + (i - ry * SW);
        raw[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? img[(size_t)gy * W + gx] : 0.f;
      }
    }
    __syncthreads();
    // along columns (axis 0) for every staged column
    for (int i = tid; i < T * SW; i += kScanX * kScanY) {
      const int ty = i / SW;
      vcol[i] = tap_sum<NTAP>(tap, raw + ty * SW + (i - ty * SW), SW, nt);
    }
    __syncthreads();
  }

  // threshold: thread (lane, y) takes columns lane + 32 k of rows y + 8 j
  unsigned mine = 0u;
  for (int y = threadIdx.y; y < T; y += kScanY) {
    const int gy = gy0 + y;
    if (gy >= H) break;
#pragma unroll
    for (int k = 0; k < kStripW / kScanX; ++k) {
      const int c = lane + kScanX * k;
      const int gx = gx0 + c;
      if (gx >= W) break;
      const size_t o = (size_t)gy * W + gx;
      float x;
      if (nt > 0) {
        // along rows (axis 1) from the column-filtered values
        x = tap_sum<NTAP>(tap, vcol + y * SW + R - r + c, 1, nt);
      } else {
        x = img[o];
      }
      if (absval) x = fabsf(x);
      const float thr =
          std_ ? __fmul_rn(nsigma, clamp_min_nan(std_[o], 1e-6f)) : nsigma;
      bool d = x > thr;
      if (excl && excl[o]) d = false;
      det[o] = d;
      if (d) mine |= 1u << (c / T);
    }
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (lane == 0 && mine) atomicOr(&flags, mine);
  __syncthreads();

  const int tiles_x = (W + T - 1) / T;
  const int per_strip = kStripW / T;
  if (tid < per_strip && (flags >> tid & 1u))
    work[1 + atomicAdd(work, 1)] =
        blockIdx.y * tiles_x + blockIdx.x * per_strip + tid;
  if (flags == (1u << per_strip) - 1u) return;
  // seg = 0 over the tiles with no detection
  for (int y = threadIdx.y; y < T; y += kScanY) {
    const int gy = gy0 + y;
    if (gy >= H) break;
    if (VEC == 4) {
      const int c = 4 * lane;
      if (gx0 + c < W && !(flags >> (c / T) & 1u))
        *reinterpret_cast<int4*>(seg + (size_t)gy * W + gx0 + c) =
            make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int k = 0; k < kStripW / kScanX; ++k) {
        const int c = lane + kScanX * k;
        if (gx0 + c < W && !(flags >> (c / T) & 1u))
          seg[(size_t)gy * W + gx0 + c] = 0;
      }
    }
  }
}

// prop_tiles' seeds and sink for K5: seeds from the detection map,
// seg = the label on detections and 0 elsewhere, roots counted
struct DetectSeeds {
  const uint8_t* __restrict__ det;
  int W, big;
  __device__ int operator()(int gy, int gx) const {
    return det[(size_t)gy * W + gx] ? gy * W + gx + 1 : big;
  }
};

struct SegSink {
  static constexpr bool kRoots = true;
  int* __restrict__ seg;
  int* __restrict__ count;
  int W, big;
  __device__ int put(int gy, int gx, int v) const {
    seg[(size_t)gy * W + gx] = v < big ? v : 0;
    return v == gy * W + gx + 1;
  }
  __device__ void roots(int n) const { atomicAdd(count, n); }
};

template <int VEC, int NTAP>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t st,
                        const float* img, const float* std_,
                        const uint8_t* excl, const Taps& taps, int ntaps,
                        float nsigma, int absval, int H, int W, int T,
                        uint8_t* det, int* seg, int* work) {
  auto kernel = detect_scan<VEC, NTAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, dim3(kScanX, kScanY), smem, st>>>(
      img, std_, excl, taps, ntaps, nsigma, absval, H, W, T, det, seg,
      work);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_scan_taps(dim3 grid, size_t smem, cudaStream_t st,
                             const float* img, const float* std_,
                             const uint8_t* excl, const Taps& taps,
                             int ntaps, float nsigma, int absval, int H,
                             int W, int T, uint8_t* det, int* seg,
                             int* work) {
  if (ntaps == 0)
    return launch_scan<VEC, 0>(grid, smem, st, img, std_, excl, taps, 0,
                               nsigma, absval, H, W, T, det, seg, work);
  // the catalog's matched filter (FWHM 3 px) with its loop unrolled:
  // detect_scan 0.742 ms on the 10560^2 star field, against 1.153 ms
  // through the loop whose count is known at run time
  // (kernel_profile.py, H100 80GB HBM3 at 700 W)
  if (ntaps == 9)
    return launch_scan<VEC, 9>(grid, smem, st, img, std_, excl, taps, 9,
                               nsigma, absval, H, W, T, det, seg, work);
  return launch_scan<VEC, -1>(grid, smem, st, img, std_, excl, taps, ntaps,
                              nsigma, absval, H, W, T, det, seg, work);
}

}  // namespace

extern "C" int bbt_fused_detect(const void* img, const void* std_,
                                const void* excl, const void* taps_host,
                                int ntaps, float nsigma, int absval,
                                int iters, int H, int W, void* det,
                                void* work, void* seg, void* count,
                                void* stream) {
  if (ntaps < 0 || ntaps > kMaxTaps || (ntaps > 0 && ntaps % 2 == 0) ||
      iters < 0 || iters > kMaxSteps || H < 1 || W < 1 ||
      (long long)H * W + 2 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Taps taps = {};
  for (int q = 0; q < ntaps; ++q) taps.t[q] = ((const float*)taps_host)[q];
  const int T = tile_for(iters);
  const int big = H * W + 2;
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = scan_smem(T, ntaps > 0 ? (ntaps - 1) / 2 : -1);
  const dim3 grid((W + kStripW - 1) / kStripW, (H + T - 1) / T);
  // 16-byte image rows when every row starts on a 16-byte boundary
  const bool vec = W % 4 == 0 && ((size_t)img | (size_t)seg) % 16 == 0;
  err = (vec ? launch_scan_taps<4> : launch_scan_taps<1>)(
      grid, smem, st, (const float*)img, (const float*)std_,
      (const uint8_t*)excl, taps, ntaps, nsigma, absval, H, W, T,
      (uint8_t*)det, (int*)seg, (int*)work);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_prop_tiles(
      DetectSeeds{(const uint8_t*)det, W, big},
      SegSink{(int*)seg, (int*)count, W, big}, (const int*)work, H, W,
      iters, big, st);
}
