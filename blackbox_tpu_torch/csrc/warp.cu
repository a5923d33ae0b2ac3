// Two-pass shifted-add remap (K10) for Hopper: ops/warp.warp_shift2pass on
// the card, one launch a pass.
//
// Replaces no TPU kernel.  The JAX package runs this remap in XLA
// (blackbox_tpu/ops/warp.py, warp_shift2pass); the port's plain route
// (ops/warp._shift2pass_plain) fans it out into PyTorch elementwise ops:
// for each strip and each integer shift s of the strip's range, ~15
// full-strip ops for the Lanczos weight, the norm and the plane's
// multiply-add, and a torch.where chain for the nearest planes.  At the
// science remap (10560², 8 strips of ~8 shifts, one Lanczos and two
// nearest planes) that reads and writes each strip hundreds of times:
// ~130 ms a visit.
//
// The planes: one float32 Lanczos plane (the reference's image) and up to
// two nearest planes (its noise map and mask), as every caller passes
// them.  Pass 1 (rows) writes
//     V(y, x) = sum_s src[clamp(y + s), x] * Ly(dys(y, x) - s) / norm
// for the Lanczos plane, s over the range of the strip of columns that
// holds x, and takes one tap, clamp(rint(dys), r0 + a - 1, r1 - a + 1),
// for each nearest plane; pass 2 (columns) does the same along x on V,
// over the range of the strip of rows that holds y, and writes the
// result or, outside the source frame, the fill.  A pixel costs a pass 3
// transcendentals and ~25 instructions a shift (an IEEE division among
// them) for its weight and the plane's multiply-add; the bytes are ~36 a
// pixel over both passes (3 sources read, 3 intermediates written and
// read, 3 results written).  The design:
//   order      bit for bit the plain route on the card: every float op
//              as PyTorch's CUDA kernels compute it, in its order, with
//              _rn intrinsics (no FMA contraction), IEEE divisions,
//              sinf/cosf as torch.sin/torch.cos call them, and the
//              divisions by a Python scalar (pid / a, arange / step) as
//              PyTorch runs them, a multiply by the float reciprocal.
//   constants  the per-shift factors a * sgn, cos(pi k / a), sin(pi k / a)
//              of k = s - c0 come from the host, rounded to float32 as
//              PyTorch rounds a Python scalar; the strips (start, r0, r1,
//              c0) too, c0 the range's centre by Python's floor division.
//   staging    pass 1: a block of 32 columns x 64 rows stages the source
//              rows its strips' shifts reach (64 + their span) of the
//              Lanczos plane in shared memory, so the plane is read from
//              device memory about once; a tile whose strips span more
//              than kStageSpan rows reads its taps from device memory
//              instead.  Pass 2: a block of 256 columns x 4 rows stages
//              each row's 256 + width columns of V.  Nearest planes take
//              one tap a pixel, read directly.
//   edges      a clamped index, as the plain route's edge padding.
//   coordinates ys and xs planes as given, or, for the (sy, sx, step)
//              form, upsample_lerp's bilinear from the coarse nodes at
//              each pixel, in its order of operations.
//   fills      pass 2's epilogue: the in-frame test on (ys, xs) against
//              the source's shape, per mode, then the fill's bits (from
//              the host, or read from a device scalar: no host read).
//   nearest    planes of 1, 2 or 4 bytes move as bits (their values are
//              selected, never computed).
//
// Launcher contract: srcs, dsts and fill_ptrs are host arrays of 1 + nn
// device pointers (the Lanczos plane first, then nn <= 2 nearest planes),
// words a host array of two ints a plane (element size, fill bits), strips
// a host array of four ints a strip (start, r0, r1, c0) and taps a host
// array of three floats for each k = kmin .. kmin + nk - 1.  Pass 1
// (axis 0) reads (Hs, W) sources and writes (H, W) planes; pass 2 (axis 1)
// reads (H, W) planes and writes (H, W) results.  ys and xs are (H, W)
// float32 planes (step 0) or (ny, nx) coarse nodes (step > 0,
// (ny - 1) * step >= H and (nx - 1) * step >= W).  One kernel launch on
// `stream`; it allocates nothing, does not synchronise, and returns the
// first CUDA error.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 3;  // the Lanczos plane and two nearest planes
constexpr int kMaxStrips = 64;
constexpr int kMaxShifts = 192;
// pass 1: 32 columns x 64 rows a block, a thread every 8th row; the rows
// a tile stages beyond its own, within 48 KB of shared memory
constexpr int kColTile = 32;
constexpr int kRowTile = 64;
constexpr int kRowThreads = 8;
constexpr int kStageSpan = 320;
// pass 2: 256 columns x 4 rows a block
constexpr int kLineTile = 256;
constexpr int kLines = 4;

// the float32 scalars of the plain route: math.pi and 1e-7 as Python
// floats, rounded to float32 as PyTorch passes them
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kEps = static_cast<float>(1e-7);

struct Strip {
  int start, r0, r1, c0;
};

struct Pass {
  const void* src[kPlanes];
  void* dst[kPlanes];
  const void* fill_ptr[kPlanes];
  uint32_t fill_bits[kPlanes];
  int esize[kPlanes];
  int n;  // plane 0 Lanczos (float32), 1 .. n-1 nearest
  const float* ys;
  const float* xs;
  int nx, step;  // step 0: (H, W) planes; else coarse nodes, nx a row
  float inv_step;
  int H, W, Hs;  // output rows and columns; source rows
  int a;
  float inv_a;
  int nstrips, kmin;
  Strip strip[kMaxStrips];
  float tap[kMaxShifts][3];  // a * sgn, cos, sin of k = kmin + i
};
// kernel parameters stay within the 4 KB every CUDA 12 driver takes
static_assert(sizeof(Pass) + sizeof(int) <= 4096, "K10's parameters");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// the strip of index i along an axis of n: the largest b with
// b * n / nstrips <= i, as pass_axis slices it
__device__ __forceinline__ const Strip& strip_of(const Pass& p, int i,
                                                 int n) {
  return p.strip[(int)(((long long)(i + 1) * p.nstrips - 1) / n)];
}

// rows[y, j] of upsample_lerp: c[i, j] + ty * (c[i + 1, j] - c[i, j])
__device__ __forceinline__ float lerp_row(const float* c, int nx, int i,
                                          int j, float ty) {
  const float c0 = c[i * nx + j];
  return __fadd_rn(c0, __fmul_rn(ty, __fsub_rn(c[(i + 1) * nx + j], c0)));
}

// a coordinate plane's value at (y, x)
__device__ __forceinline__ float coord(const Pass& p, const float* c, int y,
                                       int x) {
  if (p.step == 0) return c[(long long)y * p.W + x];
  const int i = y / p.step, j = x / p.step;
  const float ty = __fmul_rn((float)(y - i * p.step), p.inv_step);
  const float tx = __fmul_rn((float)(x - j * p.step), p.inv_step);
  const float r0 = lerp_row(c, p.nx, i, j, ty);
  const float r1 = lerp_row(c, p.nx, i, j + 1, ty);
  return __fadd_rn(r0, __fmul_rn(tx, __fsub_rn(r1, r0)));
}

// the weights of one pixel: d is its coordinate minus its own index
struct Lanczos {
  float d0, s_pi, s_pa, c_pa;

  __device__ __forceinline__ Lanczos(const Pass& p, float d, int c0) {
    d0 = __fsub_rn(d, (float)c0);
    const float pid = __fmul_rn(kPi, d0);
    s_pi = sinf(pid);
    const float pida = __fmul_rn(pid, p.inv_a);
    s_pa = sinf(pida);
    c_pa = cosf(pida);
  }

  // the weight of shift s = c0 + k
  __device__ __forceinline__ float weight(const Pass& p, int k) const {
    const float* t = p.tap[k - p.kmin];
    const float ds = __fsub_rn(d0, (float)k);
    const float num =
        __fmul_rn(__fmul_rn(s_pi, t[0]),
                  __fsub_rn(__fmul_rn(s_pa, t[1]), __fmul_rn(c_pa, t[2])));
    const float pds = __fmul_rn(kPi, ds);
    const float pid2 = __fmul_rn(pds, pds);
    const float ads = fabsf(ds);
    // torch.clamp(min=) keeps a NaN
    const float den = isnan(pid2) ? pid2 : fmaxf(pid2, kEps);
    const float w = ads < kEps ? 1.0f : __fdiv_rn(num, den);
    return ads < (float)p.a ? w : 0.0f;
  }
};

__device__ __forceinline__ uint32_t load_bits(const void* base, long long i,
                                              int esize) {
  if (esize == 1) return static_cast<const uint8_t*>(base)[i];
  if (esize == 2) return static_cast<const uint16_t*>(base)[i];
  return static_cast<const uint32_t*>(base)[i];
}

__device__ __forceinline__ void store_bits(void* base, long long i, int esize,
                                           uint32_t v) {
  if (esize == 1)
    static_cast<uint8_t*>(base)[i] = (uint8_t)v;
  else if (esize == 2)
    static_cast<uint16_t*>(base)[i] = (uint16_t)v;
  else
    static_cast<uint32_t*>(base)[i] = v;
}

// a nearest plane's tap: clamp(rint(d), r0 + a - 1, r1 - a + 1), or none
// (the plain route's zeros) where that range is empty
__device__ __forceinline__ bool nearest_shift(const Pass& p, const Strip& st,
                                              float d, int* s) {
  const int n0 = st.r0 + p.a - 1, n1 = st.r1 - p.a + 1;
  *s = clampi((int)rintf(d), n0, n1);
  return n0 <= n1;
}

// pass 1: along y, each column x over its strip's shifts
__global__ void __launch_bounds__(kColTile* kRowThreads)
    warp_rows(const Pass p, int rows_alloc) {
  extern __shared__ float stage[];  // rows_alloc x kColTile
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = blockIdx.x * kRowTile, x0 = blockIdx.y * kColTile;
  const int x = x0 + tx;
  const float* src = static_cast<const float*>(p.src[0]);
  // the union of the shift ranges of the tile's strips
  const int b0 = (int)(((long long)(x0 + 1) * p.nstrips - 1) / p.W);
  const int b1 =
      (int)(((long long)min(x0 + kColTile, p.W) * p.nstrips - 1) / p.W);
  int rlo = INT_MAX, rhi = INT_MIN;
  for (int b = b0; b <= b1; ++b) {
    if (p.strip[b].r0 > p.strip[b].r1) continue;
    rlo = min(rlo, p.strip[b].r0);
    rhi = max(rhi, p.strip[b].r1);
  }
  if (rhi < rlo) rlo = rhi = 0;  // no live strip: its own rows, unread
  const int rows = kRowTile + rhi - rlo;
  const bool staged = rows <= rows_alloc;  // the same for the whole block
  if (staged) {
    for (int i = ty; i < rows; i += kRowThreads) {
      const int sy = clampi(y0 + rlo + i, 0, p.Hs - 1);
      stage[i * kColTile + tx] = x < p.W ? src[(long long)sy * p.W + x] : 0.0f;
    }
    __syncthreads();
  }
  if (x >= p.W) return;
  const Strip st = strip_of(p, x, p.W);
  const int y_end = min(y0 + kRowTile, p.H);
  for (int y = y0 + ty; y < y_end; y += kRowThreads) {
    const float d = __fsub_rn(coord(p, p.ys, y, x), (float)y);
    const long long o = (long long)y * p.W + x;
    const Lanczos lz(p, d, st.c0);
    float acc = 0.0f, norm = 0.0f;
    for (int s = st.r0; s <= st.r1; ++s) {
      const float w = lz.weight(p, s - st.c0);
      const float v =
          staged ? stage[(y - y0 - rlo + s) * kColTile + tx]
                 : src[(long long)clampi(y + s, 0, p.Hs - 1) * p.W + x];
      norm = __fadd_rn(norm, w);
      acc = __fadd_rn(acc, __fmul_rn(w, v));
    }
    if (norm == 0.0f) norm = 1.0f;
    static_cast<float*>(p.dst[0])[o] = __fdiv_rn(acc, norm);
    int s = 0;
    const bool tap = p.n > 1 && nearest_shift(p, st, d, &s);
    const long long from = (long long)clampi(y + s, 0, p.Hs - 1) * p.W + x;
    for (int l = 1; l < p.n; ++l)
      store_bits(p.dst[l], o, p.esize[l],
                 tap ? load_bits(p.src[l], from, p.esize[l]) : 0u);
  }
}

// pass 2: along x, each row y over its strip's shifts, then the fills
__global__ void __launch_bounds__(kLineTile)
    warp_cols(const Pass p, int cols_alloc) {
  extern __shared__ float stage[];  // kLines x cols_alloc
  const int tx = threadIdx.x;
  const int y0 = blockIdx.x * kLines, x0 = blockIdx.y * kLineTile;
  const int lines = min(kLines, p.H - y0);
  for (int j = 0; j < lines; ++j) {
    const Strip& st = strip_of(p, y0 + j, p.H);
    const int n = st.r1 >= st.r0 ? kLineTile + st.r1 - st.r0 : 0;
    const float* v = static_cast<const float*>(p.src[0]) +
                     (long long)(y0 + j) * p.W;
    for (int i = tx; i < n; i += kLineTile)
      stage[j * cols_alloc + i] = v[clampi(x0 + st.r0 + i, 0, p.W - 1)];
  }
  __syncthreads();
  const int x = x0 + tx;
  if (x >= p.W) return;
  uint32_t fill[kPlanes] = {};
#pragma unroll
  for (int l = 0; l < kPlanes; ++l)
    if (l < p.n)
      fill[l] = p.fill_ptr[l] ? load_bits(p.fill_ptr[l], 0, p.esize[l])
                              : p.fill_bits[l];
  const float hs = (float)p.Hs, ws = (float)p.W;
  for (int j = 0; j < lines; ++j) {
    const int y = y0 + j;
    const Strip st = strip_of(p, y, p.H);
    const float xv = coord(p, p.xs, y, x), yv = coord(p, p.ys, y, x);
    const float d = __fsub_rn(xv, (float)x);
    const long long o = (long long)y * p.W + x;
    const bool inl =
        yv >= 0.0f && yv <= hs - 1.0f && xv >= 0.0f && xv <= ws - 1.0f;
    const Lanczos lz(p, d, st.c0);
    float acc = 0.0f, norm = 0.0f;
    const float* line = stage + j * cols_alloc + tx - st.r0;
    for (int s = st.r0; s <= st.r1; ++s) {
      const float w = lz.weight(p, s - st.c0);
      norm = __fadd_rn(norm, w);
      acc = __fadd_rn(acc, __fmul_rn(w, line[s]));
    }
    if (norm == 0.0f) norm = 1.0f;
    static_cast<float*>(p.dst[0])[o] =
        inl ? __fdiv_rn(acc, norm) : __uint_as_float(fill[0]);
    const bool inn = yv >= -0.5f && yv <= hs - 0.5f && xv >= -0.5f &&
                     xv <= ws - 0.5f;
    int s = 0;
    const bool tap = p.n > 1 && nearest_shift(p, st, d, &s);
    const long long from = (long long)y * p.W + clampi(x + s, 0, p.W - 1);
#pragma unroll
    for (int l = 1; l < kPlanes; ++l)
      if (l < p.n)
        store_bits(p.dst[l], o, p.esize[l],
                   !inn  ? fill[l]
                   : tap ? load_bits(p.src[l], from, p.esize[l])
                         : 0u);
  }
}

}  // namespace

extern "C" int bbt_warp_pass(const void* srcs, const void* dsts,
                             const void* fill_ptrs, const void* words, int nn,
                             const void* ys, const void* xs, int nx, int step,
                             float inv_step, int H, int W, int Hs,
                             const void* strips, int nstrips,
                             const void* taps, int kmin, int nk, int a,
                             float inv_a, int axis, void* stream) {
  if (nn < 0 || nn > kPlanes - 1 || nstrips < 1 || nstrips > kMaxStrips ||
      nk < 0 || nk > kMaxShifts || H < 1 || W < 1 || Hs < 1 || a < 1 ||
      step < 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  Pass p = {};
  const void* const* src = static_cast<const void* const*>(srcs);
  void* const* dst = static_cast<void* const*>(dsts);
  const void* const* fp = static_cast<const void* const*>(fill_ptrs);
  const int* w = static_cast<const int*>(words);
  p.n = 1 + nn;
  for (int l = 0; l < p.n; ++l) {
    p.src[l] = src[l];
    p.dst[l] = dst[l];
    p.fill_ptr[l] = fp[l];
    p.esize[l] = w[2 * l];
    p.fill_bits[l] = (uint32_t)w[2 * l + 1];
    const int e = p.esize[l];
    if (l == 0 ? e != 4 : e != 1 && e != 2 && e != 4)
      return (int)cudaErrorInvalidValue;
  }
  p.ys = static_cast<const float*>(ys);
  p.xs = static_cast<const float*>(xs);
  p.nx = nx;
  p.step = step;
  p.inv_step = inv_step;
  p.H = H;
  p.W = W;
  p.Hs = Hs;
  p.a = a;
  p.inv_a = inv_a;
  p.nstrips = nstrips;
  p.kmin = kmin;
  const int* sv = static_cast<const int*>(strips);
  int rlo = INT_MAX, rhi = INT_MIN, width = 0;
  for (int b = 0; b < nstrips; ++b) {
    const Strip s{sv[4 * b], sv[4 * b + 1], sv[4 * b + 2], sv[4 * b + 3]};
    p.strip[b] = s;
    if (s.r0 > s.r1) continue;
    rlo = s.r0 < rlo ? s.r0 : rlo;
    rhi = s.r1 > rhi ? s.r1 : rhi;
    width = s.r1 - s.r0 > width ? s.r1 - s.r0 : width;
    // every shift of a strip has its factors in the table
    if (s.r0 - s.c0 < kmin || s.r1 - s.c0 >= kmin + nk)
      return (int)cudaErrorInvalidValue;
  }
  const int span = rhi >= rlo ? rhi - rlo : 0;
  const float* tv = static_cast<const float*>(taps);
  for (int i = 0; i < nk; ++i)
    for (int c = 0; c < 3; ++c) p.tap[i][c] = tv[3 * i + c];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    const int rows_alloc = kRowTile + (span < kStageSpan ? span : kStageSpan);
    const dim3 grid((H + kRowTile - 1) / kRowTile,
                    (W + kColTile - 1) / kColTile);
    warp_rows<<<grid, dim3(kColTile, kRowThreads),
                rows_alloc * kColTile * sizeof(float), st>>>(p, rows_alloc);
  } else {
    const int cols_alloc = kLineTile + width;
    const dim3 grid((H + kLines - 1) / kLines,
                    (W + kLineTile - 1) / kLineTile);
    warp_cols<<<grid, kLineTile, kLines * cols_alloc * sizeof(float), st>>>(
        p, cols_alloc);
  }
  return (int)cudaGetLastError();
}
