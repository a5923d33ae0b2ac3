// Split-real mixed-radix 1-D FFT along axis 0 of an (N, L) f32 pair.
//
// Replaces the TPU kernel blackbox_tpu/pallas/fft.py::_fft_kernel
// (wrapper fft_cols_split / _fft_cols_jit).  N = N2 * N1 with
// N1 = 2^k and N2 in {1, 3, 5, 7, 11, 21}; every column is one
// transform.  Forward: step A (DFT_N2 over the row groups n2*N1 + n1,
// then the twiddle W_N^{n1 r}), then per group r a radix-2 DIF over
// N1 rows, leaving the "scrambled" layout: physical row r*N1 + p holds
// X[r + N2*bitrev(p)].  Inverse: per group a radix-2 DIT (bit-reversed
// in, natural out), then the conjugate twiddle and the inverse DFT_N2,
// times `scale`.  The twiddles are the host-built float64 -> f32
// tables of pallas/fft.py::_tables, and every product and sum is a
// separately rounded f32 operation (__fmul_rn / __fadd_rn /
// __fsub_rn, never contracted into an FMA) in the order of the plain
// version blackbox_tpu_torch/ops/fft.py::_fft_cols_plain, so the two
// agree bit for bit.
//
// What bounds it on the H100 (one H100 80GB HBM3 at 700 W): its
// operations.  At (10752, 10752) a pass must read the two 462 MB
// planes and write two, 1.85 GB, 0.552 ms at 3.35 TB/s; its
// instructions in the plain version's form (step A's DFT_21, 8 a term,
// 174 a point with its twiddle, and 8 a point for each of the 9 radix-2
// stages) are 28.4e9, 0.849 ms at 33.5e12 float32 instructions a
// second.  The transform axis is the strided one, so neighbouring
// threads take neighbouring columns, and the work is two passes
// through device memory:
//   1. step A, one thread per (n1, column), a 2-D grid: its N2 inputs
//      in registers, loaded together (coalesced across the columns of
//      a row), the DFT constants read from __constant__ memory
//      (csrc/fft_constants.cuh, generated from ops/fft.py::_tables) at
//      indices that unrolling fixes, and each output stored as soon as
//      it is summed.  Outputs j and N2 - j are summed together: where
//      their constants for an input are bit for bit equal or conjugate
//      (ops/fft.py::dft_pair_masks; at N2 = 21 all but 12 of the 210
//      input-pair terms), they share the term or its four products,
//      which rounds nothing differently (see dft_pair), and step A's
//      float instructions fall by about a fifth.  Three blocks an SM
//      (at most 80 registers a thread).
//   2. radix-2, one block per (group r, C adjacent columns), N1 / 8
//      threads a column, a kernel for each k: the stages run three at
//      a time in registers (each thread holds the 8 rows that differ
//      in three row bits, so three stages of butterflies stay inside
//      the thread), and the groups of three trade rows through shared
//      memory: two exchanges at N1 = 512, where the earlier design made
//      nine passes over a shared tile.  The first group loads straight
//      from device memory and the last stores straight to it.  A
//      butterfly's top twiddle is 1 + 0i in the table, so it is the
//      literal, and only the bottom one is loaded (through L1; one row,
//      so one address, for the columns of a half-warp).  C = min(16,
//      8192 / N1) columns, so a block has at most 1024 threads and 64 KB
//      of float2 in shared memory.
// Step A cannot join the radix pass: a group's rows need all N2 groups'
// inputs, N x C values a block.  Measured on that card
// (kernel_profile.py): forward 1.92 ms a pass (step A 1.00, radix-2
// 0.92), inverse 1.83 ms (radix-2 0.99, step A 0.85).
//
// Launcher contract: x, y, tmp are distinct (N, L) f32 planes on the
// device (tmp is scratch for the intermediate pass, unused when
// N2 == 1); twa_* are N floats, twb_* max(k-1, 1) * N1 floats.  It
// allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "fft_constants.cuh"

namespace {

constexpr int kStepThreads = 256;
constexpr int kStepBlocks = 3;        // step-A blocks an SM: <= 80 regs
constexpr int kRadixThreads = 1024;   // the most a block takes
constexpr int kMaxCols = 16;          // columns of a radix block
constexpr int kTile = 8192;           // N1 * C, float2 in shared memory

__device__ __forceinline__ void cmul(float vr, float vi, float tr, float ti,
                                     float& orr, float& oi) {
  orr = __fsub_rn(__fmul_rn(vr, tr), __fmul_rn(vi, ti));
  oi = __fadd_rn(__fmul_rn(vr, ti), __fmul_rn(vi, tr));
}

// The constant output `r` multiplies input `n` by: w[n][r] forward,
// w[r][n] for the inverse; element 2 * (its index) of dft_c, and its
// imaginary part the next.
template <int N2, bool kInverse>
__device__ __forceinline__ int w_index(int n, int r) {
  return 2 * (kInverse ? r * N2 + n : n * N2 + r);
}

// One term of an output: w * x, the real part as a*c - b*d.
__device__ __forceinline__ void term(float wr, float wi, float xr, float xi,
                                     float& tr, float& ti) {
  tr = __fsub_rn(__fmul_rn(wr, xr), __fmul_rn(wi, xi));
  ti = __fadd_rn(__fmul_rn(wr, xi), __fmul_rn(wi, xr));
}

__device__ __forceinline__ void accumulate(int n, float tr, float ti,
                                           float& acc_r, float& acc_i) {
  if (n == 0) {
    acc_r = tr;
    acc_i = ti;
  } else {
    acc_r = __fadd_rn(acc_r, tr);
    acc_i = __fadd_rn(acc_i, ti);
  }
}

// Output 0 of the DFT_N2: the sum of its terms in input order, starting
// from the first term (no added zero).
template <int N2, bool kInverse>
__device__ __forceinline__ void dft_first(const float* in_r,
                                          const float* in_i, float& out_r,
                                          float& out_i) {
#pragma unroll
  for (int n = 0; n < N2; ++n) {
    const int w = w_index<N2, kInverse>(n, 0);
    float tr, ti;
    term(dft_c<N2, kInverse>(w), dft_c<N2, kInverse>(w + 1), in_r[n],
         in_i[n], tr, ti);
    accumulate(n, tr, ti, out_r, out_i);
  }
}

// Outputs j and N2 - j together, each summed as dft_first sums output
// 0.  Where their constants for an input are equal (dft_pairs bit
// 16 + j) the second takes the first's term; where they are conjugate
// (bit j), it reuses the first's four products: with w = a + bi and
// the conjugate a - bi, (-b)*y is -(b*y) and p - (-q) is p + q, so
// its term is a*x + b*y and a*y - b*x from the same products, rounded
// the same.  Otherwise it computes its own term.
template <int N2, bool kInverse>
__device__ __forceinline__ void dft_pair(int j, const float* in_r,
                                         const float* in_i, float& a_r,
                                         float& a_i, float& b_r,
                                         float& b_i) {
#pragma unroll
  for (int n = 0; n < N2; ++n) {
    const unsigned pairs = dft_pairs<N2, kInverse>(n);
    const int w = w_index<N2, kInverse>(n, j);
    const float wr = dft_c<N2, kInverse>(w);
    const float wi = dft_c<N2, kInverse>(w + 1);
    float tr, ti, ur, ui;
    if (pairs & (1u << j)) {
      const float p1 = __fmul_rn(wr, in_r[n]), p2 = __fmul_rn(wi, in_i[n]);
      const float p3 = __fmul_rn(wr, in_i[n]), p4 = __fmul_rn(wi, in_r[n]);
      tr = __fsub_rn(p1, p2);
      ti = __fadd_rn(p3, p4);
      ur = __fadd_rn(p1, p2);
      ui = __fsub_rn(p3, p4);
    } else {
      term(wr, wi, in_r[n], in_i[n], tr, ti);
      if (pairs & (1u << (16 + j))) {
        ur = tr;
        ui = ti;
      } else {
        const int v = w_index<N2, kInverse>(n, N2 - j);
        term(dft_c<N2, kInverse>(v), dft_c<N2, kInverse>(v + 1), in_r[n],
             in_i[n], ur, ui);
      }
    }
    accumulate(n, tr, ti, a_r, a_i);
    accumulate(n, ur, ui, b_r, b_i);
  }
}

// Forward step A: DFT_N2 over rows n2*N1 + n1, then the twiddle of the
// output row r*N1 + n1, each output stored as soon as it is summed; an
// output's twiddle is loaded before its sums, so the load's latency
// hides behind them.  Grid (column blocks, N1).
__device__ __forceinline__ void store_fwd(size_t o, float a_r, float a_i,
                                          float2 tw, float* __restrict__ yr,
                                          float* __restrict__ yi) {
  float o_r, o_i;
  cmul(a_r, a_i, tw.x, tw.y, o_r, o_i);
  yr[o] = o_r;
  yi[o] = o_i;
}

template <int N2>
__global__ void __launch_bounds__(kStepThreads, kStepBlocks)
step_a_fwd(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ yr, float* __restrict__ yi,
           const float* __restrict__ twa_re,
           const float* __restrict__ twa_im, int N1, int L) {
  const int l = blockIdx.x * kStepThreads + threadIdx.x;
  const int n1 = blockIdx.y;
  if (l >= L) return;
  float in_r[N2], in_i[N2];
#pragma unroll
  for (int n2 = 0; n2 < N2; ++n2) {
    const size_t o = (size_t)(n2 * N1 + n1) * L + l;
    in_r[n2] = xr[o];
    in_i[n2] = xi[o];
  }
  auto out = [&](int r) { return (size_t)(r * N1 + n1) * L + l; };
  auto tw = [&](int r) {
    return make_float2(twa_re[r * N1 + n1], twa_im[r * N1 + n1]);
  };
  float a_r, a_i, b_r, b_i;
  float2 ta = tw(0);
  dft_first<N2, false>(in_r, in_i, a_r, a_i);
  store_fwd(out(0), a_r, a_i, ta, yr, yi);
#pragma unroll
  for (int j = 1; j <= N2 / 2; ++j) {
    ta = tw(j);
    const float2 tb = tw(N2 - j);
    dft_pair<N2, false>(j, in_r, in_i, a_r, a_i, b_r, b_i);
    store_fwd(out(j), a_r, a_i, ta, yr, yi);
    store_fwd(out(N2 - j), b_r, b_i, tb, yr, yi);
  }
}

// Inverse step A: the conjugate twiddle of each row r*N1 + n1, then the
// inverse DFT_N2 back to the natural rows n2*N1 + n1, times scale.
__device__ __forceinline__ void store_inv(int n2, float o_r, float o_i,
                                          float* __restrict__ yr,
                                          float* __restrict__ yi, int N1,
                                          int n1, int L, int l,
                                          float scale) {
  if (scale != 1.0f) {
    o_r = __fmul_rn(o_r, scale);
    o_i = __fmul_rn(o_i, scale);
  }
  const size_t o = (size_t)(n2 * N1 + n1) * L + l;
  yr[o] = o_r;
  yi[o] = o_i;
}

template <int N2>
__global__ void __launch_bounds__(kStepThreads, kStepBlocks)
step_a_inv(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ yr, float* __restrict__ yi,
           const float* __restrict__ twa_re,
           const float* __restrict__ twa_im, int N1, int L, float scale) {
  const int l = blockIdx.x * kStepThreads + threadIdx.x;
  const int n1 = blockIdx.y;
  if (l >= L) return;
  float b_r[N2], b_i[N2];
#pragma unroll
  for (int r = 0; r < N2; ++r) {
    const int row = r * N1 + n1;
    const size_t o = (size_t)row * L + l;
    cmul(xr[o], xi[o], twa_re[row], twa_im[row], b_r[r], b_i[r]);
  }
  float a_r, a_i, c_r, c_i;
  dft_first<N2, true>(b_r, b_i, a_r, a_i);
  store_inv(0, a_r, a_i, yr, yi, N1, n1, L, l, scale);
#pragma unroll
  for (int j = 1; j <= N2 / 2; ++j) {
    dft_pair<N2, true>(j, b_r, b_i, a_r, a_i, c_r, c_i);
    store_inv(j, a_r, a_i, yr, yi, N1, n1, L, l, scale);
    store_inv(N2 - j, c_r, c_i, yr, yi, N1, n1, L, l, scale);
  }
}

// One radix-2 stage on the thread's 8 rows: the rows of v[m] and
// v[m | 1 << I] are `row0 + (m << lo)` and that plus h = 1 << e.
// Forward (DIF): butterfly, then the twiddles of stage s; inverse
// (DIT): the twiddles, then the butterfly.  No twiddle when h == 1.
template <int I, bool kInverse>
__device__ __forceinline__ void stage(float* vr, float* vi, int row0, int lo,
                                      int e, const float* __restrict__ tw_r,
                                      const float* __restrict__ tw_i) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    if (m & (1 << I)) continue;
    const int mb = m | (1 << I);
    float ar = vr[m], ai = vi[m], br = vr[mb], bi = vi[mb];
    float wr = 1.f, wi = 0.f;   // the bottom twiddle; the top one is 1
    if (e > 0) {
      const int bot = row0 + (m << lo) + (1 << e);
      wr = __ldg(tw_r + bot);
      wi = __ldg(tw_i + bot);
      if (kInverse) {
        cmul(ar, ai, 1.f, 0.f, ar, ai);
        cmul(br, bi, wr, wi, br, bi);
      }
    }
    float tr = __fadd_rn(ar, br), ti = __fadd_rn(ai, bi);
    float ur = __fsub_rn(ar, br), ui = __fsub_rn(ai, bi);
    if (!kInverse && e > 0) {
      cmul(tr, ti, 1.f, 0.f, tr, ti);
      cmul(ur, ui, wr, wi, ur, ui);
    }
    vr[m] = tr;
    vi[m] = ti;
    vr[mb] = ur;
    vi[mb] = ui;
  }
}

// The radix-2 stages of one group r (blockIdx.y) over C = 1 << lgC
// adjacent columns (blockIdx.x); thread = c + C * rt, rt < N1 / 8.
// Forward stages run on row bits k-1, ..., 0, inverse on 0, ..., k-1,
// three to a group of registers.  A group's stages work on row bits
// inside a window [lo, lo + 3); the thread's 8 rows are the 8 values
// of those bits, and rt fills the others.  K is a template argument, so
// every group's window, stage and register index is a constant.  The
// inverse scales at the end (the caller passes 1 when the inverse
// step A follows).
template <bool kInverse, int K>
__global__ void __launch_bounds__(kRadixThreads)
radix2_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ yr, float* __restrict__ yi,
              const float* __restrict__ twb_re,
              const float* __restrict__ twb_im, int L, int lgC,
              float scale) {
  extern __shared__ float2 tile[];             // [row][c], N1 x C
  constexpr int N1 = 1 << K;
  constexpr int kGroups = (K + 2) / 3;
  const int C = 1 << lgC;
  const int c = threadIdx.x & (C - 1);
  const int rt = threadIdx.x >> lgC;
  const int l = blockIdx.x * C + c;
  const bool live = l < L;
  const size_t g0 = (size_t)blockIdx.y * N1;
  float vr[8], vi[8];

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    // the group's stage count and window
    const int nst = min(3, K - 3 * g);
    const int lo = kInverse ? min(3 * g, K - 3) : max(K - 3 * g - 3, 0);
    const int row0 = (rt & ((1 << lo) - 1)) | ((rt >> lo) << (lo + 3));
    if (g == 0) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const size_t o = (g0 + row0 + (m << lo)) * L + l;
        vr[m] = live ? xr[o] : 0.f;
        vi[m] = live ? xi[o] : 0.f;
      }
    } else {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float2 v = tile[((row0 + (m << lo)) << lgC) + c];
        vr[m] = v.x;
        vi[m] = v.y;
      }
    }
#pragma unroll
    for (int t = 0; t < nst; ++t) {
      const int e = kInverse ? 3 * g + t : K - 1 - 3 * g - t;
      const int s = K - 1 - e;                 // DIF stage, h = 1 << e
      const float* tw_r = twb_re + s * N1;
      const float* tw_i = twb_im + s * N1;
      switch (e - lo) {
        case 0: stage<0, kInverse>(vr, vi, row0, lo, e, tw_r, tw_i); break;
        case 1: stage<1, kInverse>(vr, vi, row0, lo, e, tw_r, tw_i); break;
        default: stage<2, kInverse>(vr, vi, row0, lo, e, tw_r, tw_i);
      }
    }
    if (g + 1 < kGroups) {
      // every thread has read the last exchange before this one's
      // writes, and written before the next group's reads
      if (g > 0) __syncthreads();
#pragma unroll
      for (int m = 0; m < 8; ++m)
        tile[((row0 + (m << lo)) << lgC) + c] = make_float2(vr[m], vi[m]);
      __syncthreads();
    } else if (live) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float o_r = vr[m], o_i = vi[m];
        if (kInverse && scale != 1.0f) {
          o_r = __fmul_rn(o_r, scale);
          o_i = __fmul_rn(o_i, scale);
        }
        const size_t o = (g0 + row0 + (m << lo)) * L + l;
        yr[o] = o_r;
        yi[o] = o_i;
      }
    }
  }
}

template <int N2>
cudaError_t launch_step(bool inverse, const float* xr, const float* xi,
                        float* yr, float* yi, const float* twa_re,
                        const float* twa_im, int N1, int L, float scale,
                        cudaStream_t stream) {
  const dim3 grid((L + kStepThreads - 1) / kStepThreads, N1);
  if (inverse)
    step_a_inv<N2><<<grid, kStepThreads, 0, stream>>>(
        xr, xi, yr, yi, twa_re, twa_im, N1, L, scale);
  else
    step_a_fwd<N2><<<grid, kStepThreads, 0, stream>>>(
        xr, xi, yr, yi, twa_re, twa_im, N1, L);
  return cudaGetLastError();
}

cudaError_t step_a(int N2, bool inverse, const float* xr, const float* xi,
                   float* yr, float* yi, const float* twa_re,
                   const float* twa_im, int N1, int L, float scale,
                   cudaStream_t stream) {
#define BBT_STEP(Q)                                                     \
  case Q:                                                               \
    return launch_step<Q>(inverse, xr, xi, yr, yi, twa_re, twa_im, N1, \
                          L, scale, stream);
  switch (N2) {
    BBT_STEP(3) BBT_STEP(5) BBT_STEP(7) BBT_STEP(11) BBT_STEP(21)
    default: return cudaErrorInvalidValue;
  }
#undef BBT_STEP
}

template <bool kInverse, int K>
cudaError_t launch_radix(const float* xr, const float* xi, float* yr,
                         float* yi, const float* twb_re, const float* twb_im,
                         int N2, int L, float scale, cudaStream_t stream) {
  constexpr int N1 = 1 << K;
  int lgC = 0;
  while ((1 << (lgC + 1)) <= kMaxCols && (N1 << (lgC + 1)) <= kTile) ++lgC;
  const int C = 1 << lgC;
  const size_t smem = (size_t)N1 * C * sizeof(float2);
  const dim3 grid((L + C - 1) / C, N2);
  cudaError_t err = cudaFuncSetAttribute(
      radix2_kernel<kInverse, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  radix2_kernel<kInverse, K><<<grid, (N1 / 8) * C, smem, stream>>>(
      xr, xi, yr, yi, twb_re, twb_im, L, lgC, scale);
  return cudaGetLastError();
}

template <bool kInverse>
cudaError_t radix2_k(int k, const float* xr, const float* xi, float* yr,
                     float* yi, const float* twb_re, const float* twb_im,
                     int N2, int L, float scale, cudaStream_t stream) {
#define BBT_RADIX(K)                                                      \
  case K:                                                                 \
    return launch_radix<kInverse, K>(xr, xi, yr, yi, twb_re, twb_im, N2, \
                                     L, scale, stream);
  switch (k) {
    BBT_RADIX(3) BBT_RADIX(4) BBT_RADIX(5) BBT_RADIX(6) BBT_RADIX(7)
    BBT_RADIX(8) BBT_RADIX(9) BBT_RADIX(10) BBT_RADIX(11) BBT_RADIX(12)
    BBT_RADIX(13)
    default: return cudaErrorInvalidValue;   // N1 above 8192
  }
#undef BBT_RADIX
}

cudaError_t radix2(bool inverse, const float* xr, const float* xi, float* yr,
                   float* yi, const float* twb_re, const float* twb_im,
                   int N2, int k, int L, float scale, cudaStream_t stream) {
  return inverse ? radix2_k<true>(k, xr, xi, yr, yi, twb_re, twb_im, N2, L,
                                  scale, stream)
                 : radix2_k<false>(k, xr, xi, yr, yi, twb_re, twb_im, N2, L,
                                   scale, stream);
}

}  // namespace

extern "C" int bbt_fft_cols(const void* xr, const void* xi, void* yr,
                            void* yi, void* tmp_r, void* tmp_i,
                            const void* twa_re, const void* twa_im,
                            const void* twb_re, const void* twb_im, int N1,
                            int N2, int k, int L, int inverse, float scale,
                            void* stream) {
  if (N1 < 8 || (N1 & (N1 - 1)) != 0 || (1 << k) != N1 || L < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ar = (const float*)xr;
  const float* ai = (const float*)xi;
  float* o_r = (float*)yr;
  float* o_i = (float*)yi;
  float* t_r = (float*)tmp_r;
  float* t_i = (float*)tmp_i;
  const float* ta_r = (const float*)twa_re;
  const float* ta_i = (const float*)twa_im;
  const float* tb_r = (const float*)twb_re;
  const float* tb_i = (const float*)twb_im;
  cudaError_t err;
  if (!inverse) {
    if (N2 > 1) {
      err = step_a(N2, false, ar, ai, t_r, t_i, ta_r, ta_i, N1, L, 1.f, st);
      if (err != cudaSuccess) return (int)err;
      err = radix2(false, t_r, t_i, o_r, o_i, tb_r, tb_i, N2, k, L, 1.f,
                   st);
    } else {
      err = radix2(false, ar, ai, o_r, o_i, tb_r, tb_i, N2, k, L, 1.f,
                   st);
    }
  } else {
    if (N2 > 1) {
      err = radix2(true, ar, ai, t_r, t_i, tb_r, tb_i, N2, k, L, 1.f,
                   st);
      if (err != cudaSuccess) return (int)err;
      err = step_a(N2, true, t_r, t_i, o_r, o_i, ta_r, ta_i, N1, L, scale,
                   st);
    } else {
      err = radix2(true, ar, ai, o_r, o_i, tb_r, tb_i, N2, k, L, scale,
                   st);
    }
  }
  return (int)err;
}
