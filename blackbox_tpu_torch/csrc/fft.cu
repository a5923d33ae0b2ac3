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
// What bounds it on the H100: memory traffic.  At (10752, 10752) one
// transform must read the two 462 MB planes and write two, 1.85 GB,
// 0.55 ms at 3.35 TB/s; its arithmetic (step A ~168 flops a point at
// N2 = 21, the radix-2 stages ~7.7 GFLOP) is ~0.4 ms at 67 TFLOP/s
// fp32.  The transform axis is the strided one, so the design keeps
// neighbouring threads on neighbouring columns and splits the work
// into two passes through device memory:
//   1. step A, one thread per (n1, column): it loads the N2 inputs of
//      its DFT into registers (coalesced across the columns of a row)
//      and writes the N2 twiddled outputs;
//   2. radix-2, one block per (group r, C adjacent columns): the N1 x C
//      tile (512 x 16 x 8 B = 64 KB of dynamic shared memory at
//      N1 = 512, three blocks to an SM) is loaded once, all k stages
//      run in shared memory, and the tile is written once.  C =
//      min(16, 8192 / N1), a power of two like N1, so every index is a
//      shift or a mask, and N1 up to 8192 fits.
// So a transform moves its planes twice instead of once (the
// two-pass price of a simple design); a later PR can fuse step A
// into the radix pass for N1 * N2 columns that fit.
//
// Launcher contract: x, y, tmp are distinct (N, L) f32 planes on the
// device (tmp is scratch for the intermediate pass, unused when
// N2 == 1); twa_* are N floats, twb_* max(k-1, 1) * N1 floats, w the
// (N2, N2) DFT constants as f32 (re, im) pairs.  It allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kStepThreads = 256;
constexpr int kRadixThreads = 512;
constexpr int kMaxSmem = 232448;  // bytes of shared memory per block

__device__ __forceinline__ void cmul(float vr, float vi, float tr, float ti,
                                     float& orr, float& oi) {
  orr = __fsub_rn(__fmul_rn(vr, tr), __fmul_rn(vi, ti));
  oi = __fadd_rn(__fmul_rn(vr, ti), __fmul_rn(vi, tr));
}

// out[r] = sum_n2 w[n2][r] * in[n2] (or w[r][n2] when kTranspose), in n2
// order, starting from the first term (no added zero).
template <int N2, bool kTranspose>
__device__ __forceinline__ void dft_n2(const float* w, const float* in_r,
                                       const float* in_i, float* out_r,
                                       float* out_i) {
#pragma unroll
  for (int r = 0; r < N2; ++r) {
    float acc_r = 0.f, acc_i = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < N2; ++n2) {
      const int wi_ = kTranspose ? (r * N2 + n2) : (n2 * N2 + r);
      const float wr = w[2 * wi_];
      const float wi = w[2 * wi_ + 1];
      const float tr = __fsub_rn(__fmul_rn(wr, in_r[n2]),
                                 __fmul_rn(wi, in_i[n2]));
      const float ti = __fadd_rn(__fmul_rn(wr, in_i[n2]),
                                 __fmul_rn(wi, in_r[n2]));
      if (n2 == 0) {
        acc_r = tr;
        acc_i = ti;
      } else {
        acc_r = __fadd_rn(acc_r, tr);
        acc_i = __fadd_rn(acc_i, ti);
      }
    }
    out_r[r] = acc_r;
    out_i[r] = acc_i;
  }
}

// Forward step A: DFT_N2 over rows n2*N1 + n1, then the twiddle of the
// output row r*N1 + n1.
template <int N2>
__global__ void __launch_bounds__(kStepThreads)
step_a_fwd(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ yr, float* __restrict__ yi,
           const float* __restrict__ twa_re,
           const float* __restrict__ twa_im, const float* __restrict__ w_g,
           int N1, int L) {
  __shared__ float w[2 * N2 * N2];
  for (int i = threadIdx.x; i < 2 * N2 * N2; i += kStepThreads) w[i] = w_g[i];
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * kStepThreads + threadIdx.x;
  if (idx >= (size_t)N1 * L) return;
  const int n1 = (int)(idx / L);
  const int l = (int)(idx - (size_t)n1 * L);
  float in_r[N2], in_i[N2], a_r[N2], a_i[N2];
#pragma unroll
  for (int n2 = 0; n2 < N2; ++n2) {
    const size_t o = (size_t)(n2 * N1 + n1) * L + l;
    in_r[n2] = xr[o];
    in_i[n2] = xi[o];
  }
  dft_n2<N2, false>(w, in_r, in_i, a_r, a_i);
#pragma unroll
  for (int r = 0; r < N2; ++r) {
    const int row = r * N1 + n1;
    float o_r, o_i;
    cmul(a_r[r], a_i[r], twa_re[row], twa_im[row], o_r, o_i);
    yr[(size_t)row * L + l] = o_r;
    yi[(size_t)row * L + l] = o_i;
  }
}

// Inverse step A: the conjugate twiddle of each row r*N1 + n1, then the
// inverse DFT_N2 back to the natural rows n2*N1 + n1, times scale.
template <int N2>
__global__ void __launch_bounds__(kStepThreads)
step_a_inv(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ yr, float* __restrict__ yi,
           const float* __restrict__ twa_re,
           const float* __restrict__ twa_im, const float* __restrict__ w_g,
           int N1, int L, float scale) {
  __shared__ float w[2 * N2 * N2];
  for (int i = threadIdx.x; i < 2 * N2 * N2; i += kStepThreads) w[i] = w_g[i];
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * kStepThreads + threadIdx.x;
  if (idx >= (size_t)N1 * L) return;
  const int n1 = (int)(idx / L);
  const int l = (int)(idx - (size_t)n1 * L);
  float b_r[N2], b_i[N2], a_r[N2], a_i[N2];
#pragma unroll
  for (int r = 0; r < N2; ++r) {
    const int row = r * N1 + n1;
    const size_t o = (size_t)row * L + l;
    cmul(xr[o], xi[o], twa_re[row], twa_im[row], b_r[r], b_i[r]);
  }
  dft_n2<N2, true>(w, b_r, b_i, a_r, a_i);
#pragma unroll
  for (int n2 = 0; n2 < N2; ++n2) {
    float o_r = a_r[n2], o_i = a_i[n2];
    if (scale != 1.0f) {
      o_r = __fmul_rn(o_r, scale);
      o_i = __fmul_rn(o_i, scale);
    }
    const size_t o = (size_t)(n2 * N1 + n1) * L + l;
    yr[o] = o_r;
    yi[o] = o_i;
  }
}

// Radix-2 stages of one group r (blockIdx.y) over C adjacent columns
// (blockIdx.x), in shared memory.  Forward: DIF, butterfly then
// twiddle; inverse: DIT, twiddle then butterfly, then `scale` (the
// caller passes 1 when the inverse step A follows and scales).
template <bool kInverse>
__global__ void __launch_bounds__(kRadixThreads)
radix2_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ yr, float* __restrict__ yi,
              const float* __restrict__ twb_re,
              const float* __restrict__ twb_im, int N1, int k, int L,
              int lgC, float scale) {
  extern __shared__ float smem[];
  const int C = 1 << lgC;
  float* s_r = smem;
  float* s_i = smem + (size_t)N1 * C;
  const int l0 = blockIdx.x * C;
  const size_t g0 = (size_t)blockIdx.y * N1;
  const int n = N1 * C;

  for (int i = threadIdx.x; i < n; i += kRadixThreads) {
    const int row = i >> lgC;
    const int l = l0 + (i & (C - 1));
    const size_t o = (g0 + row) * L + l;
    s_r[i] = l < L ? xr[o] : 0.f;
    s_i[i] = l < L ? xi[o] : 0.f;
  }
  __syncthreads();

  const int nb = (N1 / 2) * C;
  for (int t = 0; t < k; ++t) {
    const int s = kInverse ? k - 1 - t : t;   // DIF stage index
    const int lgh = k - 1 - s;                 // h = N1 >> (s + 1)
    const int h = 1 << lgh;
    const float* tw_r = twb_re + (size_t)s * N1;
    const float* tw_i = twb_im + (size_t)s * N1;
    for (int j = threadIdx.x; j < nb; j += kRadixThreads) {
      const int bj = j >> lgC;
      const int c = j & (C - 1);
      const int top = ((bj >> lgh) << (lgh + 1)) + (bj & (h - 1));
      const int bot = top + h;
      float ar = s_r[top * C + c], ai = s_i[top * C + c];
      float br = s_r[bot * C + c], bi = s_i[bot * C + c];
      if (kInverse && h > 1) {
        cmul(ar, ai, tw_r[top], tw_i[top], ar, ai);
        cmul(br, bi, tw_r[bot], tw_i[bot], br, bi);
      }
      float tr = __fadd_rn(ar, br), ti = __fadd_rn(ai, bi);
      float ur = __fsub_rn(ar, br), ui = __fsub_rn(ai, bi);
      if (!kInverse && h > 1) {
        cmul(tr, ti, tw_r[top], tw_i[top], tr, ti);
        cmul(ur, ui, tw_r[bot], tw_i[bot], ur, ui);
      }
      s_r[top * C + c] = tr;
      s_i[top * C + c] = ti;
      s_r[bot * C + c] = ur;
      s_i[bot * C + c] = ui;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += kRadixThreads) {
    const int row = i >> lgC;
    const int l = l0 + (i & (C - 1));
    if (l >= L) continue;
    float vr = s_r[i], vi = s_i[i];
    if (kInverse && scale != 1.0f) {
      vr = __fmul_rn(vr, scale);
      vi = __fmul_rn(vi, scale);
    }
    const size_t o = (g0 + row) * L + l;
    yr[o] = vr;
    yi[o] = vi;
  }
}

template <int N2>
cudaError_t launch_step(bool inverse, const float* xr, const float* xi,
                        float* yr, float* yi, const float* twa_re,
                        const float* twa_im, const float* w, int N1, int L,
                        float scale, cudaStream_t stream) {
  const size_t total = (size_t)N1 * L;
  const unsigned blocks = (unsigned)((total + kStepThreads - 1) / kStepThreads);
  if (inverse)
    step_a_inv<N2><<<blocks, kStepThreads, 0, stream>>>(
        xr, xi, yr, yi, twa_re, twa_im, w, N1, L, scale);
  else
    step_a_fwd<N2><<<blocks, kStepThreads, 0, stream>>>(
        xr, xi, yr, yi, twa_re, twa_im, w, N1, L);
  return cudaGetLastError();
}

cudaError_t step_a(int N2, bool inverse, const float* xr, const float* xi,
                   float* yr, float* yi, const float* twa_re,
                   const float* twa_im, const float* w, int N1, int L,
                   float scale, cudaStream_t stream) {
  switch (N2) {
    case 3: return launch_step<3>(inverse, xr, xi, yr, yi, twa_re, twa_im,
                                  w, N1, L, scale, stream);
    case 5: return launch_step<5>(inverse, xr, xi, yr, yi, twa_re, twa_im,
                                  w, N1, L, scale, stream);
    case 7: return launch_step<7>(inverse, xr, xi, yr, yi, twa_re, twa_im,
                                  w, N1, L, scale, stream);
    case 11: return launch_step<11>(inverse, xr, xi, yr, yi, twa_re,
                                    twa_im, w, N1, L, scale, stream);
    case 21: return launch_step<21>(inverse, xr, xi, yr, yi, twa_re,
                                    twa_im, w, N1, L, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t radix2(bool inverse, const float* xr, const float* xi, float* yr,
                   float* yi, const float* twb_re, const float* twb_im,
                   int N1, int N2, int k, int L, float scale,
                   cudaStream_t stream) {
  int lgC = 0;
  while ((1 << (lgC + 1)) <= 16 && (N1 << (lgC + 1)) <= 8192) ++lgC;
  const int C = 1 << lgC;
  const size_t smem = 2 * (size_t)N1 * C * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  dim3 grid((L + C - 1) / C, N2);
  cudaError_t err;
  if (inverse) {
    err = cudaFuncSetAttribute(radix2_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    radix2_kernel<true><<<grid, kRadixThreads, smem, stream>>>(
        xr, xi, yr, yi, twb_re, twb_im, N1, k, L, lgC, scale);
  } else {
    err = cudaFuncSetAttribute(radix2_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    radix2_kernel<false><<<grid, kRadixThreads, smem, stream>>>(
        xr, xi, yr, yi, twb_re, twb_im, N1, k, L, lgC, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int bbt_fft_cols(const void* xr, const void* xi, void* yr,
                            void* yi, void* tmp_r, void* tmp_i,
                            const void* twa_re, const void* twa_im,
                            const void* twb_re, const void* twb_im,
                            const void* w, int N1, int N2, int k, int L,
                            int inverse, float scale, void* stream) {
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
  const float* wf = (const float*)w;
  cudaError_t err;
  if (!inverse) {
    if (N2 > 1) {
      err = step_a(N2, false, ar, ai, t_r, t_i, ta_r, ta_i, wf, N1, L, 1.f,
                   st);
      if (err != cudaSuccess) return (int)err;
      err = radix2(false, t_r, t_i, o_r, o_i, tb_r, tb_i, N1, N2, k, L, 1.f,
                   st);
    } else {
      err = radix2(false, ar, ai, o_r, o_i, tb_r, tb_i, N1, N2, k, L, 1.f,
                   st);
    }
  } else {
    if (N2 > 1) {
      err = radix2(true, ar, ai, t_r, t_i, tb_r, tb_i, N1, N2, k, L, 1.f,
                   st);
      if (err != cudaSuccess) return (int)err;
      err = step_a(N2, true, t_r, t_i, o_r, o_i, ta_r, ta_i, wf, N1, L,
                   scale, st);
    } else {
      err = radix2(true, ar, ai, o_r, o_i, tb_r, tb_i, N1, N2, k, L, scale,
                   st);
    }
  }
  return (int)err;
}
