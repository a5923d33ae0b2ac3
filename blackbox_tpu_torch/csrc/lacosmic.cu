// One fused L.A.Cosmic iteration (K7) for Hopper.
//
// Replaces the TPU kernel blackbox_tpu/pallas/lacosmic.py::_iter_kernel
// (wrapper lacosmic_pallas): 5x5, 3x3 and 7x7 medians, the subsampled
// Laplacian, the two significance dilations and the masked 5x5 clean of
// one iteration, in that kernel's float arithmetic: masks are float32
// products of gt(a, b) = 0.5 * (sign(a - b) + 1), min/max propagate NaN,
// and the masked median picks its ranks by 0/1-weighted sums.  Every
// multiply and add is rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction), so the result equals the plain version
// (blackbox_tpu_torch/ops/lacosmic_fused.py::_iter_plain) bit for bit.
//
// The iteration's output depends on its inputs within 9 px, so it is
// computed over an extended domain E = (Hp + 2P) x (Wp + 2P), P >= 9,
// whose first stage reads the (Hp, Wp) input with clamped (edge) reads;
// the stages after it read E with clamped reads, which disturbs only
// the outer P - 1 px of E, never its centre.  Five launches through
// device memory (the scratch planes live on E):
//   1. m5 = max(med5(clean), 1e-5), s = lap(clean) / (2 noise), m3
//   2. sp = s - med5(s), f from med7(m3), the seed mask c1
//   3. c2 = dilate3(c1) * gt(sp, sigclip) * good
//   4. crm2 = max(crm, dilate5(c2) * gt(sp, sigclip * sigfrac) * good)
//   5. the masked 5x5 clean on the (Hp, Wp) centre
// The medians reuse the sorted-column networks of median_networks.cuh
// (a block stages a 16 x 64 tile plus halo and sorts each column once);
// the masked clean sorts its 25 values in registers with the TPU
// kernel's odd-even transposition network.
//
// What bounds it on the H100: min/max and float work, about 1,900
// operations per pixel and iteration (the 25-value transposition sort
// alone is 600; chip_smoke.py's k7_ops_per_pixel counts them), against
// about 100 bytes per pixel of device-memory traffic through the
// scratch planes.  Fusing the five launches into one tile pass is
// later work.
//
// Launcher contract: clean, inm, crm, out_c, out_m are (Hp, Wp) float32
// planes, rdn a device float32 scalar, scratch 7 planes of E.  It
// allocates nothing, does not synchronise, and returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stddef.h>

#include "median_networks.cuh"

namespace {

constexpr int TH = 16;
constexpr int TW = 64;
constexpr int NT = 256;
constexpr int PER = TH * TW / NT;
constexpr float kBig = 1e30f;

__device__ __forceinline__ int clampi(int v, int n) {
  return min(max(v, 0), n - 1);
}

// torch.clamp(x, min=lo) / (x, max=hi): NaN stays NaN, -0 stays -0
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x > hi ? hi : x;
}

// jnp.sign: NaN stays NaN, zeros keep their sign
__device__ __forceinline__ float jsign(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

__device__ __forceinline__ float gt(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(jsign(__fsub_rn(a, b)), 1.f));
}

// raw[ty * rw + tx] = src at (oy + ty, ox + tx), reads clamped to sh x sw
__device__ __forceinline__ void stage(float* raw,
                                      const float* __restrict__ src, int sh,
                                      int sw, int oy, int ox, int rh,
                                      int rw) {
  for (int i = threadIdx.x; i < rh * rw; i += NT) {
    const int ty = i / rw;
    const int tx = i - ty * rw;
    raw[i] = src[(size_t)clampi(oy + ty, sh) * sw + clampi(ox + tx, sw)];
  }
}

// cols[(r * TH + ty) * nc + tx] = rank r of the K-tall column of raw
// starting at row ty, column tx (odd-even transposition, as the plain
// version's column sort)
template <int K>
__device__ __forceinline__ void sort_cols(const float* raw, int rw, int nc,
                                          float* cols) {
  for (int i = threadIdx.x; i < TH * nc; i += NT) {
    const int ty = i / nc;
    const int tx = i - ty * nc;
    float c[K];
#pragma unroll
    for (int r = 0; r < K; ++r) c[r] = raw[(ty + r) * rw + tx];
#pragma unroll
    for (int pass = 0; pass < K; ++pass) {
#pragma unroll
      for (int j = pass % 2; j < K - 1; j += 2) bbt_ce(c[j], c[j + 1]);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) cols[(r * TH + ty) * nc + tx] = c[r];
  }
}

template <int K>
__device__ __forceinline__ float window_median(const float* cols, int nc,
                                               int ty, int tx) {
  float v[K * K];
#pragma unroll
  for (int dx = 0; dx < K; ++dx) {
#pragma unroll
    for (int r = 0; r < K; ++r)
      v[dx * K + r] = cols[(r * TH + ty) * nc + tx + dx];
  }
  return MedianNet<K>::select(v);
}

// stage 1: m5 (clamped), s and m3 on E; reads the (Hp, Wp) input
__global__ void __launch_bounds__(NT)
stage1(const float* __restrict__ clean, const float* __restrict__ rdn_p,
       float* __restrict__ m5o, float* __restrict__ so,
       float* __restrict__ m3o, int Hp, int Wp, int P, int He, int We) {
  constexpr int RH = TH + 4;
  constexpr int RW = TW + 4;
  __shared__ float raw[RH * RW];
  __shared__ float c5[5 * TH * RW];
  __shared__ float c3[3 * TH * (RW - 2)];
  const int by = blockIdx.y * TH;
  const int bx = blockIdx.x * TW;
  stage(raw, clean, Hp, Wp, by - P - 2, bx - P - 2, RH, RW);
  __syncthreads();
  sort_cols<5>(raw, RW, RW, c5);
  // the 3-tall columns start one row and one column into the 2-px halo
  for (int i = threadIdx.x; i < TH * (RW - 2); i += NT) {
    const int ty = i / (RW - 2);
    const int tx = i - ty * (RW - 2);
    float c[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) c[r] = raw[(ty + 1 + r) * RW + tx + 1];
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int j = pass % 2; j < 2; j += 2) bbt_ce(c[j], c[j + 1]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) c3[(r * TH + ty) * (RW - 2) + tx] = c[r];
  }
  __syncthreads();
  const float rdn = *rdn_p;
  const float rr = __fmul_rn(rdn, rdn);
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT;
    const int ty = i / TW;
    const int tx = i - ty * TW;
    const int ey = by + ty;
    const int ex = bx + tx;
    if (ey >= He || ex >= We) continue;
    const float m5 = clamp_lo(window_median<5>(c5, RW, ty, tx), 1e-5f);
    const float m3 = window_median<3>(c3, RW - 2, ty, tx);
    const float v = raw[(ty + 2) * RW + tx + 2];
    const float up = raw[(ty + 1) * RW + tx + 2];
    const float dn = raw[(ty + 3) * RW + tx + 2];
    const float lf = raw[(ty + 2) * RW + tx + 1];
    const float rt = raw[(ty + 2) * RW + tx + 3];
    const float v2 = __fmul_rn(2.f, v);
    float lap = clamp_lo(__fsub_rn(__fsub_rn(v2, up), lf), 0.f);
    lap = __fadd_rn(lap, clamp_lo(__fsub_rn(__fsub_rn(v2, up), rt), 0.f));
    lap = __fadd_rn(lap, clamp_lo(__fsub_rn(__fsub_rn(v2, dn), lf), 0.f));
    lap = __fadd_rn(lap, clamp_lo(__fsub_rn(__fsub_rn(v2, dn), rt), 0.f));
    lap = __fmul_rn(0.25f, lap);
    const float noise = __fsqrt_rn(__fadd_rn(m5, rr));
    const size_t o = (size_t)ey * We + ex;
    m5o[o] = m5;
    so[o] = __fdiv_rn(lap, __fmul_rn(2.f, noise));
    m3o[o] = m3;
  }
}

// stage 2: sp = s - med5(s); f from med7(m3); seeds c1
__global__ void __launch_bounds__(NT)
stage2(const float* __restrict__ s, const float* __restrict__ m3,
       const float* __restrict__ m5, const float* __restrict__ inm,
       const float* __restrict__ rdn_p, float* __restrict__ spo,
       float* __restrict__ c1o, int Hp, int Wp, int P, int He, int We,
       float sigclip, float objlim) {
  constexpr int RW5 = TW + 4;
  constexpr int RW7 = TW + 6;
  __shared__ float raw[(TH + 6) * RW7];
  __shared__ float cols[7 * TH * RW7];
  const int by = blockIdx.y * TH;
  const int bx = blockIdx.x * TW;
  stage(raw, s, He, We, by - 2, bx - 2, TH + 4, RW5);
  __syncthreads();
  sort_cols<5>(raw, RW5, RW5, cols);
  __syncthreads();
  float sp[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT;
    const int ty = i / TW;
    const int tx = i - ty * TW;
    sp[j] = __fsub_rn(raw[(ty + 2) * RW5 + tx + 2],
                      window_median<5>(cols, RW5, ty, tx));
  }
  __syncthreads();
  stage(raw, m3, He, We, by - 3, bx - 3, TH + 6, RW7);
  __syncthreads();
  sort_cols<7>(raw, RW7, RW7, cols);
  __syncthreads();
  const float rdn = *rdn_p;
  const float rr = __fmul_rn(rdn, rdn);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT;
    const int ty = i / TW;
    const int tx = i - ty * TW;
    const int ey = by + ty;
    const int ex = bx + tx;
    if (ey >= He || ex >= We) continue;
    const size_t o = (size_t)ey * We + ex;
    const float m37 = window_median<7>(cols, RW7, ty, tx);
    const float noise = __fsqrt_rn(__fadd_rn(m5[o], rr));
    const float f = clamp_lo(
        __fdiv_rn(__fsub_rn(raw[(ty + 3) * RW7 + tx + 3], m37), noise), 0.01f);
    const float good = __fsub_rn(
        1.f, inm[(size_t)clampi(ey - P, Hp) * Wp + clampi(ex - P, Wp)]);
    const float c1 = __fmul_rn(
        __fmul_rn(gt(sp[j], sigclip), gt(__fdiv_rn(sp[j], f), objlim)), good);
    spo[o] = sp[j];
    c1o[o] = c1;
  }
}

// stages 3 and 4: out = max over the (2R+1)^2 neighbours of c (from 0,
// zero outside E) * gt(sp, thr) * good, then max(crm, out) when crm is
// given (stage 4)
template <int R>
__global__ void __launch_bounds__(NT)
dilate(const float* __restrict__ c, const float* __restrict__ sp,
       const float* __restrict__ inm, const float* __restrict__ crm,
       float* __restrict__ out, int Hp, int Wp, int P, int He, int We,
       float thr) {
  const int ex = blockIdx.x * NT + threadIdx.x;
  const int ey = blockIdx.y;
  if (ex >= We) return;
  float d = 0.f;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const int yy = ey + dy;
      const int xx = ex + dx;
      const float v = (yy >= 0 && yy < He && xx >= 0 && xx < We)
                          ? c[(size_t)yy * We + xx] : 0.f;
      d = bbt_max(d, v);
    }
  }
  const size_t o = (size_t)ey * We + ex;
  const size_t io = (size_t)clampi(ey - P, Hp) * Wp + clampi(ex - P, Wp);
  const float good = __fsub_rn(1.f, inm[io]);
  float r = __fmul_rn(__fmul_rn(d, gt(sp[o], thr)), good);
  if (crm != nullptr) r = bbt_max(crm[io], r);
  out[o] = r;
}

// stage 5: the masked 5x5 clean on the (Hp, Wp) centre of E
__global__ void __launch_bounds__(NT)
clean_pass(const float* __restrict__ clean, const float* __restrict__ inm,
           const float* __restrict__ crm2, const float* __restrict__ m5,
           float* __restrict__ out_c, float* __restrict__ out_m, int Hp,
           int Wp, int P, int We) {
  const int x = blockIdx.x * NT + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= Wp) return;
  float v[25];
  float n = 0.f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      const size_t io = (size_t)clampi(y + dy - 2, Hp) * Wp
                        + clampi(x + dx - 2, Wp);
      const float b = bbt_max(
          crm2[(size_t)(y + P + dy - 2) * We + x + P + dx - 2], inm[io]);
      const float cv = clean[io];
      v[dy * 5 + dx] = __fadd_rn(cv, __fmul_rn(b, __fsub_rn(kBig, cv)));
      n = __fadd_rn(n, __fsub_rn(1.f, b));
    }
  }
#pragma unroll
  for (int pass = 0; pass < 25; ++pass) {
#pragma unroll
    for (int j = pass % 2; j < 24; j += 2) bbt_ce(v[j], v[j + 1]);
  }
  const float i_lo = floorf(__fmul_rn(clamp_lo(__fsub_rn(n, 1.f), 0.f), 0.5f));
  const float i_hi = floorf(__fmul_rn(n, 0.5f));
  float lo = 0.f;
  float hi = 0.f;
#pragma unroll
  for (int r = 0; r < 25; ++r) {
    const float rf = (float)r;
    const float wl = __fsub_rn(1.f, clamp_hi(fabsf(__fsub_rn(i_lo, rf)), 1.f));
    const float wh = __fsub_rn(1.f, clamp_hi(fabsf(__fsub_rn(i_hi, rf)), 1.f));
    lo = __fadd_rn(lo, __fmul_rn(wl, v[r]));
    hi = __fadd_rn(hi, __fmul_rn(wh, v[r]));
  }
  const float med = __fadd_rn(__fmul_rn(0.5f, lo), __fmul_rn(0.5f, hi));
  const float has = clamp_hi(n, 1.f);
  const size_t e = (size_t)(y + P) * We + x + P;
  const float repl = __fadd_rn(__fmul_rn(has, med),
                               __fmul_rn(__fsub_rn(1.f, has), m5[e]));
  const size_t o = (size_t)y * Wp + x;
  const float c = clean[o];
  const float m = crm2[e];
  out_c[o] = __fadd_rn(c, __fmul_rn(m, __fsub_rn(repl, c)));
  out_m[o] = m;
}

}  // namespace

extern "C" int bbt_lacosmic_iter(const void* clean, const void* inm,
                                 const void* crm, const void* rdn,
                                 void* out_c, void* out_m, void* scratch,
                                 int Hp, int Wp, int P, float sigclip,
                                 float sig_lo, float objlim, void* stream) {
  if (P < 9) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int He = Hp + 2 * P;
  const int We = Wp + 2 * P;
  const size_t plane = (size_t)He * We;
  float* m5 = (float*)scratch;
  float* s = m5 + plane;
  float* m3 = s + plane;
  float* sp = m3 + plane;
  float* c1 = sp + plane;
  float* c2 = c1 + plane;
  float* crm2 = c2 + plane;
  const float* cl = (const float*)clean;
  const float* im = (const float*)inm;
  const float* cr = (const float*)crm;
  const float* rd = (const float*)rdn;
  cudaError_t err;

  dim3 tiles((We + TW - 1) / TW, (He + TH - 1) / TH);
  stage1<<<tiles, NT, 0, st>>>(cl, rd, m5, s, m3, Hp, Wp, P, He, We);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stage2<<<tiles, NT, 0, st>>>(s, m3, m5, im, rd, sp, c1, Hp, Wp, P, He, We,
                               sigclip, objlim);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 rows((We + NT - 1) / NT, He);
  dilate<1><<<rows, NT, 0, st>>>(c1, sp, im, nullptr, c2, Hp, Wp, P, He, We,
                                 sigclip);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dilate<2><<<rows, NT, 0, st>>>(c2, sp, im, cr, crm2, Hp, Wp, P, He, We,
                                 sig_lo);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 centre((Wp + NT - 1) / NT, Hp);
  clean_pass<<<centre, NT, 0, st>>>(cl, im, crm2, m5, (float*)out_c,
                                    (float*)out_m, Hp, Wp, P, We);
  return (int)cudaGetLastError();
}
