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
// whose first stage reads the frame with clamped (edge) reads;
// the stages after it read E with clamped reads, which disturbs only
// the outer P - 1 px of E, never its centre.
//
// What bounds it on the H100: min/max and float work.  Run at every
// pixel, an iteration is about 1,900 operations a pixel (chip_smoke.py's
// k7_ops counts them): the masked clean's 25-value transposition sort
// and rank picks alone are 1,066, the 7x7 median 404.  But the clean
// changes a pixel only where the cosmic mask is set or a value in its
// window is special, and the 7x7 median matters only where sp is above
// sigclip (cosmics and star cores) or a value near it is special: on a
// calibrated frame about 1e-4 and 4e-5 of the pixels.  The first design
// ran every stage everywhere in five launches and took 52.8 ms for 3
// iterations at 10560^2 (17.6 ms an iteration, two fifths of it the
// clean).  This design proves a skip test for each (see stage2 and
// grow_scan), runs the dense remainder, about 234 operations a pixel,
// and the two expensive pieces only on the pixels the tests list, in
// four launches through device memory (the scratch planes live on E):
//   1. stage1: m5 = max(med5(clean), 1e-5), s = lap(clean) / (2 noise),
//      m3;
//   2. stage2: sp = s - med5(s) and the seed mask c1; the 7x7 median of
//      m3 (for f) on the pixels a block lists in shared memory;
//   3. grow_scan: both dilations (c2, crm2) on a tile in shared memory,
//      crm2 written where the clean reads it, the clean's skip test
//      (out_c = clean, out_m = crm2 where it holds) and a device list of
//      the other pixels;
//   4. clean_listed: the masked 5x5 clean on the listed pixels.
// Stages 1 and 2 take their 5x5 and 3x3 medians from K2's tile programs
// (MedianTile<K> of median_networks.cuh, a thread on a 2x4 patch of a
// 32 x 64 tile), the listed 7x7 medians from its sorted-column network
// (MedianNet<7>); every correct selection network with NaN-propagating
// min/max gives the same order statistic, so these are the plain
// version's medians bit for bit.  The masked clean sorts its 25 values
// in registers with the TPU kernel's odd-even transposition network.
// The skip tests have a plain PyTorch model in
// tests/test_torch_lacosmic_fused.py held against the plain version.
// Measured on one H100 80GB HBM3 at 700 W
// (kernel_profile.py), 3 iterations on a calibrated 10560^2 frame
// (about 9100 pixels listed for the clean and 3000-4300 for the 7x7
// median an iteration): about 16.0 ms, grow_scan 7.0-7.2, stage2
// 4.7-4.8, stage1 3.8-3.9, clean_listed 0.02.
//
// Launcher contract: clean is the (Hs, Ws) float32 frame the iteration
// reads (the (H, W) input or the last iteration's (Hp, Wp) result, read
// at clamped coordinates, which is the edge padding); inm the (H, W)
// excluded-pixel mask as bytes 0/1, read the same way; crm the last
// iteration's (Hp, Wp) mask, or null for zeros; out_c, out_m (Hp, Wp)
// float32 planes; rdn a device float32 scalar; scratch 6 planes of E
// (Wp + 2P a multiple of 4, for stage 1's 16-byte rows);
// counts two device int32 (set to the pixels listed for the 7x7 median
// and for the clean; the clean's list itself lives in the plane of s,
// which is dead after stage 2); total a device int32 the launch adds
// the frame's count of crm2 > 0.5 to.  It allocates nothing, does not
// synchronise, and returns the first cudaGetLastError() that is not
// cudaSuccess.

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

// The excluded-pixel mask: (H, W) bytes, 0 or 1, read at clamped
// coordinates (the edge padding of the frame to any larger shape).
struct Mask {
  const unsigned char* __restrict__ m;
  int H, W;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return (float)m[(size_t)clampi(y, H) * W + clampi(x, W)];
  }
};

// The frame an iteration cleans: (Hs, Ws) float32, read at clamped
// coordinates.  The first iteration reads the (H, W) frame itself, the
// later ones the (Hp, Wp) result of the one before, so the edge padding
// to (Hp, Wp) is never materialised.
struct Frame {
  const float* __restrict__ f;
  int Hs, Ws;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return f[(size_t)clampi(y, Hs) * Ws + clampi(x, Ws)];
  }
};

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

// Stages 1 and 2 stage a BH x BW tile of E plus its halo in shared
// memory with row stride RS (a multiple of 32) and row y shifted by
// y / 2 words, so that the 8 x 4 threads of a warp, each on a 2 x 4 patch
// of outputs, read 32 different banks (the layout of K2's medians.cu).
constexpr int BH = 32;
constexpr int BW = 64;
constexpr int RS = 96;

__device__ __forceinline__ int at(int y, int x) {
  return y * RS + (y >> 1) + x;
}

// raw[at(y, x)] = the plane at (oy + y, ox + x), read at clamped
// coordinates, for y < rh, x < rw
template <class Plane>
__device__ __forceinline__ void stage_tile(float* raw, const Plane& src,
                                           int oy, int ox, int rh, int rw) {
  for (int i = threadIdx.x; i < rh * rw; i += NT) {
    const int y = i / rw;
    const int x = i - y * rw;
    raw[at(y, x)] = src(oy + y, ox + x);
  }
}

// The top-left output of this thread's 2 x 4 patch within the tile: a
// warp is 8 threads across and 4 down (K2's medians.cu)
__device__ __forceinline__ int patch_y() {
  const int warp = threadIdx.x >> 5;
  return ((warp >> 1) * 4 + ((threadIdx.x & 31) >> 3)) * 2;
}
__device__ __forceinline__ int patch_x() {
  const int warp = threadIdx.x >> 5;
  return ((warp & 1) * 8 + (threadIdx.x & 7)) * 4;
}

// stage 1: m5 (clamped), s and m3 on E, from the frame.  A thread
// computes a 2 x 4 patch of outputs with K2's tile programs
// (MedianTile<5>, MedianTile<3>), which select the medians of the
// sorted-column networks bit for bit, NaN included.
__global__ void __launch_bounds__(NT)
stage1(Frame clean, const float* __restrict__ rdn_p,
       float* __restrict__ m5o, float* __restrict__ so,
       float* __restrict__ m3o, int P, int He, int We) {
  __shared__ float raw[(BH + 4) * RS + (BH + 4) / 2];
  const int by = blockIdx.y * BH;
  const int bx = blockIdx.x * BW;
  stage_tile(raw, clean, by - P - 2, bx - P - 2, BH + 4, BW + 4);
  __syncthreads();
  const int ty = patch_y();
  const int tx = patch_x();
  float med5[8], med3[8];
  MedianTile<5>::run(
      [&](int y, int x) { return raw[at(ty + y, tx + x)]; }, med5);
  MedianTile<3>::run(
      [&](int y, int x) { return raw[at(ty + 1 + y, tx + 1 + x)]; }, med3);
  const float rdn = *rdn_p;
  const float rr = __fmul_rn(rdn, rdn);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int ey = by + ty + t;
    const int ex = bx + tx;
    if (ey >= He || ex >= We) continue;
    const int y = ty + t + 2;
    float4 m5v, sv, m3v;
    float* m5a = &m5v.x;
    float* sa = &sv.x;
    float* m3a = &m3v.x;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int x = tx + u + 2;
      const float m5 = clamp_lo(med5[t * 4 + u], 1e-5f);
      const float v2 = __fmul_rn(2.f, raw[at(y, x)]);
      const float up = raw[at(y - 1, x)];
      const float dn = raw[at(y + 1, x)];
      const float lf = raw[at(y, x - 1)];
      const float rt = raw[at(y, x + 1)];
      float lap = clamp_lo(__fsub_rn(__fsub_rn(v2, up), lf), 0.f);
      lap = __fadd_rn(lap, clamp_lo(__fsub_rn(__fsub_rn(v2, up), rt), 0.f));
      lap = __fadd_rn(lap, clamp_lo(__fsub_rn(__fsub_rn(v2, dn), lf), 0.f));
      lap = __fadd_rn(lap, clamp_lo(__fsub_rn(__fsub_rn(v2, dn), rt), 0.f));
      lap = __fmul_rn(0.25f, lap);
      const float noise = __fsqrt_rn(__fadd_rn(m5, rr));
      m5a[u] = m5;
      sa[u] = __fdiv_rn(lap, __fmul_rn(2.f, noise));
      m3a[u] = med3[t * 4 + u];
    }
    // a row of the patch is 16 aligned bytes (We % 4 == 0), so the 8
    // threads across a warp write 128 contiguous bytes of each plane
    const size_t o = (size_t)ey * We + ex;
    *reinterpret_cast<float4*>(m5o + o) = m5v;
    *reinterpret_cast<float4*>(so + o) = sv;
    *reinterpret_cast<float4*>(m3o + o) = m3v;
  }
}

// |x| < 2^100: false for NaN and +-inf.  The skip predicates below ask
// it of every value a skipped result depends on, which bounds every
// intermediate of the skipped arithmetic far below overflow.
__device__ __forceinline__ bool small(float x) {
  return fabsf(x) < 0x1p100f;
}

// stage 2: sp = s - med5(s) everywhere; f from med7(m3) and the seed
// mask c1 = gt(sp, sigclip) * gt(sp / f, objlim) * good.  Where
// gt(sp, sigclip) is +0, sp is below sigclip and not NaN, so neither is
// s here, nor noise = sqrt(m5 + rdn^2), which is then at least
// sqrt(1e-5) (m5 is clamped there) or +inf.  Where besides every m3 of
// the 7x7 window is small, med7 is one of them, m3 - med7 is below
// 2^101, f = max((m3 - med7) / noise, 0.01) lies in [0.01, 2^110], sp /
// f is finite or -inf, and with a finite objlim gt(sp / f, objlim) is
// +0, 0.5 or 1: c1 = (+0 * that) * good = +0 * good, and the 7x7 median
// is skipped.  Each of the three tests is needed: a NaN objlim, or f =
// +inf beside sp = -inf (the window test's case: m3 = 1e37 over a noise
// of sqrt(1e-5) with rdn = 0), makes c1 NaN where gt(sp, sigclip) is +0.
// The block lists its other pixels in shared memory and computes their
// medians afterwards, one pixel a thread, with the same column sorts
// and merge network as the plain version.
__global__ void __launch_bounds__(NT)
stage2(const float* __restrict__ s, const float* __restrict__ m3,
       const float* __restrict__ m5, Mask inm,
       const float* __restrict__ rdn_p, float* __restrict__ spo,
       float* __restrict__ c1o, int* __restrict__ counts, int P, int He,
       int We, float sigclip, float objlim) {
  constexpr int RH = BH + 6;
  constexpr int RW = BW + 6;
  constexpr int PER2 = BH * BW / NT;
  __shared__ float raw[RH * RS + RH / 2];
  __shared__ float sps[BH * BW];
  __shared__ unsigned char ok[RH * RW];       // |m3| small
  __shared__ unsigned char okrow[RH * BW];    // ... over 7 columns
  __shared__ unsigned short list[BH * BW];
  __shared__ int nlist;
  const int by = blockIdx.y * BH;
  const int bx = blockIdx.x * BW;
  if (threadIdx.x == 0) nlist = 0;
  stage_tile(raw, Frame{s, He, We}, by - 2, bx - 2, BH + 4, BW + 4);
  __syncthreads();
  {
    const int ty = patch_y();
    const int tx = patch_x();
    float med5[8];
    MedianTile<5>::run(
        [&](int y, int x) { return raw[at(ty + y, tx + x)]; }, med5);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        sps[(ty + t) * BW + tx + u] = __fsub_rn(
            raw[at(ty + t + 2, tx + u + 2)], med5[t * 4 + u]);
    }
  }
  __syncthreads();
  stage_tile(raw, Frame{m3, He, We}, by - 3, bx - 3, RH, RW);
  __syncthreads();
  for (int i = threadIdx.x; i < RH * RW; i += NT) {
    const int y = i / RW;
    ok[i] = small(raw[at(y, i - y * RW)]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RH * BW; i += NT) {
    const int y = i / BW;
    const unsigned char* r = ok + y * RW + (i - y * BW);
    okrow[i] = r[0] & r[1] & r[2] & r[3] & r[4] & r[5] & r[6];
  }
  __syncthreads();
  const bool params = isfinite(objlim);
#pragma unroll
  for (int j = 0; j < PER2; ++j) {
    const int i = threadIdx.x + j * NT;
    const int ty = i / BW;
    const int tx = i - ty * BW;
    const int ey = by + ty;
    const int ex = bx + tx;
    if (ey >= He || ex >= We) continue;
    const size_t o = (size_t)ey * We + ex;
    const float g1 = gt(sps[i], sigclip);
    const unsigned char* w = okrow + ty * BW + tx;
    const bool window = w[0] & w[BW] & w[2 * BW] & w[3 * BW] & w[4 * BW] &
                        w[5 * BW] & w[6 * BW];
    spo[o] = sps[i];
    if (__float_as_uint(g1) == 0u && window && params)
      c1o[o] = __fmul_rn(g1, __fsub_rn(1.f, inm(ey - P, ex - P)));
    else
      list[atomicAdd(&nlist, 1)] = (unsigned short)i;
  }
  __syncthreads();
  const int n = nlist;
  if (threadIdx.x == 0 && n) atomicAdd(&counts[0], n);
  const float rdn = *rdn_p;
  const float rr = __fmul_rn(rdn, rdn);
  for (int k = threadIdx.x; k < n; k += NT) {
    const int i = list[k];
    const int ty = i / BW;
    const int tx = i - ty * BW;
    const int ey = by + ty;
    const int ex = bx + tx;
    const size_t o = (size_t)ey * We + ex;
    // the 7x7 median of m3: each column sorted by odd-even transposition,
    // then the sorted-column merge, as the plain version's network
    float v[49];
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      float c[7];
#pragma unroll
      for (int r = 0; r < 7; ++r) c[r] = raw[at(ty + r, tx + dx)];
#pragma unroll
      for (int pass = 0; pass < 7; ++pass) {
#pragma unroll
        for (int q = pass % 2; q < 6; q += 2) bbt_ce(c[q], c[q + 1]);
      }
#pragma unroll
      for (int r = 0; r < 7; ++r) v[dx * 7 + r] = c[r];
    }
    const float m37 = MedianNet<7>::select(v);
    const float noise = __fsqrt_rn(__fadd_rn(m5[o], rr));
    const float f = clamp_lo(
        __fdiv_rn(__fsub_rn(raw[at(ty + 3, tx + 3)], m37), noise), 0.01f);
    const float good = __fsub_rn(1.f, inm(ey - P, ex - P));
    const float sp = sps[i];
    c1o[o] = __fmul_rn(
        __fmul_rn(gt(sp, sigclip), gt(__fdiv_rn(sp, f), objlim)), good);
  }
}

__device__ __forceinline__ bool unit(float x) {
  return x >= 0.f && x <= 1.f;            // false for NaN
}

// stages 3 to 5a in one pass over the (Hp, Wp) centre, a tile a block:
//   c2   = max over the 3x3 neighbours of c1 (from 0, zero outside E)
//          * gt(sp, sigclip) * good, on the tile and 4 px around it;
//   crm2 = max(crm, max over the 5x5 neighbours of c2 (from 0)
//          * gt(sp, sigclip * sigfrac) * good), on the tile and 2 px;
// each max taken in the order of the two separate dilations, so every
// value is theirs bit for bit.  crm2 goes to device memory on the tile
// and, at the frame's edge, on the 2-px ring beyond the centre that the
// clean reads (no other pixel of E is ever read again).  Then the
// masked clean's skip test: out_c = c + m (repl - c) equals c bit for
// bit where m = crm2 is +0, c is not +-0 and repl - c is finite.  repl -
// c is finite where every clean value of the 5x5 window is small and
// every crm2 there lies in [0, 1] (inm is 0 or 1, so the blend weights b
// = max(crm2, inm) do too): m5, the median of the same 25 values
// clamped at 1e-5, is then small as well, each blended value is below
// 2^102, the good count n lies in [0, 25], the rank picks lo and hi are
// sums of 25 terms below 2^102, the median below 2^107 and repl = has
// med + (1 - has) m5 below 2^108.  Each test is needed: c = -0 gives
// +0, an infinite clean value or a NaN crm2 in the window a NaN repl.
// Such pixels get out_c = c,
// out_m = m here; the others go on the device list (one atomic a warp)
// for clean_listed.  The window test is separable: a flag a pixel of
// the tile + 2 px, ANDed over 5 columns, then over 5 rows.  The same
// pass adds the pixels of the (H, W) frame whose crm2 exceeds 0.5 to
// *total, from which the wrapper takes each iteration's count of new
// detections.
__global__ void __launch_bounds__(NT)
grow_scan(const float* __restrict__ c1, const float* __restrict__ sp,
          Frame clean, Mask inm, const float* __restrict__ crm,
          float* __restrict__ crm2,
          float* __restrict__ out_c, float* __restrict__ out_m,
          int* __restrict__ list, int* __restrict__ count,
          int* __restrict__ total, int Hp, int Wp, int P, int He, int We,
          float sigclip, float sig_lo) {
  constexpr int H5 = TH + 10, W5 = TW + 10;   // c1: the tile + 5 px
  constexpr int H4 = TH + 8, W4 = TW + 8;     // c2, sp, good: + 4 px
  constexpr int H2 = TH + 4, W2 = TW + 4;     // crm2, flags: + 2 px
  __shared__ float c1s[H5 * W5];
  __shared__ float sps[H4 * W4];
  __shared__ float goods[H4 * W4];
  __shared__ float c2s[H4 * W4];
  __shared__ float crm2s[H2 * W2];
  __shared__ unsigned char ok[H2 * W2];
  __shared__ unsigned char okrow[H2 * TW];
  const int by = blockIdx.y * TH;   // centre coordinates of the tile
  const int bx = blockIdx.x * TW;
  for (int i = threadIdx.x; i < H5 * W5; i += NT) {
    const int r = i / W5;
    const int ey = by - 5 + r + P;
    const int ex = bx - 5 + (i - r * W5) + P;
    c1s[i] = (ey >= 0 && ey < He && ex >= 0 && ex < We)
                 ? c1[(size_t)ey * We + ex] : 0.f;
  }
  for (int i = threadIdx.x; i < H4 * W4; i += NT) {
    const int r = i / W4;
    const int y = by - 4 + r;
    const int x = bx - 4 + (i - r * W4);
    // outside E nothing here is read again; clamp the address only
    sps[i] = sp[(size_t)clampi(y + P, He) * We + clampi(x + P, We)];
    goods[i] = __fsub_rn(1.f, inm(y, x));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H4 * W4; i += NT) {
    const int r = i / W4;
    const int cx = i - r * W4;
    const int ey = by - 4 + r + P;
    const int ex = bx - 4 + cx + P;
    float d = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        d = bbt_max(d, c1s[(r + dy) * W5 + cx + dx]);
    }
    const bool inside = ey >= 0 && ey < He && ex >= 0 && ex < We;
    c2s[i] = inside ? __fmul_rn(__fmul_rn(d, gt(sps[i], sigclip)), goods[i])
                    : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H2 * W2; i += NT) {
    const int r = i / W2;
    const int cx = i - r * W2;
    const int y = by - 2 + r;
    const int x = bx - 2 + cx;
    float d = 0.f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx)
        d = bbt_max(d, c2s[(r + dy) * W4 + cx + dx]);
    }
    const int j = (r + 2) * W4 + cx + 2;
    const float prev =
        crm ? crm[(size_t)clampi(y, Hp) * Wp + clampi(x, Wp)] : 0.f;
    const float m = bbt_max(
        prev, __fmul_rn(__fmul_rn(d, gt(sps[j], sig_lo)), goods[j]));
    crm2s[i] = m;
    const bool centre = y >= 0 && y < Hp && x >= 0 && x < Wp;
    const bool tile = r >= 2 && r < TH + 2 && cx >= 2 && cx < TW + 2;
    const bool ring = y >= -2 && y < Hp + 2 && x >= -2 && x < Wp + 2;
    if (centre ? tile : ring) crm2[(size_t)(y + P) * We + x + P] = m;
    ok[i] = small(clean(y, x)) && unit(m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H2 * TW; i += NT) {
    const int y = i / TW;
    const unsigned char* r = ok + y * W2 + (i - y * TW);
    okrow[i] = r[0] & r[1] & r[2] & r[3] & r[4];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int flagged = 0;    // crm2 > 0.5 on the (H, W) frame, for the counts
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT;
    const int ty = i / TW;
    const int tx = i - ty * TW;
    const int y = by + ty;
    const int x = bx + tx;
    bool listed = false;
    if (y < Hp && x < Wp) {
      const size_t o = (size_t)y * Wp + x;
      const float c = clean(y, x);
      const float m = crm2s[(ty + 2) * W2 + tx + 2];
      flagged += (y < inm.H && x < inm.W && m > 0.5f);
      const unsigned char* w = okrow + ty * TW + tx;
      if ((w[0] & w[TW] & w[2 * TW] & w[3 * TW] & w[4 * TW]) &&
          __float_as_uint(m) == 0u && c != 0.f) {
        out_c[o] = c;
        out_m[o] = m;
      } else {
        listed = true;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, listed);
    if (bal) {
      const int leader = __ffs(bal) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(count, __popc(bal));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (listed)
        list[base + __popc(bal & ((1u << lane) - 1u))] = y * Wp + x;
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    flagged += __shfl_down_sync(0xffffffffu, flagged, o);
  if (lane == 0 && flagged) atomicAdd(total, flagged);
}

// stage 5b: the masked 5x5 clean, unchanged, on the listed pixels
__global__ void __launch_bounds__(NT)
clean_listed(Frame clean, Mask inm, const float* __restrict__ crm2,
             const float* __restrict__ m5,
             float* __restrict__ out_c, float* __restrict__ out_m,
             const int* __restrict__ list, const int* __restrict__ count,
             int Wp, int P, int We) {
  const int n = *count;
  for (int k = blockIdx.x * NT + threadIdx.x; k < n; k += gridDim.x * NT) {
    const int o = list[k];
    const int y = o / Wp;
    const int x = o - y * Wp;
    float v[25];
    float nb = 0.f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const float b =
            bbt_max(crm2[(size_t)(y + P + dy - 2) * We + x + P + dx - 2],
                    inm(y + dy - 2, x + dx - 2));
        const float cv = clean(y + dy - 2, x + dx - 2);
        v[dy * 5 + dx] = __fadd_rn(cv, __fmul_rn(b, __fsub_rn(kBig, cv)));
        nb = __fadd_rn(nb, __fsub_rn(1.f, b));
      }
    }
#pragma unroll
    for (int pass = 0; pass < 25; ++pass) {
#pragma unroll
      for (int j = pass % 2; j < 24; j += 2) bbt_ce(v[j], v[j + 1]);
    }
    const float i_lo =
        floorf(__fmul_rn(clamp_lo(__fsub_rn(nb, 1.f), 0.f), 0.5f));
    const float i_hi = floorf(__fmul_rn(nb, 0.5f));
    float lo = 0.f;
    float hi = 0.f;
#pragma unroll
    for (int r = 0; r < 25; ++r) {
      const float rf = (float)r;
      const float wl =
          __fsub_rn(1.f, clamp_hi(fabsf(__fsub_rn(i_lo, rf)), 1.f));
      const float wh =
          __fsub_rn(1.f, clamp_hi(fabsf(__fsub_rn(i_hi, rf)), 1.f));
      lo = __fadd_rn(lo, __fmul_rn(wl, v[r]));
      hi = __fadd_rn(hi, __fmul_rn(wh, v[r]));
    }
    const float med = __fadd_rn(__fmul_rn(0.5f, lo), __fmul_rn(0.5f, hi));
    const float has = clamp_hi(nb, 1.f);
    const size_t e = (size_t)(y + P) * We + x + P;
    const float repl = __fadd_rn(__fmul_rn(has, med),
                                 __fmul_rn(__fsub_rn(1.f, has), m5[e]));
    const float c = clean(y, x);
    const float m = crm2[e];
    out_c[o] = __fadd_rn(c, __fmul_rn(m, __fsub_rn(repl, c)));
    out_m[o] = m;
  }
}

}  // namespace

extern "C" int bbt_lacosmic_iter(const void* clean, int Hs, int Ws,
                                 const void* inm, int H, int W,
                                 const void* crm, const void* rdn,
                                 void* out_c, void* out_m, void* scratch,
                                 void* counts, void* total, int Hp, int Wp,
                                 int P, float sigclip, float sig_lo,
                                 float objlim, void* stream) {
  if (P < 9 || Hs < 1 || Ws < 1 || H < 1 || W < 1 || H > Hp || W > Wp ||
      (Wp + 2 * P) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int He = Hp + 2 * P;
  const int We = Wp + 2 * P;
  const size_t plane = (size_t)He * We;
  float* m5 = (float*)scratch;
  float* s = m5 + plane;
  float* m3 = s + plane;
  float* sp = m3 + plane;
  float* c1 = sp + plane;
  float* crm2 = c1 + plane;
  int* list = (int*)s;      // the clean's list: s is dead after stage 2
  int* cnt = (int*)counts;  // pixels listed for med7, for the clean
  const Frame cl{(const float*)clean, Hs, Ws};
  const Mask im{(const unsigned char*)inm, H, W};
  const float* cr = (const float*)crm;
  const float* rd = (const float*)rdn;
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;

  dim3 tiles((We + BW - 1) / BW, (He + BH - 1) / BH);
  stage1<<<tiles, NT, 0, st>>>(cl, rd, m5, s, m3, P, He, We);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stage2<<<tiles, NT, 0, st>>>(s, m3, m5, im, rd, sp, c1, cnt, P, He, We,
                               sigclip, objlim);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 centre((Wp + TW - 1) / TW, (Hp + TH - 1) / TH);
  grow_scan<<<centre, NT, 0, st>>>(c1, sp, cl, im, cr, crm2,
                                   (float*)out_c, (float*)out_m, list,
                                   cnt + 1, (int*)total, Hp, Wp, P, He, We,
                                   sigclip, sig_lo);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  clean_listed<<<4 * sms, NT, 0, st>>>(cl, im, crm2, m5, (float*)out_c,
                                       (float*)out_m, list, cnt + 1, Wp, P,
                                       We);
  return (int)cudaGetLastError();
}
