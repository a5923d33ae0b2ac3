// Hole fill (K8) for Hopper: ops/morphology.fill_holes on the card.
//
// Replaces no TPU kernel.  The JAX package fills holes with XLA word
// ops on bit-packed planes (blackbox_tpu/ops/morphology.py,
// _fill_holes_packed): the complement O is flooded from the border by
// `iterations` rounds of four directional sweeps (down, up, right,
// left), each a log-doubling scan of ~14 shifted copies.  A sweep's
// result at a pixel is "a seed of R & O earlier on the line, with O
// true from it to the pixel": the carry recurrence
//     c <- O[p] & (R[p] | c)
// run once along the line, which is what this kernel runs, so every
// bit is the same.
//
// What bounds it on the H100: memory traffic.  One read of the
// (P, H, W) bool mask and one write of the result, 2 bytes a pixel:
// 0.067 ms at 10560^2 and 3.35 TB/s (one H100 80GB HBM3 at 700 W).
// Packed 32 pixels to a word, the complement O and the reach R take
// 13.9 MB each at 10560^2 (14.2 MB for the 16 x 5280 x 1320 channel
// stack), so both stay in the 50 MB L2 between the sweeps, and the
// sweeps' own traffic is L2 traffic.  The design is one persistent
// cooperative launch whose phases are separated by grid barriers
// (cooperative_groups' grid sync):
//   pack        a warp a row, 32 ballots of 32 bytes for 32 words;
//               writes O = ~m (the last word's slack bits 0) and
//               R = O & border.
//   vertical    lines are word columns, 32 pixel columns at once.  A
//               line is cut into S segments of L rows, S chosen so that
//               every resident thread has about one (line, segment).  A
//               segment acts on a carry as out = A | (B & in), A its
//               carry-out from 0 and B the AND of O over it, and that
//               composes: (1) each thread sums its segment, (2) a warp a
//               line scans the segments' (A, B) (a lane folds
//               ceil(S / 32) of them, then five shuffles), (3) each
//               thread rescans its segment from its carry-in.  The down
//               sweep's rescan and the up sweep's sums share a phase:
//               they cover the same rows.
//   horizontal  a warp a row, 32 words at a time.  Inside a word the
//               chain is the carry chain of the addition O + (R & O) +
//               cin (the carry out of bit i is O_i & (R_i | carry in));
//               across the lanes, the words' generate and propagate
//               bits (two ballots) give every lane its carry-in by one
//               more addition.  Right, then left on bit-reversed words;
//               the last round's left sweep writes the output bytes,
//               !R (R lies inside O, so m | (O & ~R) is ~R).
// Six barriers a round, one launch whatever the round count or shape.
// The planes are read and written through L2 (ld.cg / st.cg): other
// blocks wrote them in the same launch.  The mask is read and the
// result written with the streaming hints, so that neither pushes the
// planes out of L2.
// Measured on that card (CUDA events, chip_smoke.py): 0.319 ms a call at
// 16 x 5280 x 1320 and 0.323 ms at 10560^2 for one round, ~0.14 ms a
// further round; the plain version took 58.7 and 44.7 ms.
//
// Launcher contract: `in` and `out` are distinct (P, H, W) bool (one
// byte, 0 or 1) arrays on the device; `scratch` holds at least
// 4 * round_up(P * H * ceil(W / 32), 32) uint32 words; iterations >= 1.
// One operation on `stream`, the cooperative launch.  It allocates
// nothing, does not synchronise, and returns the first CUDA error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct Fill {
  const unsigned char* in;
  unsigned char* out;
  unsigned* O;        // complement, (P * H, nw) words
  unsigned* R;        // reach
  unsigned* TA;       // per (segment, line): carry-out, then carry-in
  unsigned* TB;       // per (segment, line): AND of O over the segment
  int P, H, W, nw, L, S, rounds;
};

__device__ void pack_row(const Fill& f, size_t row, int lane) {
  const int y = (int)(row % f.H);
  const unsigned edge = (y == 0 || y == f.H - 1) ? kFull : 0u;
  const int last = (f.W - 1) >> 5;
  const unsigned char* src = f.in + row * f.W;
  unsigned* O = f.O + row * f.nw;
  unsigned* R = f.R + row * f.nw;
  for (int w0 = 0; w0 < f.nw; w0 += 32) {
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int x = (w0 + k) * 32 + lane;
      const unsigned b = __ballot_sync(kFull, x < f.W && __ldcs(src + x));
      if (lane == k) mine = b;
    }
    const int w = w0 + lane;
    if (w < f.nw) {
      unsigned o = ~mine;
      if (w == last && (f.W & 31)) o &= (1u << (f.W & 31)) - 1u;
      unsigned border = edge;
      if (w == 0) border |= 1u;
      if (w == last) border |= 1u << ((f.W - 1) & 31);
      __stcg(O + w, o);
      __stcg(R + w, o & border);
    }
  }
}

// (line, segment) item i: line i % lines, segment i / lines; its first
// word and its rows [y0, y1)
struct Segment {
  size_t base;
  int y0, y1;
};

__device__ __forceinline__ Segment segment(const Fill& f, size_t i,
                                           size_t lines) {
  const size_t li = i % lines;
  const int s = (int)(i / lines);
  const size_t p = li / f.nw;
  Segment g;
  g.base = p * f.H * f.nw + li % f.nw;
  g.y0 = s * f.L;
  g.y1 = min(f.H, g.y0 + f.L);
  return g;
}

// (1) of the down sweep: the segment's carry-out from 0 and AND of O
__device__ void down_sums(const Fill& f, size_t i, size_t lines) {
  const Segment g = segment(f, i, lines);
  unsigned a = 0, b = kFull;
  for (int y = g.y0; y < g.y1; ++y) {
    const size_t at = g.base + (size_t)y * f.nw;
    const unsigned o = __ldcg(f.O + at);
    a = o & (__ldcg(f.R + at) | a);
    b &= o;
  }
  __stcg(f.TA + i, a);
  __stcg(f.TB + i, b);
}

// (2): a warp scans line li's segments in the sweep's order and leaves
// each segment's carry-in in TA
__device__ void scan_segments(const Fill& f, size_t li, size_t lines,
                              bool down, int lane) {
  const int K = (f.S + 31) / 32;
  const int j0 = min(f.S, lane * K), j1 = min(f.S, j0 + K);
  unsigned a = 0, b = kFull;
  for (int j = j0; j < j1; ++j) {
    const size_t at = (size_t)(down ? j : f.S - 1 - j) * lines + li;
    const unsigned bb = __ldcg(f.TB + at);
    a = __ldcg(f.TA + at) | (bb & a);
    b &= bb;
  }
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const unsigned a2 = __shfl_up_sync(kFull, a, off);
    const unsigned b2 = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      a |= b & a2;
      b &= b2;
    }
  }
  unsigned c = __shfl_up_sync(kFull, a, 1);
  if (lane == 0) c = 0;
  for (int j = j0; j < j1; ++j) {
    const size_t at = (size_t)(down ? j : f.S - 1 - j) * lines + li;
    const unsigned aa = __ldcg(f.TA + at);
    const unsigned bb = __ldcg(f.TB + at);
    __stcg(f.TA + at, c);
    c = aa | (bb & c);
  }
}

// (3) of the down sweep, then (1) of the up sweep on the same rows (B,
// the AND of O, is the same both ways)
__device__ void down_fill_up_sums(const Fill& f, size_t i, size_t lines) {
  const Segment g = segment(f, i, lines);
  unsigned c = __ldcg(f.TA + i);
  for (int y = g.y0; y < g.y1; ++y) {
    const size_t at = g.base + (size_t)y * f.nw;
    c = __ldcg(f.O + at) & (__ldcg(f.R + at) | c);
    __stcg(f.R + at, c);
  }
  unsigned a = 0;
  for (int y = g.y1 - 1; y >= g.y0; --y) {
    const size_t at = g.base + (size_t)y * f.nw;
    a = __ldcg(f.O + at) & (__ldcg(f.R + at) | a);
  }
  __stcg(f.TA + i, a);
}

// (3) of the up sweep
__device__ void up_fill(const Fill& f, size_t i, size_t lines) {
  const Segment g = segment(f, i, lines);
  unsigned c = __ldcg(f.TA + i);
  for (int y = g.y1 - 1; y >= g.y0; --y) {
    const size_t at = g.base + (size_t)y * f.nw;
    c = __ldcg(f.O + at) & (__ldcg(f.R + at) | c);
    __stcg(f.R + at, c);
  }
}

// One lane's word of a 32-word run of a row, carries toward the high
// bit and the high lane: the reach after the sweep.  `cin` is the run's
// carry-in, and becomes its carry-out (the same in every lane).
__device__ __forceinline__ unsigned carry_fill(unsigned o, unsigned r,
                                               unsigned& cin, int lane) {
  const unsigned s = o & r;
  const unsigned g = __ballot_sync(kFull, ((unsigned long long)o + s) >> 32);
  const unsigned p = __ballot_sync(kFull, o == kFull);
  const unsigned long long t = (unsigned long long)(p | g) + g + cin;
  const unsigned into = (unsigned)t ^ (p | g) ^ g;   // carry into each lane
  cin = (unsigned)(t >> 32);
  const unsigned c = (into >> lane) & 1u;
  return o & (s | ((o + s + c) ^ o ^ s));
}

__device__ void row_sweeps(const Fill& f, size_t row, bool last, int lane) {
  const unsigned* O = f.O + row * f.nw;
  unsigned* R = f.R + row * f.nw;
  unsigned cin = 0;
  for (int w0 = 0; w0 < f.nw; w0 += 32) {            // right
    const int w = w0 + lane;
    const bool ok = w < f.nw;
    const unsigned o = ok ? __ldcg(O + w) : 0u;
    const unsigned r = ok ? __ldcg(R + w) : 0u;
    const unsigned res = carry_fill(o, r, cin, lane);
    if (ok) __stcg(R + w, res);
  }
  __syncwarp();
  cin = 0;
  unsigned char* dst = f.out + row * f.W;
  for (int w0 = 0; w0 < f.nw; w0 += 32) {            // left
    const int w = f.nw - 1 - w0 - lane;
    const bool ok = w >= 0;
    const unsigned o = ok ? __brev(__ldcg(O + w)) : 0u;
    const unsigned r = ok ? __brev(__ldcg(R + w)) : 0u;
    const unsigned res = __brev(carry_fill(o, r, cin, lane));
    if (!last) {
      if (ok) __stcg(R + w, res);
      continue;
    }
    // the output bytes of these words, a word (32 bytes) a store
    for (int k = 0; k < 32 && f.nw - 1 - w0 - k >= 0; ++k) {
      const unsigned word = __shfl_sync(kFull, res, k);
      const int x = (f.nw - 1 - w0 - k) * 32 + lane;
      if (x < f.W)
        __stcs(dst + x, (unsigned char)(((word >> lane) & 1u) ^ 1u));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fill_holes_kernel(Fill f) {
  const size_t lines = (size_t)f.P * f.nw;
  const size_t rows = (size_t)f.P * f.H;
  const size_t items = lines * f.S;
  const size_t nthreads = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t nwarps = nthreads / 32, warp = tid / 32;
  const int lane = threadIdx.x & 31;
  cg::grid_group grid = cg::this_grid();

  for (size_t row = warp; row < rows; row += nwarps) pack_row(f, row, lane);
  for (int round = 0; round < f.rounds; ++round) {
    grid.sync();
    for (size_t i = tid; i < items; i += nthreads) down_sums(f, i, lines);
    grid.sync();
    for (size_t li = warp; li < lines; li += nwarps)
      scan_segments(f, li, lines, true, lane);
    grid.sync();
    for (size_t i = tid; i < items; i += nthreads)
      down_fill_up_sums(f, i, lines);
    grid.sync();
    for (size_t li = warp; li < lines; li += nwarps)
      scan_segments(f, li, lines, false, lane);
    grid.sync();
    for (size_t i = tid; i < items; i += nthreads) up_fill(f, i, lines);
    grid.sync();
    const bool last = round == f.rounds - 1;
    for (size_t row = warp; row < rows; row += nwarps)
      row_sweeps(f, row, last, lane);
  }
}

int resident_blocks[kMaxDevices];   // blocks that fit at once, per device

}  // namespace

extern "C" int bbt_fill_holes(const void* in, void* out, void* scratch,
                              int P, int H, int W, int iterations,
                              void* stream) {
  if (P < 1 || H < 1 || W < 1 || iterations < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident_blocks[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fill_holes_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident_blocks[dev] = per_sm * sms;
  }
  const size_t most = (size_t)resident_blocks[dev];

  Fill f;
  f.P = P;
  f.H = H;
  f.W = W;
  f.nw = (W + 31) / 32;
  f.rounds = iterations;
  const size_t lines = (size_t)P * f.nw;
  const size_t rows = (size_t)P * H;
  // about one (line, segment) item for each thread that fits
  size_t S = most * kThreads / lines;
  S = S < 1 ? 1 : (S > (size_t)H ? (size_t)H : S);
  f.L = (int)((H + S - 1) / S);
  f.S = (H + f.L - 1) / f.L;
  size_t want = lines * f.S;                 // threads the phases use
  if (32 * rows > want) want = 32 * rows;
  if (32 * lines > want) want = 32 * lines;
  size_t blocks = (want + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;

  const size_t plane = ((size_t)P * H * f.nw + 31) / 32 * 32;
  f.in = (const unsigned char*)in;
  f.out = (unsigned char*)out;
  f.O = (unsigned*)scratch;
  f.R = f.O + plane;
  f.TA = f.R + plane;
  f.TB = f.TA + plane;

  void* args[] = {&f};
  err = cudaLaunchCooperativeKernel((const void*)fill_holes_kernel,
                                    dim3((unsigned)blocks), dim3(kThreads),
                                    args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
