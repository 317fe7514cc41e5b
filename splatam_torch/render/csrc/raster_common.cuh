// Shared per-(pixel, instance) arithmetic of the forward and backward
// compositing kernels: aligned layout (raster_fwd.cu B1, raster_bwd.cu B2)
// and split layout (raster_split_fwd.cu B3a/B3b, raster_split_bwd.cu
// B3c/B3d); also of B2's stage-ablation probe (probe_ablate.cu P1).
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// ...), which the compiler never contracts into an FMA. So both kernels
// evaluate alpha and the transmittance recursion bit for bit alike (the
// backward replays the forward's pixel deaths exactly), and bit for bit like
// the plain PyTorch version in render/raster.py, which rounds after every
// tensor op. Only expf may differ from torch.exp in the last place.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace splat {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;  // one thread per pixel of a tile
constexpr int ROWS = 16;           // attribute rows per gaussian (pack_attrs)
constexpr int NFEAT = 8;           // feature rows
constexpr int ROW_X = 0, ROW_Y = 1, ROW_CA = 2, ROW_CB = 3, ROW_CC = 4;
constexpr int ROW_OP = 5, ROW_DEPTH = 6, ROW_FEAT0 = 8;
constexpr int MAX_CHUNK = 512;     // batch of staged instances (shared memory)

constexpr float ALPHA_CAP = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1e-4f;
constexpr float SAT_INF = 1e30f;

struct Pair {
  float dx, dy;   // mean minus pixel center
  float praw;     // power before the clamp at 0
  float epow;     // exp(min(praw, 0))
  float raw;      // opacity * epow
  float alpha;    // min(raw, ALPHA_CAP), zeroed below ALPHA_MIN
};

// s: a staged batch in shared memory, row r of instance j at s[r * chunk + j]
__device__ __forceinline__ Pair eval_pair(const float* s, int j, int chunk,
                                          float px, float py) {
  Pair q;
  const float a = s[ROW_CA * chunk + j];
  const float b = s[ROW_CB * chunk + j];
  const float c = s[ROW_CC * chunk + j];
  q.dx = __fsub_rn(s[ROW_X * chunk + j], px);
  q.dy = __fsub_rn(s[ROW_Y * chunk + j], py);
  // power = -0.5 * (a dx dx + c dy dy) - b dx dy, in this association
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, q.dx), q.dx),
                               __fmul_rn(__fmul_rn(c, q.dy), q.dy));
  q.praw = __fsub_rn(__fmul_rn(-0.5f, quad),
                     __fmul_rn(__fmul_rn(b, q.dx), q.dy));
  q.epow = expf(fminf(q.praw, 0.0f));
  q.raw = __fmul_rn(s[ROW_OP * chunk + j], q.epow);
  const float al = fminf(ALPHA_CAP, q.raw);
  q.alpha = al < ALPHA_MIN ? 0.0f : al;
  return q;
}

// Stage instances [b, b + n) of the sorted stream: all 16 rows of each,
// gathered by gid from the (N, 16) attribute table, by every thread of the
// block.
__device__ __forceinline__ void stage_batch(float* s, int* s_gid,
                                            const float* __restrict__ attrs,
                                            const int* __restrict__ sorted_gid,
                                            int b, int n, int chunk) {
  for (int i = threadIdx.x; i < n * ROWS; i += blockDim.x) {
    const int j = i / ROWS, r = i % ROWS;
    const int g = sorted_gid[b + j];
    s[r * chunk + j] = attrs[(int64_t)g * ROWS + r];
    if (s_gid != nullptr && r == 0) s_gid[j] = g;
  }
}

// Composite staged instances [j0, j1) into one pixel, front to back: a
// pixel dies where T (1 - alpha) < T_STOP and that instance adds nothing;
// the median depth is the depth where T crosses 0.5.
__device__ __forceinline__ void fwd_range(const float* s, int j0, int j1,
                                          int chunk, float px, float py,
                                          int carry_depth, float& T,
                                          bool& dead, float* acc,
                                          float& dsum) {
  if (dead) return;
  for (int j = j0; j < j1; ++j) {
    const Pair q = eval_pair(s, j, chunk, px, py);
    if (q.alpha == 0.0f) continue;  // T and the sums stay as they are
    const float test = __fmul_rn(T, __fsub_rn(1.0f, q.alpha));
    if (test < T_STOP) {
      dead = true;
      return;
    }
    const float w = __fmul_rn(q.alpha, T);
#pragma unroll
    for (int f = 0; f < NFEAT; ++f)
      acc[f] = __fadd_rn(acc[f], __fmul_rn(w, s[(ROW_FEAT0 + f) * chunk + j]));
    if (carry_depth && T > 0.5f && test < 0.5f)
      dsum = __fadd_rn(dsum, s[ROW_DEPTH * chunk + j]);
    T = test;
  }
}

// Largest depth among staged instances [j0, j1) (the saturation depth when
// the tile's last pixel died in them).
__device__ __forceinline__ float max_depth(const float* s, int j0, int j1,
                                           int chunk) {
  float m = -CUDART_INF_F;
  for (int j = j0; j < j1; ++j) m = fmaxf(m, s[ROW_DEPTH * chunk + j]);
  return m;
}

// Write one pixel's forward outputs into channel-major (8, NPIX) blocks at
// `base` (= block * 8 * NPIX + pixel): the blended features, and aux rows
// 0 median-depth sum, 1 final T, 2 saturation depth, 3-7 zero.
__device__ __forceinline__ void write_fwd(float* color, float* aux,
                                          int64_t base, const float* acc,
                                          float dsum, float T, float sat) {
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) color[base + f * NPIX] = acc[f];
  aux[base] = dsum;
  aux[base + NPIX] = T;
  aux[base + 2 * NPIX] = sat;
#pragma unroll
  for (int r = 3; r < 8; ++r) aux[base + r * NPIX] = 0.0f;
}

// Per-pixel constants of the backward for one tile's pixel at `base`:
// dL/dcolor, ga (final-T term plus sum of color * dL/dcolor) and
// dL/d median depth, from the tile's final outputs.
__device__ __forceinline__ void grad_inputs(const float* color,
                                           const float* aux,
                                           const float* g_color,
                                           const float* g_aux, int64_t base,
                                           float* gcol, float& ga,
                                           float& gdep) {
  ga = __fmul_rn(g_aux[base + NPIX], aux[base + NPIX]);
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) {
    gcol[f] = g_color[base + f * NPIX];
    ga = __fadd_rn(ga, __fmul_rn(color[base + f * NPIX], gcol[f]));
  }
  gdep = g_aux[base];
}

// The analytic backward of one (pixel, staged instance j) pair up to
// dpower, replaying the forward's recursion (advances dead and the running
// prefix accw of w * gc; the caller advances T to `test`):
//   S      = ga - prefix(w gc)
//   dalpha = T_before gc - S / (1 - alpha)
//   dpower = dalpha alpha, only where alpha is neither capped nor floored
//            and the power was not clamped
//   d/dopacity = dalpha exp(power).
// Returns whether the pair contributes; false where the pixel is dead,
// alpha is zero, or the pixel dies at this instance.
struct PairGrad {
  Pair q;
  float test;    // T after the pair
  float w;       // alpha T
  float dop;     // d/dopacity
  float dpower;  // d/dpower
};

__device__ __forceinline__ bool pair_dpower(const float* s, int j, int chunk,
                                            float px, float py,
                                            const float* gcol, float ga,
                                            float T, bool& dead, float& accw,
                                            PairGrad& g) {
  if (dead) return false;
  g.q = eval_pair(s, j, chunk, px, py);
  if (!(g.q.alpha > 0.0f)) return false;
  g.test = __fmul_rn(T, __fsub_rn(1.0f, g.q.alpha));
  if (g.test < T_STOP) {
    dead = true;
    return false;
  }
  float gc = 0.0f;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f)
    gc = __fadd_rn(gc, __fmul_rn(gcol[f], s[(ROW_FEAT0 + f) * chunk + j]));
  g.w = __fmul_rn(g.q.alpha, T);
  accw = __fadd_rn(accw, __fmul_rn(g.w, gc));
  const float suffix = __fsub_rn(ga, accw);
  const float dalpha = __fsub_rn(
      __fmul_rn(T, gc), __fdiv_rn(suffix, __fsub_rn(1.0f, g.q.alpha)));
  g.dop = g.q.raw < ALPHA_CAP ? __fmul_rn(dalpha, g.q.epow) : 0.0f;
  g.dpower =
      g.q.praw <= 0.0f ? __fmul_rn(g.dop, s[ROW_OP * chunk + j]) : 0.0f;
  return true;
}

// The whole analytic backward of one pair: pair_dpower, then d/ddepth at
// the median crossing, d/dx, d/dy, d/dconic from dpower, and the features'
// w dL/dcolor. Fills v (gradient rows of the instance from this pixel, zero
// where the pair adds nothing), advances T, and returns whether the pair
// contributed.
__device__ __forceinline__ bool bwd_pair(const float* s, int j, int chunk,
                                         float px, float py,
                                         const float* gcol, float ga,
                                         float gdep, int nfeat,
                                         int carry_depth, float& T,
                                         bool& dead, float& accw, float* v) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) v[r] = 0.0f;
  PairGrad g;
  if (!pair_dpower(s, j, chunk, px, py, gcol, ga, T, dead, accw, g))
    return false;
  const Pair& q = g.q;
  const float a = s[ROW_CA * chunk + j];
  const float bb = s[ROW_CB * chunk + j];
  const float c = s[ROW_CC * chunk + j];
  v[ROW_X] = -__fmul_rn(g.dpower, __fadd_rn(__fmul_rn(a, q.dx),
                                            __fmul_rn(bb, q.dy)));
  v[ROW_Y] = -__fmul_rn(g.dpower, __fadd_rn(__fmul_rn(c, q.dy),
                                            __fmul_rn(bb, q.dx)));
  v[ROW_CA] = __fmul_rn(g.dpower, __fmul_rn(-0.5f, __fmul_rn(q.dx, q.dx)));
  v[ROW_CB] = -__fmul_rn(g.dpower, __fmul_rn(q.dx, q.dy));
  v[ROW_CC] = __fmul_rn(g.dpower, __fmul_rn(-0.5f, __fmul_rn(q.dy, q.dy)));
  v[ROW_OP] = g.dop;
  if (carry_depth && T > 0.5f && g.test < 0.5f) v[ROW_DEPTH] = gdep;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f)
    if (f < nfeat) v[ROW_FEAT0 + f] = __fmul_rn(g.w, gcol[f]);
  T = g.test;
  return true;
}

// Sum one instance's gradient rows over the warp with shuffles and add
// them to its gaussian's row of the (N, 16) table. Every lane of the warp
// must call it for the same instance.
__device__ __forceinline__ void warp_add_rows(float* v, bool contrib,
                                              int gid, float* grad) {
  if (!__any_sync(0xffffffffu, contrib)) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[r] += __shfl_down_sync(0xffffffffu, v[r], off);
  }
  if ((threadIdx.x & 31) == 0) {
    float* out = grad + (int64_t)gid * ROWS;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (v[r] != 0.0f) atomicAdd(out + r, v[r]);
  }
}

}  // namespace splat
