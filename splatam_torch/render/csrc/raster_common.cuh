// Shared per-(pixel, instance) arithmetic of the forward and backward
// compositing kernels (raster_fwd.cu, raster_bwd.cu).
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
// gathered by gid from the (N, 16) attribute table.
__device__ __forceinline__ void stage_batch(float* s, int* s_gid,
                                            const float* __restrict__ attrs,
                                            const int* __restrict__ sorted_gid,
                                            int b, int n, int chunk) {
  for (int i = threadIdx.x; i < n * ROWS; i += NPIX) {
    const int j = i / ROWS, r = i % ROWS;
    const int g = sorted_gid[b + j];
    s[r * chunk + j] = attrs[(int64_t)g * ROWS + r];
    if (s_gid != nullptr && r == 0) s_gid[j] = g;
  }
}

}  // namespace splat
