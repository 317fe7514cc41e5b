// Shared per-(pixel, instance) arithmetic of the forward and backward
// compositing kernels: aligned layout (raster_fwd.cu B1, raster_bwd.cu B2)
// and split layout (raster_split_fwd.cu B3a/B3b, raster_split_bwd.cu
// B3c/B3d); also of the Fisher kernel (raster_fisher.cu B4) and the stage
// probes of B2 (probe_ablate.cu P1) and B1 (probe_fwd.cu).
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// ...), which the compiler never contracts into an FMA. So both kernels
// evaluate alpha and the transmittance recursion bit for bit alike (the
// backward replays the forward's pixel deaths exactly), and bit for bit like
// the plain PyTorch version in render/raster.py, which rounds after every
// tensor op. Only expf may differ from torch.exp in the last place. The
// sums of the blend and of the backward's pixel sums are taken in other
// orders (the forward's fused multiply-adds, the tensor cores' products)
// and differ from the plain version's in the last bits; no sum feeds back
// into alpha, T or a pixel's death.
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
constexpr int ROW_OP = 5, ROW_DEPTH = 6, ROW_GID = 7, ROW_FEAT0 = 8;
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
// them to its gaussian's row of the (N, 16) table (B4). Every lane of the
// warp must call it for the same instance.
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

// ---------------------------------------------------------------------------
// The backward of B2 (raster_bwd.cu), B3c and B3d (raster_split_bwd.cu):
// the pixel sums of each instance's gradient rows on the tensor cores, in
// the TPU kernel's moment form (`_bwd_chunk_body`, pallas_raster.py:903-952),
// and a block-level reduction of them. B4 keeps bwd_pair and warp_add_rows
// above.
//
// Every pixel's thread walks the staged batch in order (pair_dpower: the
// transmittance replay is sequential per pixel) and writes, for each
// instance of a warp sub-batch of SUB = 16, two values into its warp's
// shared buffers: d/dopacity where the power was not clamped (there
// dpower is the instance's opacity times it) and w. The warp then takes
// the sums over its 32 pixels with mma.sync m16n8k8 TF32 products,
// instances as M and pixels as K: the six moments sum_p phi_b(p) dop[p, j]
// against the basis phi = (1, x, y, x^2, xy, y^2) in tile-centred
// coordinates (|x|, |y| <= 7.5) -- moment 0 is d/dopacity's sum, and the
// opacity scales all six into dpower's at the flush -- and the eight
// feature sums sum_p gcol_f(p) w[p, j]. The block-level reduction: each
// warp stores its C fragments in a slot, and after a __syncthreads()
// thread (i, c) sums column c of instance i over the 8 slots. d/dopacity
// where the power was clamped (never, for a positive-definite conic) and
// the median-crossing depth term (at most once per pixel and tile) are
// added apart by the pixel concerned. The same threads then flush the
// sub-batch into the (N, 16) table with one global atomicAdd per non-zero
// (instance, row), the five geometry rows recombined once per instance
// from the moments, the mean's offset (xl, yl) from the tile centre and
// the conic: sum_p dpower dx = xl s0 - sx, ..., conic a's row
// -1/2 (xl^2 s0 - 2 xl sx + sxx). A pair costs two shared stores instead
// of 16 rows and 80 shuffles; an instance costs one global atomic per row
// and block instead of one per row and warp; no shuffle or shared atomic
// runs per instance (sm_90 has no native shared f32 atomicAdd: it is a
// compare-and-swap loop, and 8 warps adding into one sub-batch collide).
// Instances past a saturated tile's exit add nothing: the loop exits only
// after a whole batch.
//
// Precision. TF32 keeps 11 significant bits, and the product of two TF32
// values is exact in the f32 accumulator. The basis values (multiples of
// 0.25 up to 56.25) are exact in TF32. d/dopacity is split hi + lo (two
// passes), w and gcol both (three passes: lo hi, hi lo, hi hi; 3xTF32),
// so each product keeps ~20 significant bits, as an f32 sum keeps 24.
// The recombination scales a moment's error by up to xl^2 for a mean far
// off its tile, which is also the scale of that
// instance's conic rows, so the rows keep about the moments' relative
// precision, ~2^-20 of their terms' sizes, against GRAD_TOL = 5e-5 of the
// table's largest gradient (chip_smoke.py holds both kernels to it on its
// far_contention scene, means 100-600 px off their tiles). A single TF32
// pass (each product rounded to ~2^-11, 5e-4) would not hold it.
// ---------------------------------------------------------------------------

constexpr int NWARP = NPIX / 32;
// blocks per SM a B2/B3c/B3d launch keeps room for (registers capped at 80 a
// thread; shared memory allows 3 up to chunk 256)
constexpr int BWD_BLOCKS = 3;
constexpr int SUB = 16;             // instances per warp sub-batch: mma's M
constexpr int WBUF = 2 * SUB * 32;  // floats per warp: dop, then w
// columns of a warp's C fragments (its slot): 0-5 the six moments, 8-15
// the feature sums; the block's sums add in 6 d/dopacity where the power
// was clamped and 7 the median-depth term, each added apart
constexpr int COL_OP = 6, COL_DEPTH = 7, COL_FEAT0 = 8;

// Layout of a B2/B3c/B3d block's dynamic shared memory, in floats: the
// staged rows, the gids, the batch's two sums added apart (columns 6 and 7:
// one row each), then (16-byte aligned, for the fragments' 8-byte loads)
// the warps' sub-batch buffers.
__host__ __device__ inline int bwd_wbuf_offset(int chunk) {
  return (ROWS * chunk + 3 * chunk + 3) & ~3;
}

inline size_t bwd_smem_bytes(int chunk) {
  return (size_t)(bwd_wbuf_offset(chunk) + NWARP * WBUF) * sizeof(float);
}

// The batch's sums added apart, (2, chunk): d/dopacity where the power was
// clamped, then the median-depth term.
__device__ __forceinline__ float* bwd_apart(float* s, int chunk) {
  return s + ROWS * chunk + chunk;  // past the staged rows and the gids
}

// Warp 0's buffers; warp w's start WBUF floats further: (SUB, 32) dop
// where the power was not clamped, then w; the first doubles as the
// warp's slot.
__device__ __forceinline__ float* bwd_wbuf(float* s, int chunk) {
  return s + bwd_wbuf_offset(chunk);
}

__device__ __forceinline__ void zero_apart(float* apart, int chunk) {
  for (int j = threadIdx.x; j < 2 * chunk; j += blockDim.x) apart[j] = 0.0f;
}

// Allow a kernel the dynamic shared memory of a launch (past the 48 KB
// default only after this opt-in). Returns a cudaError_t as int.
inline int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The column of lane l's pixel in a buffer row. Pixel lane l is k-index
// kk = l % 8 of k-step l / 8 and sits at 8 (l / 8) + 2 (kk % 4) + kk / 4, so
// that an A fragment's (col t, col t + 4) pair is one 8-byte load; row jj
// is swizzled by xor 8 (jj % 4), so that the eight rows of a fragment
// load fall in distinct banks.
__device__ __forceinline__ int wbuf_col(int lane) {
  return (lane & ~7) | ((lane & 3) << 1) | ((lane >> 2) & 1);
}

// Write this pixel's gated d/dopacity and w of sub-batch instance jj.
__device__ __forceinline__ void wbuf_put(float* buf, int jj, int col,
                                         float dop, float w) {
  const int i = jj * 32 + (col ^ ((jj & 3) << 3));
  buf[i] = dop;
  buf[SUB * 32 + i] = w;
}

// x = hi + lo: hi is x cut to TF32 (its low 13 mantissa bits cleared) and
// lo = x - hi is exact in f32; the mma reads lo's TF32 bits, so the pair
// carries x to within 2^-20 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: mma.sync m16n8k8, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of k-step k of a (SUB, 32) buffer, split hi + lo:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void load_a(const float* x, int k, uint32_t* hi,
                                       uint32_t* lo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = x + ((8 * k + 2 * t) ^ ((g & 3) << 3));
  const float2 r0 = *reinterpret_cast<const float2*>(p + g * 32);
  const float2 r1 = *reinterpret_cast<const float2*>(p + (g + 8) * 32);
  split_tf32(r0.x, hi[0], lo[0]);
  split_tf32(r1.x, hi[1], lo[1]);
  split_tf32(r0.y, hi[2], lo[2]);
  split_tf32(r1.y, hi[3], lo[3]);
}

// A warp's B fragments, constant over a tile. For k-step k and half h
// (k-index t + 4h, t = lane % 4, g = lane / 4): the basis value phi_g of
// pixel lane 8k + t + 4h (zero for g >= 6), and its dL/dcolor_g split
// hi + lo (zero for g >= nfeat).
struct MomentB {
  uint32_t phi[4][2], gh[4][2], gl[4][2];
};

// Every lane of the warp must call it: it shuffles gcol across the warp.
__device__ __forceinline__ void moment_operands(const float* gcol, int nfeat,
                                                MomentB& m) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 2;  // tile row of the warp's pixel 0
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = 8 * k + t + 4 * h;
      const float x = (float)(l & 15) - 7.5f;
      const float y = (float)(row0 + (l >> 4)) - 7.5f;
      const float phi = g == 0 ? 1.0f : g == 1 ? x : g == 2 ? y
                      : g == 3 ? x * x : g == 4 ? x * y : g == 5 ? y * y
                      : 0.0f;
      m.phi[k][h] = __float_as_uint(phi);
      float gv = 0.0f;
#pragma unroll
      for (int f = 0; f < NFEAT; ++f) {
        const float v = __shfl_sync(0xffffffffu, gcol[f], l);
        if (f == g && f < nfeat) gv = v;
      }
      split_tf32(gv, m.gh[k][h], m.gl[k][h]);
    }
  }
}

// The warp's sums over its 32 pixels of the sub-batch in its buffers: the
// C fragments of the moments of the gated d/dopacity (cm: columns 0-5;
// 6, 7 zero) and of the feature sums (cf), rows the sub-batch's
// instances. Entry i of a C fragment is (row g + 8 (i / 2), column
// 2t + i % 2). The lo passes run in their own accumulators (shorter
// dependency chains).
__device__ __forceinline__ void warp_sums(const float* buf, const MomentB& m,
                                          float* cm, float* cf) {
  float cm2[4], cf2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cm[i] = cf[i] = cm2[i] = cf2[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t ah[4], al[4];
    load_a(buf, k, ah, al);  // d/dopacity, gated
    mma_tf32(cm2, al, m.phi[k]);
    mma_tf32(cm, ah, m.phi[k]);
    load_a(buf + SUB * 32, k, ah, al);  // w
    mma_tf32(cf2, al, m.gh[k]);
    mma_tf32(cf2, ah, m.gl[k]);
    mma_tf32(cf, ah, m.gh[k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cm[i] += cm2[i];
    cf[i] += cf2[i];
  }
}

// Store a warp's C fragments (zero for a warp to which no pixel
// contributed) in its slot, the first SUB * 16 floats of its buffers:
// (SUB, 16), columns 0-7 cm and 8-15 cf, row i swizzled by xor 8
// ((i / 2) % 2) so that a half-warp's 8-byte stores fall in distinct banks.
// Call once the warp's fragment loads are done (__syncwarp()).
__device__ __forceinline__ void part_put(float* slot, const float* cm,
                                         const float* cf) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sw = ((g >> 1) & 1) << 3;  // the same for rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = slot + (g + 8 * h) * 16;
    *reinterpret_cast<float2*>(row + ((2 * t) ^ sw)) =
        make_float2(cm[2 * h], cm[2 * h + 1]);
    *reinterpret_cast<float2*>(row + ((COL_FEAT0 + 2 * t) ^ sw)) =
        make_float2(cf[2 * h], cf[2 * h + 1]);
  }
}

// The block-level reduction of a sub-batch starting at instance jb of n:
// thread (i, c) = (tid / 16, tid % 16) returns column c of instance jb + i
// summed over the warps' slots (`wbuf`: warp 0's buffers), or for columns
// 6 and 7 the batch's sums added apart. Call after a __syncthreads() that
// follows every warp's part_put.
__device__ __forceinline__ float part_column(const float* wbuf,
                                             const float* apart, int jb,
                                             int n, int chunk) {
  const int i = threadIdx.x >> 4, c = threadIdx.x & 15;
  if (jb + i >= n) return 0.0f;
  if (c == COL_OP || c == COL_DEPTH)
    return apart[(c - COL_OP) * chunk + jb + i];
  const float* p = wbuf + i * 16 + (c ^ (((i >> 1) & 1) << 3));
  float v = 0.0f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) v += p[w * WBUF];
  return v;
}

// Flush a sub-batch's column sums (v from part_column) into the (N, 16)
// table: thread (i, r) adds row r of instance jb + i with one global
// atomicAdd if it is not zero, consecutive threads on one instance's 16
// contiguous rows. The five geometry rows are recombined from the moments
// (gathered from the instance's 16 lanes), the mean's offset (xl, yl) from
// the tile centre (cx, cy) and the conic; rows the setting makes zero are
// skipped (the gid row, features past nfeat, the median depth without
// carry_depth). Every lane of the warp must call it.
__device__ __forceinline__ void flush_rows(float v, const float* s,
                                           const int* s_gid, int jb, int n,
                                           int chunk, float cx, float cy,
                                           int nfeat, int carry_depth,
                                           float* grad) {
  const int i = threadIdx.x >> 4, r = threadIdx.x & 15;
  const int lb = threadIdx.x & 16;  // the instance's first lane
  float mo[6];
#pragma unroll
  for (int b = 0; b < 6; ++b) mo[b] = __shfl_sync(0xffffffffu, v, lb + b);
  const float op_apart = __shfl_sync(0xffffffffu, v, lb + COL_OP);
  const float dsum = __shfl_sync(0xffffffffu, v, lb + COL_DEPTH);
  const int j = jb + i;
  if (j >= n || r == ROW_GID || r >= ROW_FEAT0 + nfeat ||
      (r == ROW_DEPTH && !carry_depth))
    return;
  float out;
  if (r == ROW_OP) {  // moment 0 is the gated d/dopacity's sum
    out = mo[0] + op_apart;
  } else if (r == ROW_DEPTH) {
    out = dsum;
  } else if (r >= ROW_FEAT0) {
    out = v;  // column r: the feature sum
  } else {  // dpower = opacity x the gated d/dopacity
    const float op = s[ROW_OP * chunk + j];
#pragma unroll
    for (int b = 0; b < 6; ++b) mo[b] *= op;
    const float xl = s[ROW_X * chunk + j] - cx;
    const float yl = s[ROW_Y * chunk + j] - cy;
    // the tile's sums of dpower dx and dpower dy (dx = xl - x)
    const float sdx = xl * mo[0] - mo[1], sdy = yl * mo[0] - mo[2];
    if (r == ROW_X) {
      out = -(s[ROW_CA * chunk + j] * sdx + s[ROW_CB * chunk + j] * sdy);
    } else if (r == ROW_Y) {
      out = -(s[ROW_CC * chunk + j] * sdy + s[ROW_CB * chunk + j] * sdx);
    } else if (r == ROW_CA) {  // sum dpower dx^2 = xl sdx - xl sx + sxx
      out = -0.5f * (xl * sdx - (xl * mo[1] - mo[3]));
    } else if (r == ROW_CB) {  // sum dpower dx dy = xl sdy - yl sx + sxy
      out = -(xl * sdy - (yl * mo[1] - mo[4]));
    } else {  // ROW_CC: sum dpower dy^2 = yl sdy - yl sy + syy
      out = -0.5f * (yl * sdy - (yl * mo[2] - mo[5]));
    }
  }
  if (out != 0.0f) atomicAdd(grad + (int64_t)s_gid[j] * ROWS + r, out);
}

// One warp sub-batch of the pass: this pixel's pair_dpower for instances
// [jb, jb + SUB) of the staged batch (of n), in order. Into the warp's
// buffers go d/dopacity where the power was not clamped (there dpower is
// the opacity times it, so the flush scales its moments; zero elsewhere)
// and w, both zero where the pair adds nothing or past n; into `apart`
// d/dopacity where the power was clamped (none for a positive-definite
// conic) and the median-crossing depth term. Advances T, dead and accw;
// returns whether any pair contributed.
__device__ __forceinline__ bool sub_pairs(const float* s, int jb, int n,
                                          int chunk, float px, float py,
                                          const float* gcol, float ga,
                                          float gdep, int carry_depth,
                                          float* buf, float* apart, float& T,
                                          bool& dead, float& accw) {
  const int col = wbuf_col(threadIdx.x & 31);
  bool any = false;
#pragma unroll 4  // the buffers' row swizzle repeats every 4 rows
  for (int jj = 0; jj < SUB; ++jj) {
    const int j = jb + jj;
    float dop = 0.0f, w = 0.0f;
    PairGrad pg;
    if (j < n &&
        pair_dpower(s, j, chunk, px, py, gcol, ga, T, dead, accw, pg)) {
      if (pg.q.praw <= 0.0f)
        dop = pg.dop;
      else if (pg.dop != 0.0f)
        atomicAdd(apart + j, pg.dop);
      w = pg.w;
      if (carry_depth && T > 0.5f && pg.test < 0.5f)
        atomicAdd(apart + chunk + j, gdep);
      T = pg.test;
      any = true;
    }
    wbuf_put(buf, jj, col, dop, w);
  }
  return any;
}

// One staged batch of n instances through the backward, flushed into the
// (N, 16) table sub-batch by sub-batch. Call once the batch is staged, its
// sums apart zeroed and the block synchronised; every thread of the block
// must call it (it synchronises the block twice per sub-batch). Advances
// T, dead and accw.
__device__ __forceinline__ void bwd_batch(const float* s, const int* s_gid,
                                          int n, int chunk, float px,
                                          float py, float cx, float cy,
                                          const float* gcol, float ga,
                                          float gdep, int nfeat,
                                          int carry_depth, const MomentB& m,
                                          float* wbuf, float* apart,
                                          float& T, bool& dead, float& accw,
                                          float* grad) {
  float* buf = wbuf + (threadIdx.x >> 5) * WBUF;
  for (int jb = 0; jb < n; jb += SUB) {  // block-uniform
    const bool any = sub_pairs(s, jb, n, chunk, px, py, gcol, ga, gdep,
                               carry_depth, buf, apart, T, dead, accw);
    __syncwarp();
    float cm[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (__any_sync(0xffffffffu, any)) warp_sums(buf, m, cm, cf);
    __syncwarp();
    part_put(buf, cm, cf);
    __syncthreads();
    flush_rows(part_column(wbuf, apart, jb, n, chunk), s, s_gid, jb, n,
               chunk, cx, cy, nfeat, carry_depth, grad);
    __syncthreads();  // the next sub-batch overwrites the buffers
  }
}

// ---------------------------------------------------------------------------
// The forward of B1 (raster_fwd.cu), B3a and B3b (raster_split_fwd.cu) per
// warp sub-batch of FWD_SUB staged instances.
//
// A batch is staged in the forward's own layout (fwd_stage): the seven alpha
// and depth rows at r * stride + j, as eval_pair reads them (stride: chunk
// rounded up to FWD_SUB, the slots past n zero, so that a padded slot's
// alpha is 0), then the eight features of instance j at
// fwd_feats(s, stride) + 8 j.
// ---------------------------------------------------------------------------

// x, y, the conic's a b c, opacity, depth
constexpr int FWD_GEOM_ROWS = ROW_DEPTH + 1;
// B1's sub-batch (no mma reads it, so it is not bound to SUB); a multiple
// of 4, so that the staged features stay 16-byte aligned
constexpr int FWD_SUB = 8;

__host__ __device__ inline int fwd_stride(int chunk) {
  return (chunk + FWD_SUB - 1) / FWD_SUB * FWD_SUB;
}

template <typename F>
__device__ __forceinline__ F* fwd_feats(F* s, int stride) {
  return s + FWD_GEOM_ROWS * stride;
}

// Stage instances [b, b + n) of the sorted stream in the forward's layout,
// gathered by gid with one 16-byte load per (instance, quarter row), by
// every thread of the block; slots [n, stride) get zeros. The (N, 16)
// table's rows are 64 bytes, so a quarter is 16-byte aligned where the
// table is.
__device__ __forceinline__ void fwd_stage(float* s,
                                          const float* __restrict__ attrs,
                                          const int* __restrict__ sorted_gid,
                                          int b, int n, int stride) {
  float* feat = fwd_feats(s, stride);
  const int npad = (n + FWD_SUB - 1) / FWD_SUB * FWD_SUB;
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) {
    const int j = i >> 2, q = i & 3;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < n)
      v = reinterpret_cast<const float4*>(
          attrs + (int64_t)sorted_gid[b + j] * ROWS)[q];
    if (q == 0) {
      s[ROW_X * stride + j] = v.x;
      s[ROW_Y * stride + j] = v.y;
      s[ROW_CA * stride + j] = v.z;
      s[ROW_CB * stride + j] = v.w;
    } else if (q == 1) {
      s[ROW_CC * stride + j] = v.x;
      s[ROW_OP * stride + j] = v.y;
      s[ROW_DEPTH * stride + j] = v.z;  // v.w: the gid row, not needed
    } else {
      reinterpret_cast<float4*>(feat + 8 * j)[q - 2] = v;
    }
  }
}

// (a) The alphas of instances [jb, jb + FWD_SUB) for this pixel. They do not
// depend on T, so the FWD_SUB eval_pair chains issue side by side.
__device__ __forceinline__ void sub_alphas(const float* s, int jb, int stride,
                                           float px, float py, float* al) {
#pragma unroll
  for (int jj = 0; jj < FWD_SUB; ++jj)
    al[jj] = eval_pair(s, jb + jj, stride, px, py).alpha;
}

// (b) The transmittance recursion over the sub-batch, in order and in
// rounded arithmetic (the backward's pair_dpower replays it bit for bit): a
// pixel dies where T (1 - alpha) < T_STOP and that instance adds nothing;
// the median depth is the depth where T crosses 0.5. Turns al[jj] into
// w = alpha T, zero where the pair adds nothing (alpha 0, the pixel dead,
// or dying at this instance). Advances T, dead and the median-depth sum.
__device__ __forceinline__ void sub_scan(const float* s, int jb, int stride,
                                         int carry_depth, float* al,
                                         float& T, bool& dead, float& dsum) {
#pragma unroll
  for (int jj = 0; jj < FWD_SUB; ++jj) {
    const float a = al[jj];
    float w = 0.0f;
    if (!dead && a != 0.0f) {
      const float test = __fmul_rn(T, __fsub_rn(1.0f, a));
      if (test < T_STOP) {
        dead = true;
      } else {
        w = __fmul_rn(a, T);
        if (carry_depth && T > 0.5f && test < 0.5f)
          dsum = __fadd_rn(dsum, s[ROW_DEPTH * stride + jb + jj]);
        T = test;
      }
    }
    al[jj] = w;
  }
}

// (c) The blend of the sub-batch into this pixel's 8 channels, in order,
// one fused multiply-add per channel, for each instance where any lane of
// the warp has a non-zero w (every lane must call it; a zero w adds
// nothing). The fused add rounds once where the plain version rounds the
// product and the sum apart: the color differs from it in the last bits,
// far inside FWD_ATOL / FWD_RTOL; T, the median depth and the saturation
// depth do not touch the blend and stay bit for bit.
__device__ __forceinline__ void sub_blend(const float* s, int jb, int stride,
                                          const float* w, float* acc) {
  const float* feat = fwd_feats(s, stride) + 8 * jb;
#pragma unroll
  for (int jj = 0; jj < FWD_SUB; ++jj) {
    if (!__any_sync(0xffffffffu, w[jj] != 0.0f)) continue;
    const float4 f0 = reinterpret_cast<const float4*>(feat + 8 * jj)[0];
    const float4 f1 = reinterpret_cast<const float4*>(feat + 8 * jj)[1];
    const float fv[NFEAT] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
    for (int f = 0; f < NFEAT; ++f) acc[f] = fmaf(w[jj], fv[f], acc[f]);
  }
}

// (a)-(c) over the staged slots [0, n) for one pixel (the slots from n to
// the next multiple of FWD_SUB zero), front to back; a warp whose pixels
// are all dead skips the rest. DEPTH: whether the median-depth sum is
// taken, a template argument so that the loop without it keeps no register
// for it.
template <bool DEPTH>
__device__ __forceinline__ void fwd_sub_batches(const float* s, int n,
                                                int stride, float px,
                                                float py, float& T,
                                                bool& dead, float* acc,
                                                float& dsum) {
  for (int jb = 0; jb < n; jb += FWD_SUB) {  // warp-uniform
    if (__all_sync(0xffffffffu, dead)) break;
    float w[FWD_SUB];
    sub_alphas(s, jb, stride, px, py, w);
    sub_scan(s, jb, stride, DEPTH, w, T, dead, dsum);
    sub_blend(s, jb, stride, w, acc);
  }
}

// The split layout's per-tile forward carry, channel-major (T, 3, NPIX):
// row 0 T, negated where the pixel is dead; row 1 the median-depth sum so
// far; row 2 the saturation candidate, the largest depth of the last batch
// the interior composited (0 where the tile has no interior).
constexpr int CARRY_ROWS = 3;

// The body of B1 (CARRY false) and B3a (CARRY true): one block per tile and
// one thread per pixel walk the tile's range [ranges[2 t], ranges[2 t + 1])
// front to back, in batches of `chunk` staged in shared memory s
// (fwd_smem_bytes(chunk)) and composited per warp sub-batch. After each
// batch the block counts its live pixels and the tile stops when none is
// left; its saturation depth is then that batch's largest depth. Writes
// color and aux (write_fwd); with CARRY also the carry, whose candidate is
// the largest depth of the last batch composited, saturated or not.
template <bool DEPTH, bool CARRY>
__device__ __forceinline__ void fwd_tile(float* s,
                                         const float* __restrict__ attrs,
                                         const int* __restrict__ sorted_gid,
                                         const int* __restrict__ ranges,
                                         int grid_x, int chunk,
                                         float* __restrict__ color,
                                         float* __restrict__ aux,
                                         float* __restrict__ carry) {
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);
  const int stride = fwd_stride(chunk);

  float T = 1.0f;
  bool dead = false;
  float acc[NFEAT];
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) acc[f] = 0.0f;
  float dsum = 0.0f;
  float sat = SAT_INF;
  float cand = 0.0f;

  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    fwd_stage(s, attrs, sorted_gid, b, n, stride);
    __syncthreads();
    fwd_sub_batches<DEPTH>(s, n, stride, px, py, T, dead, acc, dsum);
    // (also the barrier before the next batch's staging)
    const bool saturated = __syncthreads_count(!dead) == 0;
    if (saturated || (CARRY && b + chunk >= end)) {  // the last batch
      const float m = max_depth(s, 0, n, stride);
      if (saturated) sat = m;
      cand = m;
      break;
    }
  }
  write_fwd(color, aux, (int64_t)tile * NFEAT * NPIX + p, acc, dsum, T, sat);
  if (CARRY) {
    float* cr = carry + (int64_t)tile * CARRY_ROWS * NPIX + p;
    cr[0] = dead ? -T : T;
    cr[NPIX] = dsum;
    cr[2 * NPIX] = cand;
  }
}

inline size_t fwd_smem_bytes(int chunk) {
  return (size_t)(FWD_GEOM_ROWS + NFEAT) * fwd_stride(chunk) * sizeof(float);
}

}  // namespace splat
