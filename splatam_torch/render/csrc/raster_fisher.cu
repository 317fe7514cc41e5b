// B4: per-gaussian squared-gradient moments (the diagonal Fisher), for
// sm_90a.
//
// Replaces the TPU kernel `_fisher_kernel` (splatam_tpu/render/
// pallas_raster.py, body `_fisher_chunk_body`, called through
// `_make_fisher_call`) together with the XLA sort that summed its
// per-instance rows per gaussian (`segment_reduce_by_key`). The backward of
// the tile compositing under a constant per-channel seed cotangent (1e-3 on
// RGB for active view selection), with every per-pixel gradient squared
// before it is summed: the reference's `backward_power=2` mode. One thread
// block per tile of the aligned layout, one thread per pixel, one
// front-to-back pass (raster_common.cuh's pair_dpower, with gcol the seed
// and ga = gtot):
//   gc     = sum_f seed_f feat_f            (per instance)
//   gtot   = sum_f color_f seed_f           (per pixel; no final-T term and
//                                            no depth cotangent)
//   S      = gtot - prefix(w gc)
//   dalpha = T_before gc - S / (1 - alpha)
//   dop    = dalpha exp(power), where alpha is neither capped nor floored
//   dpower = dop op, where in addition the power was not clamped
//   v      = dpower (-(a dx + b dy), -(c dy + b dx), -dx^2 / 2, -dx dy,
//                    -dy^2 / 2)             (d/dx, d/dy, d/dconic a, b, c)
// and per instance the 15 pixel sums of v_a v_b (a <= b) and the sum of
// dop^2, added into the (N, 16) table (rows 0-14 the upper triangle in
// (a, b) order, row 15 the sum of dop^2). The replay is B1's and B2's, so
// every pixel dies at the same instance and the tile exits at the same
// batch as in the forward; instances past a saturated tile's exit add
// nothing.
//
// Design: B2's sub-batch pass (raster_common.cuh) on moments of dop^2.
// Where the power was not clamped, v_a v_b is op^2 dop^2 times a
// polynomial of degree 2-4 in (dx, dy) whose coefficients come from the
// conic, so each row is a fixed combination of the 15 pixel moments
// S_ik = sum_p dop_g(p)^2 x^i y^k, i + k <= 4, in tile-centred pixel
// coordinates (|x|, |y| <= 7.5; dop_g: dop where the power was not
// clamped, zero elsewhere). Per staged instance the block takes gc once
// (the seed is constant over the tile: the same rounded operations in the
// same order as per pair) and the power below which its alpha is 0 (the
// alpha skip below). Each pixel's thread writes one value per pair into
// its warp's buffer, dop_g^2; dop^2 where the power was clamped (never,
// for a positive-definite conic) goes into the batch's sum kept apart.
// Per warp sub-batch of SUB = 16 instances, mma.sync m16n8k8 TF32 takes
// the sums over the warp's 32 pixels: instances as M, pixels as K, the 15
// monomials as N (two n-tiles; column 15 is free and carries the sum kept
// apart at the reduction). The warps' C fragments go to their slots, and
// after a barrier thread (i, c) sums column c over the 8 slots; the same
// threads flush the sub-batch with one global atomicAdd per non-zero
// (instance, row), the rows recombined once per instance from the moments,
// the mean's offset (xl, yl) from the tile centre, the conic and the
// opacity: the centred moments M_mn = sum_p dop_g^2 dx^m dy^n
// (dx = xl - x, dy = yl - y; m + n in {2, 3, 4}) by the binomial shift,
// first in x and then in y, each in Horner form, then e.g.
// v0 v0 = op^2 (a^2 M20 + 2ab M11 + b^2 M02), v2 v2 = op^2 M40 / 4. Each
// of an instance's 16 lanes evaluates all 15 rows side by side and keeps
// its own: a switch over the rows, whose 15 paths a warp runs one after
// another, measured 5.5% slower, and a row from per-lane moments and
// coefficients spilled at the 80-register cap.
// A pair costs one shared store instead of 16 product rows and 80 warp
// shuffles; an instance costs one global atomic per row and block instead
// of one per row and warp. The alpha skip: a pair whose power lies below
// log(1/255 / op) by more than SKIP_MARGIN has alpha 0 whatever the last
// bits of expf and logf, so it is dropped before its exp; it would change
// no T, no death and no sum (64% of the 200k scene's pairs lie below
// 1/255).
//
// Precision. TF32 keeps 11 significant bits, and the product of two TF32
// values is exact in the f32 accumulator. The basis values of degree 0-2
// (multiples of 0.25 up to 56.25) are exact in TF32; those of degree 3
// and 4 are not (7.5^3 = 3375/8 needs 12 significant bits, 7.5^4 =
// 50625/16 needs 16), so every basis value is split hi + lo, each part
// exact in TF32 (lo is zero in degree 0-2), and dop^2 is split hi + lo
// (lo carries it to within 2^-21). The passes: lo hi, hi lo and hi hi
// (3xTF32; lo lo, ~2^-22 of a product, is dropped) on both n-tiles, since
// each holds an inexact column (n-tile 0: columns 6 and 7, x^3 and x^2 y):
// 4 k-steps x 2 n-tiles x 3 passes = 24 mma per warp and sub-batch. Each
// moment then keeps ~2^-20 of its size. The recombination (in f32) keeps
// that relative precision for a mean far off its tile, where the shift's
// leading term dominates; for a narrow footprint inside the tile a row can
// be (7.5 / sigma)^4 smaller than the shift's terms, but it is then small
// against its column's largest value.
// The tightest column is v0 v1 on isotropic gaussians (op^2 a^2 M11, whose
// tile sums cancel across the tiles a gaussian covers): 3.2e-5 of its
// largest value on the golden scenes sparse_iso and overlap_deep, 4e-6 on
// dense_aniso, at most 1.4e-6 on chip_smoke.py's other scenes and the 200k
// scene, against FISHER_TOL = 1e-4 (on tests/test_torch_fisher.py's
// saturating scene JAX's kernel is itself 2.5e-5 of scale off a float64
// evaluation). render/raster.py::fisher_rows_from_moments is the
// recombination in tensor ops, which the CPU tests hold against the
// direct sums: it changes with fisher_row.
//
// Bound on an H100 (chip_smoke.py::fisher_bound): the function at its
// least in this moment form, 31 f32 operations per evaluated (pixel,
// instance) pair (the replay 19; the suffix, dalpha and d/dopacity 11; the
// square 1), the 15 moments' 30 flops per pair on the tensor cores at the
// TF32 rate and gc per instance: compute-bound, 0.048 ms on the 200k
// scene at chunk 128 (0.1316 ms under the per-pair design's count of 85
// operations per pair). This kernel takes 0.72 ms there (the per-pair
// design 1.34; PERF.md) at 79 registers and 3 blocks per SM.
#include "raster_common.cuh"

using namespace splat;

constexpr int FROWS = 16;          // 15 moment rows + the sum of dop^2
constexpr int FBUF = SUB * 32;     // floats per warp: (SUB, 32) dop_g^2
constexpr int COL_APART = 15;      // the block's column of the sum apart

// Layout of a block's dynamic shared memory, in floats: the staged rows,
// the gids, each staged instance's gc and power bound, the batch's sum of
// dop^2 kept apart, then (16-byte aligned) the warps' buffers, each of
// which doubles as its warp's slot.
__host__ __device__ inline int fisher_wbuf_offset(int chunk) {
  return (ROWS * chunk + 4 * chunk + 3) & ~3;
}

inline size_t fisher_smem_bytes(int chunk) {
  return (size_t)(fisher_wbuf_offset(chunk) + NWARP * FBUF) * sizeof(float);
}

// The alpha skip's margin: where a pair's power lies below
// log(ALPHA_MIN / op) - SKIP_MARGIN, op exp(power) < ALPHA_MIN whatever
// the last bits of expf and logf (each within a few ulp), so alpha is 0.
constexpr float SKIP_MARGIN = 1e-3f;

// Monomial q of the basis, x^i y^k with q = d (d + 1) / 2 + k, d = i + k:
// 1, x, y, x^2, xy, y^2, x^3, x^2 y, ..., y^4; zero for q = 15. Exact in
// f32: the pixel coordinates are half-integers of magnitude at most 7.5.
__device__ __forceinline__ float monomial(int q, float x, float y) {
  if (q >= 15) return 0.0f;
  const int d = q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : q < 10 ? 3 : 4;
  const int k = q - d * (d + 1) / 2;
  float v = 1.0f;
  for (int e = 0; e < d - k; ++e) v *= x;
  for (int e = 0; e < k; ++e) v *= y;
  return v;
}

// A warp's B fragments, constant over a tile: for n-tile nt, k-step k and
// half h (k-index t + 4h, t = lane % 4, g = lane / 4) monomial 8 nt + g of
// pixel lane 8k + t + 4h, split hi + lo.
struct FisherB {
  uint32_t hi[2][4][2], lo[2][4][2];
};

__device__ __forceinline__ void fisher_operands(FisherB& m) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 2;  // tile row of the warp's pixel 0
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = 8 * k + t + 4 * h;
      const float x = (float)(l & 15) - 7.5f;
      const float y = (float)(row0 + (l >> 4)) - 7.5f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        split_tf32(monomial(8 * nt + g, x, y), m.hi[nt][k][h],
                   m.lo[nt][k][h]);
    }
  }
}

// The warp's sums over its 32 pixels of the sub-batch in its buffer: the C
// fragments of the 16 moment columns (c0: n-tile 0, columns 0-7; c1:
// n-tile 1, columns 8-15), rows the sub-batch's instances. The lo passes
// run in their own accumulators (shorter dependency chains).
__device__ __forceinline__ void fisher_sums(const float* buf,
                                            const FisherB& m, float* c0,
                                            float* c1) {
  float x0[4], x1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c0[i] = c1[i] = x0[i] = x1[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t ah[4], al[4];
    load_a(buf, k, ah, al);
    mma_tf32(x0, al, m.hi[0][k]);
    mma_tf32(x0, ah, m.lo[0][k]);
    mma_tf32(c0, ah, m.hi[0][k]);
    mma_tf32(x1, al, m.hi[1][k]);
    mma_tf32(x1, ah, m.lo[1][k]);
    mma_tf32(c1, ah, m.hi[1][k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c0[i] += x0[i];
    c1[i] += x1[i];
  }
}

// One warp sub-batch: this pixel's pair_dpower for instances [jb, jb + SUB)
// of the staged batch (of n), in order, skipping the pairs whose power lies
// below the instance's bound pmin. Into the warp's buffer goes dop^2
// where the power was not clamped (zero where the pair adds nothing or
// past n); into `apart` dop^2 where it was clamped. Advances T, dead and
// accw; returns whether any pair contributed.
__device__ __forceinline__ bool fisher_sub_pairs(const float* s,
                                                 const float* gc,
                                                 const float* pmin, int jb,
                                                 int n, int chunk, float px,
                                                 float py, float gtot,
                                                 float* buf, float* apart,
                                                 float& T, bool& dead,
                                                 float& accw) {
  const int col = wbuf_col(threadIdx.x & 31);
  bool any = false;
#pragma unroll 4  // the buffer's row swizzle repeats every 4 rows
  for (int jj = 0; jj < SUB; ++jj) {
    const int j = jb + jj;
    float d2 = 0.0f;
    PairGrad pg;
    float dx, dy;
    if (j < n && !dead &&
        !(pair_power(s, j, chunk, px, py, dx, dy) < pmin[j]) &&
        pair_dpower(s, j, chunk, px, py, StagedGc{gc}, gtot, T, dead, accw,
                    pg)) {
      const float sq = __fmul_rn(pg.dop, pg.dop);
      if (pg.q.praw <= 0.0f)
        d2 = sq;
      else if (sq != 0.0f)
        atomicAdd(apart + j, sq);
      T = pg.test;
      any = true;
    }
    buf[wbuf_index(jj, col)] = d2;
  }
  return any;
}

// Row r (0-14, (a, b) order) of one instance, from its moments S (columns
// 0-14), the mean's offset (X, Y) from the tile centre, the conic (a, b, c)
// and the opacity. Every lane evaluates the instance's 15 rows, which stay
// in registers, and keeps its own. render/raster.py::fisher_rows_from_moments
// is the same arithmetic in tensor ops, and changes with it.
__device__ __forceinline__ float fisher_row(int r, const float* S, float X,
                                            float Y, float a, float b,
                                            float c, float op) {
  // T_mk = sum_p dop_g^2 (X - x)^m y^k
  const float T00 = S[0], T01 = S[2], T02 = S[5], T03 = S[9], T04 = S[14];
  const float T10 = X * S[0] - S[1], T11 = X * S[2] - S[4];
  const float T12 = X * S[5] - S[8], T13 = X * S[9] - S[13];
  const float T20 = X * (X * S[0] - 2.0f * S[1]) + S[3];
  const float T21 = X * (X * S[2] - 2.0f * S[4]) + S[7];
  const float T22 = X * (X * S[5] - 2.0f * S[8]) + S[12];
  const float T30 = X * (X * (X * S[0] - 3.0f * S[1]) + 3.0f * S[3]) - S[6];
  const float T31 = X * (X * (X * S[2] - 3.0f * S[4]) + 3.0f * S[7]) - S[11];
  const float T40 =
      X * (X * (X * (X * S[0] - 4.0f * S[1]) + 6.0f * S[3]) - 4.0f * S[6]) +
      S[10];
  // M_mn = sum_p dop_g^2 (X - x)^m (Y - y)^n
  const float M20 = T20, M11 = Y * T10 - T11;
  const float M02 = Y * (Y * T00 - 2.0f * T01) + T02;
  const float M30 = T30, M21 = Y * T20 - T21;
  const float M12 = Y * (Y * T10 - 2.0f * T11) + T12;
  const float M03 = Y * (Y * (Y * T00 - 3.0f * T01) + 3.0f * T02) - T03;
  const float M40 = T40, M31 = Y * T30 - T31;
  const float M22 = Y * (Y * T20 - 2.0f * T21) + T22;
  const float M13 = Y * (Y * (Y * T10 - 3.0f * T11) + 3.0f * T12) - T13;
  const float M04 =
      Y * (Y * (Y * (Y * T00 - 4.0f * T01) + 6.0f * T02) - 4.0f * T03) + T04;
  const float rows[15] = {
      a * a * M20 + 2.0f * a * b * M11 + b * b * M02,
      a * b * M20 + (a * c + b * b) * M11 + b * c * M02,
      0.5f * (a * M30 + b * M21),
      a * M21 + b * M12,
      0.5f * (a * M12 + b * M03),
      b * b * M20 + 2.0f * b * c * M11 + c * c * M02,
      0.5f * (b * M30 + c * M21),
      b * M21 + c * M12,
      0.5f * (b * M12 + c * M03),
      0.25f * M40,
      0.5f * M31,
      0.25f * M22,
      M22,
      0.5f * M13,
      0.25f * M04,
  };
  float out = 0.0f;
#pragma unroll
  for (int q = 0; q < 15; ++q)
    if (q == r) out = rows[q];
  return out * (op * op);
}

// Flush a sub-batch's column sums into the (N, 16) table: thread (i, r)
// gets column r of instance jb + i summed over the warps' slots (column 15:
// the sum kept apart), gathers the instance's 16 columns from its 16
// lanes, and adds row r with one global atomicAdd if it is not zero. Every
// lane of the warp must call it; call after a __syncthreads() that follows
// every warp's part_put.
__device__ __forceinline__ void fisher_flush(const float* s, const int* s_gid,
                                             const float* wbuf,
                                             const float* apart, int jb,
                                             int n, int chunk, float cx,
                                             float cy, float* mom) {
  const int i = threadIdx.x >> 4, r = threadIdx.x & 15;
  const int lb = threadIdx.x & 16;  // the instance's first lane
  const int j = jb + i;
  float v = 0.0f;
  if (j < n) v = r == COL_APART ? apart[j] : slot_sum(wbuf, i, r, FBUF);
  float S[FROWS];
#pragma unroll
  for (int q = 0; q < FROWS; ++q) S[q] = __shfl_sync(0xffffffffu, v, lb + q);
  if (j >= n) return;
  float out;
  if (r == FROWS - 1) {
    out = S[0] + S[COL_APART];
  } else {
    if (S[0] == 0.0f) return;  // no dop_g^2: every moment is zero
    out = fisher_row(r, S, s[ROW_X * chunk + j] - cx, s[ROW_Y * chunk + j] - cy,
                     s[ROW_CA * chunk + j], s[ROW_CB * chunk + j],
                     s[ROW_CC * chunk + j], s[ROW_OP * chunk + j]);
  }
  if (out != 0.0f) atomicAdd(mom + (int64_t)s_gid[j] * FROWS + r, out);
}

// One staged batch of n instances, flushed into the (N, 16) table
// sub-batch by sub-batch. Call once the batch, its gc, its power bounds
// and its zeroed sums apart are in shared memory and the block synchronised; every thread of
// the block must call it (it synchronises the block twice per sub-batch).
__device__ __forceinline__ void fisher_batch(const float* s, const int* s_gid,
                                             const float* gc,
                                             const float* pmin, int n,
                                             int chunk, float px, float py,
                                             float cx, float cy, float gtot,
                                             const FisherB& m, float* wbuf,
                                             float* apart, float& T,
                                             bool& dead, float& accw,
                                             float* mom) {
  float* buf = wbuf + (threadIdx.x >> 5) * FBUF;
  for (int jb = 0; jb < n; jb += SUB) {  // block-uniform
    const bool any = fisher_sub_pairs(s, gc, pmin, jb, n, chunk, px, py,
                                      gtot, buf, apart, T, dead, accw);
    __syncwarp();
    float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (__any_sync(0xffffffffu, any)) fisher_sums(buf, m, c0, c1);
    __syncwarp();
    part_put(buf, c0, c1);
    __syncthreads();
    fisher_flush(s, s_gid, wbuf, apart, jb, n, chunk, cx, cy, mom);
    __syncthreads();  // the next sub-batch overwrites the buffers
  }
}

__global__ void __launch_bounds__(NPIX, BWD_BLOCKS)
raster_fisher_kernel(const float* __restrict__ attrs,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ ranges, int grid_x, int chunk,
                     const float* __restrict__ color,
                     const float* __restrict__ seed,
                     float* __restrict__ mom) {
  extern __shared__ float s[];  // rows, gids, gc, bounds, apart, buffers
  int* s_gid = reinterpret_cast<int*>(s + ROWS * chunk);
  float* gc = s + ROWS * chunk + chunk;
  float* pmin = gc + chunk;
  float* apart = pmin + chunk;
  float* wbuf = s + fisher_wbuf_offset(chunk);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  if (start >= end) return;
  const float tx = (float)((tile % grid_x) * TILE);
  const float ty = (float)((tile / grid_x) * TILE);
  const float px = tx + (float)(p % TILE), py = ty + (float)(p / TILE);

  float gtot = 0.0f;
  const int64_t base = (int64_t)tile * NFEAT * NPIX + p;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f)
    gtot = __fadd_rn(gtot, __fmul_rn(color[base + f * NPIX], seed[f]));
  FisherB m;
  fisher_operands(m);
  float T = 1.0f;
  bool dead = false;
  float accw = 0.0f;  // running prefix of w * gc

  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    stage_batch(s, s_gid, attrs, sorted_gid, b, n, chunk);
    for (int j = p; j < n; j += NPIX) apart[j] = 0.0f;
    __syncthreads();
    for (int j = p; j < n; j += NPIX) {
      gc[j] = pair_gc(seed, s, j, chunk);
      pmin[j] = logf(ALPHA_MIN / s[ROW_OP * chunk + j]) - SKIP_MARGIN;
    }
    __syncthreads();
    fisher_batch(s, s_gid, gc, pmin, n, chunk, px, py, tx + 7.5f, ty + 7.5f,
                 gtot, m, wbuf, apart, T, dead, accw, mom);
    if (__syncthreads_count(!dead) == 0) break;
  }
}

extern "C" int raster_fisher(const float* attrs, const int* sorted_gid,
                             const int* ranges, int num_tiles, int grid_x,
                             int chunk, const float* color, const float* seed,
                             float* mom, cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = fisher_smem_bytes(chunk);
  const int rc = allow_smem((const void*)raster_fisher_kernel, smem);
  if (rc != 0) return rc;
  raster_fisher_kernel<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, ranges, grid_x, chunk, color, seed, mom);
  return (int)cudaGetLastError();
}

// B4's registers per thread and its resident blocks per SM on this card at
// `chunk`, as the runtime reports them for its launch (the signature of
// raster_fwd_occupancy).
extern "C" int raster_fisher_occupancy(int chunk, int* regs, int* blocks) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const void* k = (const void*)raster_fisher_kernel;
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(&a, k);
  if (rc != cudaSuccess) return (int)rc;
  *regs = a.numRegs;
  const size_t smem = fisher_smem_bytes(chunk);
  const int rs = allow_smem(k, smem);
  if (rs != 0) return rs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, NPIX,
                                                            smem);
}
