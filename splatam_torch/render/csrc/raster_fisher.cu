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
// front-to-back pass:
//   gc     = sum_f seed_f feat_f            (per instance)
//   gtot   = sum_f color_f seed_f           (per pixel; no final-T term and
//                                            no depth cotangent)
//   S      = gtot - prefix(w gc)
//   dalpha = T_before gc - S / (1 - alpha)
//   dop    = dalpha exp(power), where alpha is neither capped nor floored
//   dpower = dalpha alpha, where in addition the power was not clamped
//   v      = dpower (-(a dx + b dy), -(c dy + b dx), -dx^2 / 2, -dx dy,
//                    -dy^2 / 2)             (d/dx, d/dy, d/dconic a, b, c)
// and per pixel the 15 products v_a v_b (a <= b) and dop^2. Those 16 rows
// are summed over each warp with shuffles and added into the (N, 16) table
// with atomicAdd (rows 0-14 the upper triangle in (a, b) order, row 15 the
// sum of dop^2). The replay uses raster_common.cuh's eval_pair and the
// transmittance recursion of B1/B2, so every pixel dies at the same
// instance and the tile exits at the same batch as in the forward.
//
// Bound on an H100: the replay's ~19 f32 operations per (pixel, instance)
// pair plus ~66 for the moments, so compute-bound.
#include "raster_common.cuh"

using namespace splat;

constexpr int FROWS = 16;  // 15 moments + sum of dop^2
static_assert(FROWS == ROWS, "warp_add_rows sums ROWS rows");

// One (pixel, staged instance j) pair: fills m with its 16 moment rows (zero
// where the pair adds nothing) and advances T, dead and the running prefix
// accw of w * gc. Returns whether the pair contributed.
__device__ __forceinline__ bool fisher_pair(const float* s, int j, int chunk,
                                            float px, float py,
                                            const float* seed, float gtot,
                                            float& T, bool& dead, float& accw,
                                            float* m) {
#pragma unroll
  for (int r = 0; r < FROWS; ++r) m[r] = 0.0f;
  if (dead) return false;
  const Pair q = eval_pair(s, j, chunk, px, py);
  if (!(q.alpha > 0.0f)) return false;
  const float test = __fmul_rn(T, __fsub_rn(1.0f, q.alpha));
  if (test < T_STOP) {
    dead = true;
    return false;
  }
  float gc = 0.0f;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f)
    gc = __fadd_rn(gc, __fmul_rn(seed[f], s[(ROW_FEAT0 + f) * chunk + j]));
  const float w = __fmul_rn(q.alpha, T);
  accw = __fadd_rn(accw, __fmul_rn(w, gc));
  const float suffix = __fsub_rn(gtot, accw);
  const float dalpha = __fsub_rn(
      __fmul_rn(T, gc), __fdiv_rn(suffix, __fsub_rn(1.0f, q.alpha)));
  const bool unclamped = q.raw < ALPHA_CAP;
  const float dop = unclamped ? __fmul_rn(dalpha, q.epow) : 0.0f;
  const float dpower =
      unclamped && q.praw <= 0.0f ? __fmul_rn(dalpha, q.alpha) : 0.0f;
  const float a = s[ROW_CA * chunk + j];
  const float b = s[ROW_CB * chunk + j];
  const float c = s[ROW_CC * chunk + j];
  float v[5];
  v[0] = -__fmul_rn(dpower, __fadd_rn(__fmul_rn(a, q.dx), __fmul_rn(b, q.dy)));
  v[1] = -__fmul_rn(dpower, __fadd_rn(__fmul_rn(c, q.dy), __fmul_rn(b, q.dx)));
  v[2] = __fmul_rn(dpower, __fmul_rn(-0.5f, __fmul_rn(q.dx, q.dx)));
  v[3] = -__fmul_rn(dpower, __fmul_rn(q.dx, q.dy));
  v[4] = __fmul_rn(dpower, __fmul_rn(-0.5f, __fmul_rn(q.dy, q.dy)));
  int k = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int l = i; l < 5; ++l) m[k++] = __fmul_rn(v[i], v[l]);
  m[15] = __fmul_rn(dop, dop);
  T = test;
  return true;
}

__global__ void __launch_bounds__(NPIX)
raster_fisher_kernel(const float* __restrict__ attrs,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ ranges, int grid_x, int chunk,
                     const float* __restrict__ color,
                     const float* __restrict__ seed_in,
                     float* __restrict__ mom) {
  extern __shared__ float s[];  // ROWS * chunk floats, then chunk gids
  int* s_gid = reinterpret_cast<int*>(s + ROWS * chunk);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  if (start >= end) return;
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);

  float seed[NFEAT];
  float gtot = 0.0f;
  const int64_t base = (int64_t)tile * NFEAT * NPIX + p;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) {
    seed[f] = seed_in[f];
    gtot = __fadd_rn(gtot, __fmul_rn(color[base + f * NPIX], seed[f]));
  }
  float T = 1.0f;
  bool dead = false;
  float accw = 0.0f;  // running prefix of w * gc

  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    __syncthreads();
    stage_batch(s, s_gid, attrs, sorted_gid, b, n, chunk);
    __syncthreads();
    for (int j = 0; j < n; ++j) {  // warp-uniform: shuffles need every lane
      float m[FROWS];
      const bool contrib =
          fisher_pair(s, j, chunk, px, py, seed, gtot, T, dead, accw, m);
      warp_add_rows(m, contrib, s_gid[j], mom);
    }
    if (__syncthreads_count(!dead) == 0) break;
  }
}

extern "C" int raster_fisher(const float* attrs, const int* sorted_gid,
                             const int* ranges, int num_tiles, int grid_x,
                             int chunk, const float* color, const float* seed,
                             float* mom, cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = (size_t)chunk * (ROWS * sizeof(float) + sizeof(int));
  raster_fisher_kernel<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, ranges, grid_x, chunk, color, seed, mom);
  return (int)cudaGetLastError();
}
