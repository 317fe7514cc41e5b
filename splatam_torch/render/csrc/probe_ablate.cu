// P1: stage ablation of the aligned backward B2, for sm_90a.
//
// Replaces the TPU probe kernels of tools/kernel_ablate.py (`body_stage`,
// `k0`, `kp2`, `kl`, and `full` through `_make_bwd_call`): B2's own pass,
// cut after each stage, on the benchmark's real aligned stream, so the
// differences between successive stages price the stages. One template
// instance per stage, each a superset of the one before:
//
//   dma0      the block starts and writes one float per pixel
//   dma_lean  + stages every batch of the tile's range into shared memory
//   dma_tile  + reads the tile's cotangent inputs (grad_inputs)
//   dma       + stages the gids and runs the saturation-exit loop control
//   alpha     + eval_pair's alpha for every (pixel, instance) pair
//   scan      + transmittance and pixel death
//   gc        + gc, the suffix, dalpha, d/dopacity and dpower
//   moments   + d/dopacity (gated) and w into the warps' shared buffers
//               and the warps' tensor-core sums (moments, feature sums) of
//               each sub-batch
//   reduce    + the block-level reduction: each warp's sums in its slot,
//               one thread per (instance, column) summing the 8 slots
//   full      + the flush: geometry rows recombined, one atomicAdd per
//               non-zero (instance, row) into the (N, 16) table: B2 itself
//
// The TPU's `dma_phi` stage timed the two constant MXU basis blocks its
// kernels read; B2 makes its basis in registers, so it has no instance here.
//
// A truncated stage must not be dead code, so each accumulates its last
// quantity per pixel in a register and writes one float per pixel, a
// (T, 256) output: the staged values (dma stages; the gid as well in `dma`),
// sum alpha (`alpha`, every pair of the range: nothing dies before `scan`),
// sum w = sum alpha T (`scan`: 1 - the forward's final T), sum dpower
// (`gc`: summed over the image, sum_g op_g dL/dop_g), the lane's entries of
// the warp sums' C fragments (`moments`), column p % 16 of the block's
// sums of instances p / 16, p / 16 + 16, ... (`reduce`). Stages that do not
// read the cotangent inputs they loaded keep them alive through a test for
// NaN that never holds. The arithmetic is raster_common.cuh's (stage_batch,
// eval_pair, pair_dpower, sub_pairs, warp_sums, part_put, part_column,
// bwd_batch), so
// `full` is B2 and the stages replay its rounding.
//
// Bound on an H100: that of B2 for `full` (f32 operations per evaluated
// pair); the stages do a subset of it.
#include "raster_common.cuh"

using namespace splat;

enum Stage {
  DMA0, DMA_LEAN, DMA_TILE, DMA, ALPHA, SCAN, GC, MOMENTS, REDUCE, FULL,
  NSTAGES
};

template <int STAGE>
__global__ void __launch_bounds__(NPIX, BWD_BLOCKS)
ablate_kernel(const float* __restrict__ attrs,
              const int* __restrict__ sorted_gid,
              const int* __restrict__ ranges, int grid_x, int chunk,
              int nfeat, int carry_depth, const float* __restrict__ color,
              const float* __restrict__ aux,
              const float* __restrict__ g_color,
              const float* __restrict__ g_aux, float* __restrict__ pix,
              float* __restrict__ grad) {
  extern __shared__ float s[];  // rows, gids, sums apart, buffers
  int* s_gid = reinterpret_cast<int*>(s + ROWS * chunk);
  float* apart = bwd_apart(s, chunk);
  float* wbuf = bwd_wbuf(s, chunk);
  float* buf = wbuf + (threadIdx.x >> 5) * WBUF;  // this warp's
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int64_t out = (int64_t)tile * NPIX + p;
  if (STAGE == DMA0) {
    pix[out] = 1.0f;
    return;
  }
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  const float tx = (float)((tile % grid_x) * TILE);
  const float ty = (float)((tile / grid_x) * TILE);
  const float px = tx + (float)(p % TILE), py = ty + (float)(p / TILE);

  float gcol[NFEAT], ga = 0.0f, gdep = 0.0f;
  if (STAGE >= DMA_TILE)
    grad_inputs(color, aux, g_color, g_aux, (int64_t)tile * NFEAT * NPIX + p,
                gcol, ga, gdep);
  MomentB m;
  if (STAGE >= MOMENTS) moment_operands(gcol, nfeat, m);
  float acc = 0.0f;  // the stage's per-pixel quantity
  float T = 1.0f;
  bool dead = false;
  float accw = 0.0f;  // running prefix of w * gc

  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    if (STAGE < DMA) __syncthreads();  // later stages end on the exit test
    stage_batch(s, STAGE >= DMA ? s_gid : nullptr, attrs, sorted_gid, b, n,
                chunk);
    if (STAGE >= MOMENTS) zero_apart(apart, chunk);
    __syncthreads();
    if (STAGE <= DMA) {
      const int j = (p / ROWS) % n;
      acc = __fadd_rn(acc, s[(p % ROWS) * chunk + j]);
      if (STAGE == DMA) acc = __fadd_rn(acc, (float)s_gid[j]);
    } else if (STAGE == ALPHA) {
      for (int j = 0; j < n; ++j)
        acc = __fadd_rn(acc, eval_pair(s, j, chunk, px, py).alpha);
    } else if (STAGE == SCAN) {
      for (int j = 0; j < n && !dead; ++j) {
        const Pair q = eval_pair(s, j, chunk, px, py);
        if (q.alpha == 0.0f) continue;
        const float test = __fmul_rn(T, __fsub_rn(1.0f, q.alpha));
        if (test < T_STOP) {
          dead = true;
          break;
        }
        acc = __fadd_rn(acc, __fmul_rn(q.alpha, T));
        T = test;
      }
    } else if (STAGE == GC) {  // the backward's head: pair_dpower
      for (int j = 0; j < n && !dead; ++j) {
        PairGrad g;
        if (!pair_dpower(s, j, chunk, px, py, gcol, ga, T, dead, accw, g))
          continue;
        acc = __fadd_rn(acc, g.dpower);
        T = g.test;
      }
    } else if (STAGE == MOMENTS) {  // the warps' sums, kept per lane
      for (int jb = 0; jb < n; jb += SUB) {
        const bool any = sub_pairs(s, jb, n, chunk, px, py, gcol, ga, gdep,
                                   carry_depth, buf, apart, T, dead, accw);
        __syncwarp();
        if (__any_sync(0xffffffffu, any)) {
          float cm[4], cf[4];
          warp_sums(buf, m, cm, cf);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc = __fadd_rn(acc, __fadd_rn(cm[i], cf[i]));
        }
        __syncwarp();
      }
    } else if (STAGE == REDUCE) {  // bwd_batch without the flush
      for (int jb = 0; jb < n; jb += SUB) {
        const bool any = sub_pairs(s, jb, n, chunk, px, py, gcol, ga, gdep,
                                   carry_depth, buf, apart, T, dead, accw);
        __syncwarp();
        float cm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float cf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (__any_sync(0xffffffffu, any)) warp_sums(buf, m, cm, cf);
        __syncwarp();
        part_put(buf, cm, cf);
        __syncthreads();
        acc = __fadd_rn(acc, part_column(wbuf, apart, jb, n, chunk));
        __syncthreads();
      }
    } else {  // FULL: raster_bwd.cu's loop
      bwd_batch(s, s_gid, n, chunk, px, py, tx + 7.5f, ty + 7.5f, gcol, ga,
                gdep, nfeat, carry_depth, m, wbuf, apart, T, dead, accw, grad);
    }
    if (STAGE >= DMA && __syncthreads_count(!dead) == 0) break;
  }
  if (STAGE == FULL) return;
  if (STAGE >= DMA_TILE && STAGE <= MOMENTS) {
    const float keep = __fadd_rn(ga, gdep);
    if (keep != keep) acc = keep;  // never: the loads stay live
  }
  pix[out] = acc;
}

typedef void (*AblateFn)(const float*, const int*, const int*, int, int, int,
                         int, const float*, const float*, const float*,
                         const float*, float*, float*);

static const AblateFn kStages[NSTAGES] = {
    ablate_kernel<DMA0>,  ablate_kernel<DMA_LEAN>, ablate_kernel<DMA_TILE>,
    ablate_kernel<DMA>,   ablate_kernel<ALPHA>,    ablate_kernel<SCAN>,
    ablate_kernel<GC>,    ablate_kernel<MOMENTS>,  ablate_kernel<REDUCE>,
    ablate_kernel<FULL>,
};

extern "C" int probe_ablate(const float* attrs, const int* sorted_gid,
                            const int* ranges, int stage, int num_tiles,
                            int grid_x, int chunk, int nfeat, int carry_depth,
                            const float* color, const float* aux,
                            const float* g_color, const float* g_aux,
                            float* pix, float* grad, cudaStream_t stream) {
  if (stage < 0 || stage >= NSTAGES) return (int)cudaErrorInvalidValue;
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (nfeat < 0 || nfeat > NFEAT) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = bwd_smem_bytes(chunk);  // every stage alike: B2's
  const int rc = allow_smem((const void*)kStages[stage], smem);
  if (rc != 0) return rc;
  kStages[stage]<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, ranges, grid_x, chunk, nfeat, carry_depth, color,
      aux, g_color, g_aux, pix, grad);
  return (int)cudaGetLastError();
}
