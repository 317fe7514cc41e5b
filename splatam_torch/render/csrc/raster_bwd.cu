// B2: backward of the tile compositing, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` (splatam_tpu/render/pallas_raster.py,
// body `_bwd_chunk_body`, called through `_make_bwd_call`) together with the
// XLA sort that summed its per-instance rows per gaussian
// (`segment_reduce_by_key`). One thread block per tile, one thread per
// pixel, the same single front-to-back pass as the TPU kernel:
//   S      = ga - prefix(w gc)           (ga: final-T term plus sum of
//                                         color * dL/dcolor, per pixel)
//   dalpha = T_before gc - S / (1 - alpha)
//   dpower = dalpha alpha, only where alpha is neither capped nor floored
//            and the power was not clamped
//   d/dopacity = dalpha exp(power); d/ddepth at the median crossing;
//   d/dx, d/dy, d/dconic from dpower; features: w dL/dcolor.
// It replays the forward's arithmetic (raster_common.cuh), so every pixel
// dies at the same instance and the tile exits at the same batch as in the
// forward. Each instance's rows are summed over each warp with shuffles and
// added into the (N, 16) gradient table with atomicAdd, so no per-instance
// rows reach device memory; instances past a saturated tile's exit add
// nothing. Sums in atomic order vary from run to run in the last bits.
//
// Bound on an H100: the forward's ~20 f32 operations and one exp per
// (pixel, instance) pair, plus ~50 for the gradient, so compute-bound.
// Left for later: cp.async/TMA staging, and fewer atomics (a block-level
// reduction over the 8 warps before one atomicAdd per instance and row).
#include "raster_common.cuh"

using namespace splat;

__global__ void __launch_bounds__(NPIX)
raster_bwd_kernel(const float* __restrict__ attrs,
                  const int* __restrict__ sorted_gid,
                  const int* __restrict__ ranges, int grid_x, int chunk,
                  int nfeat, int carry_depth, const float* __restrict__ color,
                  const float* __restrict__ aux,
                  const float* __restrict__ g_color,
                  const float* __restrict__ g_aux, float* __restrict__ grad) {
  extern __shared__ float s[];  // ROWS * chunk floats, then chunk gids
  int* s_gid = reinterpret_cast<int*>(s + ROWS * chunk);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  if (start >= end) return;
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);

  float gcol[NFEAT], ga, gdep;
  grad_inputs(color, aux, g_color, g_aux, (int64_t)tile * NFEAT * NPIX + p,
              gcol, ga, gdep);
  float T = 1.0f;
  bool dead = false;
  float accw = 0.0f;  // running prefix of w * gc

  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    __syncthreads();
    stage_batch(s, s_gid, attrs, sorted_gid, b, n, chunk);
    __syncthreads();
    for (int j = 0; j < n; ++j) {  // warp-uniform: shuffles need every lane
      float v[ROWS];
      const bool contrib = bwd_pair(s, j, chunk, px, py, gcol, ga, gdep,
                                    nfeat, carry_depth, T, dead, accw, v);
      warp_add_rows(v, contrib, s_gid[j], grad);
    }
    if (__syncthreads_count(!dead) == 0) break;
  }
}

extern "C" int raster_bwd(const float* attrs, const int* sorted_gid,
                          const int* ranges, int num_tiles, int grid_x,
                          int chunk, int nfeat, int carry_depth,
                          const float* color, const float* aux,
                          const float* g_color, const float* g_aux,
                          float* grad, cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (nfeat < 0 || nfeat > NFEAT) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = (size_t)chunk * (ROWS * sizeof(float) + sizeof(int));
  raster_bwd_kernel<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, ranges, grid_x, chunk, nfeat, carry_depth, color,
      aux, g_color, g_aux, grad);
  return (int)cudaGetLastError();
}
