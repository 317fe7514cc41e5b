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
// forward; instances past a saturated tile's exit add nothing.
//
// What bounds it on an H100: the f32 pipes that run the per-pair work
// the function needs (alpha and the replay, gc, dalpha, d/dopacity: ~56
// operations and one exp per (pixel, instance) pair, in every pixel's
// thread, in order). The first port then formed 16 gradient rows per pair
// and summed each over the warp with 80 shuffles and 16 same-address
// global atomics per warp and instance (P1: 45% of its time in that
// reduction, 22% in the rows). This design (raster_common.cuh's
// bwd_batch) keeps two values per pair in shared memory, d/dopacity where
// the power was not clamped (dpower is the opacity times it) and w, and
// takes the pixel sums as the TPU kernel did, on the tensor cores: the six
// moments against the tile-centred basis and the eight feature sums, per
// warp sub-batch of 16 instances (mma.sync TF32; the moments split hi +
// lo, w and dL/dcolor 3xTF32, which holds 5e-5 of scale -- the helpers'
// comment says why). The block reduces the warps' sums through shared
// slots after one barrier per sub-batch, with no shuffle and no shared
// atomic per instance, and flushes each sub-batch with one global
// atomicAdd per non-zero (instance, row), the geometry rows recombined
// once per instance. Sums in atomic order vary from run to run in the
// last bits. Left for later: cp.async/TMA staging.
#include "raster_common.cuh"

using namespace splat;

__global__ void __launch_bounds__(NPIX, BWD_BLOCKS)
raster_bwd_kernel(const float* __restrict__ attrs,
                  const int* __restrict__ sorted_gid,
                  const int* __restrict__ ranges, int grid_x, int chunk,
                  int nfeat, int carry_depth, const float* __restrict__ color,
                  const float* __restrict__ aux,
                  const float* __restrict__ g_color,
                  const float* __restrict__ g_aux, float* __restrict__ grad) {
  extern __shared__ float s[];  // rows, gids, sums apart, buffers
  int* s_gid = reinterpret_cast<int*>(s + ROWS * chunk);
  float* apart = bwd_apart(s, chunk);
  float* wbuf = bwd_wbuf(s, chunk);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  if (start >= end) return;
  const float tx = (float)((tile % grid_x) * TILE);
  const float ty = (float)((tile / grid_x) * TILE);
  const float px = tx + (float)(p % TILE), py = ty + (float)(p / TILE);

  float gcol[NFEAT], ga, gdep;
  grad_inputs(color, aux, g_color, g_aux, (int64_t)tile * NFEAT * NPIX + p,
              gcol, ga, gdep);
  MomentB m;
  moment_operands(gcol, nfeat, m);
  float T = 1.0f;
  bool dead = false;
  float accw = 0.0f;  // running prefix of w * gc

  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    stage_batch(s, s_gid, attrs, sorted_gid, b, n, chunk);
    zero_apart(apart, chunk);
    __syncthreads();
    bwd_batch(s, s_gid, n, chunk, px, py, tx + 7.5f, ty + 7.5f, gcol, ga,
              gdep, nfeat, carry_depth, m, wbuf, apart, T, dead, accw, grad);
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
  const size_t smem = bwd_smem_bytes(chunk);
  const int rc = allow_smem((const void*)raster_bwd_kernel, smem);
  if (rc != 0) return rc;
  raster_bwd_kernel<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, ranges, grid_x, chunk, nfeat, carry_depth, color,
      aux, g_color, g_aux, grad);
  return (int)cudaGetLastError();
}
