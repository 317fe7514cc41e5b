// B1: forward alpha compositing of 16x16 tiles, for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` (splatam_tpu/render/pallas_raster.py,
// called through `_make_fwd_call`). Same function, not the same blocks: one
// thread block per tile and one thread per pixel walk the tile's range of
// the depth-sorted stream front to back, in batches of `chunk` instances
// staged in shared memory and gathered by gid from the (N, 16) attribute
// table, so no (16, K) stream is ever built in device memory.
//
// Per pixel: alpha = min(0.99, op exp(min(power, 0))), zero below 1/255; the
// pixel dies when T (1 - alpha) < 1e-4 and that instance adds nothing; the
// median depth is the depth where T crosses 0.5. After each batch the block
// counts its live pixels with __syncthreads_count and the tile stops when
// none is left. Outputs, channel-major:
//   color (T, 8, 256): the 8 blended feature channels (no background)
//   aux   (T, 8, 256): row 0 median-depth sum (0 when carry_depth is 0),
//                      row 1 final T, row 2 saturation depth (the largest
//                      depth of the batch in which the tile's last pixel
//                      died; 1e30 if it never saturated), rows 3-7 zero.
//
// Bound on an H100: the work is about 20 f32 operations and one exp for each
// (pixel, instance) pair, 256 * K pairs for K instances composited before
// the early exits; the bytes (the attribute rows, the gid stream, the two
// (T, 8, 256) outputs) are small beside that, so it is compute-bound.
// Left for later: cp.async/TMA staging overlapped with compositing (the
// block now waits on every batch load), and batching the serial per-pixel
// loop for more instruction-level parallelism.
#include "raster_common.cuh"

using namespace splat;

__global__ void __launch_bounds__(NPIX)
raster_fwd_kernel(const float* __restrict__ attrs,
                  const int* __restrict__ sorted_gid,
                  const int* __restrict__ ranges, int grid_x, int chunk,
                  int carry_depth, float* __restrict__ color,
                  float* __restrict__ aux) {
  extern __shared__ float s[];  // ROWS * chunk
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);

  float T = 1.0f;
  bool dead = false;
  float acc[NFEAT];
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) acc[f] = 0.0f;
  float dsum = 0.0f;
  float sat = SAT_INF;

  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    __syncthreads();  // the previous batch is no longer read
    stage_batch(s, nullptr, attrs, sorted_gid, b, n, chunk);
    __syncthreads();
    fwd_range(s, 0, n, chunk, px, py, carry_depth, T, dead, acc, dsum);
    if (__syncthreads_count(!dead) == 0) {
      sat = max_depth(s, 0, n, chunk);
      break;
    }
  }
  write_fwd(color, aux, (int64_t)tile * NFEAT * NPIX + p, acc, dsum, T, sat);
}

extern "C" int raster_fwd(const float* attrs, const int* sorted_gid,
                          const int* ranges, int num_tiles, int grid_x,
                          int chunk, int carry_depth, float* color, float* aux,
                          cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = (size_t)ROWS * chunk * sizeof(float);
  raster_fwd_kernel<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, ranges, grid_x, chunk, carry_depth, color, aux);
  return (int)cudaGetLastError();
}
