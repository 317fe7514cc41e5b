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
//   color (T, 8, 256): the 8 blended features (no background)
//   aux   (T, 8, 256): row 0 median-depth sum (0 when carry_depth is 0),
//                      row 1 final T, row 2 saturation depth (the largest
//                      depth of the batch in which the tile's last pixel
//                      died; 1e30 if it never saturated), rows 3-7 zero.
//
// What bounds it on an H100: the f32 pipes that run alpha, about 20
// rounded operations and one exp per (pixel, instance) pair, 256 K pairs
// for K instances composited before the early exits; the bytes (the
// attribute rows, the gid stream, the two (T, 8, 256) outputs) are small
// beside that. Each warp takes a staged batch in sub-batches of FWD_SUB =
// 8 instances (raster_common.cuh): (a) the 8 alphas, which do not depend
// on T, issue side by side (sub_alphas), where the earlier design ran one
// dependent chain per pair (shared loads, power, exp, test, branch) that
// the compiler could not overlap across its early exits; (b) the
// transmittance recursion runs over them in registers, in order and in
// eval_pair's rounded arithmetic (sub_scan), so every pixel dies at the
// same instance as in B2's replay and the plain version; (c) the blend adds
// each instance where any lane of the warp contributes, one fused
// multiply-add per channel (sub_blend). A warp whose pixels are all dead
// skips the rest of the batch. The batch is staged for this: the seven
// alpha and depth rows padded to a multiple of 8 with zero slots (alpha
// 0), the features instance-major, with 16-byte loads (fwd_stage). Eight
// measured faster than 16 (B2's SUB, which no mma binds here; 48 registers
// a thread against 59, 5 blocks per SM against 4) and than 4 or 32.
//
// The TPU kernel blends as a product on its matrix unit (`color_ref[0] +=
// jax.lax.dot_general(feats, w, ...)`, pallas_raster.py:635). Its
// counterpart here, a 3xTF32 mma.sync product per warp and sub-batch (w
// and the features split hi + lo, three passes, 12 mma for 512 pairs, the
// precision of f32), measured slower on this card than the fused
// multiply-adds it would replace, which skip the 45% of warp slots where
// no pixel reaches 1/255. The
// fused add rounds once where the plain version rounds twice, so the color
// differs from it in the last bits (within 1e-5 + 1e-4 relative); T, the
// median depth and the saturation depth are bit for bit. The kernel keeps
// expf: __expf would break the backward's replay unless every kernel
// changed with it.
#include "raster_common.cuh"

using namespace splat;

// B1 is raster_common.cuh's fwd_tile without the split layout's carry.
// DEPTH: whether the median-depth sum is taken (carry_depth).
template <bool DEPTH>
__global__ void __launch_bounds__(NPIX)
raster_fwd_kernel(const float* __restrict__ attrs,
                  const int* __restrict__ sorted_gid,
                  const int* __restrict__ ranges, int grid_x, int chunk,
                  float* __restrict__ color, float* __restrict__ aux) {
  extern __shared__ float s[];  // fwd_stage's layout
  fwd_tile<DEPTH, false>(s, attrs, sorted_gid, ranges, grid_x, chunk, color,
                         aux, nullptr);
}

extern "C" int raster_fwd(const float* attrs, const int* sorted_gid,
                          const int* ranges, int num_tiles, int grid_x,
                          int chunk, int carry_depth, float* color, float* aux,
                          cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = fwd_smem_bytes(chunk);
  if (carry_depth)
    raster_fwd_kernel<true><<<num_tiles, NPIX, smem, stream>>>(
        attrs, sorted_gid, ranges, grid_x, chunk, color, aux);
  else
    raster_fwd_kernel<false><<<num_tiles, NPIX, smem, stream>>>(
        attrs, sorted_gid, ranges, grid_x, chunk, color, aux);
  return (int)cudaGetLastError();
}

// B1's registers per thread and its resident blocks per SM on this card at
// `chunk` with no median depth, as the runtime reports them for its launch;
// the signature is probe_fwd_occupancy's, with the chunk for the stage.
extern "C" int raster_fwd_occupancy(int chunk, int* regs, int* blocks) {
  const void* k = (const void*)raster_fwd_kernel<false>;
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(&a, k);
  if (rc != cudaSuccess) return (int)rc;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, NPIX, fwd_smem_bytes(chunk));
}
