// B3a and B3b: forward alpha compositing on the split stream layout, for
// sm_90a.
//
// Replaces the TPU kernels `_fwd_kernel(emit_carry=True)` (B3a, called
// through `_make_fwd_call_split_int`) and `_fwd_kernel_tail` (B3b, through
// `_make_fwd_call_tail`) of splatam_tpu/render/pallas_raster.py. The split
// layout (render/binning.py::BinnedSplit) keeps every tile's whole chunks in
// an interior region and pairs the tiles' sub-chunk residues two per chunk
// in a tail region; a tile's state crosses from one to the other through a
// per-tile carry (T, 3, 256) f32 (raster_common.cuh's CARRY_ROWS).
//
// B3a is B1's body with the carry (raster_common.cuh's fwd_tile): one block
// per tile, one thread per pixel, the tile's interior range in batches of
// `chunk` staged in shared memory (fwd_stage), each warp's share taken in
// sub-batches of FWD_SUB = 8 instances (the alphas side by side, the
// transmittance scan in registers, the blend as fused multiply-adds), a
// warp whose pixels are all dead skipping the rest. It writes the tile's
// color and aux as B1 would for that range, and the carry. A tile with no
// interior gets color 0, T 1, median-depth sum 0 and saturation depth
// 1e30: the outputs of an empty tile.
//
// B3b: one 256-thread block per (tail chunk, segment), one thread per pixel
// of the segment's tile: segment A is rows [0, send) of the chunk (tile_a),
// segment B rows [send, lim) (tile_b). The block stages its own rows at
// slot 0, so no sub-batch of 8 mixes the two segments, and runs B1's
// sub-batch loop over them (fwd_sub_batches), from its tile's carry, or
// from T = 1 where the tile has no interior. (A 512-thread block per chunk,
// one segment per half, measured 1.4x slower: the half with the shorter
// segment waits at the block's barriers, and 2 such blocks fit an SM.) A
// tile has at most one tail segment, so each block owns its tile's outputs
// and finishes them in place, with no atomics: it adds its color into B3a's
// (one rounded add: the compose's color_i + colorp) and overwrites aux rows
// 0-2 (median-depth sum, T, saturation depth; rows 3-7 stay B3a's zeros).
// Saturation depth as `_aux_pm` (pallas_raster.py:1087): a segment whose
// pixels are all dead at the end takes the largest depth of its own rows,
// or the carry's candidate where the tile was dead on entry; otherwise
// 1e30. The B block of a single-residue chunk has no rows and no tile, and
// writes nothing.
//
// Both replay raster_common.cuh's rounded arithmetic, so the split render
// equals B1's but for the order of the color sums. Bound on an H100: B3a
// by its ~20 f32 operations and one exp per (pixel, instance) pair, as B1;
// B3b, with fewer pairs, by its bytes (its tiles' color read and written).
#include "raster_common.cuh"

using namespace splat;

// B3a: B1's body with the carry (fwd_tile), over each tile's interior
template <bool DEPTH>
__global__ void __launch_bounds__(NPIX)
split_int_fwd_kernel(const float* __restrict__ attrs,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ int_ranges, int grid_x,
                     int chunk, float* __restrict__ color,
                     float* __restrict__ aux, float* __restrict__ carry) {
  extern __shared__ float s[];  // fwd_stage's layout
  fwd_tile<DEPTH, true>(s, attrs, sorted_gid, int_ranges, grid_x, chunk,
                        color, aux, carry);
}

template <bool DEPTH>
__global__ void __launch_bounds__(NPIX)
split_tail_fwd_kernel(const float* __restrict__ attrs,
                      const int* __restrict__ sorted_gid,
                      const int* __restrict__ tmeta,
                      const int* __restrict__ tsl,
                      const int* __restrict__ tbt,
                      const float* __restrict__ carry, int tail_base,
                      int grid_x, int chunk, float* __restrict__ color,
                      float* __restrict__ aux) {
  extern __shared__ float s[];  // fwd_stage's layout
  const int c = blockIdx.x;
  const int seg = blockIdx.y;  // 0: segment A, 1: segment B
  const int p = threadIdx.x;
  const int sl = tsl[c];
  const int send = sl >> 16, lim = sl & 0xFFFF;
  // the segment's rows [j0, j0 + n) of the chunk
  const int j0 = seg == 0 ? 0 : send, n = seg == 0 ? send : lim - send;
  // block-uniform: an empty chunk, or the B half of a single-residue chunk
  if (n == 0) return;
  const int stride = fwd_stride(chunk);
  fwd_stage(s, attrs, sorted_gid, tail_base + c * chunk + j0, n, stride);
  const int meta = seg == 0 ? tmeta[c] : tbt[c];
  const int tile = meta >> 1;
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);
  float T = 1.0f, dsum = 0.0f, cand = 0.0f;
  bool dead = false;
  if (meta & 1) {  // the tile has interior chunks: continue from its carry
    const float* cr = carry + (int64_t)tile * CARRY_ROWS * NPIX + p;
    dead = cr[0] < 0.0f;
    T = fabsf(cr[0]);
    dsum = cr[NPIX];
    cand = cr[2 * NPIX];
  }
  // (also the barrier after the staging)
  const bool entry_alive = __syncthreads_count(!dead) > 0;
  float acc[NFEAT];
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) acc[f] = 0.0f;
  fwd_sub_batches<DEPTH>(s, n, stride, px, py, T, dead, acc, dsum);
  const bool alive = __syncthreads_count(!dead) > 0;

  float sat = SAT_INF;
  if (!alive) sat = entry_alive ? max_depth(s, 0, n, stride) : cand;
  // the tile's one tail segment: its final outputs, in place of B3a's
  const int64_t base = (int64_t)tile * NFEAT * NPIX + p;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f)
    color[base + f * NPIX] = __fadd_rn(color[base + f * NPIX], acc[f]);
  aux[base] = dsum;
  aux[base + NPIX] = T;
  aux[base + 2 * NPIX] = sat;  // rows 3-7: B3a's zeros
}

extern "C" int raster_split_int_fwd(const float* attrs, const int* sorted_gid,
                                    const int* int_ranges, int num_tiles,
                                    int grid_x, int chunk, int carry_depth,
                                    float* color, float* aux, float* carry,
                                    cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = fwd_smem_bytes(chunk);
  if (carry_depth)
    split_int_fwd_kernel<true><<<num_tiles, NPIX, smem, stream>>>(
        attrs, sorted_gid, int_ranges, grid_x, chunk, color, aux, carry);
  else
    split_int_fwd_kernel<false><<<num_tiles, NPIX, smem, stream>>>(
        attrs, sorted_gid, int_ranges, grid_x, chunk, color, aux, carry);
  return (int)cudaGetLastError();
}

extern "C" int raster_split_tail_fwd(const float* attrs, const int* sorted_gid,
                                     const int* tmeta, const int* tsl,
                                     const int* tbt, const float* carry,
                                     int num_tail, int tail_base, int grid_x,
                                     int chunk, int carry_depth, float* color,
                                     float* aux, cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tail == 0) return 0;
  const size_t smem = fwd_smem_bytes(chunk);
  const dim3 grid(num_tail, 2);
  if (carry_depth)
    split_tail_fwd_kernel<true><<<grid, NPIX, smem, stream>>>(
        attrs, sorted_gid, tmeta, tsl, tbt, carry, tail_base, grid_x, chunk,
        color, aux);
  else
    split_tail_fwd_kernel<false><<<grid, NPIX, smem, stream>>>(
        attrs, sorted_gid, tmeta, tsl, tbt, carry, tail_base, grid_x, chunk,
        color, aux);
  return (int)cudaGetLastError();
}
