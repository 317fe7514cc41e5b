// B3c and B3d: backward of the split-layout compositing, for sm_90a.
//
// Replaces the TPU kernels `_bwd_kernel_interior` (B3c, called through
// `_make_bwd_call_split_int`) and `_bwd_kernel_tail` (B3d, through
// `_make_bwd_call_tail`) of splatam_tpu/render/pallas_raster.py, together
// with the XLA sort that summed their per-instance rows per gaussian
// (`segment_reduce_by_key`). The per-pixel constants (dL/dcolor, ga,
// dL/d median depth) come from the COMPOSED final color and aux of each
// tile (`_ga_gdep_blocks`), so the backward of the split render is the one
// single front-to-back pass of B2, cut at the interior/tail boundary and
// handed across by a per-tile carry (T, 2, 256) f32, channel-major:
//   row 0  T, negated where the pixel is dead
//   row 1  the running prefix of w * gc (the tail continues it)
//
// B3c: one block per tile, one thread per pixel over the tile's interior
// range, then the carry. It is B2's loop and design (raster_bwd.cu,
// raster_common.cuh's bwd_batch): per pair only the gated d/dopacity and
// w, kept in shared memory; the pixel sums as moments against the
// tile-centred basis and feature sums on the tensor cores (mma.sync TF32,
// split hi + lo and 3xTF32: within 5e-5 of scale); the warps' sums reduced
// over the block through shared slots, one barrier per sub-batch of 16
// instances, and flushed with one global atomicAdd per non-zero (instance,
// row). Like B2 it is bound by the f32 pipes that run the per-pair
// replay.
// B3d: one block per tail chunk, 2 x 256 threads, each half one segment
// (rows [0, send) of tile_a, [send, lim) of tile_b), seeded from its
// tile's carry or from T = 1, prefix 0 where the tile has no interior. It
// forms each pair's 16 gradient rows, sums them over each warp (a warp
// never spans the two segments) with shuffles and adds them with
// atomicAdd: ~70 f32 operations per pair plus the reduction.
// Both replay raster_common.cuh's rounded arithmetic, so every pixel dies
// at the same instance as in B3a/B3b, and both add into the same table.
// Sums in atomic order vary in the last bits.
#include "raster_common.cuh"

using namespace splat;

constexpr int BCARRY_ROWS = 2;

__global__ void __launch_bounds__(NPIX, BWD_BLOCKS)
split_int_bwd_kernel(const float* __restrict__ attrs,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ int_ranges, int grid_x,
                     int chunk, int nfeat, int carry_depth,
                     const float* __restrict__ color,
                     const float* __restrict__ aux,
                     const float* __restrict__ g_color,
                     const float* __restrict__ g_aux,
                     float* __restrict__ grad, float* __restrict__ bcarry) {
  extern __shared__ float s[];  // rows, gids, sums apart, buffers
  int* s_gid = reinterpret_cast<int*>(s + ROWS * chunk);
  float* apart = bwd_apart(s, chunk);
  float* wbuf = bwd_wbuf(s, chunk);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = int_ranges[2 * tile], end = int_ranges[2 * tile + 1];
  const float tx = (float)((tile % grid_x) * TILE);
  const float ty = (float)((tile / grid_x) * TILE);
  const float px = tx + (float)(p % TILE), py = ty + (float)(p / TILE);

  float T = 1.0f;
  bool dead = false;
  float accw = 0.0f;
  if (start < end) {
    float gcol[NFEAT], ga, gdep;
    grad_inputs(color, aux, g_color, g_aux, (int64_t)tile * NFEAT * NPIX + p,
                gcol, ga, gdep);
    MomentB m;
    moment_operands(gcol, nfeat, m);
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
  float* cr = bcarry + (int64_t)tile * BCARRY_ROWS * NPIX + p;
  cr[0] = dead ? -T : T;
  cr[NPIX] = accw;
}

__global__ void __launch_bounds__(2 * NPIX)
split_tail_bwd_kernel(const float* __restrict__ attrs,
                      const int* __restrict__ sorted_gid,
                      const int* __restrict__ tmeta,
                      const int* __restrict__ tsl,
                      const int* __restrict__ tbt,
                      const float* __restrict__ bcarry, int tail_base,
                      int grid_x, int chunk, int nfeat, int carry_depth,
                      const float* __restrict__ color,
                      const float* __restrict__ aux,
                      const float* __restrict__ g_color,
                      const float* __restrict__ g_aux,
                      float* __restrict__ grad) {
  extern __shared__ float s[];  // ROWS * chunk floats, then chunk gids
  int* s_gid = reinterpret_cast<int*>(s + ROWS * chunk);
  const int c = blockIdx.x;
  const int seg = threadIdx.x / NPIX;  // 0: segment A, 1: segment B
  const int p = threadIdx.x % NPIX;
  const int sl = tsl[c];
  const int send = sl >> 16, lim = sl & 0xFFFF;
  if (lim == 0) return;  // block-uniform: an empty chunk adds nothing
  const int meta = seg == 0 ? tmeta[c] : tbt[c];
  const int tile = meta >> 1;
  const int j0 = seg == 0 ? 0 : send, j1 = seg == 0 ? send : lim;
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);

  stage_batch(s, s_gid, attrs, sorted_gid, tail_base + c * chunk, lim, chunk);
  __syncthreads();
  if (j0 >= j1) return;  // the B half of a single-residue chunk: whole warps

  float gcol[NFEAT], ga, gdep;
  grad_inputs(color, aux, g_color, g_aux, (int64_t)tile * NFEAT * NPIX + p,
              gcol, ga, gdep);
  float T = 1.0f, accw = 0.0f;
  bool dead = false;
  if (meta & 1) {  // the tile has interior chunks: continue from its carry
    const float* cr = bcarry + (int64_t)tile * BCARRY_ROWS * NPIX + p;
    dead = cr[0] < 0.0f;
    T = fabsf(cr[0]);
    accw = cr[NPIX];
  }
  for (int j = j0; j < j1; ++j) {  // warp-uniform: shuffles need every lane
    float v[ROWS];
    const bool contrib = bwd_pair(s, j, chunk, px, py, gcol, ga, gdep, nfeat,
                                  carry_depth, T, dead, accw, v);
    warp_add_rows(v, contrib, s_gid[j], grad);
  }
}

extern "C" int raster_split_int_bwd(const float* attrs, const int* sorted_gid,
                                    const int* int_ranges, int num_tiles,
                                    int grid_x, int chunk, int nfeat,
                                    int carry_depth, const float* color,
                                    const float* aux, const float* g_color,
                                    const float* g_aux, float* grad,
                                    float* bcarry, cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (nfeat < 0 || nfeat > NFEAT) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = bwd_smem_bytes(chunk);
  const int rc = allow_smem((const void*)split_int_bwd_kernel, smem);
  if (rc != 0) return rc;
  split_int_bwd_kernel<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, int_ranges, grid_x, chunk, nfeat, carry_depth, color,
      aux, g_color, g_aux, grad, bcarry);
  return (int)cudaGetLastError();
}

extern "C" int raster_split_tail_bwd(const float* attrs, const int* sorted_gid,
                                     const int* tmeta, const int* tsl,
                                     const int* tbt, const float* bcarry,
                                     int num_tail, int tail_base, int grid_x,
                                     int chunk, int nfeat, int carry_depth,
                                     const float* color, const float* aux,
                                     const float* g_color, const float* g_aux,
                                     float* grad, cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (nfeat < 0 || nfeat > NFEAT) return (int)cudaErrorInvalidValue;
  if (num_tail == 0) return 0;
  const size_t smem = (size_t)chunk * (ROWS * sizeof(float) + sizeof(int));
  split_tail_bwd_kernel<<<num_tail, 2 * NPIX, smem, stream>>>(
      attrs, sorted_gid, tmeta, tsl, tbt, bcarry, tail_base, grid_x, chunk,
      nfeat, carry_depth, color, aux, g_color, g_aux, grad);
  return (int)cudaGetLastError();
}
