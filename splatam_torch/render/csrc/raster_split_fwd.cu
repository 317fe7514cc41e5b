// B3a and B3b: forward alpha compositing on the split stream layout, for
// sm_90a.
//
// Replaces the TPU kernels `_fwd_kernel(emit_carry=True)` (B3a, called
// through `_make_fwd_call_split_int`) and `_fwd_kernel_tail` (B3b, through
// `_make_fwd_call_tail`) of splatam_tpu/render/pallas_raster.py. The split
// layout (render/binning.py::BinnedSplit) keeps every tile's whole chunks in
// an interior region and pairs the tiles' sub-chunk residues two per chunk
// in a tail region; a tile's state crosses from one to the other through a
// per-tile carry (T, 3, 256) f32, channel-major:
//   row 0  T, negated where the pixel is dead (T itself stays >= 1e-4)
//   row 1  median-depth sum so far
//   row 2  saturation candidate: the largest depth of the last batch the
//          interior composited (0 where the tile has no interior)
//
// B3a: one block per tile, one thread per pixel, the tile's interior range
// in batches of `chunk` staged in shared memory (B1's loop). It writes the
// tile's color and aux as B1 would for that range, and the carry. A tile
// with no residue ends here; the compose takes its aux from this kernel.
//
// B3b: one block per tail chunk, 2 x 256 threads: threads [0, 256) are
// segment A's pixels (rows [0, send) of the chunk, tile_a), threads
// [256, 512) segment B's (rows [send, lim), tile_b). Each half starts from
// its tile's carry, or from T = 1 where the tile has no interior, and
// writes its tile's final aux and its color contribution into pair blocks
// (NCt, 2, 8, 256). Saturation depth as `_aux_pm` (pallas_raster.py:1087):
// a segment whose pixels are all dead at the end takes the largest depth of
// its own rows, or the carry's candidate where the tile was dead on entry;
// otherwise 1e30. The B half of a single-residue chunk writes zeros.
//
// Both replay raster_common.cuh's rounded arithmetic, so the composed
// split render equals B1's but for the order of the color sums.
// Bound on an H100: ~20 f32 operations and one exp per (pixel, instance)
// pair, compute-bound as B1; B3b also idles the half of a single-residue
// chunk's block that has no rows.
#include "raster_common.cuh"

using namespace splat;

constexpr int CARRY_ROWS = 3;

__global__ void __launch_bounds__(NPIX)
split_int_fwd_kernel(const float* __restrict__ attrs,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ int_ranges, int grid_x,
                     int chunk, int carry_depth, float* __restrict__ color,
                     float* __restrict__ aux, float* __restrict__ carry) {
  extern __shared__ float s[];  // ROWS * chunk
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = int_ranges[2 * tile], end = int_ranges[2 * tile + 1];
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);

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
    __syncthreads();  // the previous batch is no longer read
    stage_batch(s, nullptr, attrs, sorted_gid, b, n, chunk);
    __syncthreads();
    fwd_range(s, 0, n, chunk, px, py, carry_depth, T, dead, acc, dsum);
    const bool saturated = __syncthreads_count(!dead) == 0;
    if (saturated || b + chunk >= end) {  // the last batch composited
      cand = max_depth(s, 0, n, chunk);
      if (saturated) sat = cand;
      break;
    }
  }
  write_fwd(color, aux, (int64_t)tile * NFEAT * NPIX + p, acc, dsum, T, sat);
  float* cr = carry + (int64_t)tile * CARRY_ROWS * NPIX + p;
  cr[0] = dead ? -T : T;
  cr[NPIX] = dsum;
  cr[2 * NPIX] = cand;
}

__global__ void __launch_bounds__(2 * NPIX)
split_tail_fwd_kernel(const float* __restrict__ attrs,
                      const int* __restrict__ sorted_gid,
                      const int* __restrict__ tmeta,
                      const int* __restrict__ tsl,
                      const int* __restrict__ tbt,
                      const float* __restrict__ carry, int tail_base,
                      int grid_x, int chunk, int carry_depth,
                      float* __restrict__ colorp, float* __restrict__ auxp) {
  extern __shared__ float s[];  // ROWS * chunk
  const int c = blockIdx.x;
  const int seg = threadIdx.x / NPIX;  // 0: segment A, 1: segment B
  const int p = threadIdx.x % NPIX;
  const int sl = tsl[c];
  const int send = sl >> 16, lim = sl & 0xFFFF;
  if (lim == 0) return;  // block-uniform: an empty chunk writes nothing
  const int meta = seg == 0 ? tmeta[c] : tbt[c];
  const int tile = meta >> 1;
  const int j0 = seg == 0 ? 0 : send, j1 = seg == 0 ? send : lim;
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);

  stage_batch(s, nullptr, attrs, sorted_gid, tail_base + c * chunk, lim,
              chunk);
  float T = 1.0f, dsum = 0.0f, cand = 0.0f;
  bool dead = false;
  if (meta & 1) {  // the tile has interior chunks: continue from its carry
    const float* cr = carry + (int64_t)tile * CARRY_ROWS * NPIX + p;
    dead = cr[0] < 0.0f;
    T = fabsf(cr[0]);
    dsum = cr[NPIX];
    cand = cr[2 * NPIX];
  }
  // (the first count is also the barrier after the staging)
  const bool entry_alive_a = __syncthreads_count(seg == 0 && !dead) > 0;
  const bool entry_alive_b = __syncthreads_count(seg == 1 && !dead) > 0;
  float acc[NFEAT];
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) acc[f] = 0.0f;
  fwd_range(s, j0, j1, chunk, px, py, carry_depth, T, dead, acc, dsum);
  const bool alive_a = __syncthreads_count(seg == 0 && !dead) > 0;
  const bool alive_b = __syncthreads_count(seg == 1 && !dead) > 0;

  const int64_t base = ((int64_t)c * 2 + seg) * NFEAT * NPIX + p;
  if (j0 >= j1) {  // the B half of a single-residue chunk
    const float zero[NFEAT] = {};
    write_fwd(colorp, auxp, base, zero, 0.0f, 0.0f, 0.0f);
    return;
  }
  float sat = SAT_INF;
  if (!(seg == 0 ? alive_a : alive_b))
    sat = (seg == 0 ? entry_alive_a : entry_alive_b)
              ? max_depth(s, j0, j1, chunk)
              : cand;
  write_fwd(colorp, auxp, base, acc, dsum, T, sat);
}

extern "C" int raster_split_int_fwd(const float* attrs, const int* sorted_gid,
                                    const int* int_ranges, int num_tiles,
                                    int grid_x, int chunk, int carry_depth,
                                    float* color, float* aux, float* carry,
                                    cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t smem = (size_t)ROWS * chunk * sizeof(float);
  split_int_fwd_kernel<<<num_tiles, NPIX, smem, stream>>>(
      attrs, sorted_gid, int_ranges, grid_x, chunk, carry_depth, color, aux,
      carry);
  return (int)cudaGetLastError();
}

extern "C" int raster_split_tail_fwd(const float* attrs, const int* sorted_gid,
                                     const int* tmeta, const int* tsl,
                                     const int* tbt, const float* carry,
                                     int num_tail, int tail_base, int grid_x,
                                     int chunk, int carry_depth, float* colorp,
                                     float* auxp, cudaStream_t stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tail == 0) return 0;
  const size_t smem = (size_t)ROWS * chunk * sizeof(float);
  split_tail_fwd_kernel<<<num_tail, 2 * NPIX, smem, stream>>>(
      attrs, sorted_gid, tmeta, tsl, tbt, carry, tail_base, grid_x, chunk,
      carry_depth, colorp, auxp);
  return (int)cudaGetLastError();
}
