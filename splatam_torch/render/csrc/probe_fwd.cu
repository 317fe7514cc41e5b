// B1's stage probe, for sm_90a: B1's pass (raster_fwd.cu) cut after each
// stage and built from B1's own helpers (raster_common.cuh), so that the
// differences between successive stages price them on a real stream. The
// stages, each a superset of the one before:
//
//   staging  every batch of the tile's range staged into shared memory
//            (fwd_stage)
//   alpha    + the alpha of every pair of the range, a warp sub-batch of
//              FWD_SUB at a time side by side (sub_alphas; nothing dies)
//   scan     + the transmittance recursion, pixel death and the tile's
//              exit once every pixel is dead (sub_scan)
//   blend    + the blend into the 8 channels (sub_blend): B1's loop
//
// It is a measurement probe, not a port of a TPU kernel, and runs on no
// main path: splatam_torch/bench/fwd_stages.py times it at chunk CHUNK
// with no median depth, and holds `blend` to B1's plain version. The
// kernels take the chunk as a launch argument, as B1 does, so that each
// stage compiles as B1's loop does (a chunk known to the compiler saves
// registers B1 cannot).
//
// A truncated stage must not be dead code, so it sums its last quantity
// per pixel (a staged value, sum alpha, sum w) into color row 0; every
// stage writes B1's aux rows.
#include "raster_common.cuh"

using namespace splat;

enum Stage { STAGING, ALPHA, SCAN, BLEND, NSTAGES };
constexpr int CHUNK = 128;  // fwd_stages.CHUNK

template <int STAGE>
__global__ void __launch_bounds__(NPIX)
stage_kernel(const float* __restrict__ attrs,
             const int* __restrict__ sorted_gid,
             const int* __restrict__ ranges, int grid_x, int chunk,
             float* __restrict__ color, float* __restrict__ aux) {
  extern __shared__ float s[];  // fwd_stage's layout
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = ranges[2 * tile], end = ranges[2 * tile + 1];
  const float px = (float)((tile % grid_x) * TILE + p % TILE);
  const float py = (float)((tile / grid_x) * TILE + p / TILE);
  const int stride = fwd_stride(chunk);

  float T = 1.0f, dsum = 0.0f, sat = SAT_INF;
  bool dead = false;
  float acc[NFEAT] = {};
  for (int b = start; b < end; b += chunk) {
    const int n = min(chunk, end - b);
    fwd_stage(s, attrs, sorted_gid, b, n, stride);
    __syncthreads();
    if (STAGE == STAGING) {
      acc[0] += s[(p % FWD_GEOM_ROWS) * stride + p % n];
    } else {
      for (int jb = 0; jb < n; jb += FWD_SUB) {  // warp-uniform
        if (STAGE >= SCAN && __all_sync(0xffffffffu, dead)) break;
        float w[FWD_SUB];
        sub_alphas(s, jb, stride, px, py, w);
        if (STAGE >= SCAN) sub_scan(s, jb, stride, 0, w, T, dead, dsum);
        if (STAGE == BLEND) {
          sub_blend(s, jb, stride, w, acc);
        } else {
#pragma unroll
          for (int jj = 0; jj < FWD_SUB; ++jj) acc[0] += w[jj];
        }
      }
    }
    if (__syncthreads_count(!dead) == 0) {
      sat = max_depth(s, 0, n, stride);
      break;
    }
  }
  write_fwd(color, aux, (int64_t)tile * NFEAT * NPIX + p, acc, dsum, T, sat);
}

using StageKernel = void (*)(const float*, const int*, const int*, int, int,
                             float*, float*);
static const StageKernel KERNELS[NSTAGES] = {
    stage_kernel<STAGING>, stage_kernel<ALPHA>, stage_kernel<SCAN>,
    stage_kernel<BLEND>};

extern "C" int probe_fwd(const float* attrs, const int* sorted_gid,
                         const int* ranges, int num_tiles, int grid_x,
                         int stage, float* color, float* aux,
                         cudaStream_t stream) {
  if (stage < 0 || stage >= NSTAGES) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  KERNELS[stage]<<<num_tiles, NPIX, fwd_smem_bytes(CHUNK), stream>>>(
      attrs, sorted_gid, ranges, grid_x, CHUNK, color, aux);
  return (int)cudaGetLastError();
}

// A stage's registers per thread and its resident blocks per SM on this
// card, as the runtime reports them for its launch.
extern "C" int probe_fwd_occupancy(int stage, int* regs, int* blocks) {
  if (stage < 0 || stage >= NSTAGES) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(&a, KERNELS[stage]);
  if (rc != cudaSuccess) return (int)rc;
  *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, KERNELS[stage], NPIX, fwd_smem_bytes(CHUNK));
}
