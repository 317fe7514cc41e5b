// P3: tensor-core / FMA overlap probe, for sm_90a.
//
// Replaces the TPU probe kernel `_kernel` of tools/ilp_probe.py. `steps`
// steps; step c expands its (16, 128) input windows a, b (row 0 only) into
// (256, 128) working sets x[i, j] = a[0, j] * i * 1e-3 (y from b), runs one
// case, and writes rows [0, 16) of x and y:
//   vpu       x = x * x * -0.5 + 0.6, 8 * reps times (the FMA chain)
//   mxu       x = pass(x) * 1e-3, reps times
//   chain     reps x (4 vpu -> pass * 1e-3 -> 4 vpu)
//   dual      chain on x and on y: the same mix as two independent chains
//   vpu_dual  vpu on x and on y
// pass(x) = x1 @ U + x2 @ U, the two-term bf16 split x1 = bf16(x),
// x2 = bf16(x - x1), of x times the upper-triangular 0/1 matrix U
// (U[k, n] = 1 for k <= n, a running sum over the row), summed in f32.
//
// Rows are independent in every case (the pass mixes columns only), so the
// work splits into 64-row bands, 4 per step. One persistent block per SM
// (`ctas` of them, chosen by the wrapper) walks the contiguous bands
// [c * 4 steps / ctas, (c + 1) * 4 steps / ctas), its warpgroups taking
// every WG-th: per SM the bands differ by at most one, so no wave runs part
// full. A warpgroup keeps its band of x in the wgmma m64n128 accumulator
// layout (64 floats a thread), which is also the A-register layout of the
// next pass: the split needs no shuffles. The pass runs on wgmma m64nNk16,
// the bf16 halves of x in registers and U in shared memory, written once
// per block. k-block kb of U is zero left of column 16 kb, so its products
// run over the columns [16 kb, 128) only (36 of the 64 16 x 16 blocks), a
// column slice of the product's accumulator: its registers [8 kb, 64). The
// split runs one k-block at a time, each k-block's halves taking the place
// of its f32 values, and all 16 products of a pass are in flight together
// (one group, one wait). y is formed only in dual and vpu_dual; in the
// other cases rows [0, 16) of y are expanded from b at the end. dual runs
// its other chain's FMA work between the pass's k-blocks, under its
// products; across warpgroups the SM overlaps one's FMA work with
// another's products. Registers set the block: vpu, mxu and chain run 4
// warpgroups (16 warps a SM, at most 128 registers a thread), vpu_dual 3
// (x and y live), dual 2 (x, y and the product).
//
// Only rows [0, 16) (band 0's first warp) are written; the rest keep their
// work live through a test for NaN that never holds.
//
// Bound on an H100: the FMA pipe for the vector work (the mul and the FMA of
// each vpu op, the split and the scaling of each pass), the bf16 tensor-core
// rate for the passes' products (non-zero blocks of U), HBM for the windows.
#include <math_constants.h>

#include "probe_wgmma.cuh"

namespace {

using namespace probe;

constexpr int CHUNK = 128;
constexpr int NPIX = 256;
constexpr int KB = CHUNK / 16;  // k-blocks of 16 columns
constexpr int BAND = 64;        // rows of a warpgroup's band
constexpr int BANDS = NPIX / BAND;
constexpr int X = CHUNK / 2;  // accumulator registers a thread: its band of x
enum Case { VPU, MXU, CHAIN, DUAL, VPU_DUAL, NCASES };

__host__ __device__ constexpr bool has_y(int c) { return c == DUAL || c == VPU_DUAL; }
__host__ __device__ constexpr bool has_pass(int c) { return c == MXU || c == CHAIN || c == DUAL; }
__host__ __device__ constexpr int warpgroups(int c) {
  return c == DUAL ? 2 : c == VPU_DUAL ? 3 : 4;
}

__device__ __forceinline__ void vpu(float (&x)[X], int n) {
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int e = 0; e < X; ++e) x[e] = x[e] * x[e] * -0.5f + 0.6f;
}

// 4 vpu ops on k-block kb's 8 values of y (columns [16 kb, 16 kb + 16)).
__device__ __forceinline__ void vpu4_block(float (&y)[X], int kb) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 8 * kb; e < 8 * kb + 8; ++e) y[e] = y[e] * y[e] * -0.5f + 0.6f;
}

// x = (x1 @ U + x2 @ U) * 1e-3; with OTHER, 4 vpu ops on `other` run in
// the shadow of the products, one k-block of it per k-block of the pass.
template <bool OTHER>
__device__ __forceinline__ void pass(float (&x)[X], float (&other)[X],
                                     const unsigned char* tri) {
  float d[X];  // the product, one m64n128 accumulator
#pragma unroll
  for (int e = 0; e < X; ++e) d[e] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    // k-block kb's A fragments from x[8 kb + 2 q], x[8 kb + 2 q + 1] (q = 0:
    // row r; 1: row r + 8; 2, 3: the same rows 8 columns on), whose f32
    // values then die
    unsigned hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v0 = x[8 * kb + 2 * q], v1 = x[8 * kb + 2 * q + 1];
      __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
      hi[q] = *reinterpret_cast<unsigned*>(&b);
      lo[q] = pack_bf16(v0 - __low2float(b), v1 - __high2float(b));
    }
    // columns [16 kb, 128) of the product, registers [8 kb, 64) of d; a
    // fence orders the fragments' writes (and the last k-block's wgmma of
    // another width on these registers) before the products
    const uint64_t desc = tri_desc(tri, kb * TRI_KB_BYTES + kb * 16 * 32);
    wgmma_fence();
    wgmma_n16(KB - kb, d + 8 * kb, hi, desc, 1);
    wgmma_n16(KB - kb, d + 8 * kb, lo, desc, 1);
    if (OTHER) vpu4_block(other, kb);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<X>(d);
#pragma unroll
  for (int e = 0; e < X; ++e) x[e] = d[e] * 1e-3f;
}

// Band rows: this thread's rows row0 and row0 + 8; its columns 8 j +
// 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void expand(float (&x)[X], const float* __restrict__ a,
                                       int64_t col0, int row0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(a + col0 + 8 * j +
                                                      2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float row = (float)(row0 + (e >= 2 ? 8 : 0));
      x[4 * j + e] = __fmul_rn(__fmul_rn(e & 1 ? v.y : v.x, row), 1e-3f);
    }
  }
}

__device__ __forceinline__ void store_rows(const float (&x)[X],
                                           float* __restrict__ o, int64_t col0,
                                           int64_t stride) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < CHUNK / 8; ++j) {
    const int64_t c = col0 + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(o + (lane / 4) * stride + c) =
        make_float2(x[4 * j], x[4 * j + 1]);
    *reinterpret_cast<float2*>(o + (lane / 4 + 8) * stride + c) =
        make_float2(x[4 * j + 2], x[4 * j + 3]);
  }
}

// Rows [0, 16) are written; every other row's work stays live.
__device__ __forceinline__ void finish(const float (&x)[X],
                                       float* __restrict__ o, int64_t col0,
                                       int row0, int64_t stride) {
  if (row0 < 16) {
    store_rows(x, o, col0, stride);
    return;
  }
  bool nan = false;
#pragma unroll
  for (int e = 0; e < X; ++e) nan |= x[e] != x[e];
  if (nan) o[col0] = CUDART_NAN_F;  // never: the band's work stays live
}

template <int CASE>
__global__ void __launch_bounds__(warpgroups(CASE) * 128, 1)
ilp_kernel(const float* __restrict__ a, const float* __restrict__ b, int reps,
           int steps, int ctas, float* __restrict__ oa,
           float* __restrict__ ob) {
  constexpr int WG = warpgroups(CASE);
  __shared__ __align__(128) unsigned char tri[has_pass(CASE) ? TRI_BYTES : 16];
  if (has_pass(CASE)) {
    fill_tri<true>(tri);
    fence_async_smem();
    __syncthreads();
  }
  const int64_t stride = (int64_t)steps * CHUNK;
  const int units = steps * BANDS;
  // contiguous bands per block; its warpgroups take every WG-th
  const int begin = (int)((int64_t)blockIdx.x * units / ctas);
  const int end = (int)((int64_t)(blockIdx.x + 1) * units / ctas);
  const int wg = threadIdx.x / 128, w = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int u = begin + wg; u < end; u += WG) {
    const int64_t col0 = (int64_t)(u / BANDS) * CHUNK;
    const int row0 = u % BANDS * BAND + w * 16 + lane / 4;
    float x[X], y[X];
    expand(x, a, col0, row0);
    if (has_y(CASE)) expand(y, b, col0, row0);
    if (CASE == VPU) {
      vpu(x, 8 * reps);
    } else if (CASE == MXU) {
      for (int i = 0; i < reps; ++i) pass<false>(x, y, tri);
    } else if (CASE == CHAIN) {
      for (int i = 0; i < reps; ++i) {
        vpu(x, 4);
        pass<false>(x, y, tri);
        vpu(x, 4);
      }
    } else if (CASE == DUAL) {  // two independent chains, interleaved
      for (int i = 0; i < reps; ++i) {
        vpu(x, 4);
        pass<true>(x, y, tri);  // y's first 4 vpu ops under x's pass
        pass<true>(y, x, tri);  // x's last 4 under y's pass
        vpu(y, 4);
      }
    } else {  // VPU_DUAL
      for (int i = 0; i < 8 * reps; ++i) {
        vpu(x, 1);
        vpu(y, 1);
      }
    }
    finish(x, oa, col0, row0, stride);
    if (has_y(CASE)) {
      finish(y, ob, col0, row0, stride);
    } else if (row0 < 16) {  // y unchanged: expanded here, not kept live
      expand(y, b, col0, row0);
      store_rows(y, ob, col0, stride);
    }
  }
}

template <int CASE>
int launch(const float* a, const float* b, int reps, int steps, int ctas,
           float* oa, float* ob, cudaStream_t s) {
  ilp_kernel<CASE><<<ctas, warpgroups(CASE) * 128, 0, s>>>(a, b, reps, steps,
                                                          ctas, oa, ob);
  return (int)cudaGetLastError();
}

const void* kernel_of(int kase) {
  switch (kase) {
    case VPU: return (const void*)ilp_kernel<VPU>;
    case MXU: return (const void*)ilp_kernel<MXU>;
    case CHAIN: return (const void*)ilp_kernel<CHAIN>;
    case DUAL: return (const void*)ilp_kernel<DUAL>;
    case VPU_DUAL: return (const void*)ilp_kernel<VPU_DUAL>;
    default: return nullptr;
  }
}

}  // namespace

// a, b, oa, ob: (16, steps * 128) row-major f32; rows [1, 16) of a and b
// are not read, as in the TPU kernel; 1 <= ctas <= 4 steps persistent
// blocks.
extern "C" int probe_ilp(const float* a, const float* b, int kase, int reps,
                         int steps, int ctas, float* oa, float* ob,
                         cudaStream_t stream) {
  if (reps < 0 || steps < 1 || ctas < 1 || ctas > steps * BANDS)
    return (int)cudaErrorInvalidValue;
  switch (kase) {
    case VPU: return launch<VPU>(a, b, reps, steps, ctas, oa, ob, stream);
    case MXU: return launch<MXU>(a, b, reps, steps, ctas, oa, ob, stream);
    case CHAIN: return launch<CHAIN>(a, b, reps, steps, ctas, oa, ob, stream);
    case DUAL: return launch<DUAL>(a, b, reps, steps, ctas, oa, ob, stream);
    case VPU_DUAL:
      return launch<VPU_DUAL>(a, b, reps, steps, ctas, oa, ob, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers per thread and resident blocks per SM of `kase`'s kernel, from
// the CUDA runtime.
extern "C" int probe_ilp_occupancy(int kase, int* regs, int* blocks) {
  const void* k = kernel_of(kase);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, k);
  if (rc != cudaSuccess) return (int)rc;
  *regs = attr.numRegs;
  const int threads = 128 * (kase == DUAL ? 2 : kase == VPU_DUAL ? 3 : 4);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads,
                                                            0);
}
