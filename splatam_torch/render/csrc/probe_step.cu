// P4: per-step overhead probe, for sm_90a.
//
// Replaces the TPU probe kernel of tools/step_overhead.py (`make_pf`'s
// `kernel`) at the tool's chunk, 128: `steps` steps, step c reading its
// (16, 128) window of a (16, steps * 128) stream at column blk[c] * 128
// through an index table (the TPU's scalar-prefetched `blk`) and adding a
// (256, 128) product into one (256, 128) f32 sum: out = sum over steps of
//   empty     nothing: the step's window is staged and released (the
//             per-step fixed cost)
//   passthru  bcast(0), the window's row 0 on all 256 rows
//   mxu       bcast(0) @ L
//   mxu2dep   bf16(bcast(0) @ L * 1e-3) @ L, two dependent products
//   mxu2ind   bcast(0) @ L + bcast(1) @ L, two independent products
// with L the lower-triangular 0/1 matrix (L[k, n] = 1 for n <= k, a suffix
// sum over the row), bf16 operands, as Precision.DEFAULT rounds them on a
// TPU, and f32 sums. Every product covers all 256 rows, as the TPU's
// (256, 128) @ (128, 128) does. The tool's `mxu512` (one (512, chunk)
// matmul of both rows against mxu2ind's two) has no counterpart: on the
// tensor cores both are the same instructions.
//
// The TPU ran the steps as a sequential grid and carried the sum in a VMEM
// scratch; here a loop inside the block takes the grid's place. One
// persistent block per SM (`ctas` of them, chosen by the wrapper) walks the
// contiguous steps [c * steps / ctas, (c + 1) * steps / ctas):
// - it copies its slice of the index table into shared memory once (the
//   scalar prefetch's counterpart), and its thread 0 stages each step's
//   window, at the column the table gives, into a ring of STAGES shared
//   buffers with cp.async.bulk (16 rows of 512 bytes), completing on the
//   slot's mbarrier, up to STAGES - 1 steps ahead (the BlockSpec
//   pipeline's counterpart);
// - two warpgroups own 128 rows each (two m64 tiles) and keep the
//   (256, 128) sum in registers across all the block's steps (the
//   scratch's counterpart), as wgmma m64nNk16 accumulators;
// - each product is wgmma with A, the broadcast window row in bf16, in
//   registers and B, L, in shared memory, written once per block. k-block
//   kb of L is zero past column 16 kb + 15, so its product runs over
//   columns [0, 16 (kb + 1)) only: 36 of the 64 16 x 16 blocks (72 of 128
//   mma.sync tiles), the same skip as a column slice of the accumulator
//   (its first 8 (kb + 1) registers). mxu2dep feeds the first product's
//   accumulator, scaled and rounded to bf16, back as the next A: for bf16
//   the m64n128 accumulator layout is the A-register layout.
// At the end each block writes its (256, 128) partial, and `step_sum` adds
// the partials in a fixed order: no atomics, the same result from run to
// run.
//
// Bound on an H100: the bf16 tensor-core rate for the products (the
// non-zero blocks of L), HBM for the windows.
#include "probe_wgmma.cuh"

namespace {

using namespace probe;

constexpr int NPIX = 256;
constexpr int CHUNK = 128;
constexpr int KB = CHUNK / 16;  // k-blocks
constexpr int WIN_ROWS = 16;
constexpr int WARPGROUPS = 2;  // 128 rows each
constexpr int THREADS = WARPGROUPS * 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 8;
constexpr int MAX_CTA_STEPS = 4096;  // the index table's slice in shared memory
constexpr int WIN_FLOATS = WIN_ROWS * CHUNK;
constexpr int SMEM_BYTES = TRI_BYTES + STAGES * WIN_FLOATS * 4 +
                           2 * STAGES * 8 + MAX_CTA_STEPS * 4;
constexpr int ACC = CHUNK / 2;  // accumulator registers per m64 tile
constexpr int SUM_SLICES = 4;   // step_sum: partial sums per output
constexpr int SUM_COLS = 64;    // step_sum: float4 outputs per block
enum Body { EMPTY, PASSTHRU, MXU, MXU2DEP, MXU2IND, NBODIES };

// A fragments of one window row broadcast to all rows: a[kb][0] packs
// w[k], w[k + 1] and a[kb][1] packs w[k + 8], w[k + 9], k = 16 kb +
// 2 (lane % 4); the fragment is {a0, a0, a1, a1} (rows lane / 4 and
// lane / 4 + 8 hold the same values).
__device__ __forceinline__ void row_frags(const float* w, unsigned (&a)[KB][2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const int k = kb * 16 + 2 * (lane % 4);
    const float2 v0 = *reinterpret_cast<const float2*>(w + k);
    const float2 v1 = *reinterpret_cast<const float2*>(w + k + 8);
    a[kb][0] = pack_bf16(v0.x, v0.y);
    a[kb][1] = pack_bf16(v1.x, v1.y);
  }
}

// Both m64 tiles of the warpgroup += A @ L over the non-zero k-blocks:
// k-block kb on the columns [0, 16 (kb + 1)) (the first 8 (kb + 1)
// accumulator registers). Successive k-blocks are wgmma of different
// widths on the same registers, so a fence orders each after the last;
// with `b`, each tile also adds B @ L (the same shape right after: ordered
// without a fence).
template <bool TWO>
__device__ __forceinline__ void products(float* d0, float* d1,
                                         const unsigned (&a)[KB][2],
                                         const unsigned (&b)[KB][2],
                                         const unsigned char* tri) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const unsigned fa[4] = {a[kb][0], a[kb][0], a[kb][1], a[kb][1]};
    const unsigned fb[4] = {b[kb][0], b[kb][0], b[kb][1], b[kb][1]};
    const uint64_t desc = tri_desc(tri, kb * TRI_KB_BYTES);
    wgmma_fence();
    wgmma_n16(kb + 1, d0, fa, desc, 1);
    if (TWO) wgmma_n16(kb + 1, d0, fb, desc, 1);
    wgmma_n16(kb + 1, d1, fa, desc, 1);
    if (TWO) wgmma_n16(kb + 1, d1, fb, desc, 1);
  }
}

// Stage the window of the block's step t into slot t % STAGES; idx is the
// block's slice of the index table. Called by all of warp 0: lane 0 sets
// the slot's transaction count, lanes 0-15 copy a row each.
__device__ __forceinline__ void load_window(const float* __restrict__ stream,
                                            const int* idx, int64_t stride,
                                            int t, float* win, uint64_t* full) {
  const int s = t % STAGES, lane = threadIdx.x % 32;
  const int64_t col0 = (int64_t)idx[t] * CHUNK;
  if (lane == 0) mbar_expect_tx(&full[s], WIN_FLOATS * 4);
  __syncwarp();
  if (lane < WIN_ROWS)
    bulk_load(win + s * WIN_FLOATS + lane * CHUNK,
              stream + lane * stride + col0, CHUNK * 4, &full[s]);
}

template <int BODY>
__global__ void __launch_bounds__(THREADS, 1)
step_kernel(const float* __restrict__ stream, const int* __restrict__ blk,
            int steps, int ctas, float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* tri = smem;
  float* win = reinterpret_cast<float*>(smem + TRI_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(win + STAGES * WIN_FLOATS);
  uint64_t* empty = full + STAGES;
  int* idx = reinterpret_cast<int*>(empty + STAGES);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t stride = (int64_t)steps * CHUNK;
  // the wrapper's split (step_overhead.cta_steps): contiguous, non-empty,
  // at most MAX_CTA_STEPS
  const int begin = (int)((int64_t)blockIdx.x * steps / ctas);
  const int n = (int)((int64_t)(blockIdx.x + 1) * steps / ctas) - begin;

  if (BODY >= MXU) fill_tri<false>(tri);
  for (int t = tid; t < n; t += THREADS) idx[t] = blk[begin + t];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();
  if (warp == 0)
    for (int t = 0; t < STAGES && t < n; ++t)
      load_window(stream, idx, stride, t, win, full);

  float acc[2][ACC];  // rows 128 g + 64 mt + ..., g = this warpgroup
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[mt][i] = 0.0f;

#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const float* w = win + s * WIN_FLOATS;
    unsigned a0[KB][2], a1[KB][2];
    if (BODY == PASSTHRU) {
#pragma unroll
      for (int j = 0; j < CHUNK / 8; ++j) {
        const float2 v =
            *reinterpret_cast<const float2*>(w + j * 8 + 2 * (lane % 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][4 * j] += v.x;
          acc[mt][4 * j + 1] += v.y;
          acc[mt][4 * j + 2] += v.x;
          acc[mt][4 * j + 3] += v.y;
        }
      }
    } else if (BODY >= MXU) {
      row_frags(w, a0);
      if (BODY == MXU2IND) row_frags(w + CHUNK, a1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the window is in registers

    if (BODY == MXU || BODY == MXU2IND) {
      products<BODY == MXU2IND>(acc[0], acc[1], a0,
                                 BODY == MXU2IND ? a1 : a0, tri);
      wgmma_commit();
    } else if (BODY == MXU2DEP) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float y[ACC];
#pragma unroll
        for (int i = 0; i < ACC; ++i) y[i] = 0.0f;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const unsigned g[4] = {a0[kb][0], a0[kb][0], a0[kb][1], a0[kb][1]};
          wgmma_fence();
          wgmma_n16(kb + 1, y, g, tri_desc(tri, kb * TRI_KB_BYTES), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<ACC>(y);
        unsigned f[KB][2][2];  // y * 1e-3 in bf16 as the A fragments
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              f[kb][h][r] = pack_bf16(y[8 * kb + 4 * h + 2 * r] * 1e-3f,
                                      y[8 * kb + 4 * h + 2 * r + 1] * 1e-3f);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const unsigned g[4] = {f[kb][0][0], f[kb][0][1], f[kb][1][0],
                                 f[kb][1][1]};
          wgmma_fence();
          wgmma_n16(kb + 1, acc[mt], g, tri_desc(tri, kb * TRI_KB_BYTES), 1);
        }
        wgmma_commit();
      }
    }

    // refill the slot the previous step used, once every warp released it
    if (warp == 0 && t >= 1 && t - 1 + STAGES < n) {
      const int u = t - 1;
      if (lane == 0) mbar_wait(&empty[u % STAGES], (u / STAGES) & 1);
      __syncwarp();
      load_window(stream, idx, stride, u + STAGES, win, full);
      __syncwarp();
    }
    if (BODY >= MXU) wgmma_wait<0>();
  }
  if (BODY >= MXU) {
    fence_regs<ACC>(acc[0]);
    fence_regs<ACC>(acc[1]);
  }

  // the block's partial, row-major (256, 128)
  float* p = partial + (int64_t)blockIdx.x * NPIX * CHUNK;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = warp / 4 * 128 + mt * 64 + warp % 4 * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < CHUNK / 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(p + row * CHUNK + col) =
          make_float2(acc[mt][4 * j], acc[mt][4 * j + 1]);
      *reinterpret_cast<float2*>(p + (row + 8) * CHUNK + col) =
          make_float2(acc[mt][4 * j + 2], acc[mt][4 * j + 3]);
    }
  }
}

// out = sum over c = 0 .. ctas - 1 of partial[c], in a fixed order: slice s
// of a block sums the partials c = s (mod SUM_SLICES) in increasing c, and
// the slices are added 0, 1, 2, 3.
__global__ void __launch_bounds__(SUM_SLICES * SUM_COLS)
step_sum(const float4* __restrict__ partial, int ctas,
         float4* __restrict__ out) {
  __shared__ float4 part[SUM_SLICES][SUM_COLS];
  const int i = threadIdx.x % SUM_COLS, s = threadIdx.x / SUM_COLS;
  const int q = blockIdx.x * SUM_COLS + i;
  float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int c = s; c < ctas; c += SUM_SLICES) {
    const float4 v = partial[(int64_t)c * (NPIX * CHUNK / 4) + q];
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
  }
  part[s][i] = t;
  __syncthreads();
  if (s == 0) {
#pragma unroll
    for (int r = 1; r < SUM_SLICES; ++r) {
      t.x += part[r][i].x;
      t.y += part[r][i].y;
      t.z += part[r][i].z;
      t.w += part[r][i].w;
    }
    out[q] = t;
  }
}

template <int BODY>
int launch(const float* stream, const int* blk, int steps, int ctas,
           float* partial, float* out, cudaStream_t s) {
  const void* k = (const void*)step_kernel<BODY>;
  cudaError_t rc = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  step_kernel<BODY><<<ctas, THREADS, SMEM_BYTES, s>>>(stream, blk, steps,
                                                      ctas, partial);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  step_sum<<<NPIX * CHUNK / 4 / SUM_COLS, SUM_SLICES * SUM_COLS, 0, s>>>(
      reinterpret_cast<const float4*>(partial), ctas,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

const void* kernel_of(int body) {
  switch (body) {
    case EMPTY: return (const void*)step_kernel<EMPTY>;
    case PASSTHRU: return (const void*)step_kernel<PASSTHRU>;
    case MXU: return (const void*)step_kernel<MXU>;
    case MXU2DEP: return (const void*)step_kernel<MXU2DEP>;
    case MXU2IND: return (const void*)step_kernel<MXU2IND>;
    default: return nullptr;
  }
}

}  // namespace

// stream: (16, steps * 128) f32, 16-byte aligned; blk: (steps,) int32
// window per step; partial: (ctas, 256, 128) f32 scratch, 1 <= ctas <=
// steps; out: (256, 128) f32, written (not accumulated). Launches the
// persistent kernel and its fixed-order sum on `s`.
extern "C" int probe_step(const float* stream, const int* blk, int body,
                          int steps, int ctas, float* partial, float* out,
                          cudaStream_t s) {
  if (steps < 1 || ctas < 1 || ctas > steps ||
      (steps + ctas - 1) / ctas > MAX_CTA_STEPS)
    return (int)cudaErrorInvalidValue;
  switch (body) {
    case EMPTY: return launch<EMPTY>(stream, blk, steps, ctas, partial, out, s);
    case PASSTHRU:
      return launch<PASSTHRU>(stream, blk, steps, ctas, partial, out, s);
    case MXU: return launch<MXU>(stream, blk, steps, ctas, partial, out, s);
    case MXU2DEP:
      return launch<MXU2DEP>(stream, blk, steps, ctas, partial, out, s);
    case MXU2IND:
      return launch<MXU2IND>(stream, blk, steps, ctas, partial, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers per thread and resident blocks per SM of the persistent kernel
// for `body`, from the CUDA runtime.
extern "C" int probe_step_occupancy(int body, int* regs, int* blocks) {
  const void* k = kernel_of(body);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, k);
  if (rc != cudaSuccess) return (int)rc;
  *regs = a.numRegs;
  rc = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, THREADS,
                                                            SMEM_BYTES);
}
