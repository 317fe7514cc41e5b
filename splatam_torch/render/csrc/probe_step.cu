// P4: per-block overhead probe, for sm_90a.
//
// Replaces the TPU probe kernel of tools/step_overhead.py (`make_pf`'s
// `kernel`) at the tool's chunk, 128: a grid of `steps` blocks, block c
// reading its (16, 128) window of a (16, steps * 128) stream at column
// blk[c] * 128 through an index table (the TPU's scalar-prefetched `blk`),
// and adding a (256, 128) product into one (256, 128) f32 output: out = sum
// over blocks of
//   empty     nothing: the block starts and ends (pure per-block cost)
//   passthru  bcast(0), the window's row 0 on all 256 rows
//   mxu       bcast(0) @ L
//   mxu2dep   bf16(bcast(0) @ L * 1e-3) @ L, two dependent products
//   mxu2ind   bcast(0) @ L + bcast(1) @ L, two independent products
// with L the lower-triangular 0/1 matrix (L[k, n] = 1 for n <= k, a suffix
// sum over the row). The products run on the tensor cores (mma.sync
// m16n8k16) with bf16 operands, as Precision.DEFAULT rounds them on a TPU,
// and f32 sums; each 16 x 8 output tile skips the k-blocks where L is zero.
// The tool's `mxu512` (one (512, chunk) matmul of both rows against
// mxu2ind's two) has no counterpart: on the tensor cores both are the same
// mma instructions.
//
// The TPU carried the sum across its sequential grid in scratch memory.
// Blocks run concurrently here, so every block adds its whole product into
// the output with atomicAdd (the order of the sums varies from run to
// run): the counterpart of the TPU's per-step accumulate, and part of each
// non-empty body's per-block time. Warp w owns rows [32 w, 32 w + 32).
//
// Bound on an H100: the bf16 tensor-core rate for the products (non-zero
// blocks of L), HBM for the windows, and the atomic adds into L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NPIX = 256;
constexpr int CHUNK = 128;
constexpr int NT = CHUNK / 8, KB = CHUNK / 16;  // n-tiles, k-blocks
constexpr int WIN_ROWS = 16;
constexpr int WARPS = 8;
enum Body { EMPTY, PASSTHRU, MXU, MXU2DEP, MXU2IND, NBODIES };

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ void mma(float* d, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of L for this lane (b0: k = 2 (lane % 4) + {0, 1}; b1: k + 8;
// n = lane / 4, local to the block). In the diagonal k-block m of n-tile
// 2m, b0 = [n <= k] and b1 = 1; of n-tile 2m + 1, b0 = 0 and b1 =
// [n + 8 <= k + 8]. Below the diagonal (k-block > m) all ones.
struct Tril {
  unsigned ones, diag;
  __device__ Tril() {
    const int lane = threadIdx.x % 32;
    const int k = 2 * (lane % 4), n = lane / 4;
    ones = pack_bf16(1.0f, 1.0f);
    diag = pack_bf16(n <= k ? 1.0f : 0.0f, n <= k + 1 ? 1.0f : 0.0f);
  }
  __device__ __forceinline__ void frag(int kb, int nt, unsigned& b0,
                                       unsigned& b1) const {
    if (kb > nt / 2) {
      b0 = b1 = ones;
    } else if (nt % 2 == 0) {
      b0 = diag;
      b1 = ones;
    } else {
      b0 = 0u;
      b1 = diag;
    }
  }
};

// A fragments of one window row broadcast to 16 rows: rows lane / 4 and
// lane / 4 + 8 hold the same values.
__device__ __forceinline__ void row_frags(const float* w, unsigned (&a)[KB][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const int k = kb * 16 + 2 * (lane % 4);
    a[kb][0] = a[kb][1] = pack_bf16(w[k], w[k + 1]);
    a[kb][2] = a[kb][3] = pack_bf16(w[k + 8], w[k + 9]);
  }
}

// d (one 16 x 8 tile, n-tile nt) += A @ L over the k-blocks where L is not
// zero.
__device__ __forceinline__ void tile_product(float* d,
                                             const unsigned (&a)[KB][4],
                                             int nt, const Tril& l) {
#pragma unroll
  for (int kb = nt / 2; kb < KB; ++kb) {
    unsigned b0, b1;
    l.frag(kb, nt, b0, b1);
    mma(d, a[kb], b0, b1);
  }
}

// Add one 16 x 8 accumulator tile (rows row0 + lane / 4 (+ 8), n-tile nt)
// into the output.
__device__ __forceinline__ void add_tile(float* __restrict__ out, int row0,
                                         int nt, const float* d) {
  const int lane = threadIdx.x % 32;
  const int col = nt * 8 + 2 * (lane % 4);
  float* o = out + (int64_t)(row0 + lane / 4) * CHUNK + col;
  atomicAdd(o, d[0]);
  atomicAdd(o + 1, d[1]);
  atomicAdd(o + 8 * CHUNK, d[2]);
  atomicAdd(o + 8 * CHUNK + 1, d[3]);
}

template <int BODY>
__global__ void __launch_bounds__(WARPS * 32)
step_kernel(const float* __restrict__ stream, const int* __restrict__ blk,
            int64_t stride, float* __restrict__ out) {
  if (BODY == EMPTY) return;
  __shared__ float win[WIN_ROWS * CHUNK];
  const int64_t col0 = (int64_t)blk[blockIdx.x] * CHUNK;
  for (int i = threadIdx.x; i < WIN_ROWS * CHUNK; i += blockDim.x)
    win[i] = stream[(i / CHUNK) * stride + col0 + i % CHUNK];
  __syncthreads();
  if (BODY == PASSTHRU) {
    for (int i = threadIdx.x; i < NPIX * CHUNK; i += blockDim.x)
      atomicAdd(out + i, win[i % CHUNK]);
    return;
  }
  const Tril l;
  const int warp = threadIdx.x / 32;
  unsigned a0[KB][4], a1[KB][4];
  row_frags(win, a0);
  if (BODY == MXU2IND) row_frags(win + CHUNK, a1);
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int row0 = warp * 32 + mt * 16;
    if (BODY == MXU2DEP) {  // y = A @ L for the whole band, then its A frags
      float y[NT][4] = {};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tile_product(y[nt], a0, nt, l);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            a1[kb][2 * h + r] = pack_bf16(y[2 * kb + h][2 * r] * 1e-3f,
                                          y[2 * kb + h][2 * r + 1] * 1e-3f);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4] = {};
      if (BODY == MXU) {
        tile_product(d, a0, nt, l);
      } else if (BODY == MXU2DEP) {
        tile_product(d, a1, nt, l);
      } else {  // MXU2IND: two products, added in f32
        float d1[4] = {};
        tile_product(d, a0, nt, l);
        tile_product(d1, a1, nt, l);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] += d1[e];
      }
      add_tile(out, row0, nt, d);
    }
  }
}

}  // namespace

// stream: (16, steps * 128) f32; blk: (steps,) int32 window per block;
// out: (256, 128) f32, zeroed by the caller, which the blocks add into.
extern "C" int probe_step(const float* stream, const int* blk, int body,
                          int steps, float* out, cudaStream_t s) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  const int64_t stride = (int64_t)steps * CHUNK;
  switch (body) {
#define CASE(B)                                                             \
  case B:                                                                   \
    step_kernel<B><<<steps, WARPS * 32, 0, s>>>(stream, blk, stride, out);  \
    break;
    CASE(EMPTY) CASE(PASSTHRU) CASE(MXU) CASE(MXU2DEP) CASE(MXU2IND)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
