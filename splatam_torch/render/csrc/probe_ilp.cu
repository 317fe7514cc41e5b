// P3: tensor-core / FMA overlap probe, for sm_90a.
//
// Replaces the TPU probe kernel `_kernel` of tools/ilp_probe.py. A grid of
// `steps` blocks; block c expands its (16, 128) input windows a, b (row 0
// only) into (256, 128) working sets x[i, j] = a[0, j] * i * 1e-3 (y from
// b), runs one case, and writes rows [0, 16) of x and y:
//   vpu       x = x * x * -0.5 + 0.6, 8 * reps times (the FMA chain)
//   mxu       x = pass(x) * 1e-3, reps times
//   chain     reps x (4 vpu -> pass * 1e-3 -> 4 vpu)
//   dual      chain on x and on y: the same mix as two independent chains
//   vpu_dual  vpu on x and on y
// pass(x) = x1 @ U + x2 @ U, the two-term bf16 split x1 = bf16(x),
// x2 = bf16(x - x1), of x times the upper-triangular 0/1 matrix U
// (U[k, n] = 1 for k <= n, a running sum over the row), each term summed
// in f32: a tensor-core pass of mma.sync m16n8k16 bf16 with f32
// accumulators. wgmma, the card's full tensor-core rate, is left for later.
//
// Rows are independent in every case (the pass mixes columns only), so each
// warp owns 16-row bands and keeps a band of x (and of y) in registers in
// the mma accumulator layout, 64 floats a thread. That layout is also the
// A-operand layout of the next pass, so the split needs no shuffles. The
// pass skips the blocks of U that are zero (column block m of the result
// needs x's column blocks k <= m only) and runs from the last column block
// down, so the split halves of x die as the result fills in. U's fragments
// are two constants per lane: all ones, and the diagonal block's pattern.
//
// Only band 0 (rows [0, 16), warp 0) is written; the other bands keep their
// work live through a test for NaN that never holds.
//
// Bound on an H100: the FMA pipe for the vector work (the mul and the FMA of
// each vpu op, the split and the scaling of each pass), the bf16 tensor-core
// rate for the passes' products (non-zero blocks of U), HBM for the windows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int NPIX = 256;
constexpr int NT = CHUNK / 8;    // n-tiles of 8 columns
constexpr int KB = CHUNK / 16;   // k-blocks of 16 columns
constexpr int WARPS = 8;
constexpr int BANDS = NPIX / 16;
enum Case { VPU, MXU, CHAIN, DUAL, VPU_DUAL, NCASES };

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low bits)
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

// B fragments of U for this lane: b0 holds U[k][n] for k = 2 (lane % 4) +
// {0, 1}, b1 for k + 8, n = lane / 4 (local to the 16 x 8 block).
struct Tri {
  unsigned ones, diag;  // all ones; the diagonal block's lower-k half
  __device__ Tri() {
    const int lane = threadIdx.x % 32;
    const int k = 2 * (lane % 4), n = lane / 4;
    ones = pack_bf16(1.0f, 1.0f);
    // in the diagonal k-block: n-tile 2m (n in 0..7) has b0 = [k <= n] and
    // b1 = 0 (k >= 8); n-tile 2m + 1 (n + 8) has b0 = 1 and b1 =
    // [k + 8 <= n + 8], the same pattern as the first one's b0
    diag = pack_bf16(k <= n ? 1.0f : 0.0f, k + 1 <= n ? 1.0f : 0.0f);
  }
};

__device__ __forceinline__ void vpu(float (&x)[NT][4], int n) {
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[t][e] = x[t][e] * x[t][e] * -0.5f + 0.6f;
}

// x = (x1 @ U + x2 @ U) * 1e-3, in place.
__device__ __forceinline__ void pass(float (&x)[NT][4], const Tri& u) {
  unsigned hi[KB][4], lo[KB][4];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int h = 0; h < 2; ++h)    // n-tile 2 kb + h: A regs 2h, 2h + 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows lane / 4, lane / 4 + 8
        const float v0 = x[2 * kb + h][2 * r], v1 = x[2 * kb + h][2 * r + 1];
        __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
        hi[kb][2 * h + r] = *reinterpret_cast<unsigned*>(&b);
        lo[kb][2 * h + r] = pack_bf16(v0 - __low2float(b), v1 - __high2float(b));
      }
#pragma unroll
  for (int m = KB - 1; m >= 0; --m) {
    float d1[2][4] = {}, d2[2][4] = {};
    // the diagonal block first: column blocks then share no chain of
    // partial sums that ptxas could merge into a running sum (it did, and
    // kept 53 of the 144 products of a band)
#pragma unroll
    for (int i = 0; i <= m; ++i) {
      const int kb = i == 0 ? m : i - 1;
      const bool diag = i == 0;
      const unsigned b00 = diag ? u.diag : u.ones, b01 = diag ? 0u : u.ones;
      const unsigned b10 = u.ones, b11 = diag ? u.diag : u.ones;
      mma(d1[0], hi[kb], b00, b01);
      mma(d1[1], hi[kb], b10, b11);
      mma(d2[0], lo[kb], b00, b01);
      mma(d2[1], lo[kb], b10, b11);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[2 * m + h][e] = (d1[h][e] + d2[h][e]) * 1e-3f;
  }
}

__device__ __forceinline__ void chain(float (&x)[NT][4], int reps,
                                      const Tri& u) {
  for (int i = 0; i < reps; ++i) {
    vpu(x, 4);
    pass(x, u);
    vpu(x, 4);
  }
}

__device__ __forceinline__ void expand(float (&x)[NT][4],
                                       const float* __restrict__ a,
                                       int64_t col0, int band) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = band * 16 + lane / 4 + (e >= 2 ? 8 : 0);
      const int col = t * 8 + 2 * (lane % 4) + (e & 1);
      x[t][e] = __fmul_rn(__fmul_rn(a[col0 + col], (float)row), 1e-3f);
    }
}

__device__ __forceinline__ void finish(const float (&x)[NT][4],
                                       float* __restrict__ o, int64_t col0,
                                       int band, int64_t stride) {
  const int lane = threadIdx.x % 32;
  if (band == 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = lane / 4 + (e >= 2 ? 8 : 0);
        o[row * stride + col0 + t * 8 + 2 * (lane % 4) + (e & 1)] = x[t][e];
      }
    return;
  }
  bool nan = false;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) nan |= x[t][e] != x[t][e];
  if (nan) o[col0] = CUDART_NAN_F;  // never: the band's work stays live
}

template <int CASE>
__global__ void __launch_bounds__(WARPS * 32)
ilp_kernel(const float* __restrict__ a, const float* __restrict__ b, int reps,
           int64_t stride, float* __restrict__ oa, float* __restrict__ ob) {
  const Tri u;
  const int64_t col0 = (int64_t)blockIdx.x * CHUNK;
  for (int band = threadIdx.x / 32; band < BANDS; band += WARPS) {
    float x[NT][4], y[NT][4];
    expand(x, a, col0, band);
    expand(y, b, col0, band);
    if (CASE == VPU) {
      vpu(x, 8 * reps);
    } else if (CASE == MXU) {
      for (int i = 0; i < reps; ++i) pass(x, u);
    } else if (CASE == CHAIN) {
      chain(x, reps, u);
    } else if (CASE == DUAL) {  // two independent chains, interleaved
      for (int i = 0; i < reps; ++i) {
        vpu(x, 4);
        vpu(y, 4);
        pass(x, u);
        pass(y, u);
        vpu(x, 4);
        vpu(y, 4);
      }
    } else {  // VPU_DUAL
      for (int i = 0; i < 8 * reps; ++i) {
        vpu(x, 1);
        vpu(y, 1);
      }
    }
    finish(x, oa, col0, band, stride);
    finish(y, ob, col0, band, stride);
  }
}

}  // namespace

// a, b, oa, ob: (16, steps * 128) row-major f32; rows [1, 16) of a and b
// are not read, as in the TPU kernel.
extern "C" int probe_ilp(const float* a, const float* b, int kase, int reps,
                         int steps, float* oa, float* ob,
                         cudaStream_t stream) {
  if (kase < 0 || kase >= NCASES || reps < 0 || steps < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t stride = (int64_t)steps * CHUNK;
  switch (kase) {
#define CASE(K)                                                              \
  case K:                                                                    \
    ilp_kernel<K><<<steps, WARPS * 32, 0, stream>>>(a, b, reps, stride, oa,  \
                                                    ob);                     \
    break;
    CASE(VPU) CASE(MXU) CASE(CHAIN) CASE(DUAL) CASE(VPU_DUAL)
#undef CASE
  }
  return (int)cudaGetLastError();
}
