// P2: elementwise op-rate probe, for sm_90a.
//
// Replaces the TPU probe kernel `_kernel` of tools/vpu_probe.py: a grid of
// `steps` blocks, each applying `reps` dependent elementwise ops to its
// (256, chunk) block of a (256, steps * chunk) array (block c owns columns
// [c * chunk, (c + 1) * chunk)). The chains are nonlinear, so the compiler
// cannot fold the reps into one op:
//   mul_add  x = x * x + 0.25          (f32: one FMA; bf16: mul, add)
//   where    x = x > 0.5 ? x * x : x + 0.25
//   exp      x = expf(x) * 0.5          (f32 only, as the tool)
//   log      x = logf(x * x + 0.5)
//   log1p    x = log1pf(x * 0.25)
//   roll     x = x * roll(x, 1, axis=1) * 0.5 + 0.7, jnp.roll's wrap-around
//            over the chunk axis: a warp shuffle, and for lane 0 the last
//            lane of the previous warp of the row through shared memory
// f32 chains may contract a multiply and an add into one FMA (the rate the
// card has). bf16 chains run on packed __nv_bfloat162 pairs (two adjacent
// columns per thread) and round after every op, as JAX does: multiplies are
// __hmul2_rn, which the compiler never contracts into an FMA.
//
// Threads cover `chunk` columns (chunk / 2 pairs in bf16) of 256 / (that)
// rows at a time; each thread carries PER rows at once, PER independent
// chains. Bound on an H100: at small reps the array's bytes over HBM (in
// once, out once); past that the FMA pipe (mul_add, where, roll), or the
// special-function unit and its polynomial (exp, log, log1p).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NPIX = 256;
constexpr int PER = 4;  // independent rows in flight per thread
enum Op { MUL_ADD, WHERE, EXP, LOG, LOG1P, ROLL, NOPS };

__device__ __forceinline__ float step(float x, float prev, int op) {
  switch (op) {
    case MUL_ADD: return x * x + 0.25f;
    case WHERE: return x > 0.5f ? x * x : x + 0.25f;
    case EXP: return expf(x) * 0.5f;
    case LOG: return logf(x * x + 0.5f);
    case LOG1P: return log1pf(x * 0.25f);
    default: return x * prev * 0.5f + 0.7f;  // ROLL
  }
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 from_bits(unsigned u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ __nv_bfloat162 step(__nv_bfloat162 x,
                                               __nv_bfloat162 prev, int op) {
  const __nv_bfloat162 c025 = __float2bfloat162_rn(0.25f);
  const __nv_bfloat162 c05 = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 c07 = __float2bfloat162_rn(0.7f);
  if (op == MUL_ADD) return __hadd2(__hmul2_rn(x, x), c025);
  if (op == WHERE) {
    const unsigned m = __vcmpne2(bits(__hgt2(x, c05)), 0u);  // 0xffff per lane
    return from_bits((bits(__hmul2_rn(x, x)) & m)
                     | (bits(__hadd2(x, c025)) & ~m));
  }
  // ROLL: the pair's left neighbours are (prev.hi, x.lo)
  const __nv_bfloat162 r = __halves2bfloat162(__high2bfloat16(prev),
                                              __low2bfloat16(x));
  return __hadd2(__hmul2_rn(__hmul2_rn(x, r), c05), c07);
}

__device__ __forceinline__ float shfl_up(float v) {
  return __shfl_up_sync(0xffffffffu, v, 1);
}

__device__ __forceinline__ __nv_bfloat162 shfl_up(__nv_bfloat162 v) {
  return from_bits(__shfl_up_sync(0xffffffffu, bits(v), 1));
}

// V: float, or __nv_bfloat162 (two columns). vchunk: V elements per row of
// the block (a multiple of 32, at most 256).
template <typename V, int OP>
__global__ void __launch_bounds__(NPIX)
ops_kernel(const V* __restrict__ x, V* __restrict__ out, int reps,
           int vchunk, int64_t row_stride) {
  __shared__ V edge[PER][NPIX / 32];  // the last lane of each warp
  const int rows_per_pass = NPIX / vchunk;
  const int col = threadIdx.x % vchunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps_per_row = vchunk / 32;
  const int left = warp - warp % warps_per_row
                   + (warp % warps_per_row + warps_per_row - 1) % warps_per_row;
  const int64_t base = (int64_t)blockIdx.x * vchunk + col;
  for (int r0 = threadIdx.x / vchunk; r0 < NPIX; r0 += rows_per_pass * PER) {
    V v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      v[k] = x[(int64_t)(r0 + k * rows_per_pass) * row_stride + base];
#pragma unroll 2
    for (int i = 0; i < reps; ++i) {
      V prev[PER];
      if (OP == ROLL) {  // uniform over the block: every thread syncs
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          prev[k] = shfl_up(v[k]);
          if (lane == 31) edge[k][warp] = v[k];
        }
        __syncthreads();
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < PER; ++k) prev[k] = edge[k][left];
        }
        __syncthreads();
      } else {
#pragma unroll
        for (int k = 0; k < PER; ++k) prev[k] = v[k];
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] = step(v[k], prev[k], OP);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k)
      out[(int64_t)(r0 + k * rows_per_pass) * row_stride + base] = v[k];
  }
}

template <typename V>
int launch(const void* x, void* out, int op, int reps, int steps, int vchunk,
           cudaStream_t stream) {
  const V* xi = static_cast<const V*>(x);
  V* o = static_cast<V*>(out);
  const int64_t stride = (int64_t)steps * vchunk;
  switch (op) {
#define CASE(OPV)                                                            \
  case OPV:                                                                  \
    ops_kernel<V, OPV><<<steps, NPIX, 0, stream>>>(xi, o, reps, vchunk,      \
                                                   stride);                  \
    break;
    CASE(MUL_ADD) CASE(WHERE) CASE(EXP) CASE(LOG) CASE(LOG1P) CASE(ROLL)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (256, steps * chunk) row-major, f32 (bf16 = 0) or bf16 (bf16 = 1).
extern "C" int probe_ops(const void* x, int op, int bf16, int reps,
                         int steps, int chunk, void* out,
                         cudaStream_t stream) {
  const int vchunk = bf16 ? chunk / 2 : chunk;
  if (op < 0 || op >= NOPS || reps < 0 || steps < 1)
    return (int)cudaErrorInvalidValue;
  if (vchunk % 32 != 0 || vchunk > NPIX || (NPIX / vchunk) * PER > NPIX)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (op != MUL_ADD && op != WHERE && op != ROLL)
      return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat162>(x, out, op, reps, steps, vchunk, stream);
  }
  return launch<float>(x, out, op, reps, steps, vchunk, stream);
}
