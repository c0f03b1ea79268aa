// Fused MRC combining + equalization + max-log LLR demap.
//
// Replaces the TPU kernel openair4g_tpu/ops/equalize_llr.py
// (_make_kernel / _build_call / mrc_llr_pallas). Per RE:
//   num = sum_a y_a conj(h_a),  h2 = max(sum_a |h_a|^2, 1e-12)
//   metric(l) = -(num - l h2)^2 / (h2 n0)      per Gray-PAM level l, I and Q
//   llr_b = max_{l: bit_b(l)=0} metric - max_{l: bit_b(l)=1} metric
// written in the bit order b0(I), b1(Q), b2(I), ... of ops/llr.demap_llr.
// The equalized symbol num/h2 and the effective noise n0/h2 are never
// stored. The TPU kernel pre-scaled y and h by rsqrt(n0) only to avoid a
// kernel operand; here n0 is read directly.
//
// What bounds it: device memory. Per RE it reads 16 A + 4 bytes and writes
// 4 Qm bytes for about 10 + 3 * 2^(Qm/2) float operations, far below the
// card's operations-per-byte balance. At the control channel's shapes (0.1
// to 0.25 M REs, one or two waves of blocks) the bytes take under a
// microsecond and what any launch costs on the card is the time.
//
// Design: one RE a thread, and the REs walked as [rows, cols]: the wrapper
// splits the leading shape so that y, h and n0 each have one row stride and
// one RE stride (and y, h one antenna stride), in elements. That one form
// serves interleaved [n, A] tensors, [B, A, N] antenna planes read where
// they lie (no interleaving copy ahead of the call), and every n0: a number
// (a kernel argument: no tensor, no fill launch), one value an RE of a row
// (row stride 0), one a row (RE stride 0) or one for each RE of each row.
// The RE index comes from blockIdx.x and the row index from blockIdx.y (and
// blockIdx.z past 65,535 rows of blocks), both 32-bit, so no thread divides:
// a per-RE n0 of period cols is read as n0[i], not n0[i % period]. Each
// thread serves one (row, RE) and returns; a loop over rows inside the
// kernel, which a grid-stride form would have, cost 1 to 10 % of the device
// time at the downlink's shapes on an NVIDIA H100 80GB HBM3 at 700 W.
// Blocks have 256 threads, bx along the REs and 256 / bx rows, bx the
// smallest power of two that covers a row, so short rows still fill their
// warps. A thread loads its RE's complex64 values as 8-byte vectors and
// stores its Qm LLRs as 8-byte vectors (16-byte ones at Qm 4); L2 merges a
// warp's stores into whole sectors.
//
// Measured on the same card and not taken: two REs a thread with 16-byte
// loads and float4 stores read no faster at the data shapes and slower at
// demap_llr's, and 128 or 512 threads a block and streaming (evict-first)
// cache hints move the data shapes by under 3 % either way. At 80 to 85 %
// of the bytes bound these shapes run faster than a device-to-device copy
// of the same bytes.
//
// Every float operation of an RE is written as a rounding intrinsic
// (__fmaf_rn, __fmul_rn, ...), which the compiler neither fuses nor splits:
// left to itself it contracts a * b + c * d into one of two FMAs, and chose
// differently in two instantiations of this arithmetic, whose LLRs then
// differed in the last bit. So the LLRs of an RE do not depend on the
// layout it was read from. Against the compiler's own contraction the
// intrinsics cost no device time that showed.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // a block

// Gray-PAM level j of one axis (axis bits MSB-first in j), unit-energy
// 36.211 constellations: QPSK 1/sqrt2; 16QAM {1,3}/sqrt10; 64QAM
// {3,1,5,7}/sqrt42 (ring bits select the amplitude as in ops/llr.map_symbols).
__host__ __device__ constexpr float level(int qm, int j) {
  const int nb = qm / 2;
  const int b0 = (j >> (nb - 1)) & 1;
  const double sgn = 1.0 - 2.0 * b0;
  if (nb == 1) return (float)(sgn * 0.70710678118654752440);
  if (nb == 2) {
    const int b1 = j & 1;
    return (float)(sgn * (2.0 - (1.0 - 2.0 * b1)) * 0.31622776601683793320);
  }
  const int b1 = (j >> 1) & 1, b2 = j & 1;
  return (float)(sgn * (4.0 - (1.0 - 2.0 * b1) * (2.0 - (1.0 - 2.0 * b2)))
                 * 0.15430334996209191026);
}

// The QM max-log LLRs of one RE into o: metric(l) = -(v - l h2)^2 inv on
// each axis of v = (re, im), d = v - l h2 as one FMA.
template <int QM>
__device__ __forceinline__ void llrs(float re, float im, float h2, float inv,
                                     float* o) {
  constexpr int NB = QM / 2;
  constexpr int NL = 1 << NB;
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const float v = axis ? im : re;
    float m[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const float d = __fmaf_rn(-level(QM, j), h2, v);
      m[j] = __fmul_rn(-__fmul_rn(d, d), inv);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        if ((j >> (NB - 1 - b)) & 1) m1 = fmaxf(m1, m[j]);
        else m0 = fmaxf(m0, m[j]);
      }
      o[2 * b + axis] = __fsub_rn(m0, m1);
    }
  }
}

// N floats to p (N even, p 8-byte aligned): float4s when N is a multiple
// of 4 (p then 16-byte aligned), else float2s.
template <int N>
__device__ __forceinline__ void store_llrs(float* p, const float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; ++k)
      reinterpret_cast<float2*>(p)[k] = make_float2(o[2 * k], o[2 * k + 1]);
  }
}

// The row a thread serves: blocks of rows along the grid's y, and along its
// z where y's 65,535 do not hold them (grid_for).
__device__ __forceinline__ unsigned row_of_thread() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * blockDim.y + threadIdx.y;
}

// Strides in elements: b a row, r an RE, a an antenna. n0 null: n0_scalar.
struct MrcArgs {
  const float2* y;
  const float2* h;
  const float* n0;
  float* out;
  float n0_scalar;
  int rows, cols;
  long long yb, yr, ya, hb, hr, ha, nb, nr;
};

template <int A, int QM>
__global__ void __launch_bounds__(kThreads) mrc_llr_kernel(const MrcArgs p) {
  const float2* __restrict__ y = p.y;
  const float2* __restrict__ h = p.h;
  const float* __restrict__ n0 = p.n0;
  float* __restrict__ out = p.out;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned r = row_of_thread();
  if (i >= p.cols || r >= (unsigned)p.rows) return;
  const float2* yp = y + r * p.yb + i * p.yr;
  const float2* hp = h + r * p.hb + i * p.hr;
  float num_re = 0.f, num_im = 0.f, h2 = 0.f;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float2 u = yp[a * p.ya], g = hp[a * p.ha];
    num_re = __fadd_rn(num_re, __fmaf_rn(u.y, g.y, __fmul_rn(u.x, g.x)));
    num_im = __fadd_rn(num_im, __fmaf_rn(u.y, g.x, -__fmul_rn(u.x, g.y)));
    h2 = __fadd_rn(h2, __fmaf_rn(g.y, g.y, __fmul_rn(g.x, g.x)));
  }
  h2 = fmaxf(h2, 1e-12f);
  const float n0v = n0 ? n0[r * p.nb + i * p.nr] : p.n0_scalar;
  float o[QM];
  llrs<QM>(num_re, num_im, h2, __fdiv_rn(1.0f, __fmul_rn(h2, n0v)), o);
  store_llrs<QM>(out + ((long long)r * p.cols + i) * QM, o);
}

// Max-log demap of an already equalized stream with per-RE noise:
// metric(l) = -(x - l)^2 / n0 per Gray-PAM level, the bit order of
// mrc_llr_kernel.
//
// Replaces the demap_llr_fused entry of the same TPU kernel
// (openair4g_tpu/ops/equalize_llr.py:138, mrc_llr_pallas with A = 1 and a
// ones tensor for h, x and h pre-scaled by rsqrt(n0)). Here there is no h
// operand at all and n0 is read as it is. x and n0 are walked as
// [rows, cols] with a row and an RE stride each, as in mrc_llr_kernel, so
// one layer of a [..., 2] MMSE output is read in place, without a copy.
//
// What bounds it: device memory, as mrc_llr (8 + 4 bytes in, 4 Qm out per
// RE); one RE a thread, as there. At RE stride 2 a warp's loads touch every
// other 8-byte element, so half of each fetched sector is the other
// layer's, which that layer's call then reads again from L2.
struct DemapArgs {
  const float2* x;
  const float* n0;
  float* out;
  float n0_scalar;
  int rows, cols;
  long long xb, xr, nb, nr;
};

template <int QM>
__global__ void __launch_bounds__(kThreads) demap_llr_kernel(const DemapArgs p) {
  const float2* __restrict__ x = p.x;
  const float* __restrict__ n0 = p.n0;
  float* __restrict__ out = p.out;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned r = row_of_thread();
  if (i >= p.cols || r >= (unsigned)p.rows) return;
  const float2 v = x[r * p.xb + i * p.xr];
  const float n0v = n0 ? n0[r * p.nb + i * p.nr] : p.n0_scalar;
  float o[QM];
  llrs<QM>(v.x, v.y, 1.0f, __fdiv_rn(1.0f, n0v), o);
  store_llrs<QM>(out + ((long long)r * p.cols + i) * QM, o);
}

__global__ void empty_kernel() {}

// Blocks of kThreads threads: bx along a row's REs, the smallest power of
// two that covers the row, and the rest rows; the blocks of rows along the
// grid's y, split over its z where there are more than 65,535. False for a
// shape the kernels' 32-bit indices do not hold.
bool grid_for(long long rows, long long cols, dim3* grid, dim3* block) {
  if (rows <= 0 || cols <= 0 || rows >= (1LL << 31) || cols > (1LL << 30))
    return false;
  int bx = kThreads;
  while (bx > 1 && bx / 2 >= cols) bx /= 2;
  const int by = kThreads / bx;
  const long long row_blocks = (rows + by - 1) / by;
  const long long gz = (row_blocks + 65534) / 65535;
  *block = dim3(bx, by);
  *grid = dim3((unsigned)((cols + bx - 1) / bx),
               (unsigned)((row_blocks + gz - 1) / gz), (unsigned)gz);
  return true;
}

}  // namespace

// y, h: complex64, element (row r, RE i, antenna a) at r * yb + i * yr +
// a * ya (h: hb, hr, ha); n0: float32 at r * nb + i * nr, or null for the
// number n0_scalar; out: [rows * cols, Qm] float32. Returns
// cudaGetLastError().
extern "C" int mrc_llr_launch(const void* y, const void* h, const void* n0,
                              float n0_scalar, void* out, long long rows,
                              long long cols, long long yb, long long yr,
                              long long ya, long long hb, long long hr,
                              long long ha, long long nb, long long nr, int A,
                              int Qm, void* stream) {
  dim3 grid, block;
  if (!grid_for(rows, cols, &grid, &block)) return (int)cudaErrorInvalidValue;
  const MrcArgs p{(const float2*)y, (const float2*)h, (const float*)n0,
                  (float*)out, n0_scalar, (int)rows, (int)cols,
                  yb, yr, ya, hb, hr, ha, nb, nr};
  cudaStream_t st = (cudaStream_t)stream;
  switch (A * 10 + Qm) {
    case 12: mrc_llr_kernel<1, 2><<<grid, block, 0, st>>>(p); break;
    case 14: mrc_llr_kernel<1, 4><<<grid, block, 0, st>>>(p); break;
    case 16: mrc_llr_kernel<1, 6><<<grid, block, 0, st>>>(p); break;
    case 22: mrc_llr_kernel<2, 2><<<grid, block, 0, st>>>(p); break;
    case 24: mrc_llr_kernel<2, 4><<<grid, block, 0, st>>>(p); break;
    case 26: mrc_llr_kernel<2, 6><<<grid, block, 0, st>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: complex64, element (row r, RE i) at r * xb + i * xr; n0 and out as in
// mrc_llr_launch. Returns cudaGetLastError().
extern "C" int demap_llr_launch(const void* x, const void* n0,
                                float n0_scalar, void* out, long long rows,
                                long long cols, long long xb, long long xr,
                                long long nb, long long nr, int Qm,
                                void* stream) {
  dim3 grid, block;
  if (!grid_for(rows, cols, &grid, &block)) return (int)cudaErrorInvalidValue;
  const DemapArgs p{(const float2*)x, (const float*)n0, (float*)out,
                    n0_scalar, (int)rows, (int)cols, xb, xr, nb, nr};
  cudaStream_t st = (cudaStream_t)stream;
  switch (Qm) {
    case 2: demap_llr_kernel<2><<<grid, block, 0, st>>>(p); break;
    case 4: demap_llr_kernel<4><<<grid, block, 0, st>>>(p); break;
    case 6: demap_llr_kernel<6><<<grid, block, 0, st>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// An empty <<<1, 32>>> launch: what any kernel costs on the card, the
// yardstick for the few-microsecond shapes above.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
