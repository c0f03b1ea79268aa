// Fused MRC combining + equalization + max-log LLR demap, one thread per RE.
//
// Replaces the TPU kernel openair4g_tpu/ops/equalize_llr.py
// (_make_kernel / _build_call / mrc_llr_pallas). Per RE:
//   num = sum_a y_a conj(h_a),  h2 = max(sum_a |h_a|^2, 1e-12)
//   metric(l) = -(num - l h2)^2 / (h2 n0)      per Gray-PAM level l, I and Q
//   llr_b = max_{l: bit_b(l)=0} metric - max_{l: bit_b(l)=1} metric
// written in the bit order b0(I), b1(Q), b2(I), ... of ops/llr.demap_llr.
// The equalized symbol num/h2 and the effective noise n0/h2 are never
// stored. The TPU kernel pre-scaled y and h by rsqrt(n0) only to avoid a
// kernel operand; here n0 is read directly, per RE, as n0[i % n0_period],
// so a per-data-RE noise vector broadcasts over the batch without being
// materialized.
//
// What bounds it: device memory. Per RE it reads 16 A + 4 bytes and writes
// 4 Qm bytes for about 10 + 3 * 2^(Qm/2) float operations, far below the
// card's operations-per-byte balance; one thread per RE with contiguous
// complex64 loads keeps the traffic at that minimum.
#include <cuda_runtime.h>

namespace {

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

template <int A, int QM>
__global__ void __launch_bounds__(256)
mrc_llr_kernel(const float2* __restrict__ y, const float2* __restrict__ h,
               const float* __restrict__ n0, float* __restrict__ out,
               long long n, long long n0_period) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float num_re = 0.f, num_im = 0.f, h2 = 0.f;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float2 yy = y[i * A + a];
    const float2 hh = h[i * A + a];
    num_re += yy.x * hh.x + yy.y * hh.y;
    num_im += yy.y * hh.x - yy.x * hh.y;
    h2 += hh.x * hh.x + hh.y * hh.y;
  }
  h2 = fmaxf(h2, 1e-12f);
  const float inv = 1.0f / (h2 * n0[n0_period == 1 ? 0 : i % n0_period]);
  constexpr int NB = QM / 2;
  constexpr int NL = 1 << NB;
  float* o = out + i * QM;
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const float v = axis ? num_im : num_re;
    float m[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const float d = v - level(QM, j) * h2;
      m[j] = -(d * d) * inv;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        if ((j >> (NB - 1 - b)) & 1) m1 = fmaxf(m1, m[j]);
        else m0 = fmaxf(m0, m[j]);
      }
      o[2 * b + axis] = m0 - m1;
    }
  }
}

template <int A, int QM>
void launch(const void* y, const void* h, const void* n0, void* out,
            long long n, long long period, cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  mrc_llr_kernel<A, QM><<<(unsigned)blocks, 256, 0, st>>>(
      (const float2*)y, (const float2*)h, (const float*)n0, (float*)out, n,
      period);
}

// Max-log demap of an already equalized stream with per-RE noise, one
// thread per RE: metric(l) = -(x - l)^2 / n0 per Gray-PAM level, the
// bit order of mrc_llr_kernel.
//
// Replaces the demap_llr_fused entry of the same TPU kernel
// (openair4g_tpu/ops/equalize_llr.py:138, mrc_llr_pallas with A = 1 and a
// ones tensor for h, x and h pre-scaled by rsqrt(n0)). Here there is no h
// operand at all and n0 is read as it is. x and n0 are read at element
// strides xs and ns, so one layer of a [..., 2] MMSE output is read in
// place, without a copy: x[i * xs], n0[(i % n0_period) * ns].
//
// What bounds it: device memory, as mrc_llr (8 + 4 bytes in, 4 Qm out per
// RE). With xs = 2 a warp's complex64 loads touch every other 8-byte
// element, so half of each fetched sector is the other layer's, which the
// second layer's pass then reads again from L2.
template <int QM>
__global__ void __launch_bounds__(256)
demap_llr_kernel(const float2* __restrict__ x, const float* __restrict__ n0,
                 float* __restrict__ out, long long n, long long xs,
                 long long ns, long long n0_period) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float2 v = x[i * xs];
  const float inv = 1.0f / n0[(n0_period == n ? i : i % n0_period) * ns];
  constexpr int NB = QM / 2;
  constexpr int NL = 1 << NB;
  float* o = out + i * QM;
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const float a = axis ? v.y : v.x;
    float m[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const float d = a - level(QM, j);
      m[j] = -(d * d) * inv;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        if ((j >> (NB - 1 - b)) & 1) m1 = fmaxf(m1, m[j]);
        else m0 = fmaxf(m0, m[j]);
      }
      o[2 * b + axis] = m0 - m1;
    }
  }
}

template <int QM>
void launch_demap(const void* x, const void* n0, void* out, long long n,
                  long long xs, long long ns, long long period,
                  cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  demap_llr_kernel<QM><<<(unsigned)blocks, 256, 0, st>>>(
      (const float2*)x, (const float*)n0, (float*)out, n, xs, ns, period);
}

}  // namespace

// y, h: [n, A] interleaved complex64; n0: [n0_period] float32 with
// n0_period dividing n; out: [n, Qm] float32. Returns cudaGetLastError().
extern "C" int mrc_llr_launch(const void* y, const void* h, const void* n0,
                              void* out, long long n, long long n0_period,
                              int A, int Qm, void* stream) {
  if (n <= 0 || n0_period <= 0 || n % n0_period != 0 || n / 256 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int key = A * 10 + Qm;
  switch (key) {
    case 12: launch<1, 2>(y, h, n0, out, n, n0_period, st); break;
    case 14: launch<1, 4>(y, h, n0, out, n, n0_period, st); break;
    case 16: launch<1, 6>(y, h, n0, out, n, n0_period, st); break;
    case 22: launch<2, 2>(y, h, n0, out, n, n0_period, st); break;
    case 24: launch<2, 4>(y, h, n0, out, n, n0_period, st); break;
    case 26: launch<2, 6>(y, h, n0, out, n, n0_period, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: n complex64 at element stride xs; n0: float32, element (i % n0_period)
// at stride ns, n0_period dividing n; out: [n, Qm] float32.
// Returns cudaGetLastError().
extern "C" int demap_llr_launch(const void* x, const void* n0, void* out,
                                long long n, long long xs, long long ns,
                                long long n0_period, int Qm, void* stream) {
  if (n <= 0 || xs <= 0 || ns <= 0 || n0_period <= 0 || n % n0_period != 0 ||
      n / 256 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Qm) {
    case 2: launch_demap<2>(x, n0, out, n, xs, ns, n0_period, st); break;
    case 4: launch_demap<4>(x, n0, out, n, xs, ns, n0_period, st); break;
    case 6: launch_demap<6>(x, n0, out, n, xs, ns, n0_period, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
