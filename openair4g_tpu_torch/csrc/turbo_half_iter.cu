// Windowed max-log-MAP half-iteration of the 36.212 8-state RSC
// (g0 = 1+D^2+D^3 feedback, g1 = 1+D+D^3).
//
// Replaces the TPU kernel openair4g_tpu/ops/turbo_pallas.py
// (_make_kernel_v2 / _build_call_v2 / half_iteration_pallas_v2) and computes
// what it computes, lane for lane:
//   * beta warm-up over the next window's head (BIG at the last window),
//   * main beta sweep, beta stored per node,
//   * alpha warm-up over the previous window's tail (window 0 starts
//     exactly in state 0),
//   * forward sweep emitting LLR = (max_{u=0}(a+gp+b') + gu) - (max_{u=1} - gu),
// with the metrics renormalized every R steps of each sweep, as the TPU
// kernel does (R = its unroll), so both give the same float32 sums.
//
// Design: one thread per (code block, window) lane; the 8 alpha and 8 beta
// metrics live in registers. The thread reads the [B, N] LLR rows directly
// at computed offsets (main row t of window w is g[b, w*W + t], its alpha
// warm-up g[b, w*W - U + t], its beta tail g[b, (w+1)*W + t]), so no
// t-major frames or transposes exist. The per-lane beta stack
// ((W+1) x 8 x 4 B, 7.7 KB at W = 240) is too large to keep in shared memory
// for many lanes per block; it goes to a global scratch [W+1, 8, L] in
// lane-minor order (neighbouring threads on neighbouring addresses), which
// the wrapper allocates: 260 MB at the 20 MHz flagship (L = 33,792).
//
// What bounds it: each lane is a serial recursion of 2 (W + U) trellis steps
// of ~50 dependent float operations, so the kernel is latency-bound, with
// L / 128 blocks of 128 threads to hide that latency across the card.
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e9f;
constexpr float BIG = 1e4f;

// Closed-form trellis (same formulas as turbo_pallas.py:20-26).
__host__ __device__ constexpr int next0(int s) { return ((((s >> 1) ^ s) & 1) << 2) | (s >> 1); }
__host__ __device__ constexpr int next1(int s) { return (((((s >> 1) ^ s) ^ 1) & 1) << 2) | (s >> 1); }
// parity of the u=0 branch out of s (flips for u=1)
__host__ __device__ constexpr bool par0(int s) { return (((s >> 2) ^ (s >> 1)) & 1) != 0; }
// incoming branch j=0 of s' comes from 2*(s'&3); its input bit and parity
__host__ __device__ constexpr bool pred_u0(int s) { return (((s >> 2) ^ s) & 1) != 0; }
__host__ __device__ constexpr bool pred_z0(int s) { return (((s >> 2) ^ (s >> 1)) & 1) != 0; }

__device__ __forceinline__ void normalize(float* x) {
  float m = x[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) m = fmaxf(m, x[s]);
#pragma unroll
  for (int s = 0; s < 8; ++s) x[s] = x[s] - m;
}

__device__ __forceinline__ void beta_step(float* b, float gu, float gp) {
  float nb[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float gpt = par0(s) ? -gp : gp;
    const float c0 = (b[next0(s)] + gu) + gpt;
    const float c1 = (b[next1(s)] - gu) - gpt;
    nb[s] = fmaxf(c0, c1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = nb[s];
}

__device__ __forceinline__ void alpha_step(float* a, float gu, float gp) {
  float na[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float base = (pred_u0(s) ? -gu : gu) + (pred_z0(s) ? -gp : gp);
    const int p = 2 * (s & 3);
    na[s] = fmaxf(a[p] + base, a[p + 1] - base);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = na[s];
}

template <int R>
__global__ void __launch_bounds__(128)
turbo_half_iter_kernel(const float* __restrict__ lin, const float* __restrict__ lp,
                       float* __restrict__ out, float* __restrict__ scr,
                       int n_w, int W, int U, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int w = lane % n_w;
  const long long row = (long long)(lane / n_w) * n_w * W;
  const float* gu_row = lin + row;
  const float* gp_row = lp + row;
  float* o_row = out + row;
  const int base = w * W;
  const bool last = (w == n_w - 1);

  // ---- beta warm-up over the next window's head, reversed ----
  float beta[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = 0.f;
  for (int i = 0; i < U / R; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = U - 1 - (i * R + r);
      const float gu = last ? BIG : 0.5f * gu_row[base + W + t];
      const float gp = last ? BIG : 0.5f * gp_row[base + W + t];
      beta_step(beta, gu, gp);
    }
    normalize(beta);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) scr[((long long)W * 8 + s) * L + lane] = beta[s];

  // ---- main beta sweep, reversed; beta at node t stored before the
  // block's renormalization, as in the TPU kernel ----
  for (int i = 0; i < W / R; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = W - 1 - (i * R + r);
      beta_step(beta, 0.5f * gu_row[base + t], 0.5f * gp_row[base + t]);
#pragma unroll
      for (int s = 0; s < 8; ++s) scr[((long long)t * 8 + s) * L + lane] = beta[s];
    }
    normalize(beta);
  }

  // ---- alpha warm-up over the previous window's tail ----
  float alpha[8];
  if (w == 0) {
    alpha[0] = 0.f;
#pragma unroll
    for (int s = 1; s < 8; ++s) alpha[s] = NEG;
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) alpha[s] = 0.f;
    for (int i = 0; i < U / R; ++i) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = i * R + r;
        alpha_step(alpha, 0.5f * gu_row[base - U + t], 0.5f * gp_row[base - U + t]);
      }
      normalize(alpha);
    }
  }

  // ---- forward sweep with the fused LLR ----
  for (int i = 0; i < W / R; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tau = i * R + r;
      const float gu = 0.5f * gu_row[base + tau];
      const float gp = 0.5f * gp_row[base + tau];
      float bn[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) bn[s] = scr[((long long)(tau + 1) * 8 + s) * L + lane];
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float gpt = par0(s) ? -gp : gp;
        m0 = fmaxf(m0, (alpha[s] + gpt) + bn[next0(s)]);
        m1 = fmaxf(m1, (alpha[s] - gpt) + bn[next1(s)]);
      }
      o_row[base + tau] = (m0 + gu) - (m1 - gu);
      alpha_step(alpha, gu, gp);
    }
    normalize(alpha);
  }
}

// The v1 kernel: the same half-iteration from window-replicated t-major
// frames [T = W + U, L] (lane = block * n_w + window), built by the wrapper
// as the TPU kernel's host code builds them:
//   guf/gpf row t: position w*W - U + t (0 before the trellis start),
//   gub/gpb row t: position w*W + t (BIG past the end).
// Replaces openair4g_tpu/ops/turbo_pallas.py (_make_kernel / _build_call /
// half_iteration_pallas_prepped) and follows its body lane for lane:
//   * one backward sweep over all T rows from beta = 0, beta stored after
//     each row (before the block's renormalization) in scr [T, 8, L],
//   * forward warm-up over the U guf rows from alpha = 0; window 0 starts
//     exactly in state 0,
//   * forward work over W rows emitting (m0 + gu) - (m1 - gu) from
//     beta[tau + 1],
// renormalizing every R steps at the TPU kernel's points. It differs from
// the v2 kernel only in beta at node W (stored before, not after, the
// warm-up's last renormalization), which moves the LLR at a window's last
// node by float rounding.
//
// Design: one thread per lane as in v2; at a fixed row t, neighbouring
// lanes read neighbouring addresses of the t-major frames and of the
// lane-minor scratch, so every load and store of a warp coalesces. What
// bounds it: the serial recursion, as v2, plus the four frames' traffic
// (4 T L floats in, W L out, 16 T L scratch bytes written and read).
template <int R>
__global__ void __launch_bounds__(128)
turbo_half_iter_v1_kernel(const float* __restrict__ guf,
                          const float* __restrict__ gpf,
                          const float* __restrict__ gub,
                          const float* __restrict__ gpb,
                          float* __restrict__ out, float* __restrict__ scr,
                          int L, int n_w, int W, int U) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int T = W + U;
  const long long Ll = L;

  float beta[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = 0.f;
  for (int i = 0; i < T / R; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = T - 1 - (i * R + r);
      beta_step(beta, gub[t * Ll + lane], gpb[t * Ll + lane]);
#pragma unroll
      for (int s = 0; s < 8; ++s) scr[((long long)t * 8 + s) * Ll + lane] = beta[s];
    }
    normalize(beta);
  }

  float alpha[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) alpha[s] = 0.f;
  for (int i = 0; i < U / R; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = i * R + r;
      alpha_step(alpha, guf[t * Ll + lane], gpf[t * Ll + lane]);
    }
    normalize(alpha);
  }
  if (lane % n_w == 0) {
    alpha[0] = 0.f;
#pragma unroll
    for (int s = 1; s < 8; ++s) alpha[s] = NEG;
  }

  for (int i = 0; i < W / R; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tau = i * R + r;
      const float gu = gub[tau * Ll + lane];
      const float gp = gpb[tau * Ll + lane];
      float bn[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) bn[s] = scr[((long long)(tau + 1) * 8 + s) * Ll + lane];
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float gpt = par0(s) ? -gp : gp;
        m0 = fmaxf(m0, (alpha[s] + gpt) + bn[next0(s)]);
        m1 = fmaxf(m1, (alpha[s] - gpt) + bn[next1(s)]);
      }
      out[tau * Ll + lane] = (m0 + gu) - (m1 - gu);
      alpha_step(alpha, guf[(U + tau) * Ll + lane], gpf[(U + tau) * Ll + lane]);
    }
    normalize(alpha);
  }
}

}  // namespace

// guf, gpf, gub, gpb: [W+U, L] float32 t-major frames; out: [W, L];
// scr: [(W+U) * 8 * L] float32. Returns cudaGetLastError().
extern "C" int turbo_half_iter_v1_launch(const void* guf, const void* gpf,
                                         const void* gub, const void* gpb,
                                         void* out, void* scr, int L, int n_w,
                                         int W, int U, int R, void* stream) {
  if (L <= 0 || n_w <= 0 || L % n_w != 0 || W <= 0 || U <= 0 || U > W ||
      W % R != 0 || U % R != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(128), grid((L + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)guf;
  const float* b = (const float*)gpf;
  const float* c = (const float*)gub;
  const float* d = (const float*)gpb;
  float* o = (float*)out;
  float* s = (float*)scr;
  switch (R) {
    case 8: turbo_half_iter_v1_kernel<8><<<grid, block, 0, st>>>(a, b, c, d, o, s, L, n_w, W, U); break;
    case 4: turbo_half_iter_v1_kernel<4><<<grid, block, 0, st>>>(a, b, c, d, o, s, L, n_w, W, U); break;
    case 2: turbo_half_iter_v1_kernel<2><<<grid, block, 0, st>>>(a, b, c, d, o, s, L, n_w, W, U); break;
    case 1: turbo_half_iter_v1_kernel<1><<<grid, block, 0, st>>>(a, b, c, d, o, s, L, n_w, W, U); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// lin, lp, out: [B, n_w * W] float32 rows; scr: [(W+1) * 8 * B * n_w] float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int turbo_half_iter_launch(const void* lin, const void* lp, void* out,
                                      void* scr, int B, int n_w, int W, int U,
                                      int R, void* stream) {
  const int L = B * n_w;
  if (L <= 0 || W <= 0 || U <= 0 || U > W || W % R != 0 || U % R != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(128), grid((L + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)lin;
  const float* b = (const float*)lp;
  float* o = (float*)out;
  float* s = (float*)scr;
  switch (R) {
    case 8: turbo_half_iter_kernel<8><<<grid, block, 0, st>>>(a, b, o, s, n_w, W, U, L); break;
    case 4: turbo_half_iter_kernel<4><<<grid, block, 0, st>>>(a, b, o, s, n_w, W, U, L); break;
    case 2: turbo_half_iter_kernel<2><<<grid, block, 0, st>>>(a, b, o, s, n_w, W, U, L); break;
    case 1: turbo_half_iter_kernel<1><<<grid, block, 0, st>>>(a, b, o, s, n_w, W, U, L); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
