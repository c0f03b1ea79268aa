// Windowed max-log-MAP half-iteration of the 36.212 8-state RSC
// (g0 = 1+D^2+D^3 feedback, g1 = 1+D+D^3).
//
// Replaces the TPU kernel openair4g_tpu/ops/turbo_pallas.py
// (_make_kernel_v2 / _build_call_v2 / half_iteration_pallas_v2) and computes
// what it computes, lane for lane:
//   * beta warm-up over the next window's head (BIG at the last window),
//   * main beta sweep; beta at node t is the value before the block's
//     renormalization, as in the TPU kernel,
//   * alpha warm-up over the previous window's tail (window 0 starts
//     exactly in state 0),
//   * forward sweep emitting LLR = (max_{u=0}(a+gp+b') + gu) - (max_{u=1} - gu),
// with the metrics renormalized every R steps of each sweep, as the TPU
// kernel does (R = its unroll), so both give the same float32 sums. The
// plain version, ops/turbo_cuda.half_iteration_ref, runs the same float
// operations in the same order, and the kernel equals it bit for bit.
//
// What bounds it: the function reads lin and lp [B, N] and writes out
// [B, N] once, 12 B a position: 97.3 MB at the 20 MHz flagship
// (B = 1,408, N = 5,760), 29 us at 3.35 TB/s. Its ~128 add/sub/max a
// position (1.04 G operations) issue one a float32 lane a cycle, 33.5 T/s
// (the data sheet's 67 TFLOP/s counts an FMA as two): 31 us, so the
// operations set the bound.
//
// Design: one thread per (code block, window) lane, lane = b * n_w + w; the
// 8 alpha and 8 beta metrics live in registers, and the thread reads the
// [B, N] rows at computed offsets (main node t of window w is
// g[b, w*W + t], its alpha warm-up g[b, w*W - U + t], its beta head
// g[b, (w+1)*W + t]). Against the three faults of the first port of this
// kernel:
//   1. No per-node beta stack in device memory (it was [W+1, 8, L], 260 MB
//      written and read at the flagship). The backward sweep keeps one
//      checkpoint per renormalization block: beta at node p = (k+1) R, for
//      p < W the value *before* the block's renormalization (the value the
//      LLR at node p - 1 uses; the state carried on is normalize() of it,
//      recomputed by the same operations), for p = W the warm-up's carried
//      state. The forward sweep recomputes each block's R beta values from
//      its checkpoint into registers (R x 8 floats, R a template parameter)
//      just before that block's LLRs and alpha steps: R - 1 more beta steps
//      a block, about +30 % operations. The backward sweep skips its last
//      block, whose values no LLR reads. The checkpoints take
//      W/R x 8 x 4 B a lane (960 B at W = 240): at the flagship 256 lanes
//      an SM would need 245 KB of shared memory, more than an SM's 228 KB
//      (only one of the two 128-lane blocks would fit), so they go to a
//      global scratch [W/R, L, 8] (32.4 MB at the flagship, L = 33,792),
//      small enough for the 50 MB L2 to hold while the grid is resident;
//      the wrapper allocates it.
//   2. Every sector read or written in full. A lane loads a block's R gu
//      and R gp values as 16-byte vectors (R = 8: two float4 a stream, one
//      32-byte sector), stores its R LLRs as float4s, and writes and reads
//      its checkpoints as two float4s (neighbouring lanes on neighbouring
//      32-byte pieces). The offsets w*W, w*W - U, (w+1)*W and the row
//      length N are multiples of R, and the wrapper checks that lin, lp
//      and out are 16-byte aligned; for R < 4 the loads are scalar. The
//      recomputed beta block and the alpha/LLR block read the same
//      vectors, so the forward phase loads each input once, and both main
//      sweeps load the next block's vectors (and checkpoint) into
//      registers while the current block computes.
//   3. Work in flight: not changed. Blocks of 128 threads, as in the first
//      port: the flagship's 33,792 lanes make 264 blocks, 2 on each of the
//      132 SMs in one wave, 8 warps an SM, 2 a scheduler. One thread a lane
//      caps it there: the grid has no more warps to give, and 64- or
//      32-thread blocks measured the same. The fault stays for a redesign
//      that splits a lane's work over more threads. __launch_bounds__(128,
//      2) asks for the 2 blocks an SM that the grid fills; ptxas then takes
//      168 registers at R = 8 (with (128) alone it took 128 and the kernel
//      ran 2.7 % slower), no spills. No shared memory, no __syncthreads(),
//      so the ragged last block simply masks its lanes past L.
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

// R consecutive floats at p (16-byte aligned when R % 4 == 0), as float4
// vectors when R allows it, else one by one. Plain loads, not __ldg: the
// checkpoints are read back by the thread that wrote them in this launch.
template <int R>
__device__ __forceinline__ void load_block(const float* p, float* v) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const float4 x = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z; v[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
}

template <int R>
__device__ __forceinline__ void store_block(float* p, const float* v) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = v[r];
  }
}

// ck: [W/R, L, 8] float32; checkpoint k of a lane holds beta at node (k+1) R.
template <int R>
__global__ void __launch_bounds__(128, 2)
turbo_half_iter_kernel(const float* __restrict__ lin, const float* __restrict__ lp,
                       float* __restrict__ out, float* __restrict__ ck,
                       int n_w, int W, int U, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int w = lane % n_w;
  const long long base = (long long)(lane / n_w) * n_w * W + (long long)w * W;
  const float* gu_row = lin + base;        // node t of this window at [t]
  const float* gp_row = lp + base;
  float* o_row = out + base;
  float* ck_lane = ck + (long long)lane * 8;
  const long long ck_stride = (long long)L * 8;
  const int nb = W / R;                    // blocks a window, checkpoints a lane
  const bool last = (w == n_w - 1);

  // ---- beta warm-up over the next window's head, reversed ----
  float beta[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = 0.f;
  for (int i = 0; i < U / R; ++i) {
    float gu[R], gp[R];
    if (last) {
#pragma unroll
      for (int r = 0; r < R; ++r) gu[r] = gp[r] = BIG;
    } else {
      load_block<R>(gu_row + W + U - (i + 1) * R, gu);
      load_block<R>(gp_row + W + U - (i + 1) * R, gp);
#pragma unroll
      for (int r = 0; r < R; ++r) { gu[r] *= 0.5f; gp[r] *= 0.5f; }
    }
#pragma unroll
    for (int r = R - 1; r >= 0; --r) beta_step(beta, gu[r], gp[r]);
    normalize(beta);
  }
  store_block<8>(ck_lane + (nb - 1) * ck_stride, beta);

  // ---- main beta sweep, reversed: block i covers nodes [lo, lo + R),
  // lo = W - (i+1) R; beta at lo is checkpoint lo/R - 1. The block at
  // lo = 0 is not run: no LLR reads its betas. ----
  float cu[R], cp[R], nu[R], np[R];
  load_block<R>(gu_row + W - R, cu);
  load_block<R>(gp_row + W - R, cp);
  for (int i = 0; i < nb - 1; ++i) {
    const int lo = W - (i + 1) * R;
    load_block<R>(gu_row + lo - R, nu);    // the next block, in flight
    load_block<R>(gp_row + lo - R, np);
#pragma unroll
    for (int r = R - 1; r >= 0; --r) beta_step(beta, 0.5f * cu[r], 0.5f * cp[r]);
    store_block<8>(ck_lane + (lo / R - 1) * ck_stride, beta);
    normalize(beta);
#pragma unroll
    for (int r = 0; r < R; ++r) { cu[r] = nu[r]; cp[r] = np[r]; }
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
      float gu[R], gp[R];
      load_block<R>(gu_row - U + i * R, gu);
      load_block<R>(gp_row - U + i * R, gp);
#pragma unroll
      for (int r = 0; r < R; ++r) alpha_step(alpha, 0.5f * gu[r], 0.5f * gp[r]);
      normalize(alpha);
    }
  }

  // ---- forward sweep: block j covers nodes [jR, jR + R) and reads beta
  // at nodes jR + 1 .. jR + R, recomputed from checkpoint j ----
  float ckv[8], nck[8];
  load_block<R>(gu_row, cu);
  load_block<R>(gp_row, cp);
  load_block<8>(ck_lane, ckv);
  for (int j = 0; j < nb; ++j) {
    const int jn = j + 1 < nb ? j + 1 : j;   // the next block, in flight
    load_block<R>(gu_row + jn * R, nu);
    load_block<R>(gp_row + jn * R, np);
    load_block<8>(ck_lane + jn * ck_stride, nck);

    float bv[R][8];                          // bv[r]: beta at node jR + r + 1
    float b[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) b[s] = bv[R - 1][s] = ckv[s];
    if (j + 1 < nb) normalize(b);            // the state carried from node (j+1) R
#pragma unroll
    for (int r = R - 2; r >= 0; --r) {
      beta_step(b, 0.5f * cu[r + 1], 0.5f * cp[r + 1]);
#pragma unroll
      for (int s = 0; s < 8; ++s) bv[r][s] = b[s];
    }

    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float gu = 0.5f * cu[r];
      const float gp = 0.5f * cp[r];
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float gpt = par0(s) ? -gp : gp;
        m0 = fmaxf(m0, (alpha[s] + gpt) + bv[r][next0(s)]);
        m1 = fmaxf(m1, (alpha[s] - gpt) + bv[r][next1(s)]);
      }
      o[r] = (m0 + gu) - (m1 - gu);
      alpha_step(alpha, gu, gp);
    }
    normalize(alpha);
    store_block<R>(o_row + j * R, o);
#pragma unroll
    for (int r = 0; r < R; ++r) { cu[r] = nu[r]; cp[r] = np[r]; }
#pragma unroll
    for (int s = 0; s < 8; ++s) ckv[s] = nck[s];
  }
}

// R floats at p, p + stride, ...: one row each of a t-major frame, where a
// warp's lanes read neighbouring addresses.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, long long stride,
                                          float* v) {
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = p[r * stride];
}

// The v1 kernel: the same half-iteration with the parity given as
// window-replicated t-major frames [T = W + U, L] (lane = block * n_w +
// window), already scaled by 0.5, built once a decode by the wrapper's
// prep_parity as the TPU kernel's host code builds them:
//   gpf row t: position w*W - U + t (0 before the trellis start),
//   gpb row t: position w*W + t (BIG past the end).
// Replaces openair4g_tpu/ops/turbo_pallas.py (_make_kernel / _build_call /
// half_iteration_pallas_prepped) and computes what its body computes, lane
// for lane:
//   * one backward sweep over all T rows from beta = 0; beta at node t is
//     the value after row t, before the block's renormalization,
//   * forward warm-up over the U gpf rows from alpha = 0; window 0 starts
//     exactly in state 0,
//   * forward work over W rows emitting (m0 + gu) - (m1 - gu) from
//     beta[tau + 1],
// renormalizing every R steps at the TPU kernel's points. It differs from
// the v2 kernel only in beta at node W (the value before, not after, the
// warm-up's last renormalization), which moves the LLR at a window's last
// node by float rounding. The TPU kernel also takes lin as two frames (fwd
// row U + tau and bwd row tau hold the same position w*W + tau); here lin is
// read where it lies.
//
// What bounds it: device memory by the count of its operands (lin, the two
// parity frames and out, each once: 136 MB at the flagship, 41 us), but
// what it reaches is set by the serial recursion of one thread a lane, as
// in v2.
//
// Design: the v2 kernel's, on v1's operands. Against the faults of the first
// port of this kernel (a per-node beta stack [T, 8, L] in device memory,
// 545 MB written and read at the flagship; the forward sweep reading each
// main position from both frames; two frames of lin built and the output
// un-framed by separate launches on every call):
//   1. One beta checkpoint per renormalization block in ck [W/R, L, 8]
//      (32.4 MB at the flagship), each forward block's R betas recomputed in
//      registers. Every checkpoint, the one at node W too, is the value
//      before its block's renormalization: the LLR at node p - 1 reads it as
//      it is and the recomputation starts from normalize() of it, the state
//      the backward sweep carried on. The backward sweep skips its last
//      block.
//   2. lin [B, N] is read in place at computed offsets as float4 vectors,
//      scaled by 0.5 here; the last window's head is BIG and window 0's
//      warm-up, whose alpha the exact start state replaces, is not run. The
//      LLRs go straight into out [B, N] as float4s. So a call is this one
//      launch.
//   3. The parity comes from the frames, one row a step, coalesced across
//      a warp's lanes; the forward sweep reads each main position once,
//      from gpb (gpf row U + tau is the same position: no pad lies inside a
//      window), and gpf only over its U warm-up rows. Both main sweeps load
//      the next block's values into registers while the current block
//      computes.
template <int R>
__global__ void __launch_bounds__(128, 2)
turbo_half_iter_v1_kernel(const float* __restrict__ lin,
                          const float* __restrict__ gpf,
                          const float* __restrict__ gpb,
                          float* __restrict__ out, float* __restrict__ ck,
                          int n_w, int W, int U, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int w = lane % n_w;
  const long long base = (long long)lane * W;
  const long long Ll = L;
  const float* gu_row = lin + base;        // node t of this window at [t]
  const float* pf = gpf + lane;            // row t at [t * Ll]
  const float* pb = gpb + lane;
  float* o_row = out + base;
  float* ck_lane = ck + (long long)lane * 8;
  const long long ck_stride = Ll * 8;
  const int nb = W / R;                    // blocks a window, checkpoints a lane
  const bool last = (w == n_w - 1);

  // ---- backward sweep, rows T-1 .. W: the next window's head ----
  float beta[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = 0.f;
  for (int i = 0; i < U / R; ++i) {
    const int lo = W + U - (i + 1) * R;
    float gu[R], gp[R];
    load_rows<R>(pb + lo * Ll, Ll, gp);
    if (last) {
#pragma unroll
      for (int r = 0; r < R; ++r) gu[r] = BIG;
    } else {
      load_block<R>(gu_row + lo, gu);
#pragma unroll
      for (int r = 0; r < R; ++r) gu[r] *= 0.5f;
    }
#pragma unroll
    for (int r = R - 1; r >= 0; --r) beta_step(beta, gu[r], gp[r]);
    if (lo == W) store_block<8>(ck_lane + (nb - 1) * ck_stride, beta);
    normalize(beta);
  }

  // ---- backward sweep, rows W-1 .. R: block i covers nodes [lo, lo + R),
  // lo = W - (i+1) R; beta at lo is checkpoint lo/R - 1. The block at
  // lo = 0 is not run: no LLR reads its betas. ----
  float cu[R], cp[R], nu[R], np[R];
  load_block<R>(gu_row + W - R, cu);
  load_rows<R>(pb + (W - R) * Ll, Ll, cp);
  for (int i = 0; i < nb - 1; ++i) {
    const int lo = W - (i + 1) * R;
    load_block<R>(gu_row + lo - R, nu);    // the next block, in flight
    load_rows<R>(pb + (lo - R) * Ll, Ll, np);
#pragma unroll
    for (int r = R - 1; r >= 0; --r) beta_step(beta, 0.5f * cu[r], cp[r]);
    store_block<8>(ck_lane + (lo / R - 1) * ck_stride, beta);
    normalize(beta);
#pragma unroll
    for (int r = 0; r < R; ++r) { cu[r] = nu[r]; cp[r] = np[r]; }
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
      float gu[R], gp[R];
      load_block<R>(gu_row - U + i * R, gu);
      load_rows<R>(pf + i * R * Ll, Ll, gp);
#pragma unroll
      for (int r = 0; r < R; ++r) alpha_step(alpha, 0.5f * gu[r], gp[r]);
      normalize(alpha);
    }
  }

  // ---- forward sweep: block j covers nodes [jR, jR + R) and reads beta
  // at nodes jR + 1 .. jR + R, recomputed from checkpoint j ----
  float ckv[8], nck[8];
  load_block<R>(gu_row, cu);
  load_rows<R>(pb, Ll, cp);
  load_block<8>(ck_lane, ckv);
  for (int j = 0; j < nb; ++j) {
    const int jn = j + 1 < nb ? j + 1 : j;   // the next block, in flight
    load_block<R>(gu_row + jn * R, nu);
    load_rows<R>(pb + jn * R * Ll, Ll, np);
    load_block<8>(ck_lane + jn * ck_stride, nck);

    float bv[R][8];                          // bv[r]: beta at node jR + r + 1
    float b[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) b[s] = bv[R - 1][s] = ckv[s];
    normalize(b);                            // the state carried from node (j+1) R
#pragma unroll
    for (int r = R - 2; r >= 0; --r) {
      beta_step(b, 0.5f * cu[r + 1], cp[r + 1]);
#pragma unroll
      for (int s = 0; s < 8; ++s) bv[r][s] = b[s];
    }

    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float gu = 0.5f * cu[r];
      const float gp = cp[r];
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float gpt = par0(s) ? -gp : gp;
        m0 = fmaxf(m0, (alpha[s] + gpt) + bv[r][next0(s)]);
        m1 = fmaxf(m1, (alpha[s] - gpt) + bv[r][next1(s)]);
      }
      o[r] = (m0 + gu) - (m1 - gu);
      alpha_step(alpha, gu, gp);
    }
    normalize(alpha);
    store_block<R>(o_row + j * R, o);
#pragma unroll
    for (int r = 0; r < R; ++r) { cu[r] = nu[r]; cp[r] = np[r]; }
#pragma unroll
    for (int s = 0; s < 8; ++s) ckv[s] = nck[s];
  }
}

}  // namespace

// lin, out: [B, n_w * W] float32 rows, 16-byte aligned when R % 4 == 0; gpf,
// gpb: [W + U, B * n_w] float32 t-major parity frames; scr: the checkpoints,
// [(W / R) * B * n_w * 8] float32. Returns cudaGetLastError().
extern "C" int turbo_half_iter_v1_launch(const void* lin, const void* gpf,
                                         const void* gpb, void* out, void* scr,
                                         int B, int n_w, int W, int U, int R,
                                         void* stream) {
  const int L = B * n_w;
  if (L <= 0 || W <= 0 || U <= 0 || U > W || W % R != 0 || U % R != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(128), grid((L + 127) / 128);
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)lin;
  const float* b = (const float*)gpf;
  const float* c = (const float*)gpb;
  float* o = (float*)out;
  float* s = (float*)scr;
  switch (R) {
    case 8: turbo_half_iter_v1_kernel<8><<<grid, block, 0, st>>>(a, b, c, o, s, n_w, W, U, L); break;
    case 4: turbo_half_iter_v1_kernel<4><<<grid, block, 0, st>>>(a, b, c, o, s, n_w, W, U, L); break;
    case 2: turbo_half_iter_v1_kernel<2><<<grid, block, 0, st>>>(a, b, c, o, s, n_w, W, U, L); break;
    case 1: turbo_half_iter_v1_kernel<1><<<grid, block, 0, st>>>(a, b, c, o, s, n_w, W, U, L); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// lin, lp, out: [B, n_w * W] float32 rows, 16-byte aligned when R % 4 == 0;
// scr: the checkpoints, [(W / R) * B * n_w * 8] float32. Returns
// cudaGetLastError() after the launch (0 on success).
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
