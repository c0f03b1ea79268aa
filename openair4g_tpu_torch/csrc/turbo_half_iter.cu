// Windowed max-log-MAP half-iteration of the 36.212 8-state RSC
// (g0 = 1+D^2+D^3 feedback, g1 = 1+D+D^3), and the whole iterative turbo
// decode around it in one launch (turbo_decode_kernel, at the end: the v2
// body below runs inside it, one copy of the recursion for both).
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

// The v2 half-iteration of one lane, window w of a code block's row, the
// one copy of the recursion: gu_row and gp_row point at the window's node 0
// in [B, N] rows of lin and lp (its alpha warm-up at [-U, 0), its beta head
// at [W, W + U)); checkpoint k of the lane at ck_lane + k * ck_stride holds
// beta at node (k+1) R; w is the window, n_w the row's windows. STORE, the
// caller's policy, takes block j's R LLRs o and its lin values cu as read.
// It is a macro so that the standalone kernel expands it in place and
// compiles to the instructions it did before the decode kernel shared it
// (a __device__ function, inlined, gave the same instructions with other
// registers and order); the decode kernel expands it in half_iter_lane.
#define TURBO_HALF_ITER_BODY(STORE) \
  const int nb = W / R;                    /* blocks a window, checkpoints a lane */   \
  const bool last = (w == n_w - 1);                                                    \
                                                                                       \
  /* ---- beta warm-up over the next window's head, reversed ---- */                   \
  float beta[8];                                                                       \
_Pragma("unroll")                                                                      \
  for (int s = 0; s < 8; ++s) beta[s] = 0.f;                                           \
  for (int i = 0; i < U / R; ++i) {                                                    \
    float gu[R], gp[R];                                                                \
    if (last) {                                                                        \
_Pragma("unroll")                                                                      \
      for (int r = 0; r < R; ++r) gu[r] = gp[r] = BIG;                                 \
    } else {                                                                           \
      load_block<R>(gu_row + W + U - (i + 1) * R, gu);                                 \
      load_block<R>(gp_row + W + U - (i + 1) * R, gp);                                 \
_Pragma("unroll")                                                                      \
      for (int r = 0; r < R; ++r) { gu[r] *= 0.5f; gp[r] *= 0.5f; }                    \
    }                                                                                  \
_Pragma("unroll")                                                                      \
    for (int r = R - 1; r >= 0; --r) beta_step(beta, gu[r], gp[r]);                    \
    normalize(beta);                                                                   \
  }                                                                                    \
  store_block<8>(ck_lane + (nb - 1) * ck_stride, beta);                                \
                                                                                       \
  /* ---- main beta sweep, reversed: block i covers nodes [lo, lo + R), */             \
  /* lo = W - (i+1) R; beta at lo is checkpoint lo/R - 1. The block at */              \
  /* lo = 0 is not run: no LLR reads its betas. ---- */                                \
  float cu[R], cp[R], nu[R], np[R];                                                    \
  load_block<R>(gu_row + W - R, cu);                                                   \
  load_block<R>(gp_row + W - R, cp);                                                   \
  for (int i = 0; i < nb - 1; ++i) {                                                   \
    const int lo = W - (i + 1) * R;                                                    \
    load_block<R>(gu_row + lo - R, nu);    /* the next block, in flight */             \
    load_block<R>(gp_row + lo - R, np);                                                \
_Pragma("unroll")                                                                      \
    for (int r = R - 1; r >= 0; --r) beta_step(beta, 0.5f * cu[r], 0.5f * cp[r]);      \
    store_block<8>(ck_lane + (lo / R - 1) * ck_stride, beta);                          \
    normalize(beta);                                                                   \
_Pragma("unroll")                                                                      \
    for (int r = 0; r < R; ++r) { cu[r] = nu[r]; cp[r] = np[r]; }                      \
  }                                                                                    \
                                                                                       \
  /* ---- alpha warm-up over the previous window's tail ---- */                        \
  float alpha[8];                                                                      \
  if (w == 0) {                                                                        \
    alpha[0] = 0.f;                                                                    \
_Pragma("unroll")                                                                      \
    for (int s = 1; s < 8; ++s) alpha[s] = NEG;                                        \
  } else {                                                                             \
_Pragma("unroll")                                                                      \
    for (int s = 0; s < 8; ++s) alpha[s] = 0.f;                                        \
    for (int i = 0; i < U / R; ++i) {                                                  \
      float gu[R], gp[R];                                                              \
      load_block<R>(gu_row - U + i * R, gu);                                           \
      load_block<R>(gp_row - U + i * R, gp);                                           \
_Pragma("unroll")                                                                      \
      for (int r = 0; r < R; ++r) alpha_step(alpha, 0.5f * gu[r], 0.5f * gp[r]);       \
      normalize(alpha);                                                                \
    }                                                                                  \
  }                                                                                    \
                                                                                       \
  /* ---- forward sweep: block j covers nodes [jR, jR + R) and reads beta */           \
  /* at nodes jR + 1 .. jR + R, recomputed from checkpoint j ---- */                   \
  float ckv[8], nck[8];                                                                \
  load_block<R>(gu_row, cu);                                                           \
  load_block<R>(gp_row, cp);                                                           \
  load_block<8>(ck_lane, ckv);                                                         \
  for (int j = 0; j < nb; ++j) {                                                       \
    const int jn = j + 1 < nb ? j + 1 : j;   /* the next block, in flight */           \
    load_block<R>(gu_row + jn * R, nu);                                                \
    load_block<R>(gp_row + jn * R, np);                                                \
    load_block<8>(ck_lane + jn * ck_stride, nck);                                      \
                                                                                       \
    float bv[R][8];                          /* bv[r]: beta at node jR + r + 1 */      \
    float b[8];                                                                        \
_Pragma("unroll")                                                                      \
    for (int s = 0; s < 8; ++s) b[s] = bv[R - 1][s] = ckv[s];                          \
    if (j + 1 < nb) normalize(b);            /* the state carried from node (j+1) R */ \
_Pragma("unroll")                                                                      \
    for (int r = R - 2; r >= 0; --r) {                                                 \
      beta_step(b, 0.5f * cu[r + 1], 0.5f * cp[r + 1]);                                \
_Pragma("unroll")                                                                      \
      for (int s = 0; s < 8; ++s) bv[r][s] = b[s];                                     \
    }                                                                                  \
                                                                                       \
    float o[R];                                                                        \
_Pragma("unroll")                                                                      \
    for (int r = 0; r < R; ++r) {                                                      \
      const float gu = 0.5f * cu[r];                                                   \
      const float gp = 0.5f * cp[r];                                                   \
      float m0 = -INFINITY, m1 = -INFINITY;                                            \
_Pragma("unroll")                                                                      \
      for (int s = 0; s < 8; ++s) {                                                    \
        const float gpt = par0(s) ? -gp : gp;                                          \
        m0 = fmaxf(m0, (alpha[s] + gpt) + bv[r][next0(s)]);                            \
        m1 = fmaxf(m1, (alpha[s] - gpt) + bv[r][next1(s)]);                            \
      }                                                                                \
      o[r] = (m0 + gu) - (m1 - gu);                                                    \
      alpha_step(alpha, gu, gp);                                                       \
    }                                                                                  \
    normalize(alpha);                                                                  \
    STORE;                                                                             \
_Pragma("unroll")                                                                      \
    for (int r = 0; r < R; ++r) { cu[r] = nu[r]; cp[r] = np[r]; }                      \
_Pragma("unroll")                                                                      \
    for (int s = 0; s < 8; ++s) ckv[s] = nck[s];                                       \
  }

// The body as a function for the decode kernel: store(j * R, o, cu) takes
// block j's LLRs o and lin values cu.
template <int R, class Store>
__device__ __forceinline__ void half_iter_lane(const float* gu_row,
                                               const float* gp_row,
                                               float* ck_lane,
                                               long long ck_stride, int w,
                                               int n_w, int W, int U,
                                               Store store) {
  TURBO_HALF_ITER_BODY(store(j * R, o, cu))
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
  TURBO_HALF_ITER_BODY(store_block<R>(o_row + j * R, o))
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

// The whole iterative turbo decode of one (K, F) group in one launch:
// replaces openair4g_tpu/ops/turbo.py turbo_decode, the reference's
// lax.while_loop (no Pallas kernel: XLA compiles the loop, the QPP permutes,
// the decision and the CRC latch around half_iteration_pallas_v2 into one
// device program). Its plain version is ops/turbo.turbo_decode_ref, the
// port's host loop of two v2 launches and about twenty torch ops an
// iteration with a host sync; the kernel equals it bit for bit.
//
// One block a code block row b, one thread a window (blockDim = n_w rounded
// up to a warp; threads past n_w join the row-wide passes only). Per row,
// ws holds six [N] rows: lin1, par1, lin2, par2, a1, ext2.
//   prologue: the tails de-interlaced from llr_d [B, 3, K + 4] (36.212
//     tail mapping) into lin1 = sys + 0 (the a-priori starts at 0), par1,
//     par2 and lin2's tail, BIG past K + 3;
//   each iteration, with __syncthreads() between the steps:
//     HI1: the v2 lane body on lin1, par1, storing a1 = sys + (llr - lin1),
//       the loop's sys + ext1 (so each pass below gathers one row, not
//       two: 3.66 against 4.31 ms at 1,408 rows, 8 iterations, on an H100);
//     the exchange: lin2[j] = a1[pi[j]], j < K, one pass of scattered
//       reads, so that HI2 reads a contiguous row as v2 does (the
//       recursion reads each node about 2.2 times);
//     HI2: the v2 lane body on lin2, par2, storing ext2 = llr - lin2;
//     the latch: la1[i] = ext2[inv_pi[i]], lin1[i] = sys[i] + la1[i] for
//       the next HI1, bit = (a1 + la1)[i] < 0, written to the
//       row's output until it latches; the CRC of the payload (positions
//       F..K-1) is the XOR of the packed 24-bit rows of crc_matrix(K - F)
//       over its set bits, reduced by warp shuffles and across warps in
//       shared memory. A zero XOR latches the row (done, its bits kept).
//   With dynamic_stop a latched row leaves the loop: the latch froze its
//   bits at its first pass, so the outputs are the fixed loop's; the
//   reference's batch-wide ~all(done) only ends its program. Without it
//   every row runs n_iter iterations. A row that never latches gets zeros.
//   iters[b]: the iterations the row ran.
// The float32 operations are the loop's, in its order, adds only: the
// packed XOR equals remainder(bits @ H, 2) == 0 exactly.
//
// What bounds it: the two half-iterations' operations (128 a position
// each, as v2) and their rows' bytes (each input once: llr_d, the outputs
// once). The exchange's scattered reads and the latch's go to rows the
// block wrote itself (L2 where the rows fit).
//
// Registers: __launch_bounds__(128, 3) caps a thread at 168 registers, what
// v2 takes at R = 8, so 12 one-warp blocks fit an SM (1,584 rows resident
// on 132 SMs). A row takes at most 128 windows (K = 6,144 needs 26 at
// W = 240, 65 at W = 96).
// Positions a thread takes at once in the row-wide passes: their loads are
// independent, so a warp keeps kPass of them in flight.
constexpr int kPass = 8;

template <int R>
__global__ void __launch_bounds__(128, 3)
turbo_decode_kernel(const float* __restrict__ llr_d,
                    const int* __restrict__ pi, const int* __restrict__ inv_pi,
                    const unsigned* __restrict__ crc_rows, float* ws,
                    float* ck, int* bits, unsigned char* done, int* iters,
                    int B, int K, int F, int n_w, int W, int U, int n_iter,
                    int dynamic_stop) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int N = n_w * W;
  const float* d0 = llr_d + (long long)b * 3 * (K + 4);
  const float* d1 = d0 + (K + 4);
  const float* d2 = d1 + (K + 4);
  float* lin1 = ws + (long long)b * 6 * N;
  float* par1 = lin1 + N;
  float* lin2 = par1 + N;
  float* par2 = lin2 + N;
  float* a1 = par2 + N;
  float* ext2 = a1 + N;
  int* brow = bits + (long long)b * K;
  const long long lane = (long long)b * n_w + tid;
  const long long ck_stride = (long long)B * n_w * 8;
  __shared__ unsigned s_xor[32];
  __shared__ int s_done, s_iter;

  for (int p = tid; p < N; p += nt) {
    float l1 = BIG, p1 = BIG, l2 = BIG, p2 = BIG;
    if (p < K) {
      l1 = d0[p] + 0.f;
      p1 = d1[p];
      p2 = d2[p];
    } else if (p == K) {
      l1 = d0[K]; p1 = d1[K]; l2 = d0[K + 2]; p2 = d1[K + 2];
    } else if (p == K + 1) {
      l1 = d2[K]; p1 = d0[K + 1]; l2 = d2[K + 2]; p2 = d0[K + 3];
    } else if (p == K + 2) {
      l1 = d1[K + 1]; p1 = d2[K + 1]; l2 = d1[K + 3]; p2 = d2[K + 3];
    }
    lin1[p] = l1;
    par1[p] = p1;
    par2[p] = p2;
    if (p >= K) lin2[p] = l2;
  }
  if (tid == 0) { s_done = 0; s_iter = n_iter; }
  __syncthreads();

  const bool active = tid < n_w;
  const long long row = (long long)tid * W;
  for (int it = 0; it < n_iter; ++it) {
    if (active) {
      float* a_row = a1 + row;
      const float* s_row = d0 + row;
      const int k_row = K - (int)row;
      half_iter_lane<R>(lin1 + row, par1 + row, ck + lane * 8, ck_stride,
                        tid, n_w, W, U,
                        [=](int p, const float* o, const float* cu) {
                          float a[R];
#pragma unroll
                          for (int r = 0; r < R; ++r)
                            a[r] = (p + r < k_row ? s_row[p + r] : 0.f)
                                   + (o[r] - cu[r]);
                          store_block<R>(a_row + p, a);
                        });
    }
    __syncthreads();
    for (int j0 = tid; j0 < K; j0 += kPass * nt) {
      int q[kPass];
      float v[kPass];
#pragma unroll
      for (int u = 0; u < kPass; ++u) q[u] = j0 + u * nt < K ? pi[j0 + u * nt] : 0;
#pragma unroll
      for (int u = 0; u < kPass; ++u) v[u] = a1[q[u]];
#pragma unroll
      for (int u = 0; u < kPass; ++u)
        if (j0 + u * nt < K) lin2[j0 + u * nt] = v[u];
    }
    __syncthreads();
    if (active) {
      float* e_row = ext2 + row;
      half_iter_lane<R>(lin2 + row, par2 + row, ck + lane * 8, ck_stride,
                        tid, n_w, W, U,
                        [e_row](int p, const float* o, const float* cu) {
                          float e[R];
#pragma unroll
                          for (int r = 0; r < R; ++r) e[r] = o[r] - cu[r];
                          store_block<R>(e_row + p, e);
                        });
    }
    __syncthreads();
    const bool latched = s_done != 0;
    unsigned x = 0;
    for (int i0 = tid; i0 < K; i0 += kPass * nt) {
      int q[kPass];
      float la[kPass], sy[kPass], a[kPass];
      unsigned cr[kPass];
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int i = i0 + u * nt;
        q[u] = i < K ? inv_pi[i] : 0;
        sy[u] = i < K ? d0[i] : 0.f;
        a[u] = i < K ? a1[i] : 0.f;
        cr[u] = i < K && i >= F ? crc_rows[i - F] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kPass; ++u) la[u] = ext2[q[u]];
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int i = i0 + u * nt;
        if (i < K) {
          const float llr = a[u] + la[u];
          lin1[i] = sy[u] + la[u];
          if (!latched) {
            const int bit = llr < 0.f;
            brow[i] = bit;
            if (bit) x ^= cr[u];
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, off);
    if ((tid & 31) == 0) s_xor[tid >> 5] = x;
    __syncthreads();
    if (tid == 0 && !latched) {
      unsigned r = 0;
      for (int k = 0; k < nt / 32; ++k) r ^= s_xor[k];
      if (r == 0) { s_done = 1; s_iter = it + 1; }
    }
    __syncthreads();
    if (dynamic_stop && s_done) break;
  }

  if (tid == 0) {
    done[b] = (unsigned char)s_done;
    iters[b] = dynamic_stop && s_done ? s_iter : n_iter;
  }
  if (!s_done)
    for (int i = tid; i < K; i += nt) brow[i] = 0;
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

// llr_d: [B, 3, K + 4] float32; pi, inv_pi: [K] int32 (the QPP permutation
// and its inverse); crc_rows: [K - F] the packed rows of crc_matrix(K - F);
// ws: [B, 6, n_w * W] float32, 16-byte aligned when R % 4 == 0; scr: the
// checkpoints, [(W / R) * B * n_w * 8] float32; bits: [B, K] int32, done:
// [B] bool, iters: [B] int32, all written. Returns cudaGetLastError().
extern "C" int turbo_decode_launch(const void* llr_d, const void* pi,
                                   const void* inv_pi, const void* crc_rows,
                                   void* ws, void* scr, void* bits, void* done,
                                   void* iters, int B, int K, int F, int n_w,
                                   int W, int U, int R, int n_iter,
                                   int dynamic_stop, void* stream) {
  if (B <= 0 || K <= 0 || F < 0 || F >= K || n_iter < 0 || W <= 0 ||
      U <= 0 || U > W || W % R != 0 || U % R != 0 || n_w <= 0 ||
      (long long)n_w * W < K + 3 || n_w > 128)
    return (int)cudaErrorInvalidValue;
  const int threads = (n_w + 31) / 32 * 32;
  const dim3 grid(B);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)llr_d;
  const int* p = (const int*)pi;
  const int* q = (const int*)inv_pi;
  const unsigned* c = (const unsigned*)crc_rows;
  float* w = (float*)ws;
  float* s = (float*)scr;
  int* o = (int*)bits;
  unsigned char* d = (unsigned char*)done;
  int* n = (int*)iters;
#define TURBO_DECODE(RR)                                                      \
  turbo_decode_kernel<RR><<<grid, threads, 0, st>>>(                          \
      l, p, q, c, w, s, o, d, n, B, K, F, n_w, W, U, n_iter, dynamic_stop)
  switch (R) {
    case 8: TURBO_DECODE(8); break;
    case 4: TURBO_DECODE(4); break;
    case 2: TURBO_DECODE(2); break;
    case 1: TURBO_DECODE(1); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TURBO_DECODE
  return (int)cudaGetLastError();
}
