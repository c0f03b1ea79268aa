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
#include <cuda_pipeline.h>
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

// The body as a function for the decode kernel: gu_row and gp_row are the
// lane's window in its rows, store(j * R, o, cu) takes block j's LLRs o and
// lin values cu.
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
// A block takes `rows` code block rows of the group, their windows packed
// into its warps: lane l = r * n_w + w is window w of the block's row r,
// and thread t runs lanes t, t + blockDim.x, ... (so any window count a row
// runs; the warps are full where rows * n_w is a multiple of 32). Each code
// block has lin1, lin2, par1 and par2 of N floats with the tails (36.212's
// mapping) and BIG past K + 3 written once, so the body reads plain rows as
// v2 does, and D and ext of K (decode_row). Each half-iteration stores its
// extrinsic llr - lin in order, as v2 stores its LLRs; row passes between
// them do the QPP exchange with the loop's adds:
//   the exchange: lin2 = D + ext1[pi], D = d0[pi] made once (the loop's
//     sys + ext1, permuted: the same single add);
//   the latch pass: lin1 = d0 + ext2[inv_pi] (sys + la1), the decision of
//     each position and the payload's CRC word, the XOR of the packed rows
//     crc_rows[i - F] of the set bits at i >= F.
// The decision of position i is (a1 + la1) < 0 with a1 = sys + ext1: lin2
// at inv_pi[i] holds the same float, so this is the loop's sys + ext1 +
// la1 with its two roundings. The decisions stay in shared memory as K bits
// a row. Two layouts of the rows:
//   on chip (for groups whose rows all fit the SMs' shared memory at once):
//     in dynamic shared memory; the passes gather from it, and the latch
//     pass takes lin2 + ext2 at inv_pi[i];
//   staged (the launch's choice for larger groups): in ws [B, decode_row]
//     in device memory; each pass takes a row at a time through one shared
//     staging row (cp.async in), so its gathers read shared memory; HI2
//     stores ext2 over lin1, and the latch pass reads ext1 in order beside
//     it (latch_rows_staged).
// Per iteration: HI1, a barrier, the exchange, HI2, a barrier, the latch
// pass, a barrier; a zero CRC word latches the row (its bits frozen, the
// iteration kept); a barrier. A latched row's lanes skip their work from
// then on: its outputs are fixed, so both stop modes run the same work and
// differ only in iters (the latch's iteration with dynamic_stop, else
// n_iter). The block leaves the loop when all its rows have latched. At
// the end the decisions go to bits once, coalesced (zeros for a row that
// never latched). The float32 operations are the loop's, in its order,
// adds only: the packed XOR equals remainder(bits @ H, 2) == 0 exactly.
//
// What bounds it: the two half-iterations' operations (128 a position each,
// as v2); the bytes are llr_d read once, the plans and the outputs. What
// sets its pace (NVIDIA H100 80GB HBM3, 700 W; scripts/decode_times): each
// lane is a serial chain of about 0.1 ms a half-iteration at any occupancy
// up to v2's, so a group's rows must all be resident (one wave) to reach
// v2's rate, and at a few rows an SM the work in that chain sets the time.
// On chip a row of the largest K takes 137 KB, one an SM; staged, a block
// needs one staging row (22.5 KB at K = 5,632), so the flagship's 1,408
// rows fit at once.
constexpr int kDecodeThreads = 384;  // at most, a block: 168 registers each
constexpr int kDecodeMaxRows = 4;    // rows a block, at most
constexpr int kSmallGridThreads = 256;  // threads a block at least, where SMs idle

// The tail values of a row, 36.212's tail mapping of the d0/d1/d2 streams
// [3, K + 4]: stream s (lin1, par1, lin2, par2; on chip, row kTailRow[s]
// of a code block's rows) value j is d[kTailD[s][j]][K + kTailOff[s][j]].
__device__ constexpr int kTailD[4][3] = {{0, 2, 1}, {1, 0, 2}, {0, 2, 1}, {1, 0, 2}};
__device__ constexpr int kTailOff[4][3] = {{0, 0, 1}, {0, 1, 1}, {2, 2, 3}, {2, 3, 3}};
__device__ constexpr int kTailRow[4] = {0, 2, 1, 3};

// Words of a row's decision bits, a multiple of 4 (16 bytes).
__host__ __device__ constexpr int dec_words(int K) { return (K + 127) / 128 * 4; }

__device__ __forceinline__ unsigned dec_bit(const unsigned* dec, int q) {
  return (dec[q >> 5] >> (q & 31)) & 1u;
}

// Floats of a code block's rows (in shared memory on chip, in ws staged):
// lin1, lin2, par1 and par2 of N each (rounded up to 16 bytes), D and ext
// of K.
__host__ __device__ constexpr long long decode_row(int K, int N) {
  return 4LL * ((N + 3) / 4 * 4) + 2LL * K;
}

// Dynamic shared memory of a block of `rows` rows: on chip, the rows;
// staged, one staging row of K; and the decision bits a row.
__host__ __device__ constexpr long long decode_smem_bytes(int rows, int K, int N,
                                                          bool staged) {
  return 4LL * (staged ? K : rows * decode_row(K, N)) +
         4LL * rows * dec_words(K);
}

// Positions a thread takes at once in the row passes: their loads are in
// flight together.
constexpr int kPass = 4;

// A row pass: for each unlatched row r of the block, dst_r[j] = (add_r[j]
// +) src_r[perm[j]], j < K (x_r = x + r * x_rs). With STAGE (src in device
// memory) the source row comes into the shared staging row by cp.async
// first (no registers, all of a thread's 16-byte pieces in flight at
// once), so the gathers read shared memory; dst may then be src. The rows
// are written in order. s_iter is block-uniform.
template <bool ADD, bool STAGE>
__device__ __forceinline__ void permute_rows(
    const float* src, long long src_rs, float* dst, long long dst_rs,
    const float* __restrict__ add, long long add_rs,
    const int* __restrict__ perm, float* stage, int nr, int K,
    const int* s_iter) {
  const int n4 = K / 4, nt = blockDim.x;
  const int4* p4 = reinterpret_cast<const int4*>(perm);
  for (int r = 0; r < nr; ++r) {
    if (s_iter[r] != 0) continue;
    const float* from = src + r * src_rs;
    if constexpr (STAGE) {
      for (int i = 4 * threadIdx.x; i < K; i += 4 * nt)
        __pipeline_memcpy_async(stage + i, from + i, 16);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      from = stage;
    }
    float4* to = reinterpret_cast<float4*>(dst + r * dst_rs);
    const float4* a4 = reinterpret_cast<const float4*>(add + r * add_rs);
    for (int j0 = threadIdx.x; j0 < n4; j0 += kPass * nt) {
      int4 q[kPass];
      float4 a[kPass];
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int j = j0 + u * nt;
        if (j < n4) {
          q[u] = p4[j];
          if constexpr (ADD) a[u] = a4[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int j = j0 + u * nt;
        if (j < n4) {
          float4 v = make_float4(from[q[u].x], from[q[u].y], from[q[u].z],
                                 from[q[u].w]);
          if constexpr (ADD)
            v = make_float4(a[u].x + v.x, a[u].y + v.y, a[u].z + v.z, a[u].w + v.w);
          to[j] = v;
        }
      }
    }
    if constexpr (STAGE) __syncthreads();
  }
}

// The staged latch pass: for each unlatched row r of the block, with ext2
// in e2_r (brought into the shared staging row by cp.async first) and
// ext1 in x1_r: lin1_r[i] = d0_r[i] + la1 with la1 = ext2[inv_pi[i]],
// written over ext2 in place, and the bit of position i, (a1 + la1) < 0
// with a1 = d0_r[i] + ext1[i] (the loop's sys + ext1; lin2 at inv_pi[i]
// holds the same float), into the row's decision words, and the payload's
// CRC word: the XOR of the packed rows crc_rows[i - F] of its set bits.
// Rows are r * rs apart (d0: row3).
__device__ __forceinline__ void latch_rows_staged(
    float* e2, const float* __restrict__ x1, long long rs,
    const float* __restrict__ d0, long long row3,
    const int* __restrict__ inv_pi, const unsigned* __restrict__ crc_rows,
    float* stage, unsigned* dec, int DW, unsigned* s_x, int nr, int K, int F,
    const int* s_iter) {
  const int n4 = K / 4, nt = blockDim.x;
  const int4* q4 = reinterpret_cast<const int4*>(inv_pi);
  for (int r = 0; r < nr; ++r) {
    if (s_iter[r] != 0) continue;
    float* e2_r = e2 + r * rs;
    for (int i = 4 * threadIdx.x; i < K; i += 4 * nt)
      __pipeline_memcpy_async(stage + i, e2_r + i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    float4* l1 = reinterpret_cast<float4*>(e2_r);
    const float4* a4 = reinterpret_cast<const float4*>(x1 + r * rs);
    const float4* d4 = reinterpret_cast<const float4*>(d0 + r * row3);
    unsigned* dec_r = dec + r * DW;
    unsigned x = 0u;
    for (int j0 = threadIdx.x; j0 < n4; j0 += kPass * nt) {
      int4 q[kPass];
      float4 sy[kPass], e1[kPass];
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int j = j0 + u * nt;
        if (j < n4) {
          q[u] = q4[j];
          sy[u] = d4[j];
          e1[u] = a4[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int j = j0 + u * nt;
        if (j < n4) {
          const float4 la = make_float4(stage[q[u].x], stage[q[u].y],
                                        stage[q[u].z], stage[q[u].w]);
          l1[j] = make_float4(sy[u].x + la.x, sy[u].y + la.y, sy[u].z + la.z,
                              sy[u].w + la.w);
          const float4 a1 = make_float4(sy[u].x + e1[u].x, sy[u].y + e1[u].y,
                                        sy[u].z + e1[u].z, sy[u].w + e1[u].w);
          const unsigned nib = (unsigned)(a1.x + la.x < 0.f) |
                               (unsigned)(a1.y + la.y < 0.f) << 1 |
                               (unsigned)(a1.z + la.z < 0.f) << 2 |
                               (unsigned)(a1.w + la.w < 0.f) << 3;
          if (nib != 0u) {
            atomicOr(dec_r + (j >> 3), nib << ((j & 7) * 4));
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if ((nib >> k & 1u) && 4 * j + k >= F) x ^= crc_rows[4 * j + k - F];
          }
        }
      }
    }
    if (x != 0u) atomicXor(s_x + r, x);
    __syncthreads();
  }
}

// ck: the checkpoints [W/R, B * n_w, 8]. A code block's rows (decode_row):
// lin1, lin2, par1 and par2 of N floats, their tail values (36.212's
// mapping) and BIG past K + 3 written once, so that the body reads them
// as v2 reads its rows, D = d0[pi] and ext; on chip in shared memory,
// staged in ws [B, decode_row].
template <int R, bool STAGED>
__global__ void __launch_bounds__(kDecodeThreads, 1)
turbo_decode_kernel(const float* __restrict__ llr_d,
                    const int* __restrict__ pi, const int* __restrict__ inv_pi,
                    const unsigned* __restrict__ crc_rows, float* ws,
                    float* ck, int* bits, unsigned char* done, int* iters,
                    int B, int K, int F, int n_w, int W, int U, int n_iter,
                    int dynamic_stop, int rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_x[kDecodeMaxRows];  // a row's CRC word this iteration
  __shared__ int s_iter[kDecodeMaxRows];    // the latch's iteration, 0 before
  __shared__ int s_live;                    // rows not latched
  const int b0 = blockIdx.x * rows;
  const int nr = min(rows, B - b0);         // this block's rows
  const int nl = nr * n_w;                  // and lanes
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int DW = dec_words(K);
  const long long row3 = 3LL * (K + 4);
  const float* d_blk = llr_d + b0 * row3;
  // Row r's rows at base + r * rs: HI1 reads in1 (lin1) and stores ext1
  // in ext, the exchange makes lin2 = D + ext1[pi] in in2, HI2 reads in2
  // and stores ext2 in out2 (on chip ext; staged in1, since the latch pass
  // then reads ext1 too), the latch makes lin1 = d0 + ext2[inv_pi] in in1.
  const int N = n_w * W, Np = (N + 3) / 4 * 4;
  const long long rs = decode_row(K, N);
  float* stage = smem;                                   // staged: [K]
  float* base = STAGED ? ws + b0 * rs : smem;
  float* in1 = base;
  float* in2 = base + Np;
  float* par = base + 2 * Np;
  float* dpi = base + 4 * Np;
  float* ext = dpi + K;
  float* out2 = STAGED ? in1 : ext;
  unsigned* dec = reinterpret_cast<unsigned*>(smem + (STAGED ? K : rows * rs));
  const long long ck_stride = (long long)B * n_w * 8;

  if (tid < nr) { s_x[tid] = 0u; s_iter[tid] = 0; }
  if (tid == 0) s_live = nr;
  // lin1 = d0 + la1 (la1 = 0), par1 and par2, a float4 of each at a time,
  // kPass of them in flight a thread; each row's four streams s past K:
  // the tail values d[kTailD[s][j]][K + kTailOff[s][j]], then BIG.
  const int n4 = K / 4, s4 = (K + 4) / 4, p4 = Np / 4;
  for (int i0 = tid; i0 < nr * n4; i0 += kPass * nt) {
    float4 v[kPass][3];
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int i = i0 + u * nt;
      if (i < nr * n4) {
        const int r = i / n4, j = i - r * n4;
        const float4* d = reinterpret_cast<const float4*>(d_blk + r * row3);
#pragma unroll
        for (int c = 0; c < 3; ++c) v[u][c] = d[c * s4 + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int i = i0 + u * nt;
      if (i < nr * n4) {
        const int r = i / n4, j = i - r * n4;
        float4* row = reinterpret_cast<float4*>(in1 + r * rs);
        row[j] = make_float4(v[u][0].x + 0.f, v[u][0].y + 0.f,
                             v[u][0].z + 0.f, v[u][0].w + 0.f);
        row[2 * p4 + j] = v[u][1];
        row[3 * p4 + j] = v[u][2];
      }
    }
  }
  for (int i = tid; i < nr * 16; i += nt) {
    const int r = i / 16, s = i % 16 / 4, q = i % 4;
    const float v = q < 3 ? d_blk[r * row3 + kTailD[s][q] * (K + 4) + K + kTailOff[s][q]]
                          : BIG;
    float* row = base + r * rs + kTailRow[s] * Np;
    for (int k = K + q; k < (q < 3 ? K + q + 1 : N); ++k) row[k] = v;
  }
  __syncthreads();
  permute_rows<false, STAGED>(d_blk, row3, dpi, rs, nullptr, 0, pi, stage, nr,
                              K, s_iter);

  for (int it = 0; it < n_iter && s_live > 0; ++it) {
    for (int i = tid; i < nr * DW; i += nt)
      if (s_iter[i / DW] == 0) dec[i] = 0u;
    for (int l = tid; l < nl; l += nt) {
      const int r = l / n_w, w = l - r * n_w;
      if (s_iter[r] != 0) continue;
      float* out_r = ext + r * rs;
      const int row = w * W;
      auto store = [=](int p, const float* o, const float* cu) {
        const int P = row + p;
        if (P >= K) return;
        float e[R];
#pragma unroll
        for (int k = 0; k < R; ++k) e[k] = o[k] - cu[k];
        store_block<R>(out_r + P, e);
      };
      half_iter_lane<R>(in1 + r * rs + row, par + r * rs + row,
                        ck + ((long long)b0 * n_w + l) * 8, ck_stride, w, n_w,
                        W, U, store);
    }
    __syncthreads();
    permute_rows<true, STAGED>(ext, rs, in2, rs, dpi, rs, pi, stage, nr, K,
                               s_iter);
    if constexpr (!STAGED) __syncthreads();
    for (int l = tid; l < nl; l += nt) {
      const int r = l / n_w, w = l - r * n_w;
      if (s_iter[r] != 0) continue;
      float* out_r = out2 + r * rs;
      const int row = w * W;
      auto store = [=](int p, const float* o, const float* cu) {
        const int P = row + p;
        if (P >= K) return;
        float e[R];
#pragma unroll
        for (int k = 0; k < R; ++k) e[k] = o[k] - cu[k];
        store_block<R>(out_r + P, e);
      };
      half_iter_lane<R>(in2 + r * rs + row, par + Np + r * rs + row,
                        ck + ((long long)b0 * n_w + l) * 8, ck_stride, w, n_w,
                        W, U, store);
    }
    __syncthreads();
    if constexpr (STAGED) {
      latch_rows_staged(in1, ext, rs, d_blk, row3, inv_pi, crc_rows, stage,
                        dec, DW, s_x, nr, K, F, s_iter);
    } else {
      // The latch pass: lin1 = d0 + la1, la1 = ext2[inv_pi], and the bit of
      // each position, (lin2 + ext2)[inv_pi] < 0, with the payload's CRC.
      for (int r = 0; r < nr; ++r) {
        if (s_iter[r] != 0) continue;
        const float* e2 = ext + r * rs;
        const float* l2 = in2 + r * rs;
        float* l1 = in1 + r * rs;
        const float* d0 = d_blk + r * row3;
        unsigned* dec_r = dec + r * DW;
        unsigned x = 0u;
        for (int i0 = tid; i0 < K; i0 += kPass * nt) {
          int q[kPass];
          float sy[kPass];
          unsigned c[kPass];
#pragma unroll
          for (int u = 0; u < kPass; ++u) {
            const int i = i0 + u * nt;
            q[u] = i < K ? inv_pi[i] : 0;
            sy[u] = i < K ? d0[i] : 0.f;
            c[u] = i < K && i >= F ? crc_rows[i - F] : 0u;
          }
#pragma unroll
          for (int u = 0; u < kPass; ++u) {
            const int i = i0 + u * nt;
            if (i < K) {
              const float e = e2[q[u]];
              l1[i] = sy[u] + e;
              if (l2[q[u]] + e < 0.f) {
                atomicOr(dec_r + (i >> 5), 1u << (i & 31));
                x ^= c[u];
              }
            }
          }
        }
        if (x != 0u) atomicXor(s_x + r, x);
      }
      __syncthreads();
    }
    if (tid < nr && s_iter[tid] == 0) {
      if (s_x[tid] == 0u) {
        s_iter[tid] = it + 1;
        atomicSub(&s_live, 1);
      }
      s_x[tid] = 0u;
    }
    __syncthreads();
  }

  for (int i = tid; i < nr * K; i += nt) {
    const int r = i / K, k = i - r * K;
    bits[(long long)b0 * K + i] =
        s_iter[r] != 0 ? (int)dec_bit(dec + r * DW, k) : 0;
  }
  if (tid < nr) {
    done[b0 + tid] = (unsigned char)(s_iter[tid] != 0);
    iters[b0 + tid] = dynamic_stop && s_iter[tid] != 0 ? s_iter[tid] : n_iter;
  }
}

// A launch that takes more than the 48 KB of dynamic shared memory every
// launch may take opts its kernel in first, on the current device.
template <typename Kernel>
int allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

// The decode's layout on the current device: rows a block, and whether the
// exchange rows are staged through device memory. On chip when the group's
// rows all fit the SMs' shared memory at once: as few rows a block as give
// every SM a block (at most kDecodeMaxRows), no more than a block's shared
// memory holds. Else staged at 2 rows a block. Returns rows + 256 * staged.
extern "C" int turbo_decode_plan(int B, int K, int N) {
  int dev = 0, n_sm = 1, optin = 48 * 1024, per_sm = 48 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const long long row = decode_smem_bytes(1, K, N, false);
  const bool staged = row > optin || (long long)B > n_sm * (per_sm / row);
  if (staged) return 2 + 256;
  int rows = (B + n_sm - 1) / n_sm;
  rows = rows < 1 ? 1 : rows > kDecodeMaxRows ? kDecodeMaxRows : rows;
  while (rows > 1 && decode_smem_bytes(rows, K, N, false) > optin) --rows;
  return rows;
}

// llr_d: [B, 3, K + 4] float32, 16-byte aligned, K a multiple of 8 (every
// QPP size); pi, inv_pi: [K] int32 (the QPP permutation and its inverse),
// 16-byte aligned; crc_rows: [K - F] the packed rows of crc_matrix(K - F);
// ws: with staged, [B, decode_row(K, n_w W)] float32, 16-byte aligned;
// scr: the checkpoints, [(W / R) * B * n_w * 8] float32; bits: [B, K]
// int32, done: [B] bool, iters: [B] int32, all written. rows, staged: the
// layout (turbo_decode_plan). Returns cudaGetLastError().
extern "C" int turbo_decode_launch(const void* llr_d, const void* pi,
                                   const void* inv_pi, const void* crc_rows,
                                   void* ws, void* scr, void* bits,
                                   void* done, void* iters, int B, int K,
                                   int F, int n_w, int W, int U, int R,
                                   int n_iter, int dynamic_stop, int rows,
                                   int staged, void* stream) {
  if (B <= 0 || K <= 0 || K % 8 != 0 || F < 0 || F >= K || n_iter < 0 ||
      W <= 0 || U <= 0 || U > W || W % R != 0 || U % R != 0 || n_w <= 0 ||
      (long long)n_w * W < K + 3 || rows < 1 || rows > kDecodeMaxRows)
    return (int)cudaErrorInvalidValue;
  const long long smem = decode_smem_bytes(rows, K, n_w * W, staged != 0);
  // A thread a lane, and at least kSmallGridThreads a block where the grid
  // leaves SMs idle (its row passes go faster with more threads).
  int dev = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const dim3 grid((B + rows - 1) / rows);
  int threads = (rows * n_w + 31) / 32 * 32;
  if ((int)grid.x < n_sm && threads < kSmallGridThreads) threads = kSmallGridThreads;
  if (threads > kDecodeThreads) threads = kDecodeThreads;
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
  int err = 0;
#define TURBO_DECODE(RR, ST)                                                  \
  err = allow_smem(turbo_decode_kernel<RR, ST>, smem);                        \
  if (err == 0)                                                               \
    turbo_decode_kernel<RR, ST><<<grid, threads, smem, st>>>(                 \
        l, p, q, c, w, s, o, d, n, B, K, F, n_w, W, U, n_iter, dynamic_stop,  \
        rows)
#define TURBO_DECODE_R(RR)                                                    \
  if (staged) { TURBO_DECODE(RR, true); } else { TURBO_DECODE(RR, false); }
  switch (R) {
    case 8: TURBO_DECODE_R(8); break;
    case 4: TURBO_DECODE_R(4); break;
    case 2: TURBO_DECODE_R(2); break;
    case 1: TURBO_DECODE_R(1); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TURBO_DECODE_R
#undef TURBO_DECODE
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
