// Tail-biting Viterbi decoder of the 36.212 §5.1.3.1 convolutional code
// (rate 1/3, constraint length 7, generators 0133, 0171, 0165): 64-state
// add-compare-select (ACS) over n_wrap copies of the frame, then the
// traceback of the middle copy. Two entries share one ACS:
//
//   viterbi_launch         llrs [R, 3, K] -> out [R, K] (the PBCH, the CQI);
//   viterbi_search_launch  a whole DCI blind search: llr_cces [B, W], the
//                          control region, and a search plan -> out
//                          [n_cand * B, K], candidate-major; each
//                          candidate's de-rate-matching runs in the load
//                          phase.
//
// Replaces openair4g_tpu/ops/convcode.py viterbi_decode. That is no Pallas
// kernel but two lax.scans, the ACS over T = n_wrap K steps and the reverse
// traceback, which XLA compiles into the step's one device program; the
// search entry also replaces the candidate loop of
// openair4g_tpu/phy/pdcch.py dci_blind_decode (a slice and
// cc_rate_match_rx a candidate, then a concatenation), which XLA fuses into
// that program's input. The port's plain versions are
// ops/convcode.viterbi_decode_ref (both scans as Python loops) and
// ops/convcode.viterbi_search_ref (the candidate loop, then
// viterbi_decode_ref).
//
// Function: x at step t is the row's three LLRs at k = t mod K (positive
// <=> coded bit 0) and every metric starts at 0. out: the decisions of the
// middle copy, steps [(n_wrap / 2) K, (n_wrap / 2) K + K). It equals the
// plain version bit for bit, so every count a path held before stays the
// same:
//   bm[s', j] = (x0 s0 + x1 s1) + x2 s2, s = +-1 the output bits of the
//     transition from predecessor 2 (s' & 31) + j into s' (u = s' >> 5);
//     a product by -1 is a sign flip, and the two adds are __fadd_rn, which
//     the compiler neither fuses nor reorders;
//   choice = cand[1] > cand[0] (a tie takes the lower predecessor), new =
//     the larger, metric = new - (max over the 64 states);
//   the traceback starts from the lowest-index state among the final
//     maxima (torch.argmax's and jnp.argmax's pick): after the last
//     normalisation these are exactly the metrics equal to 0, since a - b
//     is 0 only for a == b (no flush to zero here);
//   u = s' >> 5 and s = 2 (s' & 31) + choice, back to the middle copy.
// The search's load phase is ops/rate_match.cc_rate_match_rx of each
// candidate's E = 72 L LLRs: folded[i] = the sum over r of e[r L + i]
// (L the circular buffer's length, the zero pad past E), added as torch's
// CUDA reduction adds a strided dimension (four accumulators from +0, input
// r into accumulator r mod 4 in increasing r, then ((a0 + a1) + a2) + a3),
// or e[i] alone when E <= L; then d[j] = folded[map[j]] * (map[j] >= 0),
// map = make_cc_rate_match_maps(K, E).d_from_order (folded[0] where map[j]
// < 0).
//
// What bounds it: the chain of dependent steps. A row reads 12 K bytes (the
// search: its candidates' share of the control region) and writes K, and
// does about 6 float32 operations a state and step: at the full chain's
// 2,816 rows of T = 129 that is 1.6 MB and 0.14 G operations, 4.2 µs at
// the card's float32 rate, while each row is T dependent ACS steps (each a
// 64-way max) and up to T dependent traceback steps.
//
// Design: 8 lanes a row, 8 states a lane, 4 rows a warp. The butterfly of
// old states 2x, 2x + 1 into new states x, x + 32 uses one branch metric b
// and its negation (every generator taps both the input and the oldest
// bit): new[x] from (m[2x] + b, m[2x+1] - b), new[x+32] from (m[2x] - b,
// m[2x+1] + b). A lane holding both old states of its four butterflies
// computes them with no exchange. The state's bits name a lane (3 of them)
// and a register (the other 3); one step moves every bit down one place, so
// the lane bits go {3,4,5} -> {2,3,4} -> {1,2,3} -> {0,1,2}: three steps in
// registers, then an 8 x 8 transpose through 288 bytes of shared memory
// restores {3,4,5}. b is linear in the state's bits, so a lane flips the
// signs of its x once for its lane bits and picks b from 4 sums with
// signs fixed at compile time. The max is 7 fmaxf in the lane and 3
// __shfl_xor_sync levels. A lane keeps its 8 choice bits a step in a
// register over the 3 steps of a cycle and stores one word a cycle; lane 0
// of the row traces back through those words, a cycle's 8 in registers
// (the next cycle's loaded meanwhile), picked by a tree of selects. Shared memory a row: its
// inputs as float4 (16 K bytes), 32 bytes of choices a cycle, the transpose
// buffer; above 48 KB a block takes the opt-in. The search runs a block a
// (TB row, chunk of up to 16 candidates; the launcher picks the chunk from
// the shared memory it needs): the block stages the span of the control
// region its candidates read, and the rate-matching maps, once, and each
// 8-lane group de-rate-matches its candidate from them into its inputs,
// then decodes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 2048;        // n_wrap K; ops/convcode.MAX_T
constexpr int kLanes = 8;          // lanes a row
constexpr int kTbFloats = 72;      // transpose buffer a row (64 + a pad)
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;   // 227 KB, the opt-in's limit
constexpr int kSearchGroups = 16;  // the search's candidates a block at most
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int generator(int c) {
  return c == 0 ? 0133 : c == 1 ? 0171 : 0165;
}

// Bit c: output bit c of the transition from 2x into x (u = 0), the parity
// of (x << 1) under generator c. Linear in x over GF(2).
__host__ __device__ constexpr int out_bits(int x) {
  int bits = 0;
  for (int c = 0; c < 3; ++c) {
    int v = (x << 1) & generator(c), p = 0;
    for (; v; v &= v - 1) p ^= 1;
    bits |= p << c;
  }
  return bits;
}

// The register part of x = s' & 31 of butterfly i at phase ph (the lane
// part is 4 g, 2 g, g).
__host__ __device__ constexpr int reg_x(int ph, int i) {
  return ph == 0 ? i : ph == 1 ? 16 * (i >> 1) + (i & 1) : 8 * i;
}

// The cycle's three layouts, state s of lane g, register r:
//   before phase 0 (A): s = 8 g + r;
//   after phase 0  (B): s = 32 (r >> 2) + 4 g + (r & 3);
//   after phase 1  (C): s = 32 (r >> 2) + 16 ((r >> 1) & 1) + 2 g + (r & 1);
//   after phase 2  (D): s = 8 r + g, transposed back to A.
__device__ __forceinline__ int state_of(int layout, int g, int r) {
  return layout == 0 ? 8 * g + r
       : layout == 1 ? 32 * (r >> 2) + 4 * g + (r & 3)
       : 32 * (r >> 2) + 16 * ((r >> 1) & 1) + 2 * g + (r & 1);
}

// Shared memory of a block of G rows (groups): inputs [G][K] float4, the
// transpose buffers [G][72] float, choice words [cycles][G][8].
__host__ __device__ constexpr long long group_bytes(int K, int T) {
  return 16LL * K + 4LL * kTbFloats + 32LL * ((T + 2) / 3);
}

// Sign masks of x0, x1, x2 for the lane part xl of x: b(c ^ d) = (s(d0) y0
// + s(d1) y1) + s(d2) y2 with y = x, its signs flipped by c = out_bits(xl).
__device__ __forceinline__ uint3 lane_signs(int xl) {
  const int c = out_bits(xl);
  return make_uint3((c & 1) << 31, ((c >> 1) & 1) << 31,
                    ((c >> 2) & 1) << 31);
}

// One butterfly: old registers 2 I, 2 I + 1 -> new registers I (u = 0) and
// I + 4 (u = 1); choice bits 8 PH + I and 8 PH + I + 4 of the word.
template <int PH, int I>
__device__ __forceinline__ void butterfly(const float (&m)[8],
                                          const float (&q)[4], float (&n)[8],
                                          unsigned& word) {
  // b = s0 y0 + s1 y1 + s2 y2 for d = the register part's output bits, from
  // q = {ap + y2, ap - y2, am + y2, am - y2}, ap = y0 + y1, am = y0 - y1.
  constexpr int d = out_bits(reg_x(PH, I));
  constexpr int idx = d == 0 || d == 7 ? 0 : d == 4 || d == 3 ? 1
                    : d == 2 || d == 5 ? 2 : 3;
  constexpr bool neg = d == 7 || d == 3 || d == 5 || d == 1;
  const float b = neg ? -q[idx] : q[idx];
  const float p0 = m[2 * I], p1 = m[2 * I + 1];
  const float c00 = __fadd_rn(p0, b), c01 = __fadd_rn(p1, -b);
  const float c10 = __fadd_rn(p0, -b), c11 = __fadd_rn(p1, b);
  const bool h0 = c01 > c00, h1 = c11 > c10;
  n[I] = h0 ? c01 : c00;
  n[I + 4] = h1 ? c11 : c10;
  word |= ((unsigned)h0 << (8 * PH + I)) | ((unsigned)h1 << (8 * PH + I + 4));
}

template <int PH>
__device__ __forceinline__ void acs_step(float (&m)[8], float4 x, uint3 sg,
                                         unsigned& word) {
  const float y0 = __uint_as_float(__float_as_uint(x.x) ^ sg.x);
  const float y1 = __uint_as_float(__float_as_uint(x.y) ^ sg.y);
  const float y2 = __uint_as_float(__float_as_uint(x.z) ^ sg.z);
  const float ap = __fadd_rn(y0, y1), am = __fadd_rn(y0, -y1);
  const float q[4] = {__fadd_rn(ap, y2), __fadd_rn(ap, -y2),
                      __fadd_rn(am, y2), __fadd_rn(am, -y2)};
  float n[8];
  butterfly<PH, 0>(m, q, n, word);
  butterfly<PH, 1>(m, q, n, word);
  butterfly<PH, 2>(m, q, n, word);
  butterfly<PH, 3>(m, q, n, word);
  float mx = fmaxf(fmaxf(fmaxf(n[0], n[1]), fmaxf(n[2], n[3])),
                   fmaxf(fmaxf(n[4], n[5]), fmaxf(n[6], n[7])));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
#pragma unroll
  for (int r = 0; r < 8; ++r) m[r] = __fsub_rn(n[r], mx);
}

// A cycle's 8 choice words (one a lane of the group) into registers.
__device__ __forceinline__ void load_words(const unsigned* c,
                                           unsigned (&w)[8]) {
  const uint4 a = reinterpret_cast<const uint4*>(c)[0];
  const uint4 b = reinterpret_cast<const uint4*>(c)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// One traceback step at step t (phase PH of its cycle, words w): the
// decision u = s >> 5 of the middle copy, then s = its predecessor. The
// lane and register of state s after phase PH are those of state_of.
template <int PH>
__device__ __forceinline__ void trace_step(const unsigned (&w)[8], int& s,
                                           int& t, int mid, int K,
                                           int8_t* us) {
  if (t < mid + K) us[t - mid] = (int8_t)(s >> 5);
  const int lane = PH == 0 ? (s >> 2) & 7 : PH == 1 ? (s >> 1) & 7 : s & 7;
  const int reg = PH == 0 ? (s & 3) | ((s >> 5) << 2)
                : PH == 1 ? (s & 1) | ((s >> 3) & 2) | ((s >> 5) << 2)
                : s >> 3;
  const unsigned w01 = lane & 1 ? w[1] : w[0], w23 = lane & 1 ? w[3] : w[2];
  const unsigned w45 = lane & 1 ? w[5] : w[4], w67 = lane & 1 ? w[7] : w[6];
  const unsigned lo = lane & 2 ? w23 : w01, hi = lane & 2 ? w67 : w45;
  const unsigned word = lane & 4 ? hi : lo;
  s = 2 * (s & 31) + (int)((word >> (8 * PH + reg)) & 1u);
  --t;
}

// The ACS and traceback of one row by its 8-lane group (lane g): xs its K
// inputs, tb its transpose buffer, choices its first choice word (a
// cycle's words cstride apart). The K decisions go to us, which may alias
// xs. Every lane of the warp calls this with the same K and n_wrap.
__device__ void decode_row(const float4* xs, int K, int n_wrap, float* tb,
                           unsigned* choices, int cstride, int8_t* us,
                           int g) {
  const int T = n_wrap * K;
  const uint3 sg0 = lane_signs(4 * g), sg1 = lane_signs(2 * g),
              sg2 = lane_signs(g);
  float m[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) m[r] = 0.f;
  int k = 0;
  float4 x = xs[0];
  int layout = 0;
  for (int t = 0, cyc = 0; t < T; t += 3, ++cyc) {
    unsigned word = 0;
    float4 cur = x;
    if (++k == K) k = 0;
    x = xs[k];
    acs_step<0>(m, cur, sg0, word);
    layout = 1;
    if (t + 1 < T) {
      cur = x;
      if (++k == K) k = 0;
      x = xs[k];
      acs_step<1>(m, cur, sg1, word);
      layout = 2;
    }
    if (t + 2 < T) {
      cur = x;
      if (++k == K) k = 0;
      x = xs[k];
      acs_step<2>(m, cur, sg2, word);
      __syncwarp();                    // the last cycle's reads of tb
#pragma unroll
      for (int r = 0; r < 8; ++r) tb[8 * r + g] = m[r];
      __syncwarp();
      const float4 a = reinterpret_cast<const float4*>(tb)[2 * g];
      const float4 b = reinterpret_cast<const float4*>(tb)[2 * g + 1];
      m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
      m[4] = b.x; m[5] = b.y; m[6] = b.z; m[7] = b.w;
      layout = 0;
    }
    choices[cyc * cstride + g] = word;
  }
  int best = 64;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (m[r] == 0.f) best = min(best, state_of(layout, g, r));
  best = min(best, __shfl_xor_sync(kFull, best, 1));
  best = min(best, __shfl_xor_sync(kFull, best, 2));
  best = min(best, __shfl_xor_sync(kFull, best, 4));
  __syncwarp();                  // every lane's reads of xs and choices done
  if (g == 0) {
    int s = best < 64 ? best : 0;
    const int mid = (n_wrap / 2) * K;
    int t = T - 1, cyc = t / 3;
    unsigned w[8], next[8];
    load_words(choices + cyc * cstride, w);
    for (int ph = t - 3 * cyc; t >= mid; ph = 2, --cyc) {
      if (cyc > 0) load_words(choices + (cyc - 1) * cstride, next);
      if (ph == 2) trace_step<2>(w, s, t, mid, K, us);
      if (ph >= 1 && t >= mid) trace_step<1>(w, s, t, mid, K, us);
      if (t >= mid) trace_step<0>(w, s, t, mid, K, us);
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = next[i];
    }
  }
  __syncwarp();
}

struct Smem {
  float4* xs;
  float* tb;
  unsigned* choices;
  float* region;      // the search: its chunk's span of the control
  int* maps;          // region (reach floats at most), then the plan's maps
};

__device__ __forceinline__ Smem carve(unsigned char* smem, int G, int K,
                                      int T, int reach) {
  Smem s;
  s.xs = reinterpret_cast<float4*>(smem);
  s.tb = reinterpret_cast<float*>(smem + 16LL * G * K);
  s.choices = reinterpret_cast<unsigned*>(smem + 16LL * G * K
                                          + 4LL * kTbFloats * G);
  s.region = reinterpret_cast<float*>(smem + G * group_bytes(K, T));
  s.maps = reinterpret_cast<int*>(s.region + reach);
  return s;
}

// dst[i] = src[i] for i < n by the whole block, 8 loads in flight a thread.
template <typename V>
__device__ __forceinline__ void copy_block(V* dst, const V* __restrict__ src,
                                           int n) {
  constexpr int kInFlight = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += kInFlight * blockDim.x) {
    V v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

// n 4-byte words from global to shared memory: 16 bytes a load where both
// ends are aligned and n is a multiple of 4 (a control region's spans are
// multiples of 72 LLRs), else one word a load.
__device__ __forceinline__ void stage(void* dst, const void* src, int n) {
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15)
          == 0 && n % 4 == 0)
    copy_block(static_cast<uint4*>(dst), static_cast<const uint4*>(src),
               n / 4);
  else
    copy_block(static_cast<unsigned*>(dst),
               static_cast<const unsigned*>(src), n);
}

__global__ void viterbi_kernel(const float* __restrict__ llrs,
                               int8_t* __restrict__ out, int R, int K,
                               int n_wrap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / kLanes;
  const int q = threadIdx.x / kLanes, g = threadIdx.x % kLanes;
  const long long first = (long long)blockIdx.x * G;
  if (first + (threadIdx.x >> 5) * 4 >= R) return;   // a warp with no row
  long long row = first + q;
  const bool active = row < R;
  if (!active) row = R - 1;
  const int T = n_wrap * K;
  const Smem s = carve(smem, G, K, T, 0);
  float4* xs = s.xs + (long long)q * K;
  float* xf = reinterpret_cast<float*>(xs);
  const float* in = llrs + row * 3 * K;
  for (int c = 0; c < 3; ++c)
    for (int k = g; k < K; k += kLanes) xf[4 * k + c] = in[c * K + k];
  __syncwarp();
  int8_t* us = reinterpret_cast<int8_t*>(xs);
  decode_row(xs, K, n_wrap, s.tb + q * kTbFloats, s.choices + q * kLanes,
             G * kLanes, us, g);
  if (active)
    for (int i = g; i < K; i += kLanes) out[row * K + i] = us[i];
}

// The search plan (ops/convcode._search_plan): desc [n_cand][4] = (start,
// E, L, map row) in LLRs; maps [n_maps][3 K] = d_from_order. Block (b,
// chunk) decodes candidates [chunk G, chunk G + G) of TB row b; reach bounds
// the span of the control region they read.
__global__ void viterbi_search_kernel(const float* __restrict__ llr,
                                      long long width, int B,
                                      const int* __restrict__ desc,
                                      const int* __restrict__ maps,
                                      int n_maps, int reach, int n_cand,
                                      int K, int n_wrap,
                                      int8_t* __restrict__ out,
                                      float* __restrict__ d_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / kLanes;
  const int b = blockIdx.x, first = blockIdx.y * G;
  const int T = n_wrap * K;
  const Smem s = carve(smem, G, K, T, reach);
  int lo = desc[4 * first], hi = 0;          // the chunk's [lo, hi)
  for (int c = first; c < min(first + G, n_cand); ++c) {
    lo = min(lo, desc[4 * c]);
    hi = max(hi, desc[4 * c] + desc[4 * c + 1]);
  }
  stage(s.region, llr + (long long)b * width + lo, hi - lo);
  stage(s.maps, maps, n_maps * 3 * K);
  __syncthreads();
  if (first + (threadIdx.x >> 5) * 4 >= n_cand) return;   // no candidate
  const int q = threadIdx.x / kLanes, g = threadIdx.x % kLanes;
  int c = first + q;
  const bool active = c < n_cand;
  if (!active) c = n_cand - 1;
  const int start = desc[4 * c], E = desc[4 * c + 1], L = desc[4 * c + 2];
  const int* map = s.maps + desc[4 * c + 3] * 3 * K;
  const float* e = s.region + (start - lo);
  float4* xs = s.xs + (long long)q * K;
  float* xf = reinterpret_cast<float*>(xs);
  const long long orow = (long long)c * B + b;
  for (int j = g; j < 3 * K; j += kLanes) {
    const int at = map[j];
    const int i = at >= 0 ? at : 0;
    float v;
    if (E <= L) {
      v = i < E ? e[i] : 0.f;
    } else {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r0 = 0; r0 * L < E; r0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pos = (r0 + u) * L + i;
          if (pos < E) a[u] = __fadd_rn(a[u], e[pos]);
        }
      }
      v = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    }
    const float d = __fmul_rn(v, at >= 0 ? 1.f : 0.f);
    const int cs = j / K, k = j - cs * K;
    xf[4 * k + cs] = d;
    if (d_out != nullptr && active) d_out[orow * 3 * K + j] = d;
  }
  if (d_out != nullptr) return;        // the load phase alone
  __syncwarp();
  int8_t* us = reinterpret_cast<int8_t*>(xs);
  decode_row(xs, K, n_wrap, s.tb + q * kTbFloats, s.choices + q * kLanes,
             G * kLanes, us, g);
  if (active)
    for (int i = g; i < K; i += kLanes) out[orow * K + i] = us[i];
}

// A launch that takes more than the 48 KB of dynamic shared memory every
// launch may take opts its kernel in to kMaxSmem first, on the current
// device (the attribute is per device; the same value every time, so
// launches from several threads do not race).
template <typename Kernel>
int allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

extern "C" int viterbi_launch(const void* llrs, void* out, int R, int K,
                              int n_wrap, void* stream) {
  if (R <= 0) return 0;
  if (K < 1 || n_wrap < 1 || (long long)n_wrap * K > kMaxT)
    return (int)cudaErrorInvalidValue;
  const long long per_row = group_bytes(K, n_wrap * K);
  const int rows = 8 * per_row <= kMaxSmem ? 8 : 4;    // rows a block
  const long long bytes = rows * per_row;
  const int err = allow_smem(viterbi_kernel, bytes);
  if (err != 0) return err;
  const int blocks = (R + rows - 1) / rows;
  viterbi_kernel<<<blocks, kLanes * rows, bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(llrs), static_cast<int8_t*>(out), R, K,
      n_wrap);
  return (int)cudaGetLastError();
}

// plan: int32 [4 n_cand + n_maps 3 K] (desc, maps); reach: the span of the
// control region from the first candidate's start to the furthest end.
// d_out non-null: write the load phase's d-stream LLRs [n_cand B, 3, K]
// there instead of decoding.
extern "C" int viterbi_search_launch(const void* llr, long long width, int B,
                                     const void* plan, int n_cand,
                                     int n_maps, int reach, int K, int n_wrap,
                                     void* out, void* d_out, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || n_wrap < 1 || (long long)n_wrap * K > kMaxT || n_cand < 1
      || n_maps < 1 || reach < 0)
    return (int)cudaErrorInvalidValue;
  // Candidates a block: up to kSearchGroups, a multiple of 4 (a warp's
  // rows), balanced over a row's blocks; fewer where a block's shared
  // memory would pass kMaxSmem.
  const long long per = group_bytes(K, n_wrap * K);
  const long long fixed = 4LL * reach + 12LL * n_maps * K;
  const int chunks = (n_cand + kSearchGroups - 1) / kSearchGroups;
  int groups = 4 * (((n_cand + chunks - 1) / chunks + 3) / 4);
  while (groups > 4 && groups * per + fixed > kMaxSmem) groups -= 4;
  const long long bytes = groups * per + fixed;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(viterbi_search_kernel, bytes);
  if (err != 0) return err;
  const int* p = static_cast<const int*>(plan);
  const int n_chunks = (n_cand + groups - 1) / groups;
  viterbi_search_kernel<<<dim3(B, n_chunks), kLanes * groups, bytes,
                          (cudaStream_t)stream>>>(
      static_cast<const float*>(llr), width, B, p, p + 4 * n_cand, n_maps,
      reach, n_cand, K, n_wrap, static_cast<int8_t*>(out),
      static_cast<float*>(d_out));
  return (int)cudaGetLastError();
}
