// Tail-biting Viterbi decoder of the 36.212 §5.1.3.1 convolutional code
// (rate 1/3, constraint length 7, generators 0133, 0171, 0165): 64-state
// add-compare-select (ACS) over n_wrap copies of the frame, then the
// traceback of the middle copy.
//
// Replaces openair4g_tpu/ops/convcode.py viterbi_decode. That is no Pallas
// kernel but two lax.scans, the ACS over T = n_wrap K steps and the reverse
// traceback, which XLA compiles into the step's one device program. The
// port's plain version (ops/convcode.viterbi_decode_ref) runs both scans as
// Python loops: about seven launches a trellis step, and a [T, R, 64, 2, 3]
// tensor of branch products.
//
// Function: llrs [R, 3, K] float32, positive <=> coded bit 0; x at step t is
// llrs[r, :, t mod K] and every metric starts at 0. out [R, K] int8: the
// decisions of the middle copy, steps [(n_wrap / 2) K, (n_wrap / 2) K + K).
// It equals the plain version bit for bit, so every count a path held
// before stays the same:
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
//
// What bounds it: the chain of dependent steps. A row reads 12 K bytes and
// writes K, and does about 6 float32 operations a state and step: at the
// full chain's 2,816 rows of T = 129 (22 candidates x 128) that is 1.6 MB
// and 0.14 G operations, 4.2 µs at the card's float32 rate, while each row
// is T dependent ACS steps and up to T dependent traceback steps, whatever
// the rows beside it. On an NVIDIA H100 80GB HBM3 at 700 W the kernel takes
// 55.8 µs of device time there and one row alone 26.5 µs: some 240 cycles
// a step, latency-bound up to about a wave of warps.
//
// Design: one warp a row. Lane l holds the metrics of states l and l + 32;
// both have the predecessors 2l and 2l + 1 (s' = (u << 5) | (s >> 1)),
// which the lane reads from lanes 2l mod 32 and 2l + 1 mod 32 by
// __shfl_sync, in the upper slot for l >= 16. The lane's 12 output bits are
// computed once from the generators. The row's 3 K inputs are staged in
// shared memory, each step's three a broadcast read. The max over the 64
// states is an fmaxf reduction by __shfl_xor_sync (exact). A step's
// choices are two __ballot_sync words, 8 bytes a step in shared memory.
// Lane 0 then traces back from the last step down to the middle copy's
// first only, into shared memory over the inputs, and the warp writes the K
// decisions out. No branch product is stored. A block holds as many rows
// as 48 KB of shared memory takes (at most 4), so no opt-in is needed; T
// is at most kMaxT.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 2048;        // n_wrap K; ops/convcode.MAX_T
constexpr int kMaxRows = 4;        // rows (warps) a block
constexpr int kBlockSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one row: T choice words, then the 3 K inputs (which the
// traceback's K decisions overwrite), rounded to 16 bytes.
__host__ __device__ constexpr int row_bytes(int K, int T) {
  return (8 * T + 12 * K + 15) & ~15;
}

__device__ __forceinline__ int generator(int c) {
  return c == 0 ? 0133 : c == 1 ? 0171 : 0165;
}

// Bit 3 j + c: output bit c of the transition from 2 (sp & 31) + j into sp,
// the parity of the encoder register (u << 6) | s under generator c.
__device__ __forceinline__ int output_bits(int sp) {
  int bits = 0;
  for (int j = 0; j < 2; ++j) {
    const int reg = ((sp >> 5) << 6) | (((sp & 31) << 1) + j);
    for (int c = 0; c < 3; ++c)
      bits |= (__popc(reg & generator(c)) & 1) << (3 * j + c);
  }
  return bits;
}

// (x0 s0 + x1 s1) + x2 s2 for the three output bits b (bit set: s = -1).
__device__ __forceinline__ float branch(float x0, float x1, float x2, int b) {
  const float a = (b & 1) ? -x0 : x0;
  const float c = (b & 2) ? -x1 : x1;
  const float d = (b & 4) ? -x2 : x2;
  return __fadd_rn(__fadd_rn(a, c), d);
}

__global__ void viterbi_kernel(const float* __restrict__ llrs,
                               int8_t* __restrict__ out, int R, int K,
                               int n_wrap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= R) return;
  const int T = n_wrap * K;
  unsigned long long* choices = reinterpret_cast<unsigned long long*>(
      smem + (size_t)warp * row_bytes(K, T));
  float* xs = reinterpret_cast<float*>(choices + T);
  const float* in = llrs + row * 3 * K;
  for (int i = lane; i < 3 * K; i += 32) xs[i] = in[i];
  __syncwarp();

  const int bits_lo = output_bits(lane), bits_hi = output_bits(lane + 32);
  const int src0 = (2 * lane) & 31, src1 = (2 * lane + 1) & 31;
  const bool upper = lane >= 16;
  float m_lo = 0.f, m_hi = 0.f;
  int k = 0;
  for (int t = 0; t < T; ++t) {
    const float x0 = xs[k], x1 = xs[K + k], x2 = xs[2 * K + k];
    if (++k == K) k = 0;
    const float a_lo = __shfl_sync(kFull, m_lo, src0);
    const float a_hi = __shfl_sync(kFull, m_hi, src0);
    const float b_lo = __shfl_sync(kFull, m_lo, src1);
    const float b_hi = __shfl_sync(kFull, m_hi, src1);
    const float p0 = upper ? a_hi : a_lo;     // metric of state 2 lane
    const float p1 = upper ? b_hi : b_lo;     // metric of state 2 lane + 1
    const float c0_lo = __fadd_rn(p0, branch(x0, x1, x2, bits_lo));
    const float c1_lo = __fadd_rn(p1, branch(x0, x1, x2, bits_lo >> 3));
    const float c0_hi = __fadd_rn(p0, branch(x0, x1, x2, bits_hi));
    const float c1_hi = __fadd_rn(p1, branch(x0, x1, x2, bits_hi >> 3));
    const bool ch_lo = c1_lo > c0_lo, ch_hi = c1_hi > c0_hi;
    const float n_lo = ch_lo ? c1_lo : c0_lo, n_hi = ch_hi ? c1_hi : c0_hi;
    float mx = fmaxf(n_lo, n_hi);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    m_lo = __fsub_rn(n_lo, mx);
    m_hi = __fsub_rn(n_hi, mx);
    const unsigned w_lo = __ballot_sync(kFull, ch_lo);
    const unsigned w_hi = __ballot_sync(kFull, ch_hi);
    if (lane == 0) choices[t] = (unsigned long long)w_hi << 32 | w_lo;
  }
  const unsigned z_lo = __ballot_sync(kFull, m_lo == 0.f);
  const unsigned z_hi = __ballot_sync(kFull, m_hi == 0.f);
  __syncwarp();                  // every lane's last read of xs is done
  int8_t* us = reinterpret_cast<int8_t*>(xs);
  if (lane == 0) {
    int s = z_lo ? __ffs(z_lo) - 1 : z_hi ? 31 + __ffs(z_hi) : 0;
    const int mid = (n_wrap / 2) * K;
    for (int t = T - 1; t >= mid; --t) {
      if (t < mid + K) us[t - mid] = (int8_t)(s >> 5);
      s = 2 * (s & 31) + (int)((choices[t] >> s) & 1ull);
    }
  }
  __syncwarp();
  int8_t* o = out + row * K;
  for (int i = lane; i < K; i += 32) o[i] = us[i];
}

}  // namespace

extern "C" int viterbi_launch(const void* llrs, void* out, int R, int K,
                              int n_wrap, void* stream) {
  if (R <= 0) return 0;
  if (K < 1 || n_wrap < 1 || (long long)n_wrap * K > kMaxT)
    return (int)cudaErrorInvalidValue;
  const int per_row = row_bytes(K, n_wrap * K);
  int rows = kBlockSmem / per_row;
  rows = rows < 1 ? 1 : rows > kMaxRows ? kMaxRows : rows;
  const int blocks = (R + rows - 1) / rows;
  viterbi_kernel<<<blocks, 32 * rows, rows * per_row, (cudaStream_t)stream>>>(
      static_cast<const float*>(llrs), static_cast<int8_t*>(out), R, K,
      n_wrap);
  return (int)cudaGetLastError();
}
