// The DLSCH receive bit chain on the card around the turbo decode kernel
// (36.212 5.1.4 in reverse, 5.1.1): the rate de-matching of every code
// block of a redundancy version with the HARQ soft combining, the d
// streams the decode kernel reads, and the TB's CRC24A check over the
// decoded payloads.
//
// Replaces no TPU kernel: the reference leaves this to XLA
// (openair4g_tpu/phy/pdsch.py DlschCodec.decode), and the port's plain
// version, which the CPU runs, is several small torch ops a code block
// (ops/rate_match.rate_match_rx and w_to_d_llr, the group's cat, the CRC
// as a GEMM). The work is bytes: e [B, G] in, the earlier round's soft
// buffers in (rv > 0), the new ones [B, sum L] and the d streams
// [B, sum 3 (K + 4)] out, float32; then the decoded bits in and the
// payload [B, TBS + 24] out, int32.
//
// Design.
// - dlsch_dematch_kernel: one block a (row, code block). Order-space
//   position j of the block's soft buffer takes the E LLRs at
//   (j - r_off) mod L + k L, k over the repetitions (rate_match_rx: the
//   fold, then the roll by r_off), so the new w is a coalesced rotation of
//   e, added to the old w (which may be any tensors: their addresses and
//   row strides come in the launch's parameters). It is stored once, and
//   built in shared memory (L <= 18,528 floats); the d streams are then
//   gathered from there through the block's d_from_order map (every row
//   of a block reads the same map, from L2), 16 bytes a lane, 0 where
//   never sent and 1e4 at the F fillers (w_to_d_llr), and stored at the
//   block's place in its (K, F) group's [n B, 3, K + 4] input, block-major
//   as the decode kernel takes it.
// - dlsch_tb_check_kernel: one block a row. Its threads copy each code
//   block's payload bits [F, K - L) of the decode kernel's output into
//   the row of b_hat, the TB bits and their CRC24A, and XOR the
//   per-position syndromes of the set ones (ops/crc.crc_packed_rows), zero
//   iff the CRC checks; the row's flag is that and every block's CRC latch
//   (the decode kernel's done flags).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_BLOCKS = 32;         // code blocks a TB (MAX_BLOCKS in
                                       // ops/dlsch_cuda.py)
constexpr int MAX_GROUPS = 3;          // (K, F) groups: K- with F, K-, K+
constexpr int MAX_L = 3 * 32 * 193;    // order-space size at K = 6,144
constexpr int DM_THREADS = 512;
constexpr int CK_THREADS = 1024;
constexpr int kDefaultSmem = 48 * 1024;

// A code block's row of the decode plan (ops/dlsch_cuda.decode_plan).
enum { D_K, D_F, D_E, D_EOFF, D_L, D_WOFF, D_DOFF, D_MOFF, D_GROUP, D_IDX,
       D_BOFF, D_NPAY, D_ROFF, D_FIELDS = D_ROFF + 4 };

// The earlier round's soft buffer of each code block: its row 0 and row
// stride (0 for a buffer broadcast over the rows).
struct OldW {
    const float* p[MAX_BLOCKS];
    long long stride[MAX_BLOCKS];
};

struct Decoded {
    const int* bits[MAX_GROUPS];
    const unsigned char* done[MAX_GROUPS];
};

// Group g's entry of a by-value parameter array, picked without indexing
// it at run time (which would copy the array to the stack).
template <typename T>
__device__ __forceinline__ T of_group(const T (&a)[MAX_GROUPS], int g) {
    return g == 0 ? a[0] : g == 1 ? a[1] : a[2];
}

// w_to_d_llr's gather: w at the order-space index, times the mask.
__device__ __forceinline__ float pick(const float* w, int m) {
    return w[m >= 0 ? m : 0] * (m >= 0 ? 1.f : 0.f);
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(FULL, v, o);
    return v;
}

__global__ void __launch_bounds__(DM_THREADS)
dlsch_dematch_kernel(const float* __restrict__ e, long long e_stride,
                     OldW old, int has_old, float* __restrict__ w, int wtot,
                     float* __restrict__ d, const int* __restrict__ desc,
                     const int* __restrict__ maps, int C, int B, int rv)
{
    extern __shared__ float s_w[];
    const int row = blockIdx.x / C, r = blockIdx.x % C;
    const int* s = desc + r * D_FIELDS;
    const int K = s[D_K], F = s[D_F], E = s[D_E], L = s[D_L];
    const int roff = s[D_ROFF + rv];
    const int reps = (E + L - 1) / L;
    const float* er = e + row * e_stride + s[D_EOFF];
    const float* wo = has_old ? old.p[r] + row * old.stride[r] : nullptr;
    float* wn = w + (size_t)row * wtot + s[D_WOFF];

    // The soft buffer: the repetitions summed in order from 0 (a zero-
    // padded e's sum), rotated, then added to the old w.
    for (int j = threadIdx.x; j < L; j += DM_THREADS) {
        int p = j - roff;
        if (p < 0) p += L;
        float v;
        if (reps == 1) {
            v = p < E ? er[p] : 0.f;
        } else {
            v = 0.f;
            for (int q = p; q < reps * L; q += L) v += q < E ? er[q] : 0.f;
        }
        if (wo) v = wo[j] + v;
        s_w[j] = v;
        wn[j] = v;
    }
    __syncthreads();

    // The d streams, four positions a lane.
    const int n = 3 * (K + 4);
    const int4* m4 = reinterpret_cast<const int4*>(maps + s[D_MOFF]);
    float4* out = reinterpret_cast<float4*>(
        d + (size_t)B * s[D_DOFF] + (size_t)row * n);
    for (int i = threadIdx.x; i < n / 4; i += DM_THREADS) {
        const int4 m = __ldg(m4 + i);
        float4 o = make_float4(pick(s_w, m.x), pick(s_w, m.y),
                               pick(s_w, m.z), pick(s_w, m.w));
        const int k = 4 * i;
        if (k < F) {
            o.x = 1e4f;
            if (k + 1 < F) o.y = 1e4f;
            if (k + 2 < F) o.z = 1e4f;
            if (k + 3 < F) o.w = 1e4f;
        }
        out[i] = o;
    }
}

__global__ void __launch_bounds__(CK_THREADS)
dlsch_tb_check_kernel(Decoded dec, const int* __restrict__ desc, int C,
                      const int* __restrict__ rows, int nb,
                      int* __restrict__ b_hat, bool* __restrict__ tb_ok,
                      int B)
{
    __shared__ uint32_t acc[CK_THREADS / 32];
    const int row = blockIdx.x;
    int flag = 1;
    if ((int)threadIdx.x < C) {
        const int* s = desc + threadIdx.x * D_FIELDS;
        flag = of_group(dec.done, s[D_GROUP])[(size_t)s[D_IDX] * B + row]
               != 0;
    }
    uint32_t x = 0;
    for (int r = 0; r < C; ++r) {
        const int* s = desc + r * D_FIELDS;
        const int K = s[D_K], n = s[D_NPAY], boff = s[D_BOFF];
        const int* src = of_group(dec.bits, s[D_GROUP])
                         + ((size_t)s[D_IDX] * B + row) * K + s[D_F];
        int* dst = b_hat + (size_t)row * nb + boff;
        const int* syn = rows + boff;
#pragma unroll 4
        for (int k = threadIdx.x; k < n; k += CK_THREADS) {
            const int bit = src[k];
            const uint32_t sy = (uint32_t)__ldg(syn + k);
            dst[k] = bit;
            if (bit) x ^= sy;
        }
    }
    flag = __syncthreads_and(flag);
    x = warp_xor(x);
    if ((threadIdx.x & 31) == 0) acc[threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x < 32) {
        x = warp_xor(acc[threadIdx.x]);
        if (threadIdx.x == 0) tb_ok[row] = flag && x == 0;
    }
}

}  // namespace

// old: 2 C values, each block's soft buffer address and row stride (in
// floats), read only where has_old.
extern "C" int dlsch_dematch_launch(const float* e, long long e_stride,
                                    const long long* old, int has_old,
                                    float* w, int wtot, float* d,
                                    const int* desc, const int* maps, int C,
                                    int B, int rv, int smem, cudaStream_t st)
{
    if (B == 0) return 0;
    if (C > MAX_BLOCKS || smem > MAX_L * 4 || rv < 0 || rv > 3)
        return (int)cudaErrorInvalidValue;
    OldW o = {};
    for (int r = 0; has_old && r < C; ++r) {
        o.p[r] = reinterpret_cast<const float*>(old[2 * r]);
        o.stride[r] = old[2 * r + 1];
    }
    if (smem > kDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            dlsch_dematch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            MAX_L * 4);
        if (err != cudaSuccess) return (int)err;
    }
    dlsch_dematch_kernel<<<B * C, DM_THREADS, smem, st>>>(
        e, e_stride, o, has_old, w, wtot, d, desc, maps, C, B, rv);
    return (int)cudaGetLastError();
}

// bits, done: each (K, F) group's decode kernel outputs (unused ones null).
extern "C" int dlsch_tb_check_launch(const int* const* bits,
                                     const unsigned char* const* done,
                                     int n_groups, const int* desc, int C,
                                     const int* rows, int nb, int* b_hat,
                                     bool* tb_ok, int B, cudaStream_t st)
{
    if (B == 0) return 0;
    if (C > CK_THREADS || n_groups > MAX_GROUPS)
        return (int)cudaErrorInvalidValue;
    Decoded dec = {};
    for (int g = 0; g < n_groups; ++g) {
        dec.bits[g] = bits[g];
        dec.done[g] = done[g];
    }
    dlsch_tb_check_kernel<<<B, CK_THREADS, 0, st>>>(dec, desc, C, rows, nb,
                                                    b_hat, tb_ok, B);
    return (int)cudaGetLastError();
}
