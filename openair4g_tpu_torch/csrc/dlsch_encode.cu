// The DLSCH transmit bit chain on the card (36.212 5.1.1-5.1.4): CRC24A,
// code block segmentation with the filler bits, each block's CRC24B, the
// two RSC encoders over the QPP interleaver with trellis termination, the
// tail interlacing (the d streams), and the rate matching of every code
// block of a redundancy version (e).
//
// Replaces no TPU kernel: the reference leaves the chain to XLA
// (openair4g_tpu/phy/pdsch.py DlschCodec.encode_to_d and select_e), and the
// port's plain version, which the CPU runs, is hundreds of small torch ops
// (ops/crc, ops/turbo.turbo_encode_device, ops/rate_match.rate_match_tx).
// The work is bytes: the TB bits in, d [B, sum 3 (K + 4)] int32 out, then d
// in and e [B, G] int32 out each round; about 1 GB at the flagship's batch
// 512, 0.3 ms at 3.35 TB/s.
//
// Design.
// - tb_crc_kernel: a TB row's CRC24A as the XOR of per-position syndromes
//   (ops/crc.crc_packed_rows, bit j = the j-th CRC bit) over its set bits,
//   in chunks of CRC_CHUNK bits a block; each chunk's XOR lands in part
//   [B, n_part]. No atomics, so no fill: the last code block's warp XORs
//   the row's chunks.
// - dlsch_encode_kernel: one warp a (row, code block). The warp reads the
//   block's TB bits coalesced, a bit a lane, and packs them 32 to a word
//   with a ballot (bit k of the block is bit k & 31 of word k >> 5); the
//   CRC24B is the XOR of syndromes of a table of the largest block read
//   from its end, so one table serves every K. Each RSC encoder is linear
//   over GF(2) with a period-7 feedback, so a 32-bit word's feedback bits
//   a from state 0 are shifts and XORs (rsc_a), and a start state acts as
//   three injected input bits (inject): a lane takes WORDS_PER_LANE
//   consecutive words, runs them from state 0, and a warp scan of the
//   lanes' affine state maps (state after n bits: A^n s + f) gives each
//   lane its start state; a second pass then writes the parity words. The
//   second encoder's input is gathered bit by bit from the packed block in
//   shared memory at pi(j) = f1 j + f2 j^2 mod K, stepped by additions.
//   The three streams and their tails are stored as int4 rows of d.
// - dlsch_select_kernel: one block a (row, code block): the block's d
//   row, read 16 bytes a lane, is packed to bits in shared memory; each e
//   position then reads its bit through the rv's map (e_src of every
//   block, concatenated at plan time) and is stored in order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K = 6144;
constexpr int MAX_WORDS = MAX_K / 32;
constexpr int WORDS_PER_LANE = MAX_WORDS / 32;
constexpr int ENC_WARPS = 4;           // (row, code block) pairs a block
constexpr int CRC_THREADS = 128;
constexpr int CRC_CHUNK = 32 * CRC_THREADS;
constexpr int SEL_THREADS = 256;
constexpr int SEL_WORDS = (3 * (MAX_K + 4) + 31) / 32;

// A code block's row of the encode plan (ops/dlsch_cuda.plan).
enum { E_K, E_F, E_F1, E_F2, E_TB0, E_NTB, E_DOFF, E_LAST, E_FIELDS };
// A code block's row of a redundancy version's select table.
enum { S_K, S_DOFF, S_EOFF, S_E, S_FIELDS };

// The RSC (g0 = 1 + D^2 + D^3 feedback, g1 = 1 + D + D^3) on 32 input bits
// u, bit k the k-th: the feedback bits a_k = u_k ^ a_{k-2} ^ a_{k-3} from
// state 0. Its impulse response has period 7 and taps {0, 2, 3, 4}, so a is
// the stride-7 prefix XOR p of u, XORed at those shifts.
__device__ __forceinline__ uint32_t rsc_a(uint32_t u) {
    uint32_t p = u ^ (u << 7);
    p ^= p << 14;
    p ^= p << 28;
    return p ^ (p << 2) ^ (p << 3) ^ (p << 4);
}

// State s = r1 r2 r3 (a_{-1}, a_{-2}, a_{-3}) as input bits at 0-2: rsc_a of
// u ^ inject(s) is the feedback from state s.
__device__ __forceinline__ uint32_t inject(int s) {
    const int r1 = s >> 2 & 1, r2 = s >> 1 & 1, r3 = s & 1;
    return (uint32_t)((r2 ^ r3) | (r1 ^ r2) << 1 | r1 << 2);
}

// Parity z_k = a_k ^ a_{k-1} ^ a_{k-3}, the state's bits entering at 0-2.
__device__ __forceinline__ uint32_t rsc_z(uint32_t a, int s) {
    const int r1 = s >> 2 & 1, r2 = s >> 1 & 1, r3 = s & 1;
    return a ^ (a << 1) ^ (a << 3) ^ (uint32_t)((r1 ^ r3) | r2 << 1 | r1 << 2);
}

// The state after the first n >= 3 bits of feedback a.
__device__ __forceinline__ int state_at(uint32_t a, int n) {
    return (int)(a >> (n - 3)) & 7;
}

// A^n s: the state n zero inputs after s (period 7).
__device__ __forceinline__ int advance(int s, int n) {
    return state_at(rsc_a(inject(s)), n % 7 + 7);
}

// One RSC encoder over a lane's words u[0, nw) of nb[i] bits each: the
// warp's scan gives each lane its start state; z receives the parity
// words. Returns the state after the block's last bit (every lane).
__device__ __forceinline__ int rsc_words(const uint32_t (&u)[WORDS_PER_LANE],
                                         const int (&nb)[WORDS_PER_LANE],
                                         int nw, uint32_t* z, int w0,
                                         int lane) {
    int f = 0, n = 0;
#pragma unroll
    for (int i = 0; i < WORDS_PER_LANE; ++i)
        if (i < nw) {
            f = state_at(rsc_a(u[i] ^ inject(f)), nb[i]);
            n += nb[i];
        }
    n %= 7;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int fp = __shfl_up_sync(FULL, f, o);
        const int np = __shfl_up_sync(FULL, n, o);
        if (lane >= o) {
            f = advance(fp, n) ^ f;
            n = (np + n) % 7;
        }
    }
    const int last = __shfl_sync(FULL, f, 31);
    int s = __shfl_up_sync(FULL, f, 1);
    if (lane == 0) s = 0;
#pragma unroll
    for (int i = 0; i < WORDS_PER_LANE; ++i)
        if (i < nw) {
            const uint32_t a = rsc_a(u[i] ^ inject(s));
            z[w0 + i] = rsc_z(a, s);
            s = state_at(a, nb[i]);
        }
    return last;
}

// Trellis termination from state s: tail inputs x[3] and parities z[3]
// (three steps with a = 0).
__device__ __forceinline__ void tail(int s, int* x, int* z) {
    for (int t = 0; t < 3; ++t) {
        const int r1 = s >> 2 & 1, r2 = s >> 1 & 1, r3 = s & 1;
        x[t] = r2 ^ r3;
        z[t] = r1 ^ r3;
        s >>= 1;
    }
}

// ORs the 24 bits of crc into the packed block at bit p (a multiple of 8).
__device__ __forceinline__ void put24(uint32_t* c, int p, uint32_t crc) {
    const int sh = p & 31;
    c[p >> 5] |= crc << sh;
    if (sh > 8) c[(p >> 5) + 1] |= crc >> (32 - sh);
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(FULL, v, o);
    return v;
}

__global__ void __launch_bounds__(CRC_THREADS)
tb_crc_kernel(const int* __restrict__ tb, int tbs,
              const int* __restrict__ rows, int n_part, int* __restrict__ part)
{
    __shared__ uint32_t acc[CRC_THREADS / 32];
    const int row = blockIdx.x / n_part, p = blockIdx.x % n_part;
    const int* t = tb + (size_t)row * tbs;
    uint32_t x = 0;
#pragma unroll 8
    for (int i = 0; i < CRC_CHUNK / CRC_THREADS; ++i) {
        const int k = p * CRC_CHUNK + i * CRC_THREADS + threadIdx.x;
        if (k < tbs) {
            const uint32_t sy = (uint32_t)rows[k];
            if (t[k]) x ^= sy;
        }
    }
    x = warp_xor(x);
    if ((threadIdx.x & 31) == 0) acc[threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < CRC_THREADS / 32; ++w) x ^= acc[w];
        part[blockIdx.x] = (int)x;
    }
}

__global__ void __launch_bounds__(32 * ENC_WARPS)
dlsch_encode_kernel(const int* __restrict__ tb, int tbs,
                    const int* __restrict__ part, int n_part,
                    const int* __restrict__ desc, int C, int crcb,
                    const int* __restrict__ rows_b, int* __restrict__ d,
                    int dtot, int B)
{
    __shared__ uint32_t s_c[ENC_WARPS][MAX_WORDS];
    __shared__ uint32_t s_z1[ENC_WARPS][MAX_WORDS];
    __shared__ uint32_t s_z2[ENC_WARPS][MAX_WORDS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int pair = blockIdx.x * ENC_WARPS + warp;
    if (pair >= B * C) return;
    const int row = pair / C, r = pair % C;
    const int* blk = desc + r * E_FIELDS;
    const int K = blk[E_K], F = blk[E_F], tb0 = blk[E_TB0], ntb = blk[E_NTB];
    const int nw = (K + 31) >> 5;
    uint32_t* c = s_c[warp];
    uint32_t* z1 = s_z1[warp];
    uint32_t* z2 = s_z2[warp];
    const int* t = tb + (size_t)row * tbs + tb0 - F;

    // The block's bits c: F fillers, the TB bits, the CRC24A (last block),
    // the CRC24B (C > 1), which covers all bits before it.
    const int* syn = rows_b + (MAX_K - K);
    uint32_t crc = 0;
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
        const int k = 32 * w + lane;
        int bit = 0;
        uint32_t sy = 0;
        if (k >= F && k < F + ntb) {
            bit = t[k] != 0;
            if (crcb) sy = (uint32_t)syn[k];
        }
        if (bit) crc ^= sy;
        const uint32_t word = __ballot_sync(FULL, bit);
        if (lane == 0) c[w] = word;
    }
    __syncwarp();
    if (blk[E_LAST]) {
        uint32_t a = lane < n_part ? (uint32_t)part[row * n_part + lane] : 0;
        a = warp_xor(a);
        const int p = F + ntb;
        if (crcb && lane < 24 && (a >> lane & 1))
            crc ^= (uint32_t)syn[p + lane];
        if (lane == 0) put24(c, p, a);
        __syncwarp();
    }
    if (crcb) {
        crc = warp_xor(crc);
        if (lane == 0) put24(c, K - 24, crc);
        __syncwarp();
    }

    // The lane's words of both encoders' inputs: u1 = c, u2[j] = c[pi(j)].
    const int q = (nw + 31) >> 5;
    const int w0 = lane * q;
    const int mine = max(0, min(q, nw - w0));
    uint32_t u1[WORDS_PER_LANE], u2[WORDS_PER_LANE];
    int nb[WORDS_PER_LANE];
    const int f1 = blk[E_F1], f2 = blk[E_F2];
    const int j0 = 32 * w0;
    int pj = (int)(((long long)f1 * j0 + (long long)f2 * j0 % K * j0) % K);
    int dj = (int)(((long long)f1 + (long long)f2 * (2 * j0 + 1)) % K);
    const int step = 2 * f2 % K;
#pragma unroll
    for (int i = 0; i < WORDS_PER_LANE; ++i) {
        u1[i] = u2[i] = 0;
        nb[i] = 32;
        if (i < mine) {
            const int w = w0 + i;
            nb[i] = min(32, K - 32 * w);
            u1[i] = c[w];
            // (bits past K are never stored and never reach a state
            // before K, so every word takes 32)
            uint32_t v = 0;
#pragma unroll 8
            for (int b = 0; b < 32; ++b) {
                v |= (c[pj >> 5] >> (pj & 31) & 1u) << b;
                pj += dj;
                if (pj >= K) pj -= K;
                dj += step;
                if (dj >= K) dj -= K;
            }
            u2[i] = v;
        }
    }
    const int s1 = rsc_words(u1, nb, mine, z1, w0, lane);
    const int s2 = rsc_words(u2, nb, mine, z2, w0, lane);
    __syncwarp();

    // d: the streams d0 = x1, d1 = z1, d2 = z2 over K, then the tails.
    int* out = d + (size_t)row * dtot + blk[E_DOFF];
    const uint32_t* src[3] = {c, z1, z2};
#pragma unroll
    for (int st = 0; st < 3; ++st) {
        int* o = out + st * (K + 4);
        for (int k = 4 * lane; k < K; k += 128) {
            const uint32_t v = src[st][k >> 5] >> (k & 31);
            *reinterpret_cast<int4*>(o + k) = make_int4(
                v & 1, v >> 1 & 1, v >> 2 & 1, v >> 3 & 1);
        }
    }
    if (lane < 3) {
        int x1[3], t1[3], x2[3], t2[3];
        tail(s1, x1, t1);
        tail(s2, x2, t2);
        const int4 v = lane == 0 ? make_int4(x1[0], t1[1], x2[0], t2[1])
                     : lane == 1 ? make_int4(t1[0], x1[2], t2[0], x2[2])
                                 : make_int4(x1[1], t1[2], x2[1], t2[2]);
        *reinterpret_cast<int4*>(out + lane * (K + 4) + K) = v;
    }
}

__global__ void __launch_bounds__(SEL_THREADS)
dlsch_select_kernel(const int* __restrict__ d, int dtot,
                    const int* __restrict__ table, int C,
                    int* __restrict__ e, int G)
{
    __shared__ uint32_t bits[SEL_WORDS];
    const int row = blockIdx.x / C, r = blockIdx.x % C;
    const int* s = table + r * S_FIELDS;
    const int n4 = 3 * (s[S_K] + 4) / 4;
    const int4* src = reinterpret_cast<const int4*>(
        d + (size_t)row * dtot + s[S_DOFF]);
    const int lane = threadIdx.x & 31;
    // 16 bytes a lane: 4 bits, a word in each 8 lanes
#pragma unroll 4
    for (int i0 = threadIdx.x - lane; i0 < n4; i0 += SEL_THREADS) {
        const int i = i0 + lane;
        uint32_t v = 0;
        if (i < n4) {
            const int4 x = src[i];
            v = (uint32_t)((x.x != 0) | (x.y != 0) << 1 | (x.z != 0) << 2
                           | (x.w != 0) << 3) << 4 * (i & 7);
        }
        v |= __shfl_xor_sync(FULL, v, 1);
        v |= __shfl_xor_sync(FULL, v, 2);
        v |= __shfl_xor_sync(FULL, v, 4);
        if ((lane & 7) == 0 && i < n4) bits[i >> 3] = v;
    }
    __syncthreads();
    const int* map = table + C * S_FIELDS + s[S_EOFF];
    int* out = e + (size_t)row * G + s[S_EOFF];
    const int E = s[S_E];
#pragma unroll 4
    for (int j = threadIdx.x; j < E; j += SEL_THREADS) {
        const int k = map[j];
        out[j] = (int)(bits[k >> 5] >> (k & 31) & 1u);
    }
}

}  // namespace

extern "C" int dlsch_encode_launch(const int* tb, int tbs, const int* rows_a,
                                   int* part, int n_part, const int* desc,
                                   int C, int crcb, const int* rows_b, int* d,
                                   int dtot, int B, cudaStream_t st)
{
    if (B == 0) return 0;
    tb_crc_kernel<<<B * n_part, CRC_THREADS, 0, st>>>(tb, tbs, rows_a, n_part,
                                                      part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dlsch_encode_kernel<<<(B * C + ENC_WARPS - 1) / ENC_WARPS,
                          32 * ENC_WARPS, 0, st>>>(tb, tbs, part, n_part, desc,
                                                   C, crcb, rows_b, d, dtot,
                                                   B);
    return (int)cudaGetLastError();
}

extern "C" int dlsch_select_launch(const int* d, int dtot, const int* table,
                                   int C, int* e, int G, int B,
                                   cudaStream_t st)
{
    if (B == 0) return 0;
    dlsch_select_kernel<<<B * C, SEL_THREADS, 0, st>>>(d, dtot, table, C, e,
                                                       G);
    return (int)cudaGetLastError();
}
