"""What the DLSCH encode and select kernels (csrc/dlsch_encode.cu) rest on,
as far as the CPU reaches: their order of work replayed in numpy (the
TB's CRC24A in chunks of syndromes, the blocks packed 32 bits to a word,
the CRC24B from one table read from its end, the word-packed RSC
encoders with the warp's scan of state maps, the QPP interleaver stepped
by additions, the tails, and the select through the concatenated map)
against the host's golden encoder, the CRCs, the codec's plain path and
the JAX package's codec, and the wrappers' decisions. The kernels' own tests are in
test_torch_cuda.py."""
import zlib
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy.pdsch import DlschCodec as JCodec
from openair4g_tpu.phy.pdsch import DlschConfig as JConfig
from openair4g_tpu.phy.pusch import UlschConfig as JUlschConfig
from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops import dlsch_cuda
from openair4g_tpu_torch.ops.crc import (attach_crc_host, crc_bits_host,
                                         crc_packed_rows)
from openair4g_tpu_torch.ops.segmentation import Z_MAX
from openair4g_tpu_torch.ops.turbo import qpp_interleaver, turbo_encode_host
from openair4g_tpu_torch.ops.uci import UciConfig
from openair4g_tpu_torch.phy.pdsch import DlschCodec, DlschConfig
from openair4g_tpu_torch.phy.pusch import UlschConfig
from openair4g_tpu_torch.sim.mbmssim import Mbmssim, MbmssimConfig
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig
from openair4g_tpu_torch.tables.qpp import QPP_BY_K
from test_torch_dlsch_decode import _TbsConfig

torch.set_num_threads(1)

U32 = np.uint32


# ------------------------------------------------- the kernels' replay --

def _rsc_a(u):
    p = u ^ (u << U32(7))
    p ^= p << U32(14)
    p ^= p << U32(28)
    return p ^ (p << U32(2)) ^ (p << U32(3)) ^ (p << U32(4))


def _inject(s):
    r1, r2, r3 = s >> 2 & 1, s >> 1 & 1, s & 1
    return ((r2 ^ r3) | (r1 ^ r2) << 1 | r1 << 2).astype(U32)


def _rsc_z(a, s):
    r1, r2, r3 = s >> 2 & 1, s >> 1 & 1, s & 1
    return (a ^ (a << U32(1)) ^ (a << U32(3))
            ^ ((r1 ^ r3) | r2 << 1 | r1 << 2).astype(U32))


def _state_at(a, n):
    return (a >> U32(n - 3)).astype(np.int64) & 7


def _advance(s, n):
    return _state_at(_rsc_a(_inject(s)), n % 7 + 7)


def _lanes(nw):
    """Each lane's words [w0, w0 + mine) as the kernel splits a block."""
    q = -(-nw // 32)
    return [(lane * q, max(0, min(q, nw - lane * q))) for lane in range(32)]


def _rsc_words(u, nb):
    """rsc_words: u uint32 [B, nw] -> (parity words [B, nw], the state
    after the block [B]); each lane's words from state 0, the warp's
    inclusive scan of (state map, bits mod 7), then the second pass."""
    B, nw = u.shape
    lanes = _lanes(nw)
    f = [np.zeros(B, np.int64) for _ in range(32)]
    n = [0] * 32
    for lane, (w0, mine) in enumerate(lanes):
        for w in range(w0, w0 + mine):
            f[lane] = _state_at(_rsc_a(u[:, w] ^ _inject(f[lane])), nb[w])
            n[lane] += nb[w]
        n[lane] %= 7
    o = 1
    while o < 32:
        fp, np_ = list(f), list(n)
        for lane in range(o, 32):
            f[lane] = _advance(fp[lane - o], n[lane]) ^ f[lane]
            n[lane] = (np_[lane - o] + n[lane]) % 7
        o <<= 1
    z = np.zeros_like(u)
    for lane, (w0, mine) in enumerate(lanes):
        s = f[lane - 1] if lane else np.zeros(B, np.int64)
        for w in range(w0, w0 + mine):
            a = _rsc_a(u[:, w] ^ _inject(s))
            z[:, w] = _rsc_z(a, s)
            s = _state_at(a, nb[w])
    return z, f[31]


def _qpp_words(c, K):
    """The second encoder's input words, each lane stepping pi(j) = f1 j +
    f2 j^2 mod K by additions from its first position; also returns the
    positions it stepped through."""
    f1, f2 = QPP_BY_K[K]
    B, nw = c.shape
    u2 = np.zeros_like(c)
    seen = []
    for w0, mine in _lanes(nw):
        j0 = 32 * w0
        pj = (f1 * j0 + f2 * j0 % K * j0) % K
        dj = (f1 + f2 * (2 * j0 + 1)) % K
        step = 2 * f2 % K
        for w in range(w0, w0 + mine):
            idx = []
            for _ in range(32):
                idx.append(pj)
                pj += dj
                if pj >= K:
                    pj -= K
                dj += step
                if dj >= K:
                    dj -= K
            idx = np.asarray(idx)
            bits = (c[:, idx >> 5] >> (idx & 31).astype(U32)) & U32(1)
            u2[:, w] = (bits << np.arange(32, dtype=U32)).sum(
                axis=1, dtype=np.uint64).astype(U32)
            seen.extend(idx.tolist())
    return u2, seen[:K]


def _tail(s):
    x, z = [], []
    for _ in range(3):
        r1, r2, r3 = s >> 2 & 1, s >> 1 & 1, s & 1
        x.append(r2 ^ r3)
        z.append(r1 ^ r3)
        s = s >> 1
    return x, z


def _put24(c, p, crc):
    sh = p & 31
    c[:, p >> 5] |= (crc << U32(sh)).astype(U32)
    if sh > 8:
        c[:, (p >> 5) + 1] |= (crc >> U32(32 - sh)).astype(U32)


def _xor_rows(bits, rows):
    """XOR of rows[k] over the set bits k of each row: bits [B, n]."""
    return np.bitwise_xor.reduce(np.where(bits != 0, rows.astype(U32), 0),
                                 axis=1).astype(U32)


def _pack(bits):
    """A ballot a word: bit k at bit k & 31 of word k >> 5."""
    B, n = bits.shape
    nw = -(-n // 32)
    padded = np.zeros((B, 32 * nw), np.uint64)
    padded[:, :n] = bits != 0
    return (padded.reshape(B, nw, 32) << np.arange(32, dtype=np.uint64)).sum(
        axis=2).astype(U32)


def _block_streams(c, K):
    """Both encoders on the packed block c [B, nw] -> d [B, 3, K + 4]."""
    nb = [min(32, K - 32 * w) for w in range(c.shape[1])]
    u2, _ = _qpp_words(c, K)
    z1, s1 = _rsc_words(c, nb)
    z2, s2 = _rsc_words(u2, nb)
    k = np.arange(K)
    d = np.zeros((c.shape[0], 3, K + 4), np.int32)
    for st, src in enumerate((c, z1, z2)):
        d[:, st, :K] = (src[:, k >> 5] >> (k & 31).astype(U32)) & U32(1)
    (x1, t1), (x2, t2) = _tail(s1), _tail(s2)
    d[:, 0, K:] = np.stack([x1[0], t1[1], x2[0], t2[1]], axis=1)
    d[:, 1, K:] = np.stack([t1[0], x1[2], t2[0], x2[2]], axis=1)
    d[:, 2, K:] = np.stack([x1[1], t1[2], x2[1], t2[2]], axis=1)
    return d


def _encode_replay(tb, p):
    """tb_crc_kernel then dlsch_encode_kernel: tb [B, TBS] -> d [B, dtot]."""
    B = tb.shape[0]
    rows_a = crc_packed_rows(p.tbs, "crc24a")
    part = np.stack([_xor_rows(tb[:, i:i + dlsch_cuda.CRC_CHUNK],
                               rows_a[i:i + dlsch_cuda.CRC_CHUNK])
                     for i in range(0, p.tbs, dlsch_cuda.CRC_CHUNK)], axis=1)
    assert part.shape[1] == p.n_part
    rows_b = crc_packed_rows(Z_MAX - 24, "crc24b")
    d = np.zeros((B, p.dtot), np.int32)
    for K, F, f1, f2, tb0, ntb, doff, last in p.desc:
        syn = rows_b[Z_MAX - K:]
        bits = np.zeros((B, K), np.int64)
        bits[:, F:F + ntb] = tb[:, tb0:tb0 + ntb] != 0
        crc = _xor_rows(bits[:, :F + ntb], syn[:F + ntb])
        c = _pack(bits)
        if last:
            a = np.bitwise_xor.reduce(part, axis=1).astype(U32)
            abits = (a[:, None] >> np.arange(24, dtype=U32)) & U32(1)
            if p.C > 1:
                crc ^= _xor_rows(abits, syn[F + ntb:F + ntb + 24])
            _put24(c, F + ntb, a)
        if p.C > 1:
            _put24(c, K - 24, crc)
        d[:, doff:doff + 3 * (K + 4)] = _block_streams(c, K).reshape(B, -1)
    return d


def _select_replay(d, p, rv):
    """dlsch_select_kernel: each block's d packed, then e through the map."""
    table = p.select[rv]
    head, emap = table[:4 * p.C].reshape(p.C, 4), table[4 * p.C:]
    e = np.zeros((d.shape[0], p.G), np.int32)
    for K, doff, eoff, E in head:
        bits = _pack(d[:, doff:doff + 3 * (K + 4)])
        idx = emap[eoff:eoff + E]
        e[:, eoff:eoff + E] = (bits[:, idx >> 5] >> (idx & 31).astype(U32)) \
            & U32(1)
    return e


# --------------------------------------------------------------- tests --

def _codec(tbs, g):
    if tbs is None:     # the flagship: MCS 26, 100 PRB, 11 blocks of 5,632
        return DlschCodec(DlschConfig(mcs=26, n_rb=100))
    return DlschCodec(_TbsConfig(mcs=10, n_rb=25, tbs_bits=tbs,
                                 g_override=g))


@pytest.mark.parametrize("case", [
    *[("block", K) for K in (40, 200, 1024, 5504, 5632, 6144)],
    # C = 1 with 8 fillers; C = 2 with a K+/K- mix and 56 fillers; the
    # flagship's 11 blocks; each at rv 0-3
    *[("tb", tbs, g, rv) for tbs, g in ((544, 1_200), (6_208, 9_000),
                                        (None, None)) for rv in range(4)],
], ids=str)
def test_kernel_order_of_work_equals_plain_path(case):
    rng = np.random.default_rng(zlib.crc32(str(case).encode()))
    if case[0] == "block":
        K = case[1]
        bits = rng.integers(0, 2, (3, K))
        c = _pack(bits)
        want = np.stack([turbo_encode_host(b) for b in bits])
        assert np.array_equal(_block_streams(c, K), want)
        assert _qpp_words(c, K)[1] == qpp_interleaver(K).tolist()
        # the CRC24B of a K-bit block from the largest block's table
        msg = bits[:, :K - 24]
        syn = crc_packed_rows(Z_MAX - 24, "crc24b")[Z_MAX - K:]
        got = (_xor_rows(msg, syn)[:, None] >> np.arange(24, dtype=U32)) & 1
        assert np.array_equal(got, np.stack(
            [attach_crc_host(m, "crc24b")[K - 24:] for m in msg]))
        # the CRC24A of a TB of seven such blocks in chunks
        tb = rng.integers(0, 2, (2, 7 * K))
        rows_a = crc_packed_rows(7 * K, "crc24a")
        a = np.bitwise_xor.reduce(np.stack(
            [_xor_rows(tb[:, i:i + 4096], rows_a[i:i + 4096])
             for i in range(0, 7 * K, 4096)], axis=1), axis=1)
        got = (a[:, None] >> np.arange(24, dtype=U32)) & 1
        assert np.array_equal(got, np.stack([crc_bits_host(t, "crc24a")
                                             for t in tb]))
        return
    _, tbs, g, rv = case
    codec = _codec(tbs, g)
    p = codec.kernel_plan()
    assert (p.C, p.Ks) == (codec.seg.C, tuple(codec.block_Ks))
    tb = rng.integers(0, 2, (2, codec.cfg.tbs)).astype(np.int32)
    d_flats = codec.encode_to_d(torch.from_numpy(tb))
    d = _encode_replay(tb, p)
    assert np.array_equal(d, torch.cat(d_flats, dim=1).numpy())
    assert [v.shape for v in dlsch_cuda.views(torch.from_numpy(d), p)] == \
        [v.shape for v in d_flats]
    assert np.array_equal(_select_replay(d, p, rv),
                          codec.select_e(d_flats, rv).numpy())


def _sim_codec(which):
    """The codec of the flagship (MCS 26, 100 PRB), of the uplink benchmark
    (MCS 20, 100 PRB, its UCI taking REs: g_override) or of the MBSFN
    region (MCS 16, 100 PRB: g_override)."""
    if which == "flagship":
        return DlschCodec(DlschConfig(mcs=26, n_rb=100))
    if which == "uplink":
        return Ulsim(UlsimConfig(mcs=20, n_rb=100, n_rb_alloc=100, batch=1,
                                 uci=UciConfig(o_cqi=30, o_ri=1, o_ack=2)),
                     device="cpu").codec
    return Mbmssim(MbmssimConfig(mcs=16, n_rb=100, batch=1),
                   device="cpu").codec


@pytest.mark.parametrize("which", ["flagship", "uplink", "mbsfn"])
def test_kernel_order_of_work_equals_jax_codec(which):
    """The replay's d and e at rv 0-3 against the JAX package's DlschCodec
    of the same configuration on the same TB bits."""
    codec = _sim_codec(which)
    jcfg = {DlschConfig: JConfig, UlschConfig: JUlschConfig}[
        type(codec.cfg)](**asdict(codec.cfg))
    jcodec = JCodec(jcfg)
    p = codec.kernel_plan()
    tb = np.random.default_rng(zlib.crc32(which.encode())).integers(
        0, 2, (2, codec.cfg.tbs)).astype(np.int32)
    d = _encode_replay(tb, p)
    jd = jcodec.encode_to_d(jnp.asarray(tb))
    assert np.array_equal(d, np.concatenate([np.asarray(x) for x in jd], 1))
    for rv in range(4):
        assert np.array_equal(_select_replay(d, p, rv),
                              np.asarray(jcodec.select_e(jd, rv))), rv


def test_plan_layout():
    """Fillers, the K+/K- mix, the last block's CRC24A and the offsets."""
    p = _codec(6_208, 9_000).kernel_plan()
    assert p.desc.tolist() == [
        [3136, 56, *QPP_BY_K[3136], 0, 3056, 0, 0],
        [3200, 0, *QPP_BY_K[3200], 3056, 3152, 9420, 1]]
    assert (p.dtot, p.G, p.n_part) == (9420 + 9612, 9_000, 2)
    codec = _codec(None, None)
    flag = codec.kernel_plan()
    assert flag.desc[:, 5].tolist() == [5608] * 10 + [5584]
    E0, E1 = codec.Es[:2]
    assert flag.select[2][:8].tolist() == [5632, 0, 0, E0,
                                           5632, 16908, E0, E1]
    with pytest.raises(ValueError):
        dlsch_cuda.plan(544, (600, 600))


def test_wrappers_take_cuda_tensors_only():
    """A CPU tensor goes the plain way in the codec and launches nothing;
    the wrappers refuse any other device than CUDA."""
    codec = _codec(544, 1_200)
    p = codec.kernel_plan()
    before = launch_counts()
    tb = torch.zeros(2, 544, dtype=torch.int32)
    codec.select_e(codec.encode_to_d(tb), 1)
    assert launch_counts() == before
    with pytest.raises(ValueError):
        dlsch_cuda.encode(tb, p)
    with pytest.raises(ValueError):
        dlsch_cuda.select([torch.zeros(2, 3 * 580, dtype=torch.int32)], p, 0)
    with pytest.raises(ValueError):
        dlsch_cuda.select([torch.zeros(2, 7, dtype=torch.int32,
                                       device="meta")], p, 0)
