"""What the DLSCH receive kernels (csrc/dlsch_decode.cu) rest on, as far
as the CPU reaches: their order of work replayed in plain torch through
the plan (the rotated fold of e into each block's soft buffer with the
HARQ add, the gather of the d streams with the fillers into each (K, F)
group's decoder input, the payloads' gather with the CRC24A as XORs of
syndromes and the blocks' flags) against the codec's plain path
(rate_match_rx, w_to_d_llr, the group's cat, the CRC as a GF(2) product),
the plan's layout against what the decode kernel takes, and the
wrappers' decisions. The kernels' own tests are in test_torch_cuda.py."""
import zlib
from dataclasses import asdict, dataclass

import numpy as np
import pytest
import torch

from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops import dlsch_cuda
from openair4g_tpu_torch.ops.crc import crc_packed_rows
from openair4g_tpu_torch.ops.dlsch_cuda import (D_BOFF, D_DOFF, D_E, D_EOFF,
                                                D_F, D_GROUP, D_IDX, D_K, D_L,
                                                D_MOFF, D_NPAY, D_ROFF,
                                                D_WOFF)
from openair4g_tpu_torch.ops.uci import UciConfig
from openair4g_tpu_torch.phy.pdsch import DlschCodec, DlschConfig
from openair4g_tpu_torch.phy.pusch import UlschConfig
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig

torch.set_num_threads(1)


@dataclass(frozen=True)
class _TbsConfig(DlschConfig):
    """A DlschConfig of any TBS: the TBS table leaves out the TBs with
    filler bits or a K+/K- mix. The one copy: test_torch_dlsch_encode.py
    and test_torch_cuda.py import it from here, so this module imports no
    jax at its top."""
    tbs_bits: int = 0

    @property
    def tbs(self) -> int:
        return self.tbs_bits


# ------------------------------------------------- the kernels' replay --

def _dematch_replay(e, w_old, p, rv):
    """dlsch_dematch_kernel: each (row, block)'s soft buffer, position j
    the repetitions at (j - r_off) mod L + k L summed from 0 (one alone
    taken as it is), added to the old w; then its d streams gathered
    through the map, 1e4 at the fillers, stored at the block's rows of its
    group. -> (w [B, wtot], d [B drow])."""
    B = e.shape[0]
    w = torch.full((B, p.wtot), float("nan"))
    d = torch.full((B * p.drow,), float("nan"))
    maps = torch.from_numpy(p.maps).long()
    for r, row in enumerate(p.desc.tolist()):
        K, F, E, L = row[D_K], row[D_F], row[D_E], row[D_L]
        p_idx = (torch.arange(L) - row[D_ROFF + rv]) % L
        er = e[:, row[D_EOFF]:row[D_EOFF] + E]
        reps = -(-E // L)

        def take(q):
            return torch.where(q < E, er[:, q.clamp(max=E - 1)],
                               torch.zeros(()))
        if reps == 1:
            v = take(p_idx)
        else:
            v = torch.zeros(B, L)
            for k in range(reps):
                v = v + take(p_idx + k * L)
        if w_old is not None:
            v = w_old[r].expand(B, L) + v
        w[:, row[D_WOFF]:row[D_WOFF] + L] = v
        n = 3 * (K + 4)
        m = maps[row[D_MOFF]:row[D_MOFF] + n]
        dd = v[:, m.clamp(min=0)] * (m >= 0).to(torch.float32)
        dd[:, :F] = 1e4
        d[B * row[D_DOFF]:B * row[D_DOFF] + B * n] = dd.reshape(-1)
    return w, d


def _tb_check_replay(decoded, p, B):
    """dlsch_tb_check_kernel: each block's payload [F, F + n) of its
    group's rows copied into b_hat, the XOR of the syndromes of its set
    bits and the blocks' flags. -> (b_hat, tb_ok)."""
    nb = p.tbs + 24
    rows = crc_packed_rows(nb, "crc24a").astype(np.uint32)
    b_hat = torch.full((B, nb), -1, dtype=torch.int32)
    flag = torch.ones(B, dtype=torch.bool)
    for row in p.desc.tolist():
        bits, done = decoded[row[D_GROUP]]
        i, n, boff = row[D_IDX], row[D_NPAY], row[D_BOFF]
        b_hat[:, boff:boff + n] = bits[i * B:(i + 1) * B,
                                       row[D_F]:row[D_F] + n]
        flag &= done[i * B:(i + 1) * B]
    x = np.bitwise_xor.reduce(np.where(b_hat.numpy() != 0, rows, 0), axis=1)
    return b_hat, flag & torch.from_numpy(x == 0)


# --------------------------------------------------------------- tests --

def _codec(case):
    kind = case[0]
    if kind == "flagship":      # MCS 26, 100 PRB: 11 blocks of 5,632
        return DlschCodec(DlschConfig(mcs=26, n_rb=100))
    if kind == "uplink":        # MCS 20, 100 PRB, UCI: 8 blocks of 5,504
        return Ulsim(UlsimConfig(mcs=20, n_rb=100, n_rb_alloc=100, batch=1,
                                 uci=UciConfig(o_cqi=30, o_ri=1, o_ack=2)),
                     device="cpu").codec
    if kind == "block":         # C = 1 (CRC24A only), E = (reps - 1/2) L
        _, K, reps = case
        G = 4 * round((reps - 0.5) * 3 * (K + 4) / 4)
        return DlschCodec(_TbsConfig(mcs=10, n_rb=25, tbs_bits=K - 24,
                                     g_override=G))
    _, tbs, G = case            # fillers, K+/K- mixes
    return DlschCodec(_TbsConfig(mcs=10, n_rb=25, tbs_bits=tbs,
                                 g_override=G))


@pytest.mark.parametrize("case", [
    *[("block", K, reps) for K in (40, 200, 1024, 5504, 5632, 6144)
      for reps in (1, 2, 3)],
    # C = 1 with 8 fillers; C = 2, a K+/K- mix with 56 fillers; C = 3, K-
    # with fillers, K- and K+ (three groups); the flagship; the uplink
    ("tb", 544, 1_200), ("tb", 6_208, 9_000), ("tb", 12_224, 30_000),
    ("flagship",), ("uplink",),
], ids=str)
def test_kernel_order_of_work_equals_plain_path(case):
    """At rv 0-3 in turn, with no old w, then the last round's w as the
    kernel leaves it (views of one buffer), then as separate tensors (the
    oaisim form) and broadcast from one row; batch 1 and 3: the soft
    buffers, the groups' decoder inputs, the TB bits and flags."""
    codec = _codec(case)
    p = codec.decode_plan()
    assert p.groups == codec.groups
    if case[0] == "block":
        assert p.C == 1 and -(-p.Es[0] // p.Ls[0]) == case[2]
    gen = torch.Generator().manual_seed(zlib.crc32(str(case).encode()))
    for B in (1, 3):
        w_k = w_p = None
        for step, rv in enumerate((0, 2, 3, 1, 0)):
            e = 4 * torch.randn(B, p.G, generator=gen)
            if step == 3:       # separate tensors, as oaisim passes them
                w_k = w_p = [x * 0.5 for x in w_p]
            if step == 4:       # one row broadcast over the batch
                w_k = w_p = [x[:1].clone() for x in w_p]
            w, d = _dematch_replay(e, w_k, p, rv)
            new_w, d_llrs = codec.dematch_ref(e, w_p, rv)
            got_w = dlsch_cuda.w_views(w, p)
            assert all(torch.equal(a, b) for a, b in zip(got_w, new_w)), \
                (B, rv)
            for g, (_, _, rs) in zip(dlsch_cuda.group_inputs(d, p, B),
                                     codec.groups):
                assert torch.equal(g, torch.cat([d_llrs[r] for r in rs])), \
                    (B, rv)
            w_k, w_p = got_w, new_w
        # the TB check on decoded bits: the code blocks' own bits (the
        # systematic streams: fillers, TB bits, CRCs), a bit flipped in
        # one row; each block's flag drawn
        tb = torch.randint(0, 2, (B, codec.cfg.tbs), generator=gen,
                           dtype=torch.int32)
        sys_bits = [x[:, :K] for x, K in zip(codec.encode_to_d(tb),
                                             codec.block_Ks)]
        sys_bits[-1][-1, -30] ^= 1
        for ok_share in (1.0, 0.7):
            decoded = [(torch.cat([sys_bits[r] for r in rs]).contiguous(),
                        torch.rand(len(rs) * B, generator=gen) < ok_share)
                       for _, _, rs in codec.groups]
            b_hat, tb_ok = _tb_check_replay(decoded, p, B)
            want_b, want_ok = codec.tb_check_ref(decoded)
            assert torch.equal(b_hat, want_b) and torch.equal(tb_ok, want_ok)
            if ok_share == 1.0:
                assert torch.equal(b_hat[:-1, :-24], tb[:-1])
                assert tb_ok.tolist() == [True] * (B - 1) + [False]


def _t(x):
    """A JAX array as a torch tensor of its own."""
    return torch.from_numpy(np.array(x))


def _jax_codec(codec):
    """The JAX package's DlschCodec of the port codec's configuration (a
    TBS of the test's own given through a subclass, as _TbsConfig)."""
    from openair4g_tpu.phy.pdsch import DlschCodec as JCodec
    from openair4g_tpu.phy.pdsch import DlschConfig as JConfig
    from openair4g_tpu.phy.pusch import UlschConfig as JUlschConfig
    cfg = codec.cfg
    if isinstance(cfg, _TbsConfig):
        @dataclass(frozen=True)
        class _JTbsConfig(JConfig):
            tbs_bits: int = 0

            @property
            def tbs(self) -> int:
                return self.tbs_bits
        return JCodec(_JTbsConfig(**asdict(cfg)))
    jtype = JUlschConfig if isinstance(cfg, UlschConfig) else JConfig
    return JCodec(jtype(**asdict(cfg)))


@pytest.mark.parametrize("case", [
    ("flagship",), ("uplink",), ("tb", 12_224, 30_000), ("tb", 544, 1_200),
    ("block", 200, 3), ("block", 1024, 2),
], ids=str)
def test_kernel_order_of_work_equals_jax_codec(case, monkeypatch):
    """The replay against the JAX package's DlschCodec.decode on the same
    e and the same earlier w, at rv 0, 2, 3, 1 in turn (the last w as
    separate tensors), batch 1 and 3: every block's soft buffer, each
    group's decoder input, the TB bits and flag. The turbo decoder is not
    this layer, and the two packages' decoders part on a steep waterfall,
    so both sides are handed the same decoded bits: the JAX codec's
    turbo_decode is stood in for by one that records its input and
    returns them."""
    import jax.numpy as jnp
    from openair4g_tpu.phy import pdsch as jpdsch

    codec = _codec(case)
    jcodec = _jax_codec(codec)
    p = codec.decode_plan()
    assert jcodec.block_Ks == codec.block_Ks and jcodec.Es == codec.Es
    seen, handed = [], []

    def turbo_decode(stacked, dcfg):
        seen.append((dcfg.K, dcfg.F, _t(stacked)))
        bits, done = handed[len(seen) - 1]
        return jnp.asarray(bits.numpy()), jnp.asarray(done.numpy())

    monkeypatch.setattr(jpdsch.turbo, "turbo_decode", turbo_decode)
    gen = torch.Generator().manual_seed(zlib.crc32(str(case).encode()))
    for B in (1, 3):
        tb = torch.randint(0, 2, (B, codec.cfg.tbs), generator=gen,
                           dtype=torch.int32)
        sys_bits = [x[:, :K] for x, K in zip(codec.encode_to_d(tb),
                                             codec.block_Ks)]
        sys_bits[-1][-1, -30] ^= 1
        w_k = None
        for step, rv in enumerate((0, 2, 3, 1)):
            e = 4 * torch.randn(B, p.G, generator=gen)
            if step == 3:
                w_k = [x * 0.5 for x in w_k]
            handed[:] = [(torch.cat([sys_bits[r] for r in rs]).contiguous(),
                          torch.rand(len(rs) * B, generator=gen)
                          < (1.0, 0.8)[step % 2])
                         for _, _, rs in codec.groups]
            seen.clear()
            w, d = _dematch_replay(e, w_k, p, rv)
            b_hat, tb_ok = _tb_check_replay(handed, p, B)
            jb, jok, jw = jcodec.decode(
                jnp.asarray(e.numpy()),
                None if w_k is None else [jnp.asarray(x.numpy())
                                          for x in w_k], rv=rv)
            what = (B, rv)
            got_w = dlsch_cuda.w_views(w, p)
            assert len(jw) == len(got_w) == p.C
            for a, b in zip(got_w, jw):
                assert torch.equal(a, _t(b)), what
            assert [(K, F) for K, F, _ in seen] == \
                [(K, F) for K, F, _ in codec.groups]
            for g, (_, _, x) in zip(dlsch_cuda.group_inputs(d, p, B), seen):
                assert torch.equal(g, x), what
            assert torch.equal(b_hat[:, :codec.cfg.tbs],
                               _t(jb)), what
            assert torch.equal(tb_ok, _t(jok)), \
                what
            if step % 2 == 0:
                assert tb_ok.tolist() == [True] * (B - 1) + [False]
            w_k = got_w


def test_plan_layout():
    """Three groups in the order of their first block, each block's rows
    of d where the decode kernel takes them: every group's input a
    contiguous [n B, 3, K + 4] view starting on 16 bytes; the maps' and
    payloads' offsets."""
    codec = _codec(("tb", 12_224, 30_000))
    p = codec.decode_plan()
    assert p.groups == ((4096, 32, (0,)), (4096, 0, (1,)), (4160, 0, (2,)))
    n0, n2 = 3 * 4100, 3 * 4164
    assert p.goffs == (0, n0, 2 * n0) and p.drow == 2 * n0 + n2
    assert p.desc[:, [D_K, D_F, D_DOFF, D_MOFF, D_GROUP, D_IDX]].tolist() \
        == [[4096, 32, 0, 0, 0, 0], [4096, 0, n0, n0, 1, 0],
            [4160, 0, 2 * n0, 2 * n0, 2, 0]]
    assert p.desc[:, D_NPAY].tolist() == [4096 - 56, 4072, 4136]
    assert p.desc[:, D_BOFF].tolist() == [0, 4040, 8112]
    assert sum(p.desc[:, D_NPAY]) == p.tbs + 24
    assert p.maps.size == p.drow and p.smem == 4 * max(p.Ls)
    assert p.desc[:, D_L].tolist() == list(p.Ls)
    assert p.desc[:, D_WOFF].tolist() == [0, p.Ls[0], p.Ls[0] + p.Ls[1]]
    assert p.desc[:, D_EOFF].tolist() == [0, p.Es[0], p.Es[0] + p.Es[1]]
    assert p.desc[:, D_E].tolist() == list(p.Es)
    for B in (1, 2, 3, 128):
        d = torch.empty(B * p.drow)
        for g, (K, _, rs), o in zip(dlsch_cuda.group_inputs(d, p, B),
                                    p.groups, p.goffs):
            assert g.shape == (len(rs) * B, 3, K + 4) and g.is_contiguous()
            assert (4 * B * o) % 16 == 0 and (4 * 3 * (K + 4)) % 16 == 0
    # the flagship's eleven blocks are one group; the uplink's too
    flag = _codec(("flagship",)).decode_plan()
    assert flag.groups == ((5632, 0, tuple(range(11))),)
    assert flag.desc[:, D_DOFF].tolist() == [3 * 5636 * i for i in range(11)]
    assert flag.smem == 4 * 16908 <= 4 * 3 * 32 * 193
    with pytest.raises(ValueError):
        dlsch_cuda.decode_plan(544, (600, 600))


def test_wrappers_take_cuda_tensors_only():
    """A CPU tensor goes the plain way in the codec and launches nothing;
    the wrappers refuse any other device than CUDA."""
    codec = _codec(("tb", 544, 1_200))
    p = codec.decode_plan()
    before = launch_counts()
    e = torch.randn(2, p.G)
    _, ok, w = codec.decode(e, dynamic_stop=False)
    codec.decode(e, w_soft=w, rv=2)
    assert launch_counts() == before and ok.shape == (2,)
    with pytest.raises(ValueError):
        dlsch_cuda.dematch(e, None, p, 0)
    with pytest.raises(ValueError):
        dlsch_cuda.tb_check([(torch.zeros(2, 576, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.bool))], p)
    with pytest.raises(ValueError):
        dlsch_cuda.dematch(torch.zeros(2, p.G, device="meta"), None, p, 0)
