"""Bit-level codec of the PyTorch port against the JAX reference: the same
numpy inputs through both, exact equality for bits and soft buffers."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openair4g_tpu.ops import crc as jcrc
from openair4g_tpu.ops import gold as jgold
from openair4g_tpu.ops import rate_match as jrm
from openair4g_tpu.ops import segmentation as jseg
from openair4g_tpu.ops import turbo as jturbo
from openair4g_tpu.phy.pdsch import DlschCodec as JCodec
from openair4g_tpu.phy.pdsch import DlschConfig as JConfig
from openair4g_tpu.tables import tbs as jtbs
from openair4g_tpu.tables.qpp import QPP_TABLE as J_QPP_TABLE
from openair4g_tpu_torch.ops import crc, gold, rate_match as rm, turbo
from openair4g_tpu_torch.ops import segmentation
from openair4g_tpu_torch.phy.pdsch import DlschCodec, DlschConfig
from openair4g_tpu_torch.tables import tbs
from openair4g_tpu_torch.tables.qpp import QPP_TABLE

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.array(x))


def test_standard_tables_equal_reference():
    assert QPP_TABLE == J_QPP_TABLE
    for mcs in range(29):
        assert tbs.get_Qm(mcs) == jtbs.get_Qm(mcs)
        for n_rb in (6, 25, 50, 100):
            assert tbs.get_TBS_DL(mcs, n_rb) == jtbs.get_TBS_DL(mcs, n_rb)
    for B in (40, 1000, 6144, 6168, 20000, 61688, 75400):
        assert vars(segmentation.segment_tb(B)) == vars(jseg.segment_tb(B))


@pytest.mark.parametrize("kind", ["crc24a", "crc24b", "crc16"])
def test_crc_matches_reference(kind):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (6, 200)).astype(np.int32)
    np.testing.assert_array_equal(crc.crc_matrix(200, kind),
                                  jcrc.crc_matrix(200, kind))
    np.testing.assert_array_equal(crc.crc_bits_host(bits[0], kind),
                                  jcrc.crc_bits_host(bits[0], kind))
    want = np.asarray(jcrc.crc_device(jnp.asarray(bits), kind))
    np.testing.assert_array_equal(crc.crc_device(t(bits), kind).numpy(), want)
    # a message with its own CRC attached checks; a flipped bit does not
    msg = np.stack([jcrc.attach_crc_host(b, kind) for b in bits])
    msg[1, 7] ^= 1
    want_ok = np.asarray(jcrc.crc_ok_device(jnp.asarray(msg), kind))
    got_ok = crc.crc_ok_device(t(msg), kind).numpy()
    np.testing.assert_array_equal(got_ok, want_ok)
    assert got_ok.sum() == 5 and not got_ok[1]


def test_scrambling_matches_reference():
    rng = np.random.default_rng(1)
    seq = gold.gold_sequence(gold.pdsch_cinit(0x1234, 0, 14, 0), 900)
    np.testing.assert_array_equal(
        seq, jgold.gold_sequence(jgold.pdsch_cinit(0x1234, 0, 14, 0), 900))
    bits = rng.integers(0, 2, (3, 900)).astype(np.int32)
    llr = rng.normal(size=(3, 900)).astype(np.float32)
    np.testing.assert_array_equal(
        gold.scramble_bits(t(bits), seq).numpy(),
        np.asarray(jgold.scramble_bits(jnp.asarray(bits), seq)))
    np.testing.assert_array_equal(
        gold.unscramble_llrs(t(llr), seq).numpy(),
        np.asarray(jgold.unscramble_llrs(jnp.asarray(llr), seq)))


# (K, F, rv, E, Ncb): filler bits, every rv, repetition (E > L), Ncb cap
_RM_CASES = [(40, 0, 0, 132, None), (512, 12, 1, 1200, None),
             (1824, 0, 2, 3000, None), (5632, 0, 3, 8184, 16000),
             (104, 8, 0, 400, None)]


@pytest.mark.parametrize("K,F,rv,E,Ncb", _RM_CASES)
def test_rate_match_maps_equal_reference(K, F, rv, E, Ncb):
    m, j = rm.make_rate_match_maps(K, F, rv, E, Ncb), \
        jrm.make_rate_match_maps(K, F, rv, E, Ncb)
    assert (m.Ncb, m.L, m.r_off) == (j.Ncb, j.L, j.r_off)
    np.testing.assert_array_equal(m.e_src, j.e_src)
    np.testing.assert_array_equal(m.d_from_order, j.d_from_order)
    assert rm.compute_ncb(K, 11) == jrm.compute_ncb(K, 11)
    assert rm.block_e_sizes(90000, 11, 6) == jrm.block_e_sizes(90000, 11, 6)


@pytest.mark.parametrize("K,F,rv,E,Ncb", _RM_CASES)
def test_rate_match_tx_rx_match_reference(K, F, rv, E, Ncb):
    rng = np.random.default_rng(K + rv)
    m, j = rm.make_rate_match_maps(K, F, rv, E, Ncb), \
        jrm.make_rate_match_maps(K, F, rv, E, Ncb)
    d = rng.integers(0, 2, (3, 3 * (K + 4))).astype(np.int32)
    np.testing.assert_array_equal(
        rm.rate_match_tx(t(d), m).numpy(),
        np.asarray(jrm.rate_match_tx(jnp.asarray(d), j)))
    e = rng.normal(size=(3, E)).astype(np.float32)
    w = rm.rate_match_rx(t(e), m)
    jw = jrm.rate_match_rx(jnp.asarray(e), j)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    # HARQ soft combining on top of an earlier round's buffer
    prev = rng.normal(size=(3, m.L)).astype(np.float32)
    np.testing.assert_array_equal(
        rm.rate_match_rx(t(e), m, t(prev)).numpy(),
        np.asarray(jrm.rate_match_rx(jnp.asarray(e), j, jnp.asarray(prev))))
    np.testing.assert_array_equal(
        rm.w_to_d_llr(w, m).numpy(), np.asarray(jrm.w_to_d_llr(jw, j)))


@pytest.mark.parametrize("D,E", [(43, 72), (43, 576), (60, 288)])
def test_cc_rate_match_rx_matches_reference(D, E):
    m, j = rm.make_cc_rate_match_maps(D, E), jrm.make_cc_rate_match_maps(D, E)
    np.testing.assert_array_equal(m.e_src, j.e_src)
    e = np.random.default_rng(D + E).normal(size=(4, E)).astype(np.float32)
    np.testing.assert_allclose(
        rm.cc_rate_match_rx(t(e), m).numpy(),
        np.asarray(jrm.cc_rate_match_rx(jnp.asarray(e), j)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K", [40, 432, 1824, 5632])
def test_turbo_encode_matches_reference(K):
    bits = np.random.default_rng(K).integers(0, 2, (3, K)).astype(np.int32)
    pi = turbo.qpp_interleaver(K)
    np.testing.assert_array_equal(pi, jturbo.qpp_interleaver(K))
    want = np.asarray(jturbo.turbo_encode_device(jnp.asarray(bits), pi))
    np.testing.assert_array_equal(
        turbo.turbo_encode_device(t(bits), pi).numpy(), want)


def _noisy_llrs(d, sigma, rng):
    y = (1.0 - 2.0 * d) + sigma * rng.standard_normal(d.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("K", [136, 512, 1824])
def test_turbo_decode_matches_reference(K):
    """Bits and CRC flags equal JAX's where every block decodes."""
    rng = np.random.default_rng(2 + K)
    payload = rng.integers(0, 2, (6, K - 24))
    bits = np.stack([jcrc.attach_crc_host(p, "crc24a") for p in payload])
    d = np.stack([jturbo.turbo_encode_host(b) for b in bits])
    llr = _noisy_llrs(d, np.sqrt(1.0 / (2 * 10 ** 0.2)), rng)   # Es/N0 2 dB
    jcfg = jturbo.TurboDecoderConfig(K=K, n_iter=6, window=96)
    cfg = turbo.TurboDecoderConfig(K=K, n_iter=6, window=96)
    jb, jok = jturbo.turbo_decode(jnp.asarray(llr), jcfg)
    b, ok = turbo.turbo_decode(t(llr), cfg)
    assert bool(np.all(np.asarray(jok)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(b.numpy(), bits)


def test_turbo_dynamic_stop_output_identical():
    """The early exit must give the fixed-iteration loop's output on a
    mixed pass/fail batch (as tests/test_turbo.py pins for JAX)."""
    K = 512
    rng = np.random.default_rng(3)
    tbs_ = np.stack([jcrc.attach_crc_host(rng.integers(0, 2, K - 24),
                                          "crc24a") for _ in range(16)])
    d = np.stack([jturbo.turbo_encode_host(b) for b in tbs_])
    llr = t(((1 - 2 * d) * 2.0 + rng.normal(size=d.shape) * 2.3)
            .astype(np.float32))
    bd, okd = turbo.turbo_decode(llr, turbo.TurboDecoderConfig(
        K=K, dynamic_stop=True))
    bs, oks = turbo.turbo_decode(llr, turbo.TurboDecoderConfig(
        K=K, dynamic_stop=False))
    assert 0 < int(okd.sum()) < 16, "want a mixed batch"
    assert torch.equal(okd, oks) and torch.equal(bd, bs)


@pytest.mark.parametrize("mcs,n_rb", [(4, 25), (26, 25), (10, 6)])
def test_dlsch_encode_matches_reference(mcs, n_rb):
    codec = DlschCodec(DlschConfig(mcs=mcs, n_rb=n_rb))
    jcodec = JCodec(JConfig(mcs=mcs, n_rb=n_rb))
    tb = np.random.default_rng(mcs).integers(
        0, 2, (3, codec.cfg.tbs)).astype(np.int32)
    for rv in (0, 2):
        np.testing.assert_array_equal(
            codec.encode(t(tb), rv).numpy(),
            np.asarray(jcodec.encode(jnp.asarray(tb), rv)))


@pytest.mark.parametrize("mcs", [4, 26])
def test_dlsch_decode_matches_reference(mcs):
    """Decoded TB bits, TB flags and soft buffers equal JAX's, with the
    decoder window pinned; a second round combines into the buffer."""
    cfg = dict(mcs=mcs, n_rb=25, n_turbo_iter=4, decoder_window=96)
    codec, jcodec = DlschCodec(DlschConfig(**cfg)), JCodec(JConfig(**cfg))
    rng = np.random.default_rng(10 + mcs)
    tb = rng.integers(0, 2, (3, codec.cfg.tbs)).astype(np.int32)
    e = np.asarray(jcodec.encode(jnp.asarray(tb)))
    llr = _noisy_llrs(e, 0.6, rng)
    jb, jok, jw = jcodec.decode(jnp.asarray(llr))
    b, ok, w = codec.decode(t(llr))
    assert bool(np.all(np.asarray(jok)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(b.numpy(), tb)
    e1 = np.asarray(jcodec.encode(jnp.asarray(tb), 1))
    llr1 = _noisy_llrs(e1, 0.6, rng)
    _, jok1, jw1 = jcodec.decode(jnp.asarray(llr1), w_soft=jw, rv=1)
    _, ok1, w1 = codec.decode(t(llr1), w_soft=w, rv=1)
    np.testing.assert_array_equal(ok1.numpy(), np.asarray(jok1))
    for a, b_ in zip(w1, jw1):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
