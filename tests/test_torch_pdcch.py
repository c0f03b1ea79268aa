"""PDCCH path of the PyTorch port against the JAX reference: the Viterbi
decoder and the DCI blind decode give exactly the same bits and flags on
the same LLRs; the host-side control plans equal the reference's."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openair4g_tpu.ops import convcode as jcc
from openair4g_tpu.phy import control_region as jcr
from openair4g_tpu.phy import pdcch as jpd
from openair4g_tpu_torch.ops import convcode as cc
from openair4g_tpu_torch.phy import control_region as cr
from openair4g_tpu_torch.phy import pdcch as pd

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.mark.parametrize("n_rb,n_pdcch", [(6, 2), (25, 1), (100, 1),
                                          (100, 3)])
def test_control_plans_equal_reference(n_rb, n_pdcch):
    m, j = (cr.make_control_region_map(n_rb, n_pdcch),
            jcr.make_control_region_map(n_rb, n_pdcch))
    assert m.n_cce == j.n_cce
    for f in ("pcfich_sym", "pcfich_bin", "pdcch_sym", "pdcch_sc",
              "pdcch_bin"):
        np.testing.assert_array_equal(getattr(m, f), getattr(j, f))
    n_cce = m.n_cce
    as_pairs = lambda cs: [(c.L, c.cce_offset) for c in cs]   # noqa: E731
    assert as_pairs(pd.common_search_candidates(n_cce)) == \
        as_pairs(jpd.common_search_candidates(n_cce))
    assert as_pairs(pd.ue_search_candidates(n_cce, 0x1234, 7)) == \
        as_pairs(jpd.ue_search_candidates(n_cce, 0x1234, 7))


def test_dci_coding_plans_equal_reference():
    for cfi in (1, 2, 3):
        np.testing.assert_array_equal(pd.cfi_encode(cfi), jpd.cfi_encode(cfi))
    np.testing.assert_array_equal(pd.pdcch_scramble_seq(0, 14, 1512),
                                  jpd.pdcch_scramble_seq(0, 14, 1512))
    for n_rb, mcs in ((25, 4), (100, 26)):
        p = pd.pack_dci_format1a(n_rb, 0, n_rb, mcs, 0, 1, 0)
        np.testing.assert_array_equal(
            p, jpd.pack_dci_format1a(n_rb, 0, n_rb, mcs, 0, 1, 0))
        for L in (1, 2, 4, 8):
            np.testing.assert_array_equal(pd.dci_encode(p, 0x1234, L),
                                          jpd.dci_encode(p, 0x1234, L))
    bits = np.random.default_rng(0).integers(0, 2, 43)
    np.testing.assert_array_equal(cc.conv_encode_host(bits),
                                  jcc.conv_encode_host(bits))


@pytest.mark.parametrize("sigma", [0.5, 1.2])
def test_viterbi_matches_reference(sigma):
    rng = np.random.default_rng(int(10 * sigma))
    K = 43
    bits = rng.integers(0, 2, (12, K))
    d = np.stack([jcc.conv_encode_host(b) for b in bits])
    llr = ((1 - 2.0 * d) + sigma * rng.normal(size=d.shape)).astype(
        np.float32) * 2.0 / sigma ** 2
    got = cc.viterbi_decode(torch.from_numpy(llr), K).numpy()
    want = np.asarray(jcc.viterbi_decode(jnp.asarray(llr), K))
    np.testing.assert_array_equal(got, want)
    if sigma < 1:
        np.testing.assert_array_equal(got, bits)


def test_dci_blind_decode_matches_reference():
    """Trials with the DCI at different candidates, one with noise only:
    found flags, payloads and candidate indices equal the reference's."""
    n_cce, rnti = 21, 0x1234
    cands = pd.common_search_candidates(n_cce) + [
        c for c in pd.ue_search_candidates(n_cce, rnti, 7)
        if c not in pd.common_search_candidates(n_cce)]
    jcands = [jpd.DciCandidate(c.L, c.cce_offset) for c in cands]
    payload = pd.pack_dci_format1a(100, 0, 100, 26, 0, 1, 0)
    rng = np.random.default_rng(3)
    B = 6
    llr = rng.normal(size=(B, n_cce * pd.BITS_PER_CCE)).astype(np.float32)
    for b, ci in enumerate((0, 3, len(cands) - 1, 5, 1)):
        c = cands[ci]
        e = pd.dci_encode(payload, rnti, c.L)
        s = c.cce_offset * pd.BITS_PER_CCE
        llr[b, s:s + len(e)] = (1 - 2.0 * e) * 4 + rng.normal(size=len(e))
    found, bits, idx = pd.dci_blind_decode(torch.from_numpy(llr),
                                           len(payload), rnti, cands)
    jfound, jbits, jidx = jpd.dci_blind_decode(jnp.asarray(llr),
                                               len(payload), rnti, jcands)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert found[:5].all() and not found[5]
    assert (bits[:5].numpy() == payload).all()
