"""The DCI blind search as one launch (ops/convcode.viterbi_search): its
search plan reproduces cc_rate_match_rx candidate by candidate, added in
the kernel's order; the plan cache; dci_blind_decode on the CPU against the
JAX reference; the search wrapper's argument checks and its CPU dispatch;
and, on a card, the search kernel against its plain version bit for bit.

The reference is imported inside a fixture, so the `cuda` test also runs
where jax is not installed:

    python -m pytest --noconftest tests/test_torch_dci_search.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from openair4g_tpu_torch import kernels
from openair4g_tpu_torch.device import device_plan, launch_counts
from openair4g_tpu_torch.ops import convcode as cc
from openair4g_tpu_torch.ops.rate_match import make_cc_rate_match_maps
from openair4g_tpu_torch.phy import dci_formats as dci
from openair4g_tpu_torch.phy import pdcch as pd
from openair4g_tpu_torch.phy.control_region import make_control_region_map

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

CCE = pd.BITS_PER_CCE


def _spaces(n_rb: int, rnti: int = 0x1234, subframe: int = 7) -> dict:
    """The control region's CCEs (CFI 3) and its candidate sets: the common
    space with the UE space as the 0/1A search takes them, the UE space
    alone (the TM formats') and every (L, offset) (UlGrantSim's)."""
    n_cce = make_control_region_map(n_rb, 3).n_cce
    common = pd.common_search_candidates(n_cce)
    ue = pd.ue_search_candidates(n_cce, rnti, subframe)
    return {"n_cce": n_cce,
            "common+UE": common + [c for c in ue if c not in common],
            "UE": ue, "all": pd.search_space_candidates(n_cce)}


def _cands(candidates) -> tuple:
    return tuple((c.cce_offset * CCE, CCE * c.L) for c in candidates)


def _payload_ks(n_rb: int) -> list:
    """K = payload + CRC16 of formats 0/1A, 1 and 2A."""
    return sorted({dci.dci_format0_size(n_rb) + 16,
                   pd.dci_format1a_size(n_rb) + 16,
                   dci.dci_format1_size(n_rb) + 16,
                   dci.dci_format2a_size(n_rb) + 16})


def apply_plan(plan: cc.SearchPlan, llr: np.ndarray, K: int) -> np.ndarray:
    """The kernel's load phase in numpy, read from the plan's table: each
    candidate's fold in float32, input r into accumulator r mod 4 from +0
    in increasing r, then ((a0 + a1) + a2) + a3 (torch's CUDA order of a
    strided reduction); e[i] alone and the zero pad where E <= L; then the
    d_from_order gather times its mask. llr [B, W] -> [n_cand B, 3, K]."""
    n = plan.n_cand
    desc = plan.table[:4 * n].reshape(n, 4)
    maps = plan.table[4 * n:].reshape(-1, 3 * K)
    B, out = llr.shape[0], []
    for start, E, L, row in desc:
        e = llr[:, start:start + E]
        if E <= L:
            folded = np.zeros((B, L), np.float32)
            folded[:, :E] = e
        else:
            acc = np.zeros((4, B, L), np.float32)
            for r in range(-(-E // L)):
                seg = e[:, r * L:(r + 1) * L]
                acc[r % 4, :, :seg.shape[1]] += seg
            folded = ((acc[0] + acc[1]) + acc[2]) + acc[3]
        m = maps[row]
        d = folded[:, np.where(m >= 0, m, 0)] * (m >= 0).astype(np.float32)
        out.append(d.reshape(B, 3, K))
    return np.concatenate(out)


@pytest.mark.parametrize("space", ["common+UE", "UE", "all"])
@pytest.mark.parametrize("n_rb", [6, 25, 100])
def test_plan_reproduces_the_candidate_loop(n_rb, space):
    """The plan applied in the kernel's order equals search_llrs_ref (the
    candidate loop of cc_rate_match_rx): exactly on integer LLRs, within
    rtol = atol = 2e-6 on Gaussian ones (the CPU's fold may add in another
    order); L = 1 (punctured) to 8 (repeated), formats 0/1A, 1, 2A."""
    sp = _spaces(n_rb)
    cands = _cands(sp[space])
    assert {L for _, L in cands} >= ({CCE, 2 * CCE, 4 * CCE}
                                     if n_rb > 6 else {CCE})
    rng = np.random.default_rng(n_rb)
    W = sp["n_cce"] * CCE
    ints = rng.integers(-2, 3, (3, W)).astype(np.float32)
    gauss = (3.0 * rng.normal(size=(3, W))).astype(np.float32)
    gauss[0, :7] = -0.0
    for K in _payload_ks(n_rb):
        plan = cc._search_plan(K, cands)
        assert plan.n_cand == len(cands)
        for llr in (ints, gauss):
            want = cc.search_llrs_ref(torch.from_numpy(llr), K, cands).numpy()
            got = apply_plan(plan, llr, K)
            assert got.shape == want.shape == (len(cands) * 3, 3, K)
            if llr is ints:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_plan_layout():
    """A row a candidate (start, E, the circular buffer's L, its map), one
    d_from_order map a distinct E; the furthest end and the reach from the
    first start, which bounds the span a block of the kernel stages."""
    cands = _cands(_spaces(100)["all"])
    plan = cc._search_plan(43, cands)
    Es = sorted({E for _, E in cands})
    assert plan.n_maps == len(Es)
    assert plan.table.size == 4 * len(cands) + plan.n_maps * 3 * 43
    desc = plan.table[:4 * len(cands)].reshape(-1, 4)
    maps = plan.table[4 * len(cands):].reshape(-1, 3 * 43)
    for (s, E), (start, e, L, row) in zip(cands, desc):
        m = make_cc_rate_match_maps(43, E)
        assert (start, e, L, row) == (s, E, m.L, Es.index(E))
        np.testing.assert_array_equal(maps[row], m.d_from_order)
    assert plan.end == max(s + E for s, E in cands)
    assert plan.reach == plan.end - min(s for s, _ in cands)


def test_plan_cache():
    """One entry a candidate tuple, the same plan and the same device tensor
    on a second call; the UE space of another subframe is another entry."""
    n_cce = 87
    a = _cands(pd.ue_search_candidates(n_cce, 0x2BAD, 3))
    b = _cands(pd.ue_search_candidates(n_cce, 0x2BAD, 4))
    assert a != b
    before = cc._search_plan.cache_info().currsize
    pa = cc._search_plan(61, a)
    assert cc._search_plan.cache_info().currsize == before + 1
    assert cc._search_plan(61, a) is pa
    assert cc._search_plan.cache_info().currsize == before + 1
    assert cc._search_plan(61, b) is not pa
    assert cc._search_plan.cache_info().currsize == before + 2
    t = device_plan(pa.table, "cpu")
    assert device_plan(cc._search_plan(61, a).table, "cpu") is t
    assert t.dtype == torch.int32


@pytest.fixture(scope="module")
def jax_pdcch():
    pytest.importorskip("jax")
    from openair4g_tpu.phy import pdcch as jpd
    return jpd


@pytest.mark.parametrize("n_rb", [6, 25])
def test_blind_decode_on_the_cpu_equals_reference(jax_pdcch, n_rb):
    """dci_blind_decode on a CPU tensor (the plain loop) against the JAX
    reference on the same numpy draws: found, payload and candidate index;
    DCIs at several candidates, one row of noise alone."""
    import jax.numpy as jnp
    jpd = jax_pdcch
    rnti = 0x1234
    cands = _spaces(n_rb, rnti)["common+UE"]
    n_cce = _spaces(n_rb)["n_cce"]
    jcands = [jpd.DciCandidate(c.L, c.cce_offset) for c in cands]
    payload = pd.pack_dci_format1a(n_rb, 0, n_rb, 4, 0, 1, 0)
    rng = np.random.default_rng(n_rb)
    B = 5
    llr = rng.normal(size=(B, n_cce * CCE)).astype(np.float32)
    for b, ci in enumerate((0, len(cands) - 1, len(cands) // 2, 1)):
        c = cands[ci]
        e = pd.dci_encode(payload, rnti, c.L)
        s = c.cce_offset * CCE
        llr[b, s:s + len(e)] = (1 - 2.0 * e) * 4 + rng.normal(size=len(e))
    found, bits, idx = pd.dci_blind_decode(torch.from_numpy(llr),
                                           len(payload), rnti, cands)
    jfound, jbits, jidx = jpd.dci_blind_decode(jnp.asarray(llr),
                                               len(payload), rnti, jcands)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert found[:4].all() and not found[4]


def test_cpu_tensor_takes_the_plain_loop(monkeypatch):
    """A CPU tensor runs viterbi_search_ref and search_llrs_ref and never
    builds, loads or counts the kernel; B = 0 returns at once."""
    monkeypatch.setattr(kernels, "load",
                        lambda: pytest.fail("the CPU path built"))
    cands = _cands(_spaces(25)["common+UE"])
    W = _spaces(25)["n_cce"] * CCE
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -2, 3, (2, W)).astype(np.float32))
    before = launch_counts()["viterbi_search"]
    assert torch.equal(cc.viterbi_search(x, 39, cands),
                       cc.viterbi_search_ref(x, 39, cands))
    assert torch.equal(cc.search_llrs(x, 39, cands),
                       cc.search_llrs_ref(x, 39, cands))
    out = cc.viterbi_search(x[:0], 39, cands)
    assert out.shape == (0, 39) and out.dtype == torch.int8
    assert launch_counts()["viterbi_search"] == before


def test_search_argument_checks():
    x = torch.zeros(3, 10 * CCE)
    good = ((0, CCE), (2 * CCE, 4 * CCE))
    assert cc._check_search_args(x, 43, good) is cc._search_plan(43, good)
    with pytest.raises(TypeError):
        cc._check_search_args(x.double(), 43, good)
    with pytest.raises(ValueError):                # not [B, W]
        cc._check_search_args(torch.zeros(3, 2, 5 * CCE), 43, good)
    for cands in ((), ((0, 0),), ((-1, CCE),), ((9 * CCE, 2 * CCE),),
                  ((0, CCE, 1),)):
        with pytest.raises(ValueError):
            cc._check_search_args(x, 43, cands)
    with pytest.raises(ValueError):                # T = 3 K beyond MAX_T
        cc._check_search_args(x, 683, good)
    with pytest.raises(ValueError):
        cc._check_search_args(x, 0, good)
    with pytest.raises(ValueError):                # neither CUDA nor CPU
        cc.viterbi_search(torch.zeros(2, 10 * CCE, device="meta"), 43, good)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 128])
def test_search_kernel_equals_plain_version(cuda, B):
    """One launch a call, the decisions equal to viterbi_search_ref and the
    load phase to search_llrs_ref bit for bit (torch's CUDA fold), on
    Gaussian and tie-forcing integer LLRs, at 6, 25 and 100 PRB with each
    candidate set and format size."""
    rng = np.random.default_rng(B)
    for n_rb in (6, 25, 100):
        sp = _spaces(n_rb)
        W = sp["n_cce"] * CCE
        for space in ("common+UE", "UE", "all"):
            cands = _cands(sp[space])
            for K in _payload_ks(n_rb):
                for llr in (3.0 * rng.normal(size=(B, W)),
                            rng.integers(-2, 3, (B, W))):
                    x = torch.from_numpy(llr.astype(np.float32)).to(cuda)
                    before = launch_counts()["viterbi_search"]
                    got = cc.viterbi_search(x, K, cands)
                    torch.cuda.synchronize()
                    assert launch_counts()["viterbi_search"] == before + 1
                    assert torch.equal(got, cc.viterbi_search_ref(x, K,
                                                                  cands))
                    d, want = (cc.search_llrs(x, K, cands),
                               cc.search_llrs_ref(x, K, cands))
                    assert torch.equal(d.view(torch.int32),
                                       want.view(torch.int32))
