"""The port's hand-written CUDA kernels and its device entry on a card.

Every test here needs a CUDA device and skips without one. The module
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py sets jax up for the rest of the suite, hence
--noconftest there).
"""
import numpy as np
import pytest
import torch

from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops.equalize_llr import (demap_llr_fused,
                                                  demap_llr_fused_ref,
                                                  mrc_llr, mrc_llr_ref)
from openair4g_tpu_torch.ops.turbo_cuda import (BIG, half_iteration,
                                                half_iteration_prepped,
                                                half_iteration_prepped_ref,
                                                half_iteration_ref,
                                                pick_unroll, prep_parity)
from openair4g_tpu_torch.ops.uci import UciConfig
from openair4g_tpu_torch.phy.pdsch import DlschCodec, DlschConfig
from openair4g_tpu_torch.phy.pusch import UlschConfig
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig
from openair4g_tpu_torch.sim.dlsim_sm import DlsimSm, DlsimSmConfig
from openair4g_tpu_torch.sim.mbmssim import Mbmssim, MbmssimConfig
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig
from test_torch_dlsch_decode import _TbsConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,W,n_w,U", [(64, 48, 3, 24), (64, 96, 2, 24),
                                       (1408, 240, 24, 24), (5, 240, 3, 24),
                                       (5, 44, 3, 20), (5, 42, 3, 18),
                                       (5, 45, 3, 15)])
def test_turbo_kernel_matches_plain_version(cuda, B, W, n_w, U):
    """(5, 240, 3): 15 lanes, most of the kernel's one block masked. The
    last three run the kernel's R = 4 (float4), 2 and 1 (scalar) instances;
    the others R = 8."""
    rng = np.random.default_rng(W + n_w)
    lin = (3.0 * rng.standard_normal((B, W * n_w))).astype(np.float32)
    lp = (3.0 * rng.standard_normal((B, W * n_w))).astype(np.float32)
    lin[:, -7:] = BIG
    lp[:, -7:] = BIG
    lin, lp = torch.from_numpy(lin).to(cuda), torch.from_numpy(lp).to(cuda)
    before = launch_counts()["turbo_half_iter"]
    got = half_iteration(lin, lp, W, U)
    torch.cuda.synchronize()
    assert launch_counts()["turbo_half_iter"] == before + 1
    # same float32 operations in the same order: equal bit for bit
    torch.testing.assert_close(got, half_iteration_ref(lin, lp, W, U),
                               rtol=0, atol=0)


@pytest.mark.parametrize("A,Qm,n0_kind", [(1, 6, "per_re"), (1, 2, "scalar"),
                                          (2, 4, "per_re"), (2, 6, "full")])
def test_mrc_llr_kernel_matches_plain_version(cuda, A, Qm, n0_kind):
    rng = np.random.default_rng(A * 10 + Qm)
    shape = (3, 700, A)
    y = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    H = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    y, H = torch.from_numpy(y).to(cuda), torch.from_numpy(H).to(cuda)
    n0 = {"scalar": 0.37,
          "per_re": torch.from_numpy(rng.uniform(0.1, 2, 700).astype(
              np.float32)).to(cuda),
          "full": torch.from_numpy(rng.uniform(0.1, 2, (3, 700)).astype(
              np.float32)).to(cuda)}[n0_kind]
    before = launch_counts()["mrc_llr"]
    got = mrc_llr(y, H, n0, Qm)
    torch.cuda.synchronize()
    assert launch_counts()["mrc_llr"] == before + 1
    torch.testing.assert_close(got, mrc_llr_ref(y, H, n0, Qm),
                               rtol=3e-4, atol=3e-4)


def _cplx(gen, *shape, device):
    return torch.view_as_complex(torch.randn(*shape, 2, generator=gen,
                                             device=device))


@pytest.mark.parametrize("Qm", [2, 4, 6])
@pytest.mark.parametrize("A", [1, 2])
def test_mrc_llr_kernel_layouts_agree(cuda, A, Qm):
    """The kernel against the plain version, and equal LLRs from every
    layout of the same REs (the same per-RE arithmetic): an even and an odd
    count, interleaved [B, N, A] and [B, A, N] planes given as a transposed
    view, a view of y 8 bytes off a 16-byte boundary, n0 as a number, one
    value an RE, one a row and full shape."""
    gen = torch.Generator(device=cuda).manual_seed(10 * A + Qm)
    for B, N in ((3, 700), (3, 701), (130, 10)):
        y, H = _cplx(gen, B, N, A, device=cuda), _cplx(gen, B, N, A,
                                                       device=cuda)
        yp, Hp = (t.transpose(1, 2).contiguous() for t in (y, H))
        off = torch.zeros(B * N * A + 1, dtype=torch.complex64, device=cuda)
        off[1:] = y.reshape(-1)
        off = off[1:].view(B, N, A)                 # 8 bytes off 16
        assert off.data_ptr() % 16 == 8
        for n0 in (0.37, 0.05 + torch.rand(N, generator=gen, device=cuda),
                   0.05 + torch.rand(B, 1, generator=gen, device=cuda),
                   0.05 + torch.rand(B, N, generator=gen, device=cuda)):
            before = launch_counts()["mrc_llr"]
            got = mrc_llr(y, H, n0, Qm)
            assert launch_counts()["mrc_llr"] == before + 1
            torch.testing.assert_close(got, mrc_llr_ref(y, H, n0, Qm),
                                       rtol=3e-4, atol=3e-4)
            planes = mrc_llr(yp.transpose(1, 2), Hp.transpose(1, 2), n0, Qm)
            assert planes.is_contiguous() and torch.equal(planes, got)
            assert torch.equal(mrc_llr(off, H, n0, Qm), got)


def test_mrc_llr_and_demap_llr_kernels_take_more_rows_than_one_grid_axis(cuda):
    """One n0 a row of 4 REs makes blocks of 64 rows; 65,535 x 64 + 100 rows
    are more blocks than the grid's y extent holds, so they spill into z."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    rows = 65535 * 64 + 100
    y, H = _cplx(gen, rows, 4, 1, device=cuda), _cplx(gen, rows, 4, 1,
                                                     device=cuda)
    n0 = 0.05 + torch.rand(rows, 1, generator=gen, device=cuda)
    got = mrc_llr(y, H, n0, 2)
    for part in (slice(0, 4096), slice(rows - 4096, rows)):
        torch.testing.assert_close(got[part],
                                   mrc_llr_ref(y[part], H[part], n0[part], 2),
                                   rtol=3e-4, atol=3e-4)
    x = y[..., 0]
    got = demap_llr_fused(x, n0, 2)
    for part in (slice(0, 4096), slice(rows - 4096, rows)):
        torch.testing.assert_close(got[part],
                                   demap_llr_fused_ref(x[part], n0[part], 2),
                                   rtol=3e-4, atol=3e-4)


def test_kernels_refuse_what_they_do_not_take(cuda):
    y = torch.zeros(4, 3, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        mrc_llr(y, y, 1.0, 8)                       # Qm not built
    with pytest.raises(ValueError):
        mrc_llr(y.t(), y.t(), 1.0, 2)               # A = 4 not built
    crop = torch.zeros(4, 6, 8, 2, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):                 # cropped in two dims:
        mrc_llr(crop[:, :3, :5], crop[:, :3, :5], 1.0, 2)   # no rows x cols
    with pytest.raises(ValueError):
        demap_llr_fused(crop[:, :3, :5, 0], 1.0, 2)
    with pytest.raises(ValueError):
        demap_llr_fused(y, 1.0, 8)                  # Qm not built
    with pytest.raises(ValueError):                 # n0 on another device
        mrc_llr(y, y, torch.ones(4), 2)
    with pytest.raises(ValueError):
        demap_llr_fused(y, torch.ones(4, 3), 2)
    with pytest.raises(TypeError):
        demap_llr_fused(y.to(torch.complex128), 1.0, 2)
    lin = torch.zeros(2, 96, device=cuda)
    with pytest.raises(TypeError):
        half_iteration(lin.double(), lin.double(), 48, 24)
    off = torch.zeros(2 * 96 + 1, device=cuda)[1:].view(2, 96)
    with pytest.raises(ValueError, match="16-byte aligned"):
        half_iteration(off, lin, 48, 24)            # float4 loads
    gpf, gpb = prep_parity(lin, 48, 24)
    with pytest.raises(ValueError, match="16-byte aligned"):
        half_iteration_prepped(off, gpf, gpb, 48, 24)
    with pytest.raises(ValueError):                 # frames of another shape
        half_iteration_prepped(lin, gpf[:-1], gpb, 48, 24)
    with pytest.raises(ValueError):                 # a strided frame
        half_iteration_prepped(lin, gpf, gpb.t().contiguous().t(), 48, 24)


def test_step_on_card_decodes_through_both_kernels(cuda):
    cfg = DlsimFadingConfig(mcs=26, n_rb=25, channel="EVA", n_rx=1,
                            n_harq_rounds=1, batch=8, est_mode="joint",
                            n_turbo_iter=4)
    sim = DlsimFading(cfg, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    W, ev = sim.wiener(30.0), sim.err_var(30.0)
    before = launch_counts()
    res = sim.step(gen, 10.0 ** -3.0, W, ev).rounds[0]
    after = launch_counts()
    assert bool(res.ok.all()) and int(res.bit_errs.sum()) == 0
    assert all(after[k] > before[k] for k in ("turbo_decode", "mrc_llr")), \
        (before, after)
    # the path runs v2's body inside the decode kernel, never v2 alone
    assert after["turbo_half_iter"] == before["turbo_half_iter"]


@pytest.mark.parametrize("est_mode", ["dd", "interp"])
def test_1x2_harq_step_on_card_goes_through_mrc_at_two_antennas(cuda,
                                                                est_mode):
    """Two RX antennas, 2 HARQ rounds: per round one mrc_llr launch for the
    data and one for the PDCCH, both at A = 2, and the turbo decode
    kernel."""
    cfg = DlsimFadingConfig(mcs=16, n_rb=25, channel="EVA", n_rx=2,
                            n_harq_rounds=2, batch=8, est_mode=est_mode,
                            n_turbo_iter=4)
    sim = DlsimFading(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    W, ev = sim.wiener(30.0), sim.err_var(30.0)
    before = launch_counts()
    res = sim.step(gen, 10.0 ** -3.0, W, ev)
    after = launch_counts()
    assert bool(res.rounds[0].ok.all()) and res.reach.tolist() == [8, 0]
    assert after["mrc_llr"] == before["mrc_llr"] + 4, (before, after)
    assert after["turbo_decode"] > before["turbo_decode"]


@pytest.mark.parametrize("Qm", [2, 4, 6])
@pytest.mark.parametrize("layout", ["contiguous", "layer", "odd",
                                    "unaligned"])
def test_demap_llr_kernel_matches_plain_version(cuda, Qm, layout):
    """`layer`: x_hat[..., 1] and n0_eff[..., 1] of an MMSE output
    [B, N, 2], read in place at element stride 2; `odd`: an odd count;
    `unaligned`: a view 8 bytes off a 16-byte boundary."""
    gen = torch.Generator(device=cuda).manual_seed(Qm)
    shape = {"layer": (3, 700, 2), "odd": (3, 701)}.get(layout, (3, 700))
    x = _cplx(gen, *shape, device=cuda)
    n0 = 0.05 + torch.rand(*shape, generator=gen, device=cuda)
    if layout == "layer":
        x, n0 = x[..., 1], n0[..., 1]
        assert not x.is_contiguous()
    if layout == "unaligned":
        buf = torch.zeros(x.numel() + 1, dtype=torch.complex64, device=cuda)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
        assert x.data_ptr() % 16 == 8
    before = launch_counts()["demap_llr"]
    got = demap_llr_fused(x, n0, Qm)
    torch.cuda.synchronize()
    assert launch_counts()["demap_llr"] == before + 1
    torch.testing.assert_close(got, demap_llr_fused_ref(x, n0, Qm),
                               rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(demap_llr_fused(x, 0.3, Qm),
                               demap_llr_fused_ref(x, 0.3, Qm),
                               rtol=3e-4, atol=3e-4)


def test_demap_llr_kernel_takes_broadcast_n0(cuda):
    """n0_eff as a full-shape view of one value, or of one value per row
    (stride 0), on a strided x_hat layer."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.view_as_complex(torch.randn(3, 700, 2, 2, generator=gen,
                                          device=cuda))[..., 0]
    for n0 in (torch.tensor(0.3, device=cuda).expand_as(x),
               torch.tensor([0.2, 0.5, 1.1], device=cuda)[:, None]
               .expand(3, 700)):
        torch.testing.assert_close(demap_llr_fused(x, n0, 4),
                                   demap_llr_fused_ref(x, n0.contiguous(), 4),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("B,W,n_w,U", [(64, 48, 3, 24), (1408, 240, 24, 24),
                                       (5, 240, 3, 24), (5, 44, 3, 20),
                                       (5, 42, 3, 18), (5, 45, 3, 15)])
def test_turbo_v1_kernel_matches_plain_version(cuda, B, W, n_w, U):
    """(5, 240, 3): 15 lanes, most of the kernel's one block masked; the
    last three run its R = 4, 2 and 1 instances. One call is one launch."""
    gen = torch.Generator(device=cuda).manual_seed(W)
    lin = 3.0 * torch.randn(B, W * n_w, generator=gen, device=cuda)
    lp = 3.0 * torch.randn(B, W * n_w, generator=gen, device=cuda)
    lin[:, -7:] = BIG
    lp[:, -7:] = BIG
    gpf, gpb = prep_parity(lp, W, U)
    before = launch_counts()["turbo_half_iter_v1"]
    got = half_iteration_prepped(lin, gpf, gpb, W, U)
    torch.cuda.synchronize()
    assert launch_counts()["turbo_half_iter_v1"] == before + 1
    assert pick_unroll(W, U) == {240: 8, 48: 8, 44: 4, 42: 2, 45: 1}[W]
    # same float32 operations in the same order: equal bit for bit
    torch.testing.assert_close(
        got, half_iteration_prepped_ref(lin, gpf, gpb, W, U),
        rtol=0, atol=0)


def test_tm3_step_on_card_goes_through_demap_kernel(cuda):
    sim = DlsimSm(DlsimSmConfig(tm=3, mcs=16, mcs2=16, n_rb=25, batch=8,
                                n_turbo_iter=4), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    W0, W1 = sim.wiener(40.0)
    before = launch_counts()
    res = sim.step(gen, 1e-4, W0, W1)
    after = launch_counts()
    assert bool(res.dci_ok.all())
    assert res.ok.shape == (2, 8)
    # two layers and the PDCCH
    assert after["demap_llr"] == before["demap_llr"] + 3, (before, after)
    assert after["turbo_decode"] > before["turbo_decode"]


# ------------------------------------------------- the DLSCH bit chain --

def _dlsch_equal(codec, B, cuda, seed):
    """The encode and select kernels' d and e (every rv) against the plain
    path on the CPU, bit for bit."""
    gen = torch.Generator().manual_seed(seed)
    tb = torch.randint(0, 2, (B, codec.cfg.tbs), generator=gen,
                       dtype=torch.int32)
    want = codec.encode_to_d(tb)
    got = codec.encode_to_d(tb.to(cuda))
    assert torch.equal(torch.cat(got, 1).cpu(), torch.cat(want, 1)), \
        (codec.cfg, B)
    for rv in range(4):
        assert torch.equal(codec.select_e(got, rv).cpu(),
                           codec.select_e(want, rv)), (codec.cfg, B, rv)


@pytest.mark.parametrize("n_rb", [6, 15, 25, 50, 75, 100])
def test_dlsch_kernels_match_plain_path_at_every_table_tbs(cuda, n_rb):
    """Every DL MCS at 1 and 2 ports and CFI 1-3, and every UL MCS, over
    the band: the codecs of DlsimFading, DlsimAwgn, dlsim_mimo,
    FullChainSim, tddsim, oaisim, the capstones and sched/ue_tx (K = 40 to
    6,144, C = 1 to 13) at each bandwidth."""
    codecs = [DlschCodec(DlschConfig(mcs=m, n_rb=n_rb, nports=p,
                                     n_pdcch_symbols=cfi))
              for m in range(29) for p in (1, 2) for cfi in (1, 2, 3)]
    codecs += [DlschCodec(UlschConfig(mcs=m, n_rb_alloc=n_rb))
               for m in range(29)]
    for i, codec in enumerate(codecs):
        _dlsch_equal(codec, 3, cuda, seed=1000 * n_rb + i)


@pytest.mark.parametrize("B", [1, 128, 512])
def test_dlsch_kernels_match_plain_path_at_the_benchmark_batches(cuda, B):
    """The flagship's codec, the uplink's with its UCI (g_override) and the
    MBSFN region's (g_override) at batch 1, 128 and 512."""
    ul = Ulsim(UlsimConfig(mcs=20, n_rb=100, n_rb_alloc=100, batch=B,
                           uci=UciConfig(o_cqi=30, o_ri=1, o_ack=2)),
               device=cuda).codec
    mbms = Mbmssim(MbmssimConfig(mcs=16, n_rb=100, batch=B),
                   device=cuda).codec
    flagship = DlschCodec(DlschConfig(mcs=26, n_rb=100))
    for i, codec in enumerate((flagship, ul, mbms)):
        _dlsch_equal(codec, B, cuda, seed=B + i)


def test_dlsch_kernels_launch_once_a_trial_and_once_a_round(cuda):
    """One encode a trial and one select a round, in the DL and the UL;
    streams that are not views of one encode's buffer are refused."""
    dl = DlsimFading(DlsimFadingConfig(mcs=26, n_rb=25, channel="EVA",
                                       n_harq_rounds=2, batch=8,
                                       n_turbo_iter=4), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = launch_counts()
    dl.step(gen, 10.0 ** -3.0, dl.wiener(30.0), dl.err_var(30.0))
    after = launch_counts()
    assert (after["dlsch_encode"] - before["dlsch_encode"],
            after["dlsch_select"] - before["dlsch_select"]) == (1, 2)
    ul = Ulsim(UlsimConfig(mcs=20, n_rb=25, n_rb_alloc=25, channel="EVA",
                           n_harq_rounds=4, batch=8), device=cuda)
    before = launch_counts()
    ul.step(gen, 10.0 ** -1.6, ul.wiener(16.0))
    after = launch_counts()
    assert (after["dlsch_encode"] - before["dlsch_encode"],
            after["dlsch_select"] - before["dlsch_select"]) == (1, 4)
    tb = torch.randint(0, 2, (8, dl.dlsch.cfg.tbs), device=cuda,
                       generator=gen, dtype=torch.int32)
    d = dl.dlsch.encode_to_d(tb)
    with pytest.raises(ValueError):
        dl.dlsch.select_e([x.clone() for x in d], 3)


# --------------------------------------- the DLSCH receive bit chain --

def _decode_equal(codec, B, cuda, seed, rvs=(0, 2, 3, 1)):
    """DlschCodec.decode on the card (the dematch and TB check kernels)
    against its plain path on the card (decode_ref), HARQ rounds at rvs
    combined, dynamic stop on and off: b_hat, tb_ok, every block's soft
    buffer and the iterations bit for bit; the w passed in unchanged; one
    launch of each kernel a call. The LLRs: an encoded TB at a spread of
    SNRs, so that some rows decode and some do not."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    tb = torch.randint(0, 2, (B, codec.cfg.tbs), generator=gen, device=cuda,
                       dtype=torch.int32)
    d = codec.encode_to_d(tb)
    amp = torch.linspace(0.3, 3.0, B, device=cuda)[:, None]
    for dyn in (True, False):
        w_k = w_p = None
        for rv in rvs:
            e = codec.select_e(d, rv)
            llr = (amp * (1 - 2 * e) + 2 * torch.randn(
                e.shape, generator=gen, device=cuda)).contiguous()
            held = None if w_k is None else [x.clone() for x in w_k]
            before = launch_counts()
            it_k, it_p = [], []
            got = codec.decode(llr, w_soft=w_k, rv=rv, dynamic_stop=dyn,
                               iters=it_k)
            after = launch_counts()
            want = codec.decode_ref(llr, w_soft=w_p, rv=rv, dynamic_stop=dyn,
                                    iters=it_p)
            what = (codec.cfg, B, rv, dyn)
            assert (after["dlsch_dematch"] - before["dlsch_dematch"],
                    after["dlsch_tb_check"] - before["dlsch_tb_check"]) \
                == (1, 1), what
            assert torch.equal(got[0], want[0]), what
            assert torch.equal(got[1], want[1]), what
            assert len(got[2]) == len(want[2]) == codec.seg.C
            for a, b in zip(got[2], want[2]):
                assert torch.equal(a, b), what
            assert [k for k, _ in it_k] == [k for k, _ in it_p]
            for (_, a), (_, b) in zip(it_k, it_p):
                assert torch.equal(a, b), what
            if held is not None:
                assert all(torch.equal(a, b) for a, b in zip(w_k, held)), \
                    what
            w_k, w_p = got[2], want[2]


@pytest.mark.parametrize("B", [1, 128, 512])
def test_dlsch_decode_kernels_match_plain_path_at_the_cells(cuda, B):
    """The benchmark's codecs: the flagship's (MCS 26, 100 PRB, CFI 1), the
    dd cell's (CFI 2) and the uplink's with its UCI, four rounds each."""
    ul = Ulsim(UlsimConfig(mcs=20, n_rb=100, n_rb_alloc=100, batch=B,
                           uci=UciConfig(o_cqi=30, o_ri=1, o_ack=2)),
               device=cuda).codec
    for i, codec in enumerate((DlschCodec(DlschConfig(mcs=26, n_rb=100)),
                               DlschCodec(DlschConfig(mcs=26, n_rb=100,
                                                      n_pdcch_symbols=2)),
                               ul)):
        _decode_equal(codec, B, cuda, seed=B + i)


@pytest.mark.parametrize("case", [
    *[("block", K, reps) for K in (40, 200, 1024, 5504, 5632, 6144)
      for reps in (1, 2, 3)],
    ("tb", 544, 1_200), ("tb", 6_208, 9_000), ("tb", 12_224, 30_000),
], ids=str)
def test_dlsch_decode_kernels_match_plain_path_at_the_replay_keys(cuda,
                                                                  case):
    """The CPU replay's keys (test_torch_dlsch_decode.py): C = 1 at K = 40
    to 6,144 with 1-3 repetitions, fillers, K+/K- mixes, three groups;
    batch 1 and 3."""
    if case[0] == "block":
        _, K, reps = case
        tbs, G = K - 24, 4 * round((reps - 0.5) * 3 * (K + 4) / 4)
    else:
        _, tbs, G = case
    codec = DlschCodec(_TbsConfig(mcs=10, n_rb=25, tbs_bits=tbs,
                                  g_override=G))
    for B in (1, 3):
        _decode_equal(codec, B, cuda, seed=B)


@pytest.mark.parametrize("n_rb", [6, 25, 100])
def test_dlsch_decode_kernels_match_plain_path_at_every_table_tbs(cuda,
                                                                  n_rb):
    """Every DL MCS at 1 and 2 ports and CFI 1-3, and every UL MCS (K = 40
    to 6,144, E up to several times L), two rounds at batch 3."""
    codecs = [DlschCodec(DlschConfig(mcs=m, n_rb=n_rb, nports=p,
                                     n_pdcch_symbols=cfi))
              for m in range(29) for p in (1, 2) for cfi in (1, 3)]
    codecs += [DlschCodec(UlschConfig(mcs=m, n_rb_alloc=n_rb))
               for m in range(29)]
    for i, codec in enumerate(codecs):
        _decode_equal(codec, 3, cuda, seed=1000 * n_rb + i, rvs=(0, 2))


def test_dlsch_decode_kernels_launch_once_a_round(cuda):
    """One dematch and one TB check a round in the DL and the UL."""
    dl = DlsimFading(DlsimFadingConfig(mcs=26, n_rb=25, channel="EVA",
                                       n_harq_rounds=2, batch=8,
                                       n_turbo_iter=4), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = launch_counts()
    dl.step(gen, 10.0 ** -3.0, dl.wiener(30.0), dl.err_var(30.0))
    after = launch_counts()
    assert (after["dlsch_dematch"] - before["dlsch_dematch"],
            after["dlsch_tb_check"] - before["dlsch_tb_check"]) == (2, 2)
    ul = Ulsim(UlsimConfig(mcs=20, n_rb=25, n_rb_alloc=25, channel="EVA",
                           n_harq_rounds=4, batch=8), device=cuda)
    before = launch_counts()
    ul.step(gen, 10.0 ** -1.6, ul.wiener(16.0))
    after = launch_counts()
    assert (after["dlsch_dematch"] - before["dlsch_dematch"],
            after["dlsch_tb_check"] - before["dlsch_tb_check"]) == (4, 4)
