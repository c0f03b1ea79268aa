"""The port's parallel modules and utils/rng against their one-process
counterparts and the JAX reference (tests/test_parallel.py's five cases
and more). The ranks are spawned interpreters on gloo, one torch thread
each, with jax and the JAX package blocked; they meet through a file://
rendezvous under tmp_path. One spawn of 4 ranks runs every ranked job;
the tests read its results. Sharded statistics must equal the
one-process ones integer for integer (SURVEY.md §4)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from openair4g_tpu.parallel import make_mesh as jmake_mesh
from openair4g_tpu.parallel import sharded_pss_correlate as jsharded
from openair4g_tpu.utils.rng import host_keys as jhost_keys
from openair4g_tpu_torch.config import FrameParms
from openair4g_tpu_torch.parallel.launch import spawn
from openair4g_tpu_torch.parallel.mesh import make_mesh
from openair4g_tpu_torch.phy.sync import CellSearch, pss_time_replica
from openair4g_tpu_torch.sim.dlsim import (DlsimAwgn, DlsimConfig,
                                           DlsimFading, DlsimFadingConfig)
from openair4g_tpu_torch.utils import rng

torch.set_num_threads(1)

WORLD = 4
SPAWN_TIMEOUT = 240          # seconds for the whole spawn and each collective
N_FFT = FrameParms(n_rb=6).n_fft
L = 4096
HALO_CASES = [5, 1024 - 64, 2 * 1024 - 1, 3 * 1024 - 100]
SIM = dict(mcs=4, n_rb=6, n_turbo_iter=4)
SWEEP_SNRS = [-2.5, -2.0, -1.0]
# JAX's XLA FFT and torch's pocketfft round differently: the peak's
# |corr|^2 agrees within this relative tolerance.
PEAK_RTOL = 1e-5


def _halo_capture():
    """Peaks inside a block and straddling each boundary of 4 blocks."""
    r = np.zeros((len(HALO_CASES), L), np.complex64)
    for b, tp in enumerate(HALO_CASES):
        r[b, tp:tp + N_FFT] = pss_time_replica(b % 3, N_FFT)
    return r


def _noisy_capture():
    g = np.random.default_rng(0)
    r = (g.normal(size=(2, L)) + 1j * g.normal(size=(2, L))
         ).astype(np.complex64) * 0.2
    r[0, 1000:1000 + N_FFT] += pss_time_replica(0, N_FFT) * 4
    r[1, 3000:3000 + N_FFT] += pss_time_replica(2, N_FFT) * 4
    return r


def _sweep(**kw):
    return ("bler_sweep", dict(device="cpu", bpd=8, snrs=SWEEP_SNRS,
                               n_frames=64, sim=SIM, **kw))


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """{job name: rank 0's result}, after checking every rank returned the
    same thing (the reduced counts and peaks are replicated)."""
    work = tmp_path_factory.mktemp("ranks")
    ckpt = str(work / "sweep.json")
    jobs = {
        "sharded": ("sharded_sweep", dict(
            device="cpu", n_ue=4, n_t=1, bpd=4, snr_db=-2.5, n_frames=16,
            seed=3, sim=SIM)),
        "2d": ("sharded_sweep", dict(
            device="cpu", n_ue=2, n_t=2, bpd=4, snr_db=3.0, n_frames=8,
            seed=0, sim=dict(mcs=0, n_rb=6, n_turbo_iter=2))),
        "halo_1x4": ("pss_correlate", dict(device="cpu", n_ue=1, n_t=4,
                                           n_fft=N_FFT,
                                           capture=_halo_capture())),
        "halo_2x2": ("pss_correlate", dict(device="cpu", n_ue=2, n_t=2,
                                           n_fft=N_FFT,
                                           capture=_halo_capture())),
        "noisy_1x4": ("pss_correlate", dict(device="cpu", n_ue=1, n_t=4,
                                            n_fft=N_FFT,
                                            capture=_noisy_capture())),
        "dist_0": ("distributed_sweep", dict(device="cpu", bpd=8, snr_db=-2.0,
                                             n_frames=32, seed=0, sim=SIM)),
        "dist_1": ("distributed_sweep", dict(device="cpu", bpd=8, snr_db=-2.0,
                                             n_frames=32, seed=0, sim=SIM,
                                             stream0=1)),
        "dist_01": ("distributed_sweep", dict(device="cpu", bpd=8,
                                              snr_db=-2.0, n_frames=64,
                                              seed=0, sim=SIM)),
        "unbroken": _sweep(),
        # preempted at the first trial of the second point: the checkpoint
        # holds the first point only
        "preempted": _sweep(ckpt_path=ckpt, preempt_after=2),
        "resumed": _sweep(ckpt_path=ckpt),
        # everything is in the checkpoint now: any trial would raise
        "rerun": _sweep(ckpt_path=ckpt, preempt_after=0),
    }
    names = list(jobs)
    out = spawn("openair4g_tpu_torch.parallel.checks:run_jobs", WORLD,
                backend="gloo", workdir=work, kwargs={"jobs": list(
                    jobs.values())}, timeout=SPAWN_TIMEOUT,
                block=("jax", "openair4g_tpu"), threads=1)
    values = [r["value"] for r in out]
    for rank in range(1, WORLD):
        for name, a, b in zip(names, values[0], values[rank]):
            if isinstance(a, dict):
                a = {k: v for k, v in a.items() if not k.endswith("ms")}
                b = {k: v for k, v in b.items() if not k.endswith("ms")}
            np.testing.assert_equal(b, a, err_msg=f"{name}, rank {rank}")
    with open(ckpt) as f:
        state = json.load(f)
    return dict(zip(names, values[0]), ckpt_state=state)


@pytest.mark.parametrize("seed,n,stream", [(0, 8, 0), (3, 16, 5),
                                           (2 ** 32 + 7, 32, 1000)])
def test_host_keys_equal_reference(seed, n, stream):
    got = rng.host_keys(seed, n, stream)
    want = jhost_keys(seed, n, stream)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_rank_rows_cut_every_tensor_of_a_draw():
    """Tensors, None entries and (normals, AoA) pairs: each cut into equal
    blocks on its batch dimension; the blocks put together are the draw."""
    tb = torch.arange(24).reshape(8, 3)
    draw = (tb, [None, (torch.ones(8, 1, 2), torch.arange(8.0))],
            [torch.zeros(8, 5)])
    blocks = [rng.rank_rows(draw, r, 4) for r in range(4)]
    assert blocks[1][1][0] is None
    assert isinstance(blocks[1][1][1], tuple)
    assert torch.equal(torch.cat([b[0] for b in blocks]), tb)
    assert torch.equal(torch.cat([b[1][1][1] for b in blocks]),
                       torch.arange(8.0))
    assert blocks[3][2][0].shape == (2, 5)
    with pytest.raises(ValueError, match="equal blocks"):
        rng.rank_rows(draw, 0, 3)


def test_dlsim_awgn_step_draws_what_it_drew_before():
    """step = trial(*draw(gen)): the TB bits, then the noise, from one
    generator, as step drew them before draw existed."""
    sim = DlsimAwgn(DlsimConfig(batch=4, **SIM), device="cpu")
    gen = torch.Generator().manual_seed(11)
    tb = torch.randint(0, 2, (4, sim.dlsch.cfg.tbs), generator=gen,
                       dtype=torch.int32)
    noise = torch.randn(4, sim.fp.samples_per_tti, 2, generator=gen)
    want = sim.trial(tb, noise, 10.0 ** 0.2)
    got = sim.step(torch.Generator().manual_seed(11), 10.0 ** 0.2)
    assert torch.equal(got.ok, want.ok)
    assert torch.equal(got.bit_errs, want.bit_errs)
    d_tb, d_noise = sim.draw(torch.Generator().manual_seed(11))
    assert torch.equal(d_tb, tb) and torch.equal(d_noise, noise)


def test_fast_forward_reaches_chunk_k():
    sim = DlsimAwgn(DlsimConfig(batch=2, **SIM), device="cpu")
    gen = rng.draw_stream(5, "cpu")
    chunks = [sim.draw(gen) for _ in range(3)]
    gen = rng.draw_stream(5, "cpu")
    rng.fast_forward(sim, gen, 2)
    tb, noise = sim.draw(gen)
    assert torch.equal(tb, chunks[2][0]) and torch.equal(noise, chunks[2][1])


@pytest.mark.parametrize("cfg,snr", [
    (DlsimFadingConfig(mcs=16, n_rb=25, channel="EVA", n_harq_rounds=1,
                       est_mode="joint", n_turbo_iter=4, batch=8), 10.0),
    (DlsimFadingConfig(mcs=16, n_rb=25, channel="EVA", n_harq_rounds=2,
                       est_mode="dd", n_rx=2, n_turbo_iter=3, batch=8), 6.0),
], ids=["joint round 0", "dd 1x2 two rounds"])
def test_trial_on_a_row_block_is_those_rows_of_the_batch(cfg, snr):
    """What the sharded sweeps rest on: turbo early stop (batch-wide
    until every block latches, latched rows frozen), the PDCCH blind
    decode and the estimator state W, ev give a block of rows the same
    flags, bit errors and soft buffers as those rows of the whole batch.
    Blocks of 4 rows: the CPU's BLAS rounds a product of 1-3 rows (the
    joint estimate's ls @ W) by another path (ROADMAP Queue 3)."""
    sim = DlsimFading(cfg, device="cpu")
    n0 = 10.0 ** (-snr / 10.0)
    W, ev = sim.wiener(snr), sim.err_var(snr)
    draws = sim.draw(rng.draw_stream(2, "cpu"))
    whole = sim.trial(*draws, n0, W, ev)
    oks = torch.stack([r.ok for r in whole.rounds])
    assert oks.any() and not oks.all(), "the point should be mixed"
    for blk in range(2):
        part = sim.trial(*rng.rank_rows(draws, blk, 2), n0, W, ev)
        rows = slice(4 * blk, 4 * blk + 4)
        for a, b in zip(part.rounds, whole.rounds):
            assert torch.equal(a.ok, b.ok[rows])
            assert torch.equal(a.dci_ok, b.dci_ok[rows])
            assert torch.equal(a.bit_errs, b.bit_errs[rows])
            for wa, wb in zip(a.w_soft, b.w_soft):
                assert torch.equal(wa, wb[rows])


class TestShardedSweep:
    def test_matches_single_device_bitwise(self, ranked):
        """(ue=4, t=1), 4 trials a rank, at 6 PRB MCS 4 -2.5 dB: the
        all_reduced errors equal run_snr's at the global batch of 16."""
        sim = DlsimAwgn(DlsimConfig(batch=16, **SIM), device="cpu")
        errs_single, _ = sim.run_snr(-2.5, 16, seed=3)
        res = ranked["sharded"]
        assert res["trials"] == 16 and res["backend"] == "gloo"
        assert res["errs"] == errs_single
        assert 0 < errs_single < 16, "operating point should be mixed"

    def test_2d_mesh(self, ranked):
        res = ranked["2d"]
        assert res["trials"] == 8 and res["errs"] == 0


class TestTimeSharded:
    @pytest.mark.parametrize("mesh", ["1x4", "2x2"])
    def test_peaks_across_halo(self, ranked, mesh):
        res = ranked[f"halo_{mesh}"]
        assert list(res["pos"]) == HALO_CASES
        assert list(res["nid2"]) == [c % 3 for c in range(len(HALO_CASES))]

    def test_matches_unsharded_correlation(self, ranked):
        r = _noisy_capture()
        pos_ref, nid2_ref, _, _ = CellSearch(
            FrameParms(n_rb=6), capture_len=L).pss_correlate(
            torch.as_tensor(r))
        res = ranked["noisy_1x4"]
        np.testing.assert_array_equal(res["pos"], pos_ref.numpy())
        np.testing.assert_array_equal(res["nid2"], nid2_ref.numpy())
        assert list(res["pos"]) == [1000, 3000]

    @pytest.mark.parametrize("capture", ["halo", "noisy"])
    def test_matches_jax_sharded_correlation(self, ranked, capture):
        """The JAX sharded_pss_correlate on conftest's virtual devices,
        (ue=2, t=4) with the same blocks, on the same numpy capture."""
        r = _halo_capture() if capture == "halo" else _noisy_capture()
        mesh = jmake_mesh(n_ue=2, n_t=4)
        corr = jsharded(mesh, N_FFT, L // 4)
        rd = jax.device_put(jnp.asarray(r), NamedSharding(mesh, P(None, "t")))
        pos, nid2, peak = (np.asarray(x) for x in corr(rd))
        res = ranked[f"{capture}_1x4"]
        np.testing.assert_array_equal(res["pos"], pos)
        np.testing.assert_array_equal(res["nid2"], nid2)
        np.testing.assert_allclose(res["peak"], peak, rtol=PEAK_RTOL)


def test_mesh_larger_than_the_group_raises():
    """One process is a group of one: a (3, 2) mesh needs 6 ranks."""
    try:
        with pytest.raises(ValueError, match="need 6 devices, have 1"):
            make_mesh(3, 2, device="cpu")
        assert make_mesh(device="cpu").shape == (1, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_distributed_sweep_matches_unsharded(ranked):
    """DistributedSweep over 4 ranks x 8 equals the sim's own run_snr at
    the global batch of 32."""
    sim = DlsimAwgn(DlsimConfig(batch=32, **SIM), device="cpu")
    assert tuple(ranked["dist_0"]) == (*sim.run_snr(-2.0, 32), 1)


def test_distributed_sweep_resumes_at_stream0(ranked):
    """Chunk 1 alone (stream0=1, reached by drawing and discarding chunk
    0) plus chunk 0 alone is the two-chunk run."""
    e0, t0, s0 = ranked["dist_0"]
    e1, t1, s1 = ranked["dist_1"]
    assert (s0, s1) == (1, 2)
    assert tuple(ranked["dist_01"]) == (e0 + e1, t0 + t1, 2)
    assert e0 > 0 and e1 > 0


def test_resumed_sweep_equals_the_unbroken_one(ranked):
    """A sweep preempted after its first point, resumed from its
    checkpoint, gives the unbroken sweep's rows; a third run finds every
    point in the checkpoint and runs no trial."""
    unbroken = [tuple(r) for r in ranked["unbroken"]]
    sim = DlsimAwgn(DlsimConfig(batch=32, **SIM), device="cpu")
    want = []
    for s in SWEEP_SNRS:
        errs, trials = sim.run_snr(s, 64)
        want.append((s, errs, trials))
        if errs == 0:
            break
    assert unbroken == want
    assert len(unbroken) == 3 and unbroken[0][1] > 0 and unbroken[1][1] > 0
    assert ranked["preempted"] is None
    assert [tuple(r) for r in ranked["resumed"]] == unbroken
    assert [tuple(r) for r in ranked["rerun"]] == unbroken
    state = ranked["ckpt_state"]
    assert state["config"] == dict(kind="distributed", seed=0, batch=32,
                                   snrs=SWEEP_SNRS, n_frames=64)
    assert {k: v["streams"] for k, v in state["points"].items()} == {
        "-2.5": 2, "-2": 2, "-1": 2}


def test_entry_runs_one_trial_on_seeded_draws():
    """graft_entry.entry: DlsimAwgn MCS 4, 25 PRB, batch 8, 4 iterations
    at -0.6 dB on seed 0's draws; its step is the sim's trial on them."""
    from openair4g_tpu_torch.graft_entry import entry
    fn, (tb, noise, n0) = entry(device="cpu")
    assert tb.shape == (8, 1800) and noise.shape == (8, 7680, 2)
    assert n0 == np.float32(10.0 ** -0.06)
    ok, bit_errs = fn(tb, noise, n0)
    sim = DlsimAwgn(DlsimConfig(mcs=4, n_rb=25, batch=8, n_turbo_iter=4),
                    device="cpu")
    res = sim.step(rng.draw_stream(0, "cpu"), n0)
    assert (int(ok), int(bit_errs)) == (int(res.ok.sum()),
                                        int(res.bit_errs.sum())) == (8, 0)


def test_entry_points_need_the_card_by_default(monkeypatch):
    """device=None means the card: without one each entry point raises
    before it makes a process group; it never carries on on the CPU."""
    from openair4g_tpu_torch.graft_entry import entry, make_flagship_sharded
    from openair4g_tpu_torch.parallel.distributed import global_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry, make_mesh, global_mesh,
                 lambda: make_flagship_sharded(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()
