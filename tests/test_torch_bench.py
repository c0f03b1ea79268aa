"""The port's bench (openair4g_tpu_torch/bench.py) against the JAX package:
DlschCodec.decode with dynamic_stop off and on gives the JAX codec's bits
and flags on the same numpy LLRs, and with it off runs every iteration;
the front-end pass of the fourth cell equals the JAX composition of the
same five functions on the same time samples; each cell runs at a tiny
size on the CPU and the last line has bench.py's keys."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.config import FrameParms as JFrameParms
from openair4g_tpu.ops.llr import demap_llr as j_demap_llr
from openair4g_tpu.phy import ofdm as j_ofdm
from openair4g_tpu.phy.channel_est import (
    estimate_channel_joint as j_estimate_channel_joint,
    make_wiener_joint as j_make_wiener_joint)
from openair4g_tpu.phy.equalize import mrc_equalize as j_mrc_equalize
from openair4g_tpu.phy.pdsch import DlschCodec as JCodec
from openair4g_tpu.phy.pdsch import DlschConfig as JConfig
from openair4g_tpu.phy.resource_grid import (
    extract_data_res as j_extract_data_res, make_grid_map as j_make_grid_map)
from openair4g_tpu_torch import bench
from openair4g_tpu_torch.ops import turbo
from openair4g_tpu_torch.ops.llr import map_symbols
from openair4g_tpu_torch.phy.ofdm import ofdm_modulate
from openair4g_tpu_torch.phy.pdsch import DlschCodec, DlschConfig
from openair4g_tpu_torch.phy.resource_grid import fill_grid

torch.set_num_threads(1)

# 25 PRB MCS 20: TBS 9,912 in 2 blocks of K = 4,992 (the CRC24B latch);
# 4 iterations, the CPU's window pinned on both sides.
CODEC = dict(mcs=20, n_rb=25, n_turbo_iter=4, decoder_window=96)
# rows 0-1 decode at the first iterations, rows 2-3 never
AMPLITUDE = np.array([4.0, 4.0, 0.3, 0.3])


@pytest.fixture(scope="module")
def codecs():
    return DlschCodec(DlschConfig(**CODEC)), JCodec(JConfig(**CODEC))


@pytest.fixture(scope="module")
def llrs(codecs):
    port, _ = codecs
    rng = np.random.default_rng(0)
    tb = rng.integers(0, 2, (len(AMPLITUDE), port.cfg.tbs)).astype(np.int32)
    e = port.encode(torch.as_tensor(tb)).numpy()
    llr = ((1 - 2 * e) * AMPLITUDE[:, None]
           + rng.normal(size=e.shape)).astype(np.float32)
    return tb, llr


@pytest.mark.parametrize("rows", ["decodable", "mixed"])
@pytest.mark.parametrize("dynamic_stop", [False, True])
def test_decode_dynamic_stop_equals_jax(codecs, llrs, monkeypatch,
                                        dynamic_stop, rows):
    port, ref = codecs
    tb, llr = llrs
    if rows == "decodable":
        tb, llr = tb[:2], llr[:2]
    calls = []
    plain = turbo.half_iteration
    monkeypatch.setattr(turbo, "half_iteration",
                        lambda *a: calls.append(1) or plain(*a))
    bits, ok, _ = port.decode(torch.as_tensor(llr),
                              dynamic_stop=dynamic_stop)
    jbits, jok, _ = ref.decode(jnp.asarray(llr), dynamic_stop=dynamic_stop)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(ok.numpy(), AMPLITUDE[:len(tb)] > 1)
    np.testing.assert_array_equal(bits.numpy()[ok.numpy()],
                                  tb[ok.numpy()])
    full = 2 * CODEC["n_turbo_iter"]   # both blocks share one (K, F) plan
    if dynamic_stop and rows == "decodable":
        assert len(calls) < full
    else:
        assert len(calls) == full


def test_turbo_cell_decodes_two_blocks_of_4032_as_1024_rows_of_4080():
    codec = DlschCodec(DlschConfig(mcs=10, n_rb=50, n_turbo_iter=8))
    assert codec.cfg.tbs == 7992
    assert codec.block_Ks == [4032, 4032]
    assert codec.Es == [15000, 15000]
    assert turbo._padded_len(4032 + 3, 240) == 4080 == 17 * 240


# The front end's LLRs: float32 sums of FFT, GEMM and divisions in two
# packages; max |diff| within FRONT_RTOL of the largest |LLR|.
FRONT_RTOL = 1e-4


def test_front_end_equals_jax_composition():
    n_rb, B = 6, 3
    fe = bench.FrontEnd(n_rb, torch.device("cpu"))
    rng = np.random.default_rng(1)
    n_data = len(fe.gm.data_sc)
    e = torch.as_tensor(rng.integers(0, 2, (B, 4 * n_data)),
                        dtype=torch.int32)
    t = ofdm_modulate(fill_grid(map_symbols(e, 4), fe.gm), fe.fp).numpy()
    noise = rng.normal(size=t.shape + (2,)) * np.sqrt(0.05)
    t = (t + noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64)
    got = fe.llrs(torch.as_tensor(t)).numpy()

    fp, gm = JFrameParms(n_rb=n_rb), j_make_grid_map(n_rb, 1)
    rgrid = j_ofdm.ofdm_demodulate(jnp.asarray(t), fp)
    H = j_estimate_channel_joint(rgrid, gm,
                                 jnp.asarray(j_make_wiener_joint(gm, 0.1)))
    y = j_extract_data_res(rgrid, gm)
    h = H[:, jnp.asarray(gm.data_sym), jnp.asarray(gm.data_sc)]
    x, n0e = j_mrc_equalize(y[..., None], h[..., None], 0.1)
    want = np.asarray(j_demap_llr(x, n0e, 4))
    assert got.shape == want.shape == (B, n_data, 4)
    err = np.abs(got - want).max()
    assert err <= FRONT_RTOL * np.abs(want).max(), err


TINY = {"flagship": dict(batch=2, n_rep=1, windows=2, n_rb=6),
        "awgn": dict(batch=4, n_rep=1, windows=2),
        "turbo": dict(batch=2, n_rep=1, windows=2, n_rb=6),
        "front_end": dict(batch=2, n_rep=1, windows=2, reps=2, n_rb=6)}


@pytest.fixture(scope="module")
def rows():
    return bench.run("cpu", TINY)


def _rates(value):
    return list(value.values()) if isinstance(value, dict) else [value]


CELLS = ["pdsch_20mhz_mcs26_fading_estce_subframes_per_s",
         "pdsch_5mhz_mcs4_awgn_subframes_per_s", "turbo_decode_mbit_per_s",
         "ofdm_equalize_msamples_per_s"]


@pytest.mark.parametrize("k", range(4))
def test_each_cell_gives_a_positive_finite_rate_on_the_cpu(rows, k):
    row = rows[k]
    assert row["cell"] == CELLS[k]
    for v in _rates(row["value"]) + _rates(row["median"]):
        assert v > 0 and math.isfinite(v)
    assert len(row["windows_s"]) == 2 or set(row["windows_s"]) == {
        "fixed_8iter", "earlystop_operating"}
    # a CPU run launches no kernel and has no device time
    assert row["card"] == "cpu"
    assert not any(_rates(row["launches"]))
    assert all(v is None for v in _rates(row["device_ms_per_step"]))


def test_turbo_cell_reports_iterations_run(rows):
    """Read after the timed windows: every row of the fixed decode runs all
    8 iterations, the dynamic stop's rows at most 8."""
    its = rows[2]["iterations"]
    assert its["fixed_8iter"] == {"mean": 8.0, "max": 8}
    assert 1 <= its["earlystop_operating"]["mean"] <= 8
    assert its["earlystop_operating"]["max"] <= 8


def test_last_line_has_bench_py_keys(rows):
    line = bench.last_line(rows)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert line["unit"] == "subframes/s"
    assert line["vs_baseline"] == round(rows[0]["value"] / 1000.0, 3)
    assert set(line["extras"]) == {
        "pdsch_5mhz_mcs4_awgn_subframes_per_s", "turbo_decode_mbit_per_s",
        "ofdm_equalize_msamples_per_s"}
    assert set(line["extras"]["turbo_decode_mbit_per_s"]) == {
        "fixed_8iter", "earlystop_operating"}


def test_bench_without_a_card_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)
