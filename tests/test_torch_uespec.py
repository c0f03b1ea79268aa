"""TM7/8 UE-specific reference signals of the PyTorch port (phy/uespec.py)
against the JAX package's on the same inputs: the RS values and maps
equal, the port fills within 1e-5 of their scale, the estimators on one
received grid within 1e-5 of their scale; and tests/test_tm7.py's links
through the port (the estimate recovers the beamformed channel, the
symbols demap), plus the Octave dump round trip of utils/octave_io."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openair4g_tpu.phy import uespec as ju
from openair4g_tpu.utils.octave_io import read_output as j_read
from openair4g_tpu.utils.octave_io import write_output as j_write
from openair4g_tpu_torch.phy import ofdm
from openair4g_tpu_torch.phy import uespec as u
from openair4g_tpu_torch.phy.mimo_rx import mmse_detect
from openair4g_tpu_torch.utils.octave_io import read_output, write_output

torch.set_num_threads(1)

QPSK = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], np.complex64) / np.sqrt(2)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _unit_beams(rng, *shape):
    w = _cplx(rng, *shape)
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.complex64)


@pytest.mark.parametrize("args", [(25, 2, 8, 0x1234, 0, 7, 1),
                                  (50, 10, 20, 0x77, 11, 3, 2)])
def test_maps_and_rs_equal_reference(args):
    um, jm = u.make_uespec_map(*args), ju.make_uespec_map(*args)
    for f in ("data_sym", "data_sc", "data_bin", "rs_sym", "rs_sc",
              "rs_bin", "rs_val"):
        np.testing.assert_array_equal(getattr(um, f), getattr(jm, f), f)
    n_rb, rb, n_prb, _, nid, sf, n_pdcch = args
    tm, jt = (m(n_rb, rb, n_prb, nid, sf, n_pdcch, 1)
              for m in (u.make_tm8_map, ju.make_tm8_map))
    for f in ("data_sym", "data_sc", "data_bin", "rs_sym", "rs_bin",
              "rs_sc_rel", "rs_val"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jt, f), f)
    np.testing.assert_array_equal(
        u._comb_wiener(n_rb, n_prb, 0.01, tuple(tm.rs_sc_rel.tolist())),
        ju._comb_wiener(n_rb, n_prb, 0.01, tuple(jt.rs_sc_rel.tolist())))
    assert not np.allclose(u.ue_rs_values(0x1111, 0, 7, 3, 8),
                           u.ue_rs_values(0x2222, 0, 7, 3, 8))


def test_tm7_equals_reference_and_recovers_the_beamformed_channel():
    """tests/test_tm7.py's 2-TX beam over a flat 1x2 channel: the fill and
    the estimate equal the reference's on the same grid; the estimate is
    within 0.1 of h @ w and QPSK demaps with SER below 1e-3."""
    rng = np.random.default_rng(0)
    um = u.make_uespec_map(25, rb_start=0, n_prb=10, rnti=0x77)
    fp = um.fp
    B = 4
    bits = rng.integers(0, 4, (B, um.n_data_re))
    sym = QPSK[bits]
    w = _unit_beams(rng, B, 2)
    want = np.asarray(ju.tm7_fill_ports(jnp.asarray(sym), ju.make_uespec_map(
        25, rb_start=0, n_prb=10, rnti=0x77), jnp.asarray(w)))
    ports = u.tm7_fill_ports(torch.from_numpy(sym), um, torch.from_numpy(w))
    assert ports.shape == (B, 2, 14, fp.n_fft)
    assert _rel(ports, want) < 1e-5
    h = (_cplx(rng, B, 2) / np.sqrt(2)).astype(np.complex64)
    t = ofdm.ofdm_modulate(torch.einsum("bp,bpsf->bsf",
                                        torch.from_numpy(h), ports), fp)
    n0 = 1e-3
    rgrid = ofdm.ofdm_demodulate(t + torch.from_numpy(
        (np.sqrt(n0 / 2) * _cplx(rng, *t.shape)).astype(np.complex64)), fp)
    h_hat = u.tm7_estimate(rgrid, um, n0)
    assert _rel(h_hat, ju.tm7_estimate(jnp.asarray(rgrid.numpy()), um,
                                       n0)) < 1e-5
    assert np.abs(h_hat.numpy() - np.einsum("bp,bp->b", h, w)[:, None]
                  ).max() < 0.1
    y = rgrid[:, torch.as_tensor(um.data_sym, dtype=torch.long),
              torch.as_tensor(um.data_bin, dtype=torch.long)]
    x = (y * torch.conj(h_hat) / torch.clamp(h_hat.abs() ** 2, min=1e-9)
         ).numpy()
    got = np.argmin(np.abs(x[..., None] - QPSK), -1)
    assert (got != bits).mean() < 1e-3


def test_tm8_equals_reference_and_separates_the_layers():
    """tests/test_tm7.py's two layers on ports 7/8 through distinct beams
    over a flat 2x2 channel: the fill and the per-layer estimate equal the
    reference's on the same grid; the estimate is within 0.1 of H @ w_l
    and MMSE detection recovers both QPSK streams (> 99 %)."""
    rng = np.random.default_rng(3)
    tm = u.make_tm8_map(25, rb_start=0, n_prb=10)
    fp = tm.fp
    B, R, P = 3, 2, 2
    bits = rng.integers(0, 4, (B, 2, tm.n_data_re))
    layers = QPSK[bits]
    w = _unit_beams(rng, B, P, 2)
    want = np.asarray(ju.tm8_fill_ports(
        jnp.asarray(layers), ju.make_tm8_map(25, rb_start=0, n_prb=10),
        jnp.asarray(w)))
    ports = u.tm8_fill_ports(torch.from_numpy(layers), tm,
                             torch.from_numpy(w))
    assert _rel(ports, want) < 1e-5
    h = (_cplx(rng, B, R, P) / np.sqrt(2)).astype(np.complex64)
    grid_rx = torch.einsum("brp,bpsf->brsf", torch.from_numpy(h), ports)
    t = ofdm.ofdm_modulate(grid_rx.reshape(B * R, 14, fp.n_fft), fp)
    n0 = 1e-3
    rgrid = ofdm.ofdm_demodulate(t + torch.from_numpy(
        (np.sqrt(n0 / 2) * _cplx(rng, *t.shape)).astype(np.complex64)),
        fp).reshape(
            B, R, 14, fp.n_fft)
    h_hat = u.tm8_estimate(rgrid, tm, n0)              # [B, R, n_data, 2]
    assert _rel(h_hat, ju.tm8_estimate(jnp.asarray(rgrid.numpy()), tm,
                                       n0)) < 1e-5
    h_eff = np.einsum("brp,bpl->brl", h, w)
    assert np.abs(h_hat.numpy() - h_eff[:, :, None, :]).max() < 0.1
    y = rgrid[:, :, torch.as_tensor(tm.data_sym, dtype=torch.long),
              torch.as_tensor(tm.data_bin, dtype=torch.long)]
    x_hat, _ = mmse_detect(y.movedim(1, -1), h_hat.movedim(1, 2), n0)
    dec = np.argmin(np.abs(x_hat.numpy()[..., None] - QPSK), -1)
    assert (dec[:, :, 0] == bits[:, 0]).mean() > 0.99
    assert (dec[:, :, 1] == bits[:, 1]).mean() > 0.99


def test_octave_round_trip_equals_reference(tmp_path):
    """write_output / read_output of the port and of the reference: the
    same file bytes, and each reads back what the other wrote."""
    rng = np.random.default_rng(9)
    data = {"txs": _cplx(rng, 37), "gain": rng.standard_normal(5)}
    got, want = tmp_path / "port.m", tmp_path / "jax.m"
    for i, (name, x) in enumerate(data.items()):
        write_output(str(got), name, x, append=bool(i))
        j_write(str(want), name, x, append=bool(i))
    assert got.read_bytes() == want.read_bytes()
    a, b = read_output(str(got)), j_read(str(want))
    assert a.keys() == b.keys() == data.keys()
    for name, x in data.items():
        np.testing.assert_array_equal(a[name], b[name])
        np.testing.assert_allclose(a[name], x, rtol=1e-6)
