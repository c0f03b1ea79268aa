"""The tail-biting Viterbi decoder of the PyTorch port: its plain version
against the JAX reference, exactly, at every K the decode paths use; the
dispatch between the plain version (CPU tensors) and the CUDA kernel
(csrc/viterbi.cu, CUDA tensors); the kernel's argument checks; and, on a
card, the kernel against the plain version bit for bit.

The reference is imported inside a fixture, so the `cuda` test also runs
where jax is not installed:

    python -m pytest --noconftest tests/test_torch_viterbi.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from openair4g_tpu_torch import kernels
from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops import convcode as cc
from openair4g_tpu_torch.phy import dci_formats as dci

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

# Every K = payload + CRC the decode paths use: the CQI report of the
# full-width uplink (O = 30, CRC8), DCI format 0/1A at 25 and 100 PRB
# (CRC16), the PBCH (24 + 16), and formats 1, 2A and 2 at 100 PRB, which
# sched/ue_rx's multi-size search and the MIMO simulators decode.
PATH_KS = sorted({30 + 8, dci.dci_format1a_size(25) + 16,
                  dci.dci_format1a_size(100) + 16,
                  dci.dci_format0_size(100) + 16, 24 + 16,
                  dci.dci_format1_size(100) + 16,
                  dci.dci_format2a_size(100) + 16,
                  dci.dci_format2_size(100) + 16})


@pytest.fixture(scope="module")
def jax_viterbi():
    jnp = pytest.importorskip("jax.numpy")
    from openair4g_tpu.ops import convcode as jcc

    def decode(llr, K, n_wrap):
        return np.asarray(jcc.viterbi_decode(jnp.asarray(llr), K, n_wrap))
    return decode


def _inputs(K: int, seed: int):
    """(llrs [12, 3, K] float32, the info bits of rows 0-3): four noisy
    codewords at 4 dB, two rows of noise alone, two of zeros (every metric
    ties) and four of integers in [-2, 2] (ties at many steps)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (4, K))
    d = np.stack([cc.conv_encode_host(b) for b in bits])
    sigma = 0.6
    coded = ((1 - 2.0 * d) + sigma * rng.normal(size=d.shape)) \
        * 2.0 / sigma ** 2
    noise = 3.0 * rng.normal(size=(2, 3, K))
    zeros = np.zeros((2, 3, K))
    ints = rng.integers(-2, 3, (4, 3, K))
    llr = np.concatenate([coded, noise, zeros, ints]).astype(np.float32)
    return llr, bits


def test_path_ks():
    assert PATH_KS == [38, 39, 40, 43, 54, 63, 66]


@pytest.mark.parametrize("n_wrap", [1, 3])
@pytest.mark.parametrize("K", PATH_KS)
def test_plain_version_equals_reference(jax_viterbi, K, n_wrap):
    llr, bits = _inputs(K, 100 * K + n_wrap)
    got = cc.viterbi_decode_ref(torch.from_numpy(llr), K, n_wrap).numpy()
    assert got.dtype == np.int8 and got.shape == (12, K)
    np.testing.assert_array_equal(got, jax_viterbi(llr, K, n_wrap))
    if n_wrap == 3:
        np.testing.assert_array_equal(got[:4], bits)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    """A CPU tensor goes to viterbi_decode_ref and never builds, loads or
    counts the kernel."""
    def no_kernel():
        raise AssertionError("the CPU path touched the kernel library")
    monkeypatch.setattr(kernels, "load", no_kernel)
    K = 43
    llr, _ = _inputs(K, 7)
    x = torch.from_numpy(llr)
    before = launch_counts()["viterbi"]
    for n_wrap in (1, 3):
        assert torch.equal(cc.viterbi_decode(x, K, n_wrap),
                           cc.viterbi_decode_ref(x, K, n_wrap))
    assert launch_counts()["viterbi"] == before


def test_empty_batch_returns_at_once(monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("built"))
    out = cc.viterbi_decode(torch.zeros(0, 3, 40), 40)
    assert out.shape == (0, 40) and out.dtype == torch.int8


def test_kernel_argument_checks():
    x = torch.zeros(5, 3, 43)
    cc._check_kernel_args(x, 43, 3)
    cc._check_kernel_args(torch.zeros(1, 3, cc.MAX_T), cc.MAX_T, 1)
    with pytest.raises(TypeError):
        cc._check_kernel_args(x.double(), 43, 3)
    for bad in (torch.zeros(5, 2, 43), torch.zeros(5, 3, 42),
                torch.zeros(5, 129)):
        with pytest.raises(ValueError):
            cc._check_kernel_args(bad, 43, 3)
    with pytest.raises(ValueError):           # T = 3 K beyond the limit
        cc._check_kernel_args(torch.zeros(5, 3, 683), 683, 3)
    with pytest.raises(ValueError):
        cc._check_kernel_args(x, 43, 0)


def test_other_device_raises():
    with pytest.raises(ValueError):
        cc.viterbi_decode(torch.zeros(2, 3, 40, device="meta"), 40)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 5, 13, 128, 21120])
def test_kernel_equals_plain_version(cuda, R):
    """One launch a call, equal to the plain version bit for bit at every
    path K and n_wrap 1 and 3, on Gaussian and on tie-forcing integer LLRs;
    at the ACS's edges: one row, rows that fill no warp (4 rows) or block
    (8 rows) and, up to 13 rows, T = MAX_T (n_wrap 1 and 3); 21,120 rows is
    UlGrantSim's 165 candidates x 128."""
    rng = np.random.default_rng(R)
    shapes = [(K, n_wrap) for K in PATH_KS for n_wrap in (1, 3)]
    if R <= 13:
        shapes += [(cc.MAX_T, 1), (cc.MAX_T // 3, 3)]
    for K, n_wrap in shapes:
        for llr in (3.0 * rng.normal(size=(R, 3, K)),
                    rng.integers(-2, 3, (R, 3, K))):
            x = torch.from_numpy(llr.astype(np.float32)).to(cuda)
            before = launch_counts()["viterbi"]
            got = cc.viterbi_decode(x, K, n_wrap)
            torch.cuda.synchronize()
            assert launch_counts()["viterbi"] == before + 1
            assert torch.equal(got, cc.viterbi_decode_ref(x, K, n_wrap))
