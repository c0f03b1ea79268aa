"""The turbo decode of the PyTorch port, whose card path is one launch of
turbo_decode_kernel (csrc/turbo_half_iter.cu) a (K, F) group: the port's
decode against the JAX decode as it runs on an accelerator (the v2 Pallas
kernel, here in interpret mode), the packed-XOR CRC the kernel checks, a
row-by-row replay of the kernel's schedule against the plain loop, and the
wrappers' device rules. The kernel's own tests are marked `cuda`. The
reference is imported inside a fixture, so the `cuda` tests also run where
jax is not installed:

    python -m pytest --noconftest tests/test_torch_turbo_decode.py -q
"""
import functools

import numpy as np
import pytest
import torch

from openair4g_tpu_torch.device import launch_counts
from openair4g_tpu_torch.ops import turbo, turbo_cuda
from openair4g_tpu_torch.ops.crc import (CRC_POLYS, attach_crc_host,
                                         crc_matrix, crc_packed_rows,
                                         crc_remainder)
from openair4g_tpu_torch.ops.turbo_cuda import (BIG,
                                                _half_iteration_ckpt_ref)

# The suite runs in several pytest workers on the host's cores; torch's own
# thread pool in each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)

# (K, F, CRC, W, sigma): F > 0 with crc24b (block 0 of a segmented TB), and
# the sizes at which a batch of 8 mixes passing and failing blocks.
_CASES = [(136, 0, "crc24a", 48, 2.3), (136, 16, "crc24b", 48, 2.4),
          (512, 0, "crc24a", 96, 2.3), (512, 8, "crc24b", 96, 2.2)]


def _coded(K, F, kind, B, sigma, seed):
    """[B, 3, K + 4] float32 LLRs of B turbo-coded words: F filler zeros
    (their d0/d1 LLRs +BIG, as the rate matcher leaves them), a random
    payload and its CRC; LLR = 2 (1 - 2 d) + sigma N(0, 1)."""
    rng = np.random.default_rng(seed)
    L = CRC_POLYS[kind][0]
    words = [np.concatenate([np.zeros(F, np.int8), attach_crc_host(
        rng.integers(0, 2, K - F - L), kind)]) for _ in range(B)]
    d = np.stack([turbo.turbo_encode_host(w) for w in words])
    llr = 2.0 * (1.0 - 2.0 * d) + sigma * rng.standard_normal(d.shape)
    llr[:, :2, :F] = BIG
    return llr.astype(np.float32), np.stack(words)


def _cfg(K, F, kind, W, dyn, n_iter=6):
    return turbo.TurboDecoderConfig(K=K, F=F, n_iter=n_iter, window=W,
                                    crc_kind=kind, dynamic_stop=dyn)


@pytest.fixture
def jax_on_pallas_v2(monkeypatch):
    """The JAX decode as it runs on an accelerator: the v2 Pallas kernel
    (in interpret mode on the CPU) for each half-iteration. Returns
    (openair4g_tpu.ops.turbo, jax.numpy)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from openair4g_tpu.ops import turbo as jturbo
    from openair4g_tpu.ops import turbo_pallas as jturbo_pallas
    monkeypatch.setattr(jturbo, "_use_pallas", lambda: True)
    monkeypatch.setattr(jturbo_pallas, "half_iteration_pallas_v2",
                        functools.partial(
                            jturbo_pallas.half_iteration_pallas_v2,
                            interpret=True))
    return jturbo, jnp


@pytest.mark.parametrize("dyn", [True, False])
@pytest.mark.parametrize("K,F,kind,W,sigma", _CASES)
def test_decode_equals_jax_decode_on_the_v2_kernel(jax_on_pallas_v2, K, F,
                                                   kind, W, sigma, dyn):
    """Bits and flags bit for bit on a mixed pass/fail batch."""
    jturbo, jnp = jax_on_pallas_v2
    llr, words = _coded(K, F, kind, 8, sigma, K + F)
    jcfg = jturbo.TurboDecoderConfig(K=K, F=F, n_iter=6, window=W,
                                     crc_kind=kind, dynamic_stop=dyn)
    jb, jok = jturbo.turbo_decode(jnp.asarray(llr), jcfg)
    b, ok = turbo.turbo_decode(torch.from_numpy(llr),
                               _cfg(K, F, kind, W, dyn))
    jok = np.asarray(jok)
    assert 0 < int(jok.sum()) < 8, "want a mixed batch"
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(b.numpy()[jok], words[jok])


@pytest.mark.parametrize("kind", ["crc24a", "crc24b"])
def test_packed_crc_rows_give_the_remainder(kind):
    """The XOR of the packed rows over a word's set bits is its remainder,
    bit j = remainder[j]: zero exactly where crc_remainder is."""
    rng = np.random.default_rng(len(kind))
    n = 200
    rows = crc_packed_rows(n, kind)
    H = crc_matrix(n, kind)
    valid = [attach_crc_host(rng.integers(0, 2, n - 24), kind)
             for _ in range(8)]
    words = np.concatenate([rng.integers(0, 2, (24, n)), np.stack(valid)])
    words[-1, :] = 0                       # the zero word passes too
    rem = crc_remainder(torch.from_numpy(words), H).numpy()
    for w, r in zip(words, rem):
        x = np.bitwise_xor.reduce(rows[w.astype(bool)], initial=0)
        assert [(x >> j) & 1 for j in range(24)] == r.astype(int).tolist()
    assert rem[-8:].sum() == 0 and rem[:24].sum(axis=1).min() > 0
    assert rows.dtype == np.int32 and rows.max() < 1 << 24


def _decode_schedule_ref(llr_d, cfg):
    """The kernel's schedule, row by row in plain PyTorch: the prologue's
    rows, then per iteration HI1 (the checkpointed v2 order) with a1 = sys
    + ext1 in its store, the exchange lin2[j] = a1[pi[j]], HI2, and the
    latch (la1[i] = ext2[inv_pi[i]], lin1 = sys + la1, the packed-XOR CRC of
    the payload, the row's own exit with dynamic_stop). Returns (bits,
    done, iters)."""
    K, F, W, U = cfg.K, cfg.F, cfg.window, cfg.warmup
    N = -(-(K + 3) // W) * W
    pi = torch.from_numpy(turbo.qpp_interleaver(K).astype(np.int64))
    inv = torch.from_numpy(turbo._inverse_perm(turbo.qpp_interleaver(K)))
    rows = crc_packed_rows(K - F, cfg.crc_kind)
    B = llr_d.shape[0]
    bits = torch.zeros(B, K, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), cfg.n_iter, dtype=torch.int32)
    for b in range(B):
        d0, d1, d2 = llr_d[b]
        lin1, par1, lin2, par2 = (torch.full((N,), BIG) for _ in range(4))
        lin1[:K], par1[:K], par2[:K] = d0[:K] + 0.0, d1[:K], d2[:K]
        lin1[K:K + 3] = torch.stack([d0[K], d2[K], d1[K + 1]])
        par1[K:K + 3] = torch.stack([d1[K], d0[K + 1], d2[K + 1]])
        lin2[K:K + 3] = torch.stack([d0[K + 2], d2[K + 2], d1[K + 3]])
        par2[K:K + 3] = torch.stack([d1[K + 2], d0[K + 3], d2[K + 3]])
        for it in range(cfg.n_iter):
            llr1 = _half_iteration_ckpt_ref(lin1[None], par1[None], W, U)[0]
            a1 = d0[:K] + (llr1[:K] - lin1[:K])
            lin2[:K] = a1[pi]
            llr2 = _half_iteration_ckpt_ref(lin2[None], par2[None], W, U)[0]
            la1 = (llr2[:K] - lin2[:K])[inv]
            lin1[:K] = d0[:K] + la1
            bit = ((a1 + la1) < 0).to(torch.int32)
            if done[b]:
                continue
            bits[b] = bit
            payload = bit[F:].numpy().astype(bool)
            if np.bitwise_xor.reduce(rows[payload], initial=0) == 0:
                done[b] = True
                if cfg.dynamic_stop:
                    iters[b] = it + 1
                    break
        if not done[b]:
            bits[b] = 0
    return bits, done, iters


@pytest.mark.parametrize("dyn", [True, False])
@pytest.mark.parametrize("K,F,kind,W,U,sigma",
                         [(136, 16, "crc24b", 48, 24, 2.4),
                          (512, 0, "crc24a", 96, 24, 2.3),
                          (256, 0, "crc24a", 44, 20, 2.3),
                          (200, 0, "crc24a", 45, 15, 2.3)])
def test_kernel_schedule_equals_plain_loop(K, F, kind, W, U, sigma, dyn):
    """Bits, flags and iterations run; W, U = 44, 20 and 45, 15 run the
    half-iterations at R = 4 and 1."""
    llr = torch.from_numpy(_coded(K, F, kind, 8, sigma, 3 * K)[0])
    cfg = turbo.TurboDecoderConfig(K=K, F=F, n_iter=5, window=W, warmup=U,
                                   crc_kind=kind, dynamic_stop=dyn)
    iters = torch.zeros(8, dtype=torch.int32)
    want = turbo.turbo_decode_ref(llr, cfg, iters)
    got = _decode_schedule_ref(llr, cfg)
    assert 0 < int(want[1].sum()) < 8, "want a mixed batch"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], iters)
    if not dyn:
        assert bool((iters == 5).all())


def test_plain_loop_counts_iterations_to_each_latch():
    llr = torch.from_numpy(_coded(512, 0, "crc24a", 8, 2.3, 1)[0])
    iters = torch.zeros(8, dtype=torch.int32)
    bits, done = turbo.turbo_decode_ref(llr, _cfg(512, 0, "crc24a", 96, True,
                                                  n_iter=8), iters)
    for n in range(1, 9):
        b, ok = turbo.turbo_decode_ref(llr, _cfg(512, 0, "crc24a", 96, False,
                                                 n_iter=n))
        # a block latched at iteration iters[b] <= n has its final bits
        assert torch.equal(ok, done & (iters <= n))
        assert torch.equal(b[ok], bits[ok])
    assert bool((iters[~done] == 8).all())


def test_decode_takes_plain_loop_for_cpu_tensors():
    llr = torch.from_numpy(_coded(136, 0, "crc24a", 4, 2.3, 5)[0])
    cfg = _cfg(136, 0, "crc24a", 48, True)
    before = launch_counts()
    a = turbo.turbo_decode(llr, cfg)
    b = turbo.turbo_decode_ref(llr, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert launch_counts() == before


def test_decode_rejects_other_devices():
    cfg = _cfg(136, 0, "crc24a", 48, True)
    with pytest.raises(ValueError):
        turbo.turbo_decode(torch.zeros(2, 3, 140, device="meta"), cfg)
    pi = torch.zeros(136, dtype=torch.int32)
    with pytest.raises(ValueError):          # the kernel's wrapper: CUDA only
        turbo_cuda.decode(torch.zeros(2, 3, 140), pi, pi, 0, 6, 48, 24,
                          "crc24a", True)


# ------------------------------------------------------ on the card only --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dyn", [True, False])
@pytest.mark.parametrize("K,F,kind,W,U,sigma",
                         [(136, 16, "crc24b", 48, 24, 2.4),
                          (512, 8, "crc24b", 96, 24, 2.2),
                          (256, 0, "crc24a", 44, 20, 2.3),
                          (1024, 0, "crc24a", 240, 24, 2.3),
                          (1024, 0, "crc24a", 24, 8, 2.3),
                          (6016, 0, "crc24a", 48, 24, 2.3)])
def test_kernel_equals_plain_loop_on_the_card(cuda, K, F, kind, W, U, sigma,
                                              dyn):
    """One launch a decode, bits, flags and iterations equal to the host
    loop's (its half-iterations on the v2 kernel) bit for bit; W = 24 and
    48 give rows of 43 and 126 windows, so two and four warps a block."""
    llr = torch.from_numpy(_coded(K, F, kind, 16, sigma, K)[0]).to(cuda)
    cfg = turbo.TurboDecoderConfig(K=K, F=F, n_iter=6, window=W, warmup=U,
                                   crc_kind=kind, dynamic_stop=dyn)
    it_k = torch.zeros(16, dtype=torch.int32, device=cuda)
    it_r = torch.zeros_like(it_k)
    before = launch_counts()["turbo_decode"]
    got = turbo.turbo_decode(llr, cfg, it_k)
    torch.cuda.synchronize()
    assert launch_counts()["turbo_decode"] == before + 1
    want = turbo.turbo_decode_ref(llr, cfg, it_r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(it_k, it_r)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    llr = torch.zeros(2, 3, 140, device=cuda)
    pi = torch.zeros(136, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        turbo_cuda.decode(llr.double(), pi, pi, 0, 6, 48, 24, "crc24a", True)
    with pytest.raises(ValueError):
        turbo_cuda.decode(llr, pi.long(), pi, 0, 6, 48, 24, "crc24a", True)
    with pytest.raises(ValueError):
        turbo_cuda.decode(llr.transpose(0, 1).contiguous().transpose(0, 1),
                          pi, pi, 0, 6, 48, 24, "crc24a", True)
    with pytest.raises(ValueError):
        turbo_cuda.decode(llr, pi, pi, 136, 6, 48, 24, "crc24a", True)
    pi = torch.zeros(6144, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):          # 129 windows of 48
        turbo_cuda.decode(torch.zeros(2, 3, 6148, device=cuda), pi, pi, 0, 6,
                          48, 24, "crc24a", True)
