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


def _decode_schedule_ref(llr_d, cfg, staged=False):
    """The kernel's schedule, row by row in plain PyTorch. Per iteration:
    HI1 (the checkpointed v2 order) on lin1, storing ext1 = llr - lin1; the
    exchange lin2 = D + ext1[pi] with D = d0[pi]; HI2 on lin2, storing
    ext2; the latch pass lin1 = d0 + ext2[inv_pi] and the decision of
    position i, (lin2 + ext2)[inv_pi[i]] < 0 (on chip) or (a1 +
    ext2[inv_pi])[i] < 0 with a1 = d0 + ext1 (staged, where lin2 is no
    longer at hand); the packed-XOR CRC of the payload; the row's own exit
    once latched. Returns (bits, done, iters)."""
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
        par1[:K], par2[:K] = d1[:K], d2[:K]
        lin1[K:K + 3] = torch.stack([d0[K], d2[K], d1[K + 1]])
        par1[K:K + 3] = torch.stack([d1[K], d0[K + 1], d2[K + 1]])
        lin2[K:K + 3] = torch.stack([d0[K + 2], d2[K + 2], d1[K + 3]])
        par2[K:K + 3] = torch.stack([d1[K + 2], d0[K + 3], d2[K + 3]])
        lin1[:K] = d0[:K] + 0.0
        D = d0[:K][pi]
        for it in range(cfg.n_iter):
            llr1 = _half_iteration_ckpt_ref(lin1[None], par1[None], W, U)[0]
            ext1 = llr1[:K] - lin1[:K]
            lin2[:K] = D + ext1[pi]
            llr2 = _half_iteration_ckpt_ref(lin2[None], par2[None], W, U)[0]
            e = llr2[:K] - lin2[:K]
            if staged:
                bit = (((d0[:K] + ext1) + e[inv]) < 0).to(torch.int32)
            else:
                bit = ((lin2[:K][inv] + e[inv]) < 0).to(torch.int32)
            lin1[:K] = d0[:K] + e[inv]
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
    """Bits, flags and iterations run, in both layouts' orders; W, U = 44,
    20 and 45, 15 run the half-iterations at R = 4 and 1."""
    llr = torch.from_numpy(_coded(K, F, kind, 8, sigma, 3 * K)[0])
    cfg = turbo.TurboDecoderConfig(K=K, F=F, n_iter=5, window=W, warmup=U,
                                   crc_kind=kind, dynamic_stop=dyn)
    iters = torch.zeros(8, dtype=torch.int32)
    want = turbo.turbo_decode_ref(llr, cfg, iters)
    assert 0 < int(want[1].sum()) < 8, "want a mixed batch"
    for staged in (False, True):
        got = _decode_schedule_ref(llr, cfg, staged)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2], iters)
    if not dyn:
        assert bool((iters == 5).all())


@pytest.mark.parametrize("dyn", [True, False])
def test_kernel_schedule_above_128_windows(dyn):
    """K = 6,144 in windows of W = 40 (U = 8): 154 windows a row, more than
    one thread a window in a block of 128 could take; bits, flags and
    iterations equal to the plain loop's in both layouts' orders."""
    K, W, U = 6144, 40, 8
    llr = torch.from_numpy(_coded(K, 0, "crc24a", 3, 2.2, 8)[0])
    cfg = turbo.TurboDecoderConfig(K=K, n_iter=4, window=W, warmup=U,
                                   dynamic_stop=dyn)
    assert -(-(K + 3) // W) == 154
    iters = torch.zeros(3, dtype=torch.int32)
    want = turbo.turbo_decode_ref(llr, cfg, iters)
    assert 0 < int(want[1].sum()) < 3, "want a mixed batch"
    for staged in (False, True):
        got = _decode_schedule_ref(llr, cfg, staged)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2], iters)


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
    loop's (its half-iterations on the v2 kernel) bit for bit, in the
    launch's own layout; W = 24 and 48 give rows of 43 and 126 windows."""
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


def _card_equals_loop(llr, cfg):
    """The kernel (one launch) against the host loop, bits, flags and
    iterations, in both stop modes."""
    B = llr.shape[0]
    pi = turbo.qpp_interleaver(cfg.K)
    pi_d = torch.from_numpy(pi).to(llr.device)
    inv_d = torch.from_numpy(turbo._inverse_perm(pi).astype(np.int32)).to(
        llr.device)
    for dyn in (True, False):
        c = turbo.TurboDecoderConfig(**{**cfg.__dict__, "dynamic_stop": dyn})
        it_k = torch.zeros(B, dtype=torch.int32, device=llr.device)
        it_r = torch.zeros_like(it_k)
        before = launch_counts()["turbo_decode"]
        got = turbo_cuda.decode(llr, pi_d, inv_d, c.F, c.n_iter, c.window,
                                c.warmup, c.crc_kind, dyn, it_k)
        torch.cuda.synchronize()
        assert launch_counts()["turbo_decode"] == before + 1
        want = turbo.turbo_decode_ref(llr, c, it_r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(it_k, it_r)


def _batch_for(K, W, rows, staged):
    """The fewest rows B at which the launch picks `rows` a block and the
    layout `staged`, with B not a multiple of rows (so a block takes fewer
    than the others) where rows > 1."""
    for B in range(1, 8192):
        if (turbo_cuda.decode_plan(B, K, W) == (rows, staged)
                and (rows == 1 or B % rows)):
            return B
    pytest.fail(f"the launch picks rows={rows}, staged={staged} at no B")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,staged", [(1, False), (2, False), (3, False),
                                         (4, False), (2, True)])
def test_kernel_layouts_on_the_card(cuda, rows, staged):
    """Each layout the launch picks at K = 1,024 (on chip at 1 to 4 rows a
    block as the group grows, staged past what the SMs' shared memory
    holds), at the fewest rows that reach it: B = 1, then B not a multiple
    of the rows a block; equal to the host loop."""
    B = _batch_for(1024, 96, rows, staged)
    llr = torch.from_numpy(_coded(1024, 0, "crc24a", B, 2.3, B)[0]).to(cuda)
    cfg = turbo.TurboDecoderConfig(K=1024, n_iter=6, window=96)
    _card_equals_loop(llr, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("W,U", [(48, 24), (40, 8)])
def test_kernel_above_128_windows_on_the_card(cuda, W, U, staged):
    """K = 6,144 in rows of 129 (W = 48) and 154 (W = 40) windows, which
    the kernel once refused, on chip and staged (the fewest rows the launch
    stages): equal to the host loop."""
    B = 6 if not staged else next(
        b for b in range(1, 8192)
        if turbo_cuda.decode_plan(b, 6144, W)[1])
    assert turbo_cuda.decode_plan(B, 6144, W)[1] == staged
    llr = torch.from_numpy(_coded(6144, 0, "crc24a", B, 2.2, W)[0]).to(cuda)
    cfg = turbo.TurboDecoderConfig(K=6144, n_iter=5, window=W, warmup=U)
    _card_equals_loop(llr, cfg)


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
    with pytest.raises(ValueError):          # 16-byte vectors: aligned rows
        turbo_cuda.decode(torch.zeros(2 * 3 * 140 + 1, device=cuda)[1:]
                          .view(2, 3, 140), pi, pi, 0, 6, 48, 24, "crc24a",
                          True)
