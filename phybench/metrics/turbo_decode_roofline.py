"""The turbo decode kernel's share of its roofline: the least time its
launches in the traced window could take on the card, over their summed
device time.

The least time of a launch on a (K, F) group of B code blocks is the
larger of its bytes at the HBM rate and its float32 operations at the
non-FMA rate (peaks.json). Operations count what these inputs needed: for
each row, the iterations it ran (DlschCodec.decode(iters=)) times two
half-iterations over the K + 3 trellis positions at 128 operations each,
and 6 K for the exchange, the decision and the latch; never the kernel's
padded window length. Bytes: the LLRs in, the permutation and its inverse
and the CRC rows read once; the bits, flags and iteration counts written
once.
"""

# Float32 operations a trellis position of one half-iteration takes: beta
# step 40, alpha step 32, the LLR 51 (8 states), renormalisations and the
# two 0.5 scalings 5.
OPS_PER_POS = 128
# The exchange, the decision and the latch a position and iteration.
EXCHANGE_OPS_PER_POS = 6
KERNEL = "turbo_decode_kernel"


def _iters(fn, store):
    def decode(self, e_llr, *a, **k):
        if store.get("on") and k.get("iters") is None:
            k["iters"] = []
            store.setdefault("turbo_iters", []).append(k["iters"])
        return fn(self, e_llr, *a, **k)
    return decode


_HOOK = {"openair4g_tpu_torch.phy.pdsch:DlschCodec.decode": _iters}
HOOKS = {"DlsimFading": _HOOK, "Ulsim": _HOOK}


def bound_s(K: int, F: int, iters, peaks: dict) -> float:
    """The least seconds of one launch: iters, the iterations each of its
    B rows ran."""
    B = len(iters)
    ops = sum(iters) * (2 * OPS_PER_POS * (K + 3) + EXCHANGE_OPS_PER_POS * K)
    n_bytes = 4 * (3 * B * (K + 4) + 2 * K + (K - F)) + B * (4 * K + 5)
    return max(ops / peaks["fp32_ops_per_s"],
               n_bytes / peaks["hbm_bytes_per_s"])


def read(t):
    calls = [c for lst in t.store.get("turbo_iters", []) for c in lst]
    spent = t.kernel_s(KERNEL)
    if not calls or spent <= 0:
        return None
    least = sum(bound_s(K, F, ran.cpu().tolist(), t.store["peaks"])
                for (K, F), ran in calls)
    return 100.0 * least / spent
