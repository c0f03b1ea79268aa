"""The Viterbi search kernel's share of its roofline: the least time of
its launches in the traced window (each a DCI blind search) over their
summed device time.

A search of n candidates over a control region [B, W] at K bits: the
region read once a row and the decisions written (B W 4 + n B K bytes),
and the add-compare-select of a decode of its n B rows over 3 K trellis
steps (the circular decode's three copies) at 6 + 64 x 5 + 63 float32
operations a step; the larger of the two at the card's peaks.
"""

OPS_PER_STEP = 6 + 64 * 5 + 63
WRAP = 3
KERNEL = "viterbi_search_kernel"


def _shapes(fn, store):
    def viterbi_search(llr_cces, K, cands):
        if store.get("on"):
            B, W = llr_cces.shape
            store.setdefault("viterbi_search", []).append(
                (B, W, K, len(cands)))
        return fn(llr_cces, K, cands)
    return viterbi_search


HOOKS = {"DlsimFading": {
    "openair4g_tpu_torch.phy.pdcch:viterbi_search": _shapes}}


def bound_s(B: int, W: int, K: int, n: int, peaks: dict) -> float:
    ops = n * B * WRAP * K * OPS_PER_STEP
    n_bytes = B * W * 4 + n * B * K
    return max(ops / peaks["fp32_ops_per_s"],
               n_bytes / peaks["hbm_bytes_per_s"])


def read(t):
    calls = t.store.get("viterbi_search", [])
    spent = t.kernel_s(KERNEL)
    if not calls or spent <= 0:
        return None
    least = sum(bound_s(*c, t.store["peaks"]) for c in calls)
    return 100.0 * least / spent
