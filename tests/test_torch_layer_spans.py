"""The program's own layer spans (utils/tracing.annotate) and the stage
timers' waits: one DlsimFading and one Ulsim trial at 6 PRB, batch 4,
under tracing.trace open every "oai4g:" span at its place, each child
inside its parent, the top-level spans covering the trial's host time but
for the gaps between them, and the outputs equal an untraced run's bit
for bit; with no profiler active `annotate` makes no record_function
call; a run_snr outside sweep(profile=True) never waits on the device for
the stage timers."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openair4g_tpu_torch.ops.uci import UciConfig
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig
from openair4g_tpu_torch.utils import profiler, tracing

torch.set_num_threads(1)

PREFIX = "oai4g:"
PARENT = {"encode.crc_seg": "bitchain.encode",
          "encode.turbo": "bitchain.encode",
          "encode.rate_match": "bitchain.encode",
          "frontend.channel": "frontend",
          "frontend.estimate": "frontend",
          "frontend.detect": "frontend",
          "decode.dematch": "bitchain.decode",
          "decode.turbo": "bitchain.decode",
          "decode.crc": "bitchain.decode"}
TOP = {"dl": {"bitchain.encode", "tx.map", "frontend", "control.dci",
              "bitchain.decode", "sim.harq"},
       "ul": {"bitchain.encode", "tx.map", "frontend", "control.uci",
              "bitchain.decode", "sim.harq"}}


def _dl():
    sim = DlsimFading(DlsimFadingConfig(
        mcs=4, n_rb=6, channel="EVA", n_pdcch_symbols=3, batch=4,
        n_harq_rounds=2, est_mode="joint"), device="cpu")
    snr = 10.0
    args = (np.float32(10.0 ** (-snr / 10.0)), sim.wiener(snr),
            sim.err_var(snr))
    return sim, sim.draw(torch.Generator().manual_seed(5)) + args


def _ul():
    sim = Ulsim(UlsimConfig(
        mcs=10, n_rb=6, n_rb_alloc=6, channel="EVA", n_harq_rounds=2,
        batch=4, uci=UciConfig(o_cqi=30, o_ri=1, o_ack=2)), device="cpu")
    snr = 10.0
    args = (np.float32(10.0 ** (-snr / 10.0)), sim.wiener(snr))
    return sim, sim.draw(torch.Generator().manual_seed(5)) + args


SIMS = {"dl": _dl, "ul": _ul}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


@pytest.fixture(scope="module", params=sorted(SIMS))
def traced(request, tmp_path_factory):
    """(kind, untraced output, traced output, the trial's span, the
    program's spans [(label, t0, t1)], the torch operators in the trial)."""
    sim, args = SIMS[request.param]()
    plain = sim.trial(*args)
    d = tmp_path_factory.mktemp(f"trace_{request.param}")
    with tracing.trace(str(d), device="cpu"):
        with tracing.annotate("test.trial"):
            spanned = sim.trial(*args)
    (path,) = tracing.trace_artifacts(str(d))
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (trial,) = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"] == "test.trial"]
    spans = [(e["name"][len(PREFIX):], e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and trial[0] <= e["ts"] <= trial[1]]
    return request.param, plain, spanned, trial, spans, ops


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner != outer


def test_every_span_opens_and_nests(traced):
    kind, _, _, trial, spans, _ = traced
    assert {lab for lab, _, _ in spans} == TOP[kind] | set(PARENT)
    for s in spans:
        assert trial[0] <= s[1] and s[2] <= trial[1]
        holders = {o[0] for o in spans if _inside(s, o)}
        if s[0] in PARENT:
            assert holders == {PARENT[s[0]]}, s
        else:
            assert not holders, s


def test_top_level_spans_cover_the_trial(traced):
    """Every torch operator of the trial runs inside a top-level span, but
    for the moves of its inputs to their device (aten::to, here a no-op),
    and the gaps between the spans are a small part of the trial."""
    kind, _, _, trial, spans, ops = traced
    top = sorted((a, b) for lab, a, b in spans if lab in TOP[kind])
    outside = {e["name"] for e in ops
               if not any(a <= e["ts"] <= b for a, b in top)}
    assert outside <= {"aten::to"}
    for (_, b), (a, _) in zip(top, top[1:]):
        assert a >= b                  # one after another, none nested
    covered = sum(b - a for a, b in top)
    assert covered >= 0.9 * (trial[1] - trial[0])


def test_spans_leave_the_outputs_bit_for_bit(traced):
    _, plain, spanned, _, _, _ = traced
    a, b = _tensors(plain), _tensors(spanned)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_annotate_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = tracing.annotate("oai4g:x"), tracing.annotate("oai4g:y")
    assert a is b is tracing._NOOP
    with a:
        with b:
            pass


def test_stage_timers_wait_only_under_sweep_profile(monkeypatch):
    """run_snr never reaches profiler.block_until_ready (the stage timers'
    wait on the device); sweep(profile=True) does, once for the encode and
    once a round, each trial, and records both stages."""
    waits = []
    monkeypatch.setattr(profiler, "block_until_ready",
                        lambda result: waits.append(result) or result)
    sim = DlsimFading(DlsimFadingConfig(mcs=4, n_rb=6, channel="AWGN",
                                        n_pdcch_symbols=3, batch=4,
                                        n_harq_rounds=2), device="cpu")
    profiler.reset_meas()
    sim.run_snr(2.0, 8)
    assert waits == [] and profiler.get_meas() == {}
    sim.sweep([2.0], n_frames=8, verbose=False, profile=True)
    assert len(waits) == 2 * (1 + 2)
    got = profiler.get_meas()
    assert got["dlsim.tx_encode"][0] == 2
    assert got["dlsim.round1(chan+rx+decode)"][0] == 2
    waits.clear()
    sim.run_snr(2.0, 4)
    assert waits == []
    profiler.reset_meas()
