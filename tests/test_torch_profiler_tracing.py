"""The port's observability against the JAX package: utils/profiler (the
time_meas table) and utils/tracing (the trace artifact), and
DlsimFading.sweep's `profile` and `trace_dir`, at the reference test's
configuration (tests/test_observability.py).

The profiler's pure-Python parts are copies: each function or class is
held equal to the reference's by its AST. stop_meas and timed wait on
their result with a torch.cuda.synchronize of the devices of its CUDA
tensors where the reference calls jax.block_until_ready."""
import ast
import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from openair4g_tpu.sim.dlsim import DlsimFading as JDlsimFading
from openair4g_tpu.sim.dlsim import DlsimFadingConfig as JConfig
from openair4g_tpu.utils import profiler as jprofiler
from openair4g_tpu_torch.sim.dlsim import DlsimFading, DlsimFadingConfig
from openair4g_tpu_torch.utils import profiler, tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
COPIED = ("enable", "reset_meas", "_Meas", "meas", "print_meas", "get_meas")
WAITING = ("stop_meas", "timed")


def _defs(rel: str) -> dict:
    tree = ast.parse((ROOT / rel).read_text())
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("name", COPIED)
def test_profiler_copy_equals_its_reference(name):
    ref = _defs("openair4g_tpu/utils/profiler.py")[name]
    got = _defs("openair4g_tpu_torch/utils/profiler.py")[name]
    assert ast.dump(got) == ast.dump(ref)


@pytest.mark.parametrize("name", WAITING)
def test_waiting_functions_differ_in_their_wait_only(name):
    """stop_meas and timed are the reference's with jax.block_until_ready
    replaced by the port's block_until_ready."""
    ref = ast.unparse(_defs("openair4g_tpu/utils/profiler.py")[name])
    got = ast.unparse(_defs("openair4g_tpu_torch/utils/profiler.py")[name])
    assert ref.count("jax.block_until_ready") == 1

    def body(src):          # the statements after the docstring
        return [ast.dump(n) for n in ast.parse(src).body[0].body[1:]]
    assert body(got) == body(ref.replace("jax.block_until_ready",
                                         "block_until_ready"))


def _run_sweep(sim, **kw) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sim.sweep([2.0], n_frames=32, **kw)
    return buf.getvalue()


def test_sweep_profile_names_the_reference_stages():
    """sweep(profile=True) at tests/test_observability.py's configuration
    (6 PRB, MCS 4, EVA, CFI 3, batch 32, 2 HARQ rounds): the port's stage
    names equal the JAX run's, each counted once a trial, and the table's
    header line is the same."""
    kw = dict(mcs=4, n_rb=6, channel="EVA", n_pdcch_symbols=3, batch=32,
              n_harq_rounds=2)
    jprofiler.reset_meas()
    out_ref = _run_sweep(JDlsimFading(JConfig(**kw)), profile=True)
    ref = jprofiler.get_meas()
    profiler.reset_meas()
    out = _run_sweep(DlsimFading(DlsimFadingConfig(**kw), device="cpu"),
                     profile=True)
    got = profiler.get_meas()
    assert set(got) == set(ref) == {"dlsim.tx_encode",
                                    "dlsim.round0(chan+rx+decode)",
                                    "dlsim.round1(chan+rx+decode)"}
    assert got["dlsim.tx_encode"][0] == ref["dlsim.tx_encode"][0] == 1
    assert got["dlsim.round0(chan+rx+decode)"][0] == 1

    def header(text):
        return next(line for line in text.splitlines()
                    if line.startswith("stage"))
    assert header(out) == header(out_ref)
    assert "mean_us" in header(out)
    for name in got:
        assert name in out


def test_profiler_disabled_records_nothing():
    profiler.reset_meas()
    profiler.enable(False)
    try:
        sim = DlsimFading(DlsimFadingConfig(mcs=4, n_rb=6, channel="AWGN",
                                            batch=4, n_harq_rounds=1),
                          device="cpu")
        sim.sweep([2.0], n_frames=4, verbose=False)
        assert profiler.get_meas() == {}
    finally:
        profiler.enable(True)


def test_trace_dir_writes_a_trace_with_the_step_span(tmp_path):
    """trace_dir at the reference test's configuration: a Chrome trace
    JSON whose events hold the `dlsim.step` span."""
    sim = DlsimFading(DlsimFadingConfig(mcs=4, n_rb=6, channel="AWGN",
                                        n_pdcch_symbols=3, batch=16,
                                        n_harq_rounds=1), device="cpu")
    d = str(tmp_path / "trace")
    sim.sweep([2.0], n_frames=16, verbose=False, trace_dir=d)
    found = tracing.trace_artifacts(d)
    assert len(found) == 1 and found[0].endswith(".json")
    events = json.loads(Path(found[0]).read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "dlsim.step"]
    assert len(steps) == 1 and steps[0]["dur"] > 0


def test_annotate_spans_nest_in_the_trace(tmp_path):
    with tracing.trace(str(tmp_path), device="cpu"):
        with tracing.annotate("outer"):
            with tracing.annotate("inner"):
                torch.ones(8).sum()
    (path,) = tracing.trace_artifacts(str(tmp_path))
    names = {e.get("name") for e in json.loads(Path(path).read_text())[
        "traceEvents"]}
    assert {"outer", "inner"} <= names


@pytest.mark.parametrize("result", [
    torch.ones(3),
    (torch.ones(2), torch.zeros(2)),
    {"a": torch.ones(2), "b": [torch.zeros(1), 3]},
    None,
], ids=["tensor", "tuple", "dict", "none"])
def test_stop_meas_and_timed_take_any_result(result):
    profiler.reset_meas()
    profiler.stop_meas("stage", 0.0, result)
    assert profiler.block_until_ready(result) is result

    @profiler.timed("fn")
    def fn():
        return result
    assert fn() is result
    got = profiler.get_meas()
    assert got["stage"][0] == 1 and got["fn"][0] == 1
    assert got["fn"][1] >= 0.0


def test_meas_context_counts_a_stage():
    profiler.reset_meas()
    with profiler.meas("ctx"):
        torch.ones(4)
    with profiler.meas("ctx"):
        pass
    n, mean, std, mx = profiler.get_meas()["ctx"]
    assert n == 2 and mx >= mean >= 0.0 and std >= 0.0
    buf = io.StringIO()
    profiler.print_meas(file=buf)
    assert buf.getvalue().splitlines()[1].startswith("ctx")
