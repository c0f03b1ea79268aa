"""The port's multi-process sweep for real: two processes of `python -m
openair4g_tpu_torch.parallel.distributed --device cpu` on gloo, meeting
through a file:// rendezvous, against one process with the same global
batch (the reference's tests/test_distributed_2proc.py); and the port's
dryrun_multichip in two ranks. Every spawned interpreter has jax and the
JAX package blocked and one torch thread."""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from openair4g_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240                 # seconds, each spawn and its collectives
PRELUDE = ("import runpy, sys\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['openair4g_tpu'] = None\n"
           "import torch\n"
           "torch.set_num_threads(1)\n"
           "sys.argv = ['distributed'] + sys.argv[1:]\n"
           "runpy.run_module('openair4g_tpu_torch.parallel.distributed',\n"
           "                 run_name='__main__')\n")


def _start(nprocs: int, bpd: int, tmp_path, out: str) -> tuple:
    args = [sys.executable, "-c", PRELUDE, "--device", "cpu", "--mcs", "4",
            "--n-rb", "6", "--snrs=-2.5:-1.5:0.5", "--frames", "128",
            "--batch-per-device", str(bpd), "--timeout", str(TIMEOUT)]
    procs = []
    for pid in range(nprocs):
        cmd = list(args)
        if nprocs > 1:
            cmd += ["--coordinator", f"file://{tmp_path}/rdzv{nprocs}",
                    "--nprocs", str(nprocs), "--proc-id", str(pid)]
        if pid == 0:
            cmd += ["--out", out]
        procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    return procs, out


def _finish(procs, out: str) -> tuple:
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=TIMEOUT)
            logs.append(stdout.decode())
            assert p.returncode == 0, logs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    with open(out) as f:
        return json.load(f), logs


def test_two_processes_match_one_process(tmp_path):
    """1 process x 16 trials against 2 processes x 8, run side by side:
    the same global batch drawn from the same generator, so every row is
    equal."""
    single = _start(1, 16, tmp_path, str(tmp_path / "single.json"))
    dual = _start(2, 8, tmp_path, str(tmp_path / "dual.json"))
    rows1, _ = _finish(*single)
    rows2, logs = _finish(*dual)
    assert rows1 == rows2, (rows1, rows2)
    assert rows1[0][1] > 0 and all(r[2] == 128 for r in rows1), rows1
    assert "on 2 ranks (gloo, cpu)" in logs[0], logs[0][-500:]
    assert "on 1 ranks (gloo, cpu)" not in logs[0]


def test_command_line_needs_the_card_by_default():
    code = PRELUDE.replace("import torch\n", "import torch\n"
                           "torch.cuda.is_available = lambda: False\n")
    r = subprocess.run([sys.executable, "-c", code, "--frames", "8"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_dryrun_multichip_in_two_ranks(tmp_path):
    """The reference's three multi-device checks (the DP PDSCH step, the
    time-sharded PSS correlation across the halo, the 20 MHz flagship
    sharded over 'ue' with every TB and DCI decoded) in 2 gloo ranks."""
    out = spawn("openair4g_tpu_torch.graft_entry:dryrun_multichip", 2,
                backend="gloo", workdir=tmp_path / "dryrun",
                kwargs={"world": 2, "device": "cpu"}, timeout=TIMEOUT,
                block=("jax", "openair4g_tpu"), threads=1)
    log = out[0]["log"]
    assert "2/2 TBs decoded (all_reduce over 'ue')" in log, log
    assert "found peaks [987, 960] across the halo" in log, log
    assert "2/2 TBs decoded, 0 DCI misses" in log, log
    assert out[1]["log"] == ""


def test_dryrun_multichip_needs_its_world():
    """In a process of its own (a group of one), dryrun_multichip(3)
    refuses to run."""
    from openair4g_tpu_torch.graft_entry import dryrun_multichip
    try:
        with pytest.raises(RuntimeError, match="runs in 3 ranks"):
            dryrun_multichip(3, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
