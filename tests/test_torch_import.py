"""The port and chip_smoke.py import torch and never jax, nor anything of
the JAX package openair4g_tpu; the simulators run on the card unless
their caller asks for the CPU."""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import openair4g_tpu_torch
from openair4g_tpu_torch.device import (count_launch, launch_counts,
                                        launch_shapes, reset_launch_counts)
from openair4g_tpu_torch.sim import capstone, capstone_multiue
from openair4g_tpu_torch.sim.capstone import CapstoneConfig, FullStackSim
from openair4g_tpu_torch.sim.capstone_multiue import MultiUeSim
from openair4g_tpu_torch.sim.dlsim import (DlsimAwgn, DlsimConfig,
                                           DlsimFading, DlsimFadingConfig)
from openair4g_tpu_torch.sim.dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
from openair4g_tpu_torch.sim.dlsim_sm import DlsimSm, DlsimSmConfig
from openair4g_tpu_torch.sim.fullsim import FullChainSim, FullsimConfig
from openair4g_tpu_torch.sim.mbmssim import Mbmssim, MbmssimConfig
from openair4g_tpu_torch.sim.oaisim import Oaisim, OaisimConfig
from openair4g_tpu_torch.sim.pbchsim import Pbchsim, PbchsimConfig
from openair4g_tpu_torch.sim.pdcchsim import Pdcchsim, PdcchsimConfig
from openair4g_tpu_torch.sim.prachsim import Prachsim, PrachsimConfig
from openair4g_tpu_torch.sim.pucchsim import Pucchsim, PucchsimConfig
from openair4g_tpu_torch.sim.scansim import CarrierScan, ScanConfig
from openair4g_tpu_torch.sim.syncsim import Syncsim, SyncsimConfig
from openair4g_tpu_torch.sim.tddsim import TddFrameSim, TddsimConfig
from openair4g_tpu_torch.sim.ulgrantsim import UlGrantConfig, UlGrantSim
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_with_jax_and_the_jax_package_blocked():
    mods = ["openair4g_tpu_torch", "chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(openair4g_tpu_torch.__path__,
                                              "openair4g_tpu_torch.")]
    assert len(mods) >= 25, mods
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            f"for name in {mods!r}:\n"
            "    importlib.import_module(name)\n"
            "leaked = sorted(k for k, v in sys.modules.items() if v is not None\n"
            "                and k.split('.')[0] in ('jax', 'openair4g_tpu'))\n"
            "assert not leaked, leaked\n"
            "print('imported')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout


def test_multi_antenna_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert {"openair4g_tpu_torch.sim.dlsim_mimo",
            "openair4g_tpu_torch.sim.dlsim_sm",
            "openair4g_tpu_torch.phy.alamouti",
            "openair4g_tpu_torch.phy.precoding",
            "openair4g_tpu_torch.phy.mimo_rx",
            "openair4g_tpu_torch.phy.dci_formats"} <= names


def test_siso_harq_slice_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert {"openair4g_tpu_torch.sim.dlsim",
            "openair4g_tpu_torch.sim.channels",
            "openair4g_tpu_torch.sim.harness",
            "openair4g_tpu_torch.phy.channel_est"} <= names


def test_uplink_slice_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert {"openair4g_tpu_torch.sim.ulsim",
            "openair4g_tpu_torch.sim.pucchsim",
            "openair4g_tpu_torch.ops.uci",
            "openair4g_tpu_torch.phy.ulref",
            "openair4g_tpu_torch.phy.scfdma",
            "openair4g_tpu_torch.phy.hopping",
            "openair4g_tpu_torch.phy.pusch",
            "openair4g_tpu_torch.phy.power_control",
            "openair4g_tpu_torch.phy.srs",
            "openair4g_tpu_torch.phy.pucch",
            "openair4g_tpu_torch.tables._ul_dmrs_phi"} <= names


def test_control_and_sync_slice_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert {"openair4g_tpu_torch.tables.prach_root_map",
            "openair4g_tpu_torch.phy.sync",
            "openair4g_tpu_torch.phy.pbch",
            "openair4g_tpu_torch.phy.phich",
            "openair4g_tpu_torch.phy.pmch",
            "openair4g_tpu_torch.phy.prach",
            "openair4g_tpu_torch.phy.measurements",
            "openair4g_tpu_torch.phy.tracking",
            "openair4g_tpu_torch.phy.tdd",
            "openair4g_tpu_torch.sim.rf",
            "openair4g_tpu_torch.sim.pdcchsim",
            "openair4g_tpu_torch.sim.pbchsim",
            "openair4g_tpu_torch.sim.syncsim",
            "openair4g_tpu_torch.sim.scansim",
            "openair4g_tpu_torch.sim.prachsim",
            "openair4g_tpu_torch.sim.mbmssim"} <= names


def test_per_tti_slice_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert {"openair4g_tpu_torch.sched",
            "openair4g_tpu_torch.sched.enb_tx",
            "openair4g_tpu_torch.sched.ue_rx",
            "openair4g_tpu_torch.sched.ue_tx",
            "openair4g_tpu_torch.sched.enb_rx",
            "openair4g_tpu_torch.sim.fullsim",
            "openair4g_tpu_torch.sim.framegen",
            "openair4g_tpu_torch.sim.ulgrantsim",
            "openair4g_tpu_torch.sim.tddsim",
            "openair4g_tpu_torch.phy.uespec",
            "openair4g_tpu_torch.utils",
            "openair4g_tpu_torch.utils.octave_io"} <= names


SYSTEM_SLICE = ["openair4g_tpu_torch.sim.abstraction",
                "openair4g_tpu_torch.sim.oaisim",
                "openair4g_tpu_torch.sim.oaisim_fullstack",
                "openair4g_tpu_torch.utils.log",
                "openair4g_tpu_torch.utils.opt",
                "openair4g_tpu_torch.utils.msc"] + [
    f"openair4g_tpu_torch.{pkg}.{name}" for pkg, names in (
        ("mac", ("mux", "ra", "rlc", "rohc", "pdcp", "scheduler", "ue_mac",
                 "ul_scheduler")),
        ("rrc", ("messages", "phy_config", "enb", "ue", "handover",
                 "paging")),
        ("epc", ("nas", "s1ap", "gtpu", "sctp_lite", "hss", "sgw",
                 "security", "mme", "enb_app", "ue_nas", "crypto")))
    for name in names] + ["openair4g_tpu_torch.mac", "openair4g_tpu_torch.rrc",
                          "openair4g_tpu_torch.epc"]


def test_system_slice_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert set(SYSTEM_SLICE) <= names


def test_system_slice_and_fullstack_command_line_run_without_cryptography():
    """The system simulators, MAC/RLC/PDCP, RRC and EPC import with jax,
    the JAX package and `cryptography` blocked; in that interpreter the
    full-stack command line attaches and echoes 4 UEs (EEA2/EIA2 through
    the port's own AES) and a full-PHY Oaisim runs a frame on the CPU."""
    code = ("import importlib, runpy, sys\n"
            "for m in ('jax', 'openair4g_tpu', 'cryptography'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            f"for name in {SYSTEM_SLICE!r}:\n"
            "    importlib.import_module(name)\n"
            "from openair4g_tpu_torch.sim.oaisim import Oaisim, OaisimConfig\n"
            "out = Oaisim(OaisimConfig(n_enb=2, n_ue=2, n_rb=6, mcs=0,\n"
            "                          tx_power_db=55.0, mode='phy',\n"
            "                          channel='AWGN', n_turbo_iter=2),\n"
            "             device='cpu').run_frames(1)\n"
            "assert out['frames'] == 1\n"
            "sys.argv = ['oaisim_fullstack', '-u', '4']\n"
            "runpy.run_module('openair4g_tpu_torch.sim.oaisim_fullstack',\n"
            "                 run_name='__main__')\n"
            "leaked = sorted(k for k, v in sys.modules.items() if v is not None\n"
            "                and k.split('.')[0] in ('jax', 'openair4g_tpu',\n"
            "                                        'cryptography'))\n"
            "assert not leaked, leaked\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout)
    assert res["all_registered"] and res["all_echoed"]
    assert res["mme_registered"] == 4 and res["int_failures"] == 0


CAPSTONE_SLICE = ["openair4g_tpu_torch.sim.capstone",
                  "openair4g_tpu_torch.sim.capstone_multiue",
                  "openair4g_tpu_torch.utils.profiler",
                  "openair4g_tpu_torch.utils.tracing",
                  "openair4g_tpu_torch.runtime",
                  "openair4g_tpu_torch.runtime.native",
                  "openair4g_tpu_torch.runtime.softmodem",
                  "openair4g_tpu_torch.runtime.fronthaul"]


def test_capstone_slice_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert set(CAPSTONE_SLICE) <= names


def test_capstones_and_runtime_run_with_jax_and_cryptography_blocked():
    """The capstones, the observability modules and the runtime import
    with jax, the JAX package and `cryptography` blocked; in that
    interpreter the ring buffer builds and round-trips, and the capstone's
    command line climbs the whole ladder at 25 PRB on the CPU."""
    code = ("import importlib, sys\n"
            "for m in ('jax', 'openair4g_tpu', 'cryptography'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            f"for name in {CAPSTONE_SLICE!r}:\n"
            "    importlib.import_module(name)\n"
            "from openair4g_tpu_torch.runtime import RingBuffer\n"
            "rb = RingBuffer(64)\n"
            "assert rb.write(b'x' * 40) == 40 and rb.read(40) == b'x' * 40\n"
            "from openair4g_tpu_torch.sim.capstone import main\n"
            "main(['--device', 'cpu'])\n"
            "leaked = sorted(k for k, v in sys.modules.items() if v is not None\n"
            "                and k.split('.')[0] in ('jax', 'openair4g_tpu',\n"
            "                                        'cryptography'))\n"
            "assert not leaked, leaked\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout)
    assert res["registered"] and res["echo_ok"] and res["ttis"] == 53


@pytest.mark.parametrize("main", [capstone.main, capstone_multiue.main],
                         ids=["capstone", "capstone_multiue"])
def test_capstone_command_lines_need_the_card_by_default(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])


def test_fullsim_and_framegen_command_lines_run_with_jax_blocked(tmp_path):
    """fullsim_main at one 6 PRB point and framegen, on the CPU, in one
    interpreter with jax and the JAX package blocked."""
    out = tmp_path / "frame.npy"
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            "from openair4g_tpu_torch.sim.harness import fullsim_main\n"
            "fullsim_main(['-B', '6', '-s', '10', '-S', '10', '-n', '2',\n"
            "              '-b', '2', '-r', '1', '--device', 'cpu'])\n"
            f"sys.argv = ['framegen', '-B', '6', '-o', {str(out)!r},\n"
            "            '--device', 'cpu']\n"
            "runpy.run_module('openair4g_tpu_torch.sim.framegen',\n"
            "                 run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("SNR +10.00 dB: r0:0.0000(0/2)"), lines
    assert lines[1].startswith("wrote 19200 samples"), lines
    assert out.exists()


def test_control_and_sync_command_lines_run_with_jax_blocked():
    """pbchsim, pdcchsim, syncsim and prachsim, each at one tiny point on
    the CPU, in one interpreter with jax and the JAX package blocked."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            "for name, argv in [\n"
            "        ('pbchsim', ['-B', '6', '-s', '-2', '-S', '-2']),\n"
            "        ('pdcchsim', ['-B', '6', '-s', '0', '-S', '0']),\n"
            "        ('syncsim', ['-B', '6', '-s', '3', '-S', '3']),\n"
            "        ('prachsim', ['-s', '-10', '-S', '-10',\n"
            "                      '--time-domain'])]:\n"
            "    sys.argv = [name] + argv + ['-n', '1', '--device', 'cpu']\n"
            "    runpy.run_module('openair4g_tpu_torch.sim.' + name,\n"
            "                     run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 4, lines
    for line, word in zip(lines, ("PBCH BLER", "DCI err", "timing_err",
                                  "delay_ok")):
        assert word in line, line


def test_pucchsim_command_line_starts_with_jax_blocked():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            "sys.argv = ['pucchsim', '--help']\n"
            "runpy.run_module('openair4g_tpu_torch.sim.pucchsim',\n"
            "                 run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "--device" in r.stdout


def test_dlsim_command_line_starts_with_jax_blocked():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            "sys.argv = ['dlsim', '--help']\n"
            "runpy.run_module('openair4g_tpu_torch.sim.harness',\n"
            "                 run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "--device" in r.stdout



@pytest.mark.parametrize("sim_cls,cfg", [
    (DlsimFading, DlsimFadingConfig(n_rb=6, batch=2)),
    (DlsimSm, DlsimSmConfig(tm=3, n_rb=6, batch=2)),
    (DlsimTxDiv, DlsimTxDivConfig(n_rb=6, batch=2)),
    (DlsimAwgn, DlsimConfig(n_rb=6, batch=2)),
    (Ulsim, UlsimConfig(n_rb=6, n_rb_alloc=6, batch=2)),
    (Pucchsim, PucchsimConfig(batch=2)),
    (Pdcchsim, PdcchsimConfig(n_rb=6, batch=2)),
    (Pbchsim, PbchsimConfig(n_rb=6, batch=2)),
    (Syncsim, SyncsimConfig(n_rb=6, batch=2)),
    (CarrierScan, ScanConfig(n_rb=6)),
    (Prachsim, PrachsimConfig(batch=2)),
    (Mbmssim, MbmssimConfig(n_rb=6, batch=2)),
    (FullChainSim, FullsimConfig(n_rb=6, batch=2)),
    (UlGrantSim, UlGrantConfig(n_rb=6, n_prb=4, batch=2)),
    (TddFrameSim, TddsimConfig(batch=2)),
    (Oaisim, OaisimConfig(n_enb=1, n_ue=2, n_rb=6)),
    (Oaisim, OaisimConfig(n_enb=1, n_ue=2, n_rb=6, mode="phy")),
    (FullStackSim, CapstoneConfig()),
    (MultiUeSim, CapstoneConfig())],
    ids=["DlsimFading", "DlsimSm", "DlsimTxDiv", "DlsimAwgn", "Ulsim",
         "Pucchsim", "Pdcchsim", "Pbchsim", "Syncsim", "CarrierScan",
         "Prachsim", "Mbmssim", "FullChainSim", "UlGrantSim",
         "TddFrameSim", "Oaisim abstraction", "Oaisim full PHY",
         "FullStackSim", "MultiUeSim"])
def test_simulators_run_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                             sim_cls, cfg):
    """device=None means the card: without one the simulator raises rather
    than carry on on the CPU; device="cpu" still builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_cls(cfg)
    assert sim_cls(cfg, device="cpu").device == torch.device("cpu")


def test_launches_are_counted_by_kernel_and_by_shape():
    """count_launch adds one to the kernel's count and one to its (kernel,
    shape) count; reset_launch_counts clears both."""
    reset_launch_counts()
    count_launch("mrc_llr", ((4, 16, 1), 2, True))
    count_launch("mrc_llr", ((4, 16, 1), 2, True))
    count_launch("turbo_half_iter", (64, 3840, 240, 24))
    assert launch_counts()["mrc_llr"] == 2
    assert launch_shapes() == {("mrc_llr", ((4, 16, 1), 2, True)): 2,
                               ("turbo_half_iter", (64, 3840, 240, 24)): 1}
    reset_launch_counts()
    assert launch_shapes() == {} and not any(launch_counts().values())


PARALLEL_SLICE = ["openair4g_tpu_torch.parallel",
                  "openair4g_tpu_torch.parallel.mesh",
                  "openair4g_tpu_torch.parallel.sweep",
                  "openair4g_tpu_torch.parallel.timeshard",
                  "openair4g_tpu_torch.parallel.distributed",
                  "openair4g_tpu_torch.parallel.launch",
                  "openair4g_tpu_torch.parallel.checks",
                  "openair4g_tpu_torch.utils.rng",
                  "openair4g_tpu_torch.graft_entry"]


def test_parallel_slice_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert set(PARALLEL_SLICE) <= names


def test_distributed_command_line_starts_with_jax_blocked():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            "sys.argv = ['distributed', '--help']\n"
            "runpy.run_module('openair4g_tpu_torch.parallel.distributed',\n"
            "                 run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    for flag in ("--coordinator", "--nprocs", "--proc-id", "--ckpt",
                 "--batch-per-device", "--device", "--backend"):
        assert flag in r.stdout
    assert "--host-devices have no" in " ".join(r.stdout.split())


PROGRAMS = ["bench"] + [f"scripts.{name}" for name in (
    "common", "awgn_campaign", "fading_campaign", "fidelity_campaign",
    "ulsim_campaign", "doppler_campaign", "prach_roc", "eva_ablation",
    "turbo_roofline", "flagship_stages", "flagship_profile",
    "scale_campaign")]


def test_bench_and_campaign_programs_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert {f"openair4g_tpu_torch.{p}" for p in PROGRAMS} <= names


@pytest.mark.parametrize("program", ["bench", "scripts.awgn_campaign"])
def test_program_help_starts_with_jax_blocked(program):
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            "sys.argv = ['prog', '--help']\n"
            f"runpy.run_module('openair4g_tpu_torch.{program}',\n"
            "                 run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "--device" in r.stdout
