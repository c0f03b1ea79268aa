"""The port's campaign programs (openair4g_tpu_torch/scripts/) against the
repo's scripts/: every copied table equals the reference script's by
value, `crossing` equals the reference's, the AWGN corpus data equals
awgn_campaign.json, small CPU runs write the committed files' CSV header
and keys and resume, the default outputs lie under results_torch/, and
no program runs without a card unless asked for the CPU."""
import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openair4g_tpu.sim.prachsim import PrachsimConfig as JPrachsimConfig
from openair4g_tpu_torch.scripts import (awgn_campaign, common,
                                         doppler_campaign, eva_ablation,
                                         fading_campaign, fidelity_campaign,
                                         flagship_profile, flagship_stages,
                                         prach_roc, scale_campaign,
                                         turbo_roofline, ulsim_campaign)
from openair4g_tpu_torch.sim.prachsim import PrachsimConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PROGRAMS = {"awgn_campaign": awgn_campaign,
            "fading_campaign": fading_campaign,
            "fidelity_campaign": fidelity_campaign,
            "ulsim_campaign": ulsim_campaign,
            "doppler_campaign": doppler_campaign, "prach_roc": prach_roc,
            "eva_ablation": eva_ablation, "turbo_roofline": turbo_roofline,
            "flagship_stages": flagship_stages,
            "flagship_profile": flagship_profile,
            "scale_campaign": scale_campaign}


def reference(name: str):
    """The repo's scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fading_corpus_equals_reference():
    assert fading_campaign.CORPUS == reference("fading_campaign").CORPUS


def test_eva_ablation_cases_equal_reference():
    ref = reference("eva_ablation")
    assert eva_ablation.CASES == ref.CASES
    assert eva_ablation.REF_SCALE == ref.REF_SCALE


def test_ulsim_ladder_equals_reference():
    ref = reference("ulsim_campaign")
    for name in ("LADDER_MCS", "START_DB", "FADING", "N_TRIALS",
                 "TAIL_TRIALS", "TAIL_THRESH", "STEP_DB"):
        assert getattr(ulsim_campaign, name) == getattr(ref, name), name
    # the fading curves' start, a literal in the reference's make_cfg
    assert ref.make_cfg("eva")[1] == ulsim_campaign.FADING_START_DB


def test_doppler_grid_equals_reference():
    ref = reference("doppler_campaign")
    for name in ("CHANNELS", "DOPPLERS", "SNRS"):
        assert getattr(doppler_campaign, name) == getattr(ref, name), name


def test_scale_campaign_sizes_equal_reference():
    ref = reference("scale_campaign")
    assert scale_campaign.BATCH_PER_DEV == ref.BATCH_PER_DEV
    assert scale_campaign.N_REP == ref.N_REP
    # 1, 2 and 4 ranks on one card; the reference's virtual mesh went to 8
    assert scale_campaign.MESHES == ref.MESHES[:3]


def _literal_in(path: Path, func: str, pred):
    """The first node under `func` of the reference script for which pred
    holds."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    return next(n for n in ast.walk(fn) if pred(n))


def test_prach_configurations_equal_reference():
    node = _literal_in(ROOT / "scripts" / "prach_roc.py", "main",
                       lambda n: isinstance(n, ast.List) and len(n.elts) == 4)
    ref = eval(compile(ast.Expression(node), "prach_roc", "eval"),
               {"PrachsimConfig": JPrachsimConfig})
    assert [(n, s) for n, _, s in ref] == \
        [(n, s) for n, _, s in prach_roc.CONFIGS]
    for (_, jcfg, _), (_, fields, _) in zip(ref, prach_roc.CONFIGS):
        assert dataclasses.asdict(jcfg) == \
            dataclasses.asdict(PrachsimConfig(**fields))
    ths = _literal_in(ROOT / "scripts" / "prach_roc.py", "main",
                      lambda n: isinstance(n, ast.Call)
                      and getattr(n.func, "attr", "") == "arange")
    assert [a.value for a in ths.args] == [6.0, 30.0, 1.0]
    np.testing.assert_array_equal(prach_roc.THRESHOLDS,
                                  np.arange(6.0, 30.0, 1.0))


def test_flagship_stages_and_profile_equal_reference():
    path = ROOT / "scripts" / "flagship_stages.py"
    node = _literal_in(path, "main", lambda n: isinstance(n, ast.Assign)
                       and getattr(n.targets[0], "id", "") == "stages")
    assert ast.literal_eval(node.value) == flagship_stages.STAGES
    node = _literal_in(ROOT / "scripts" / "flagship_profile.py", "main",
                       lambda n: isinstance(n, ast.For))
    ref = eval(compile(ast.Expression(node.iter), "flagship_profile",
                       "eval"), {"dict": dict})
    assert ref == flagship_profile.VARIANTS
    for mod, name in ((flagship_stages, "flagship_stages"),
                      (flagship_profile, "flagship_profile")):
        r = reference(name)
        assert (mod.BATCH, mod.SNR) == (r.BATCH, r.SNR)


@pytest.mark.parametrize("config", ["ulsim16", "txdiv64"])
def test_fidelity_snrs_equal_reference(config):
    call = _literal_in(ROOT / "scripts" / "fidelity_campaign.py",
                       f"run_{config}",
                       lambda n: isinstance(n, ast.Call)
                       and getattr(n.func, "attr", "") == "sweep")
    assert ast.literal_eval(call.args[0]) == fidelity_campaign.SNRS[config]
    assert fidelity_campaign.CONFIGS == \
        reference("fidelity_campaign").CONFIGS


def test_awgn_corpus_data_equals_committed_campaign():
    with open(ROOT / "awgn_campaign.json") as f:
        committed = json.load(f)
    ref = reference("awgn_campaign")
    for name in ("N_TRIALS", "TAIL_TRIALS", "TAIL_THRESH", "STEP_DB"):
        assert getattr(awgn_campaign, name) == getattr(ref, name), name
    assert sorted(awgn_campaign.REF) == sorted(awgn_campaign.GRID) == \
        list(range(28))
    for mcs in range(28):
        row = committed[f"mcs{mcs}"]
        tbs, *cross = awgn_campaign.REF[mcs]
        assert tbs == row["tbs"]
        assert cross == [row["ref"][lvl] for lvl in common.LEVELS]
        assert awgn_campaign.GRID[mcs] == (row["snr"][0], row["snr"][-1])
        grid = awgn_campaign.grid(mcs)
        assert grid[0] == row["snr"][0]
        assert grid[-1] >= max(row["snr"][-1], cross[2])


CURVES = [([-1.0, 0.0, 1.0, 2.0], [1.0, 0.6, 0.05, 0.001]),
          ([0.0, 0.25, 0.5], [0.3, 0.2, 0.0]),
          ([3.0, 3.1, 3.2], [0.9, 0.8, 0.7]),
          ([5.0, 5.5], [0.0, 0.0])]


@pytest.mark.parametrize("level", [0.5, 0.1, 0.01])
@pytest.mark.parametrize("curve", range(len(CURVES)))
def test_crossing_equals_reference(curve, level):
    snrs, blers = CURVES[curve]
    want = reference("awgn_campaign").crossing(snrs, blers, level)
    assert common.crossing(snrs, blers, level) == want
    assert reference("ulsim_campaign").crossing(snrs, blers, level) == want


def _committed_keys(path: Path) -> tuple:
    with open(path) as f:
        d = json.load(f)
    return set(next(iter(d.values())))


@pytest.mark.parametrize("program", ["awgn", "ulsim"])
def test_small_run_writes_the_committed_schema_and_resumes(
        tmp_path, monkeypatch, capsys, program):
    mod = {"awgn": awgn_campaign, "ulsim": ulsim_campaign}[program]
    sel, snrs = {"awgn": ("4", "0:0.1"), "ulsim": ("awgn4", "-1:-0.75")}[
        program]
    argv = ["16", sel, f"--snr-range={snrs}", "--device", "cpu",
            "--out-dir", str(tmp_path)]
    agg = mod.main(argv, n_rb=6, batch=16)
    tag = f"mcs{sel}" if program == "awgn" else sel
    res = agg[tag]
    committed = ROOT / f"{program}_campaign.json"
    assert _committed_keys(committed) <= set(res)
    assert res["device"] == "cpu" and res["seconds"] >= 0
    assert len(res["snr"]) == 2
    csv = (tmp_path / f"{tag}.csv").read_text().splitlines()
    results_dir = {"awgn": "awgn_results", "ulsim": "ulsim_results"}[program]
    with open(ROOT / results_dir / f"{tag}.csv") as f:
        assert csv[0] == f.readline().rstrip("\n")
    assert len(csv) == 3 and all(len(r.split(";")) == 13 for r in csv)
    assert json.loads((tmp_path / f"{program}_campaign.json").read_text()) \
        == agg
    # resume: the curve's file exists, so nothing runs again
    monkeypatch.setattr(mod, "run_curve", lambda *a, **k: pytest.fail(
        "a finished curve ran again"))
    capsys.readouterr()
    assert mod.main(argv, n_rb=6, batch=16) == agg
    assert f"{tag}: exists, skipping" in capsys.readouterr().out


def test_run_each_skips_a_finished_configuration(tmp_path):
    ran = []

    def run_one(name):
        ran.append(name)
        return {"value": len(name)}

    out = common.run_each(["a", "bb"], tmp_path, run_one, "cpu")
    assert ran == ["a", "bb"] and out["bb"]["value"] == 2
    assert out["a"]["device"] == "cpu" and "seconds" in out["a"]
    (tmp_path / "a.json").write_text(json.dumps({"value": 9}))
    assert common.run_each(["a", "bb", "c"], tmp_path, run_one, "cpu")[
        "a"] == {"value": 9}
    assert ran == ["a", "bb", "c"]
    assert set(common.collect(["a", "bb", "c", "d"], tmp_path)) == \
        {"a", "bb", "c"}


PRE_PORT = ["awgn_results", "ulsim_results", "awgn_results_r4", "build",
            "scripts", "openair4g_tpu", "."]


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_default_output_is_under_results_torch(prog):
    out = common.default_out(prog)
    assert out == ROOT / "results_torch" / prog
    assert all(out != ROOT / p for p in PRE_PORT)
    assert "results_torch/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_program_without_a_card_exits_non_zero(monkeypatch, tmp_path, prog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        PROGRAMS[prog].main(["--out-dir", str(tmp_path)])
    assert exc.value.code not in (0, None)
    assert not any(tmp_path.iterdir())


def test_two_proportion_z():
    assert common.two_proportion_z(10, 100, 10, 100) == 0.0
    assert common.two_proportion_z(0, 50, 0, 80) == 0.0
    assert common.two_proportion_z(0, 50, 50, 50) == pytest.approx(10.0)
    # 0.5 against 0.4 over 1,000 each: pooled 0.45
    assert common.two_proportion_z(500, 1000, 400, 1000) == pytest.approx(
        0.1 / np.sqrt(0.45 * 0.55 * 2 / 1000))
