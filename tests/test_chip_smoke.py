"""``chip_smoke.py`` on the CPU: its refusal to run off a GPU, its result
line, and the mechanics and check arithmetic of each phase at tiny sizes.

The reference anchors hold only at the reference's own sizes, so these
tests check what each phase computes and how it gates, not the anchors;
the card runs the script itself.
"""

import json
import math
import os
import subprocess
import sys
import types

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _by_name(checks):
    return {c.name: c for c in checks}


def test_refuses_cpu_platform():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert "not a GPU" in lines[-1]
    assert '"ok"' not in out.stdout


def test_result_line_format():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line(dev, 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_card_names_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert chip_smoke.card_names().startswith("nvidia-smi unavailable")


@pytest.mark.parametrize("value,tol,ok", [
    (1e-12, 1e-10, True), (1e-10, 1e-10, True), (2e-10, 1e-10, False),
    (math.nan, 1e-10, False), (math.inf, 1.0, False)])
def test_check_gates_on_finite_value_within_tol(value, tol, ok):
    assert chip_smoke.Check("c", value, tol).ok is ok


@pytest.mark.parametrize("checks,ok", [
    ([chip_smoke.Check("c", 0.0, 1.0)], True),
    ([chip_smoke.Check("c", 0.0, 1.0), chip_smoke.Check("d", 2.0, 1.0)],
     False)])
def test_run_phase_line_gates_and_reports_memory(capsys, checks, ok):
    assert chip_smoke.run_phase("PX", lambda: ({"n": 1}, checks)) is ok
    name, payload = capsys.readouterr().out.strip().split(" ", 1)
    line = json.loads(payload)
    assert name == "PX" and line["ok"] is ok and line["result"] == {"n": 1}
    assert {"peak_bytes_in_use", "peak_set_by_phase",
            "bytes_in_use_after"} <= set(line)


def test_run_phase_reports_exception_as_failure(capsys):
    def broken():
        raise RuntimeError("boom")
    assert chip_smoke.run_phase("PX", broken) is False
    assert capsys.readouterr().out.startswith("PX FAILED RuntimeError: boom")


def test_p1_discrete_ssy_mechanics():
    rec, checks = chip_smoke.phase_discrete_ssy(shapes=(4, 4, 4, 4))
    assert rec["points"] == 256 and rec["converged"]
    assert rec["first_call_s"] > 0 and rec["second_call_s"] > 0
    c = _by_name(checks)
    assert c["factored_vs_broadcast_sup_log_w"].ok
    assert c["residual_under_broadcast_sup_log_w"].ok
    assert c["residual_under_broadcast_sup_log_w"].tol == 1e-7


def test_p2_discrete_gcy_mechanics():
    rec, checks = chip_smoke.phase_discrete_gcy(shapes=(2,) * 6)
    assert rec["points"] == 64 and rec["converged"]
    (check,) = checks
    assert check.ok and check.value < 1e-10


def test_p3_continuous_ssy_mechanics():
    # Anchors of 1.0 cannot hold; the checks must report the relative
    # errors of the computed moments against them, and fail.
    recs, checks = chip_smoke.phase_continuous_ssy(
        cases=(((4, 4, 4, 4), 3.2, 3, (1.0, 1.0)),), num_draws=1000)
    (rec,) = recs
    c = _by_name(checks)
    assert c["4x4x4x4_converged"].ok
    assert c["4x4x4x4_mean_rel_err"].value == pytest.approx(rec["mean"] - 1)
    assert c["4x4x4x4_std_rel_err"].value == pytest.approx(
        abs(rec["std"] - 1))
    assert not c["4x4x4x4_mean_rel_err"].ok


def test_p4_scale_checks_on_host_cpu():
    rec, checks = chip_smoke.phase_scale(shapes=(6, 6, 6, 6))
    assert rec["points"] == 6 ** 4 and rec["converged"]
    (check,) = checks
    assert check.name == "residual_on_host_cpu_sup_log_w" and check.ok


def test_p5_plain_chain_mechanics():
    rec, checks = chip_smoke.phase_plain_chain(shapes=(6, 6, 6, 8),
                                               n_apps=2, n_calls=2)
    assert rec["f64_ms_per_app"] > 0 and rec["f32_ms_per_app"] > 0
    c = _by_name(checks)
    assert c["f64_output_nonfinite_count"].ok
    assert c["f32_output_nonfinite_count"].ok
    assert c["f32_vs_f64_sup_log_w"].ok
    assert c["f32_vs_f64_sup_log_w"].value > 0      # f32 is not f64


def test_sharded_phase_on_four_virtual_devices():
    rec, checks = chip_smoke.phase_sharded(n_devices=4, shapes=(8, 4, 4, 4))
    assert rec["mesh"] == {"dp": 4, "tp": 1}
    assert "dp" in rec["iterate_spec"]
    assert len(rec["peak_bytes_per_device"]) == 4
    assert all(c.ok for c in checks), [c.as_dict() for c in checks]
