"""CLI smoke tests (in-process main())."""

import json

import pytest

from sdfs_via_autodiff_tpu.cli import main


@pytest.mark.fast


def test_info(capsys):
    assert main(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "version" in out and "backend" in out


def test_solve_discrete_and_simulate(tmp_path, capsys):
    ckpt = str(tmp_path / "c.npz")
    rc = main(["solve", "ssy", "--kind", "continuous",
               "--shapes", "4,4,4,6", "--algorithm", "newton",
               "--tol", "1e-8", "--checkpoint", ckpt])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["converged"] is True
    assert out["w_min"] > 1

    rc = main(["simulate", "ssy", "--checkpoint", ckpt, "--steps", "5000"])
    assert rc == 0
    sim = json.loads(capsys.readouterr().out)
    assert sim["w_std"] > 0

    # Pricing from the same checkpoint: E[M'] in (0, 1) near the mean
    # state and a finite risk-free rate consistent with it.
    rc = main(["price", "--checkpoint", ckpt, "--quad-degree", "3"])
    assert rc == 0
    pr = json.loads(capsys.readouterr().out)
    assert 0.0 < pr["expected_sdf"] < 1.0
    assert abs(pr["risk_free_rate"] + __import__("math").log(
        pr["expected_sdf"])) < 1e-6

    rc = main(["price", "--checkpoint", ckpt, "--quad-degree", "3",
               "--state", "0.01,0,0,0"])
    assert rc == 0
    pr2 = json.loads(capsys.readouterr().out)
    assert pr2["state"] == [0.01, 0, 0, 0]
    assert pr2["expected_sdf"] != pr["expected_sdf"]


@pytest.mark.fast


def test_solve_discrete_small(capsys):
    rc = main(["solve", "gcy", "--kind", "discrete",
               "--shapes", "2,2,2,2,2,2", "--algorithm", "newton",
               "--tol", "1e-8"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["converged"] is True


def test_bad_model():
    with pytest.raises(SystemExit):
        main(["solve", "bad", "--shapes", "2,2"])


def test_gcy_continuous_cli_and_simulate(tmp_path, capsys):
    ckpt = str(tmp_path / "gcy.npz")
    rc = main(["solve", "gcy", "--kind", "continuous",
               "--shapes", "3,3,3,3,4,3", "--algorithm", "newton",
               "--tol", "1e-7", "--quad-degree", "3",
               "--checkpoint", ckpt])
    assert rc == 0
    json.loads(capsys.readouterr().out)
    rc = main(["simulate", "gcy", "--checkpoint", ckpt, "--steps", "3000"])
    assert rc == 0
    sim = json.loads(capsys.readouterr().out)
    assert sim["model"] == "GCY" and sim["w_std"] >= 0


def test_check_command(capsys):
    rc = main(["check", "ssy", "--kind", "discrete", "--shapes", "3,3,3,3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["exists_unique"] is True
    assert out["stability_exponent"] < 1


def test_solve_degroot_spec(capsys):
    rc = main(["solve", "ssy", "--kind", "discrete", "--shapes", "3,3,3,3",
               "--spec", "degroot", "--tol", "1e-10"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["spec"] == "degroot" and out["converged"] is True
    assert out["log_g_min"] <= out["log_g_mean"] <= out["log_g_max"]


def test_check_degroot_spec(capsys):
    # The alternative-specification existence check rides the same
    # subcommand: S~ = ln beta + ln sup h + ln r(K~)/theta.
    rc = main(["check", "ssy", "--kind", "discrete", "--shapes", "3,3,3,3",
               "--spec", "degroot", "--h", "0.97"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["spec"] == "degroot" and out["h_sup"] == 0.97
    assert out["exists_unique"] is True
    assert out["stability_exponent"] < 0


def test_cli_solve_tauchen_discrete(tmp_path, capsys):
    # The tauchen discretization option round-trips through the CLI.
    import json

    from sdfs_via_autodiff_tpu.cli import main
    rc = main(["solve", "ssy", "--kind", "discrete", "--shapes", "4,4,4,6",
               "--discretization", "tauchen", "--algorithm", "newton",
               "--tol", "1e-9"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] and out["iterations"] > 0


def test_grad_command(capsys):
    rc = main(["grad", "ssy", "--shapes", "4,4,4,4", "--fields",
               "beta,gamma", "--quad-degree", "3", "--tol", "1e-9"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["moment"] == "mean_log_w"
    assert set(out["grad"]) == {"beta", "gamma"}
    # beta -> 1 blows up w, so the beta-gradient of mean log w is large
    # and positive; gamma raises risk aversion and lowers w.
    assert out["grad"]["beta"] > 10
    assert out["grad"]["gamma"] < 0


def test_checkpoint_consumers_use_stored_calibration(tmp_path):
    # simulate/price must reconstruct the EXACT calibration a checkpoint
    # was solved at (a non-default checkpoint priced under default
    # dynamics is silently wrong), and must refuse de Groot checkpoints
    # whose stored field is ln g*, not w*.
    import dataclasses

    from sdfs_via_autodiff_tpu import SSY
    from sdfs_via_autodiff_tpu.cli import _model_from_ckpt, \
        _reject_degroot_ckpt
    from sdfs_via_autodiff_tpu.drivers import (degroot_fixed_point,
                                               wc_ratio_discrete)
    from sdfs_via_autodiff_tpu.utils.checkpoint import load_solution

    tweaked = dataclasses.replace(SSY(), gamma=9.5, beta=0.9985)
    path = str(tmp_path / "wc.npz")
    wc_ratio_discrete(tweaked, (3, 3, 3, 3), tol=1e-8,
                      checkpoint_path=path)
    ckpt = load_solution(path)
    m = _model_from_ckpt(ckpt)
    assert m.gamma == 9.5 and m.beta == 0.9985
    _reject_degroot_ckpt(ckpt, "simulate")      # standard ckpt: no-op

    dpath = str(tmp_path / "dg.npz")
    degroot_fixed_point(SSY(), (3, 3, 3, 3), tol=1e-8,
                        checkpoint_path=dpath)
    with pytest.raises(SystemExit, match="ln g"):
        _reject_degroot_ckpt(load_solution(dpath), "price")


def test_solve_degroot_rejects_unsupported_flags(capsys):
    with pytest.raises(SystemExit, match="--baseline"):
        main(["solve", "ssy", "--shapes", "3,3,3,3", "--spec", "degroot",
              "--baseline", "loglinear"])
    with pytest.raises(SystemExit, match="--polish"):
        main(["solve", "ssy", "--shapes", "3,3,3,3", "--spec", "degroot",
              "--polish"])


def test_check_shapes_count_validated():
    with pytest.raises(SystemExit, match="6 comma-separated"):
        main(["check", "gcy", "--kind", "continuous",
              "--shapes", "10,10,10,10"])
