"""The solve path stays on the device it is given: the compile cache's
location, the float64 polish stage's placement, and the refusal of the
removed kernel options."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from sdfs_via_autodiff_tpu import SSY, wc_ratio_continuous, wc_ratio_discrete
from sdfs_via_autodiff_tpu.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PRINT_CACHE = ("import jax, sdfs_via_autodiff_tpu; "
                "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir_in_child(**env):
    env = {k: v for k, v in dict(os.environ, **env).items() if v is not None}
    out = subprocess.run([sys.executable, "-c", _PRINT_CACHE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env_variable(tmp_path):
    assert _cache_dir_in_child(JAX_PLATFORMS="cpu",
                               JAX_COMPILATION_CACHE_DIR=str(tmp_path)) \
        == str(tmp_path)


def test_compile_cache_defaults_to_fixed_path_in_checkout():
    got = _cache_dir_in_child(JAX_PLATFORMS="cpu",
                              JAX_COMPILATION_CACHE_DIR=None)
    assert got == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.fixture
def accelerator_backend(monkeypatch):
    """Pretend the default backend is an accelerator: a polish stage that
    moved itself to the host CPU would then leave the given device."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    return jax.devices()[1]


def test_discrete_polish_runs_on_default_device(accelerator_backend):
    with jax.default_device(accelerator_backend):
        sol = wc_ratio_discrete(SSY(), (3, 3, 3, 4), tol=1e-9,
                                dtype=jnp.float32, polish=True)
    assert sol.converged and sol.w_star.dtype == jnp.float64
    assert sol.w_star.devices() == {accelerator_backend}


def test_continuous_polish_runs_on_default_device(accelerator_backend):
    with jax.default_device(accelerator_backend):
        sol = wc_ratio_continuous(SSY(), (3, 3, 3, 4), quad_degree=3,
                                  tol=1e-9, dtype=jnp.float32, polish=True)
    assert sol.converged and sol.w_star.dtype == jnp.float64
    assert sol.w_star.devices() == {accelerator_backend}


def test_drivers_refuse_removed_kernel_options():
    with pytest.raises(TypeError, match="kernel"):
        wc_ratio_discrete(SSY(), (3, 3, 3, 3), kernel="tiled")
    with pytest.raises(TypeError, match="kernel"):
        wc_ratio_continuous(SSY(), (3, 3, 3, 3), quad_degree=3,
                            kernel="tiled")
    for algorithm in ("fused_sa", "fused_anderson"):
        with pytest.raises(ValueError, match="unknown method"):
            wc_ratio_continuous(SSY(), (3, 3, 3, 3), quad_degree=3,
                                algorithm=algorithm)
    with pytest.raises(ValueError, match="polish"):
        wc_ratio_continuous(SSY(), (3, 3, 3, 3), polish="host")


@pytest.mark.parametrize("argv", [
    ["--kernel", "tiled"], ["--algorithm", "fused_sa"],
    ["--algorithm", "fused_anderson"], ["--polish", "host"]])
def test_cli_refuses_removed_options(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["solve", "ssy", "--shapes", "3,3,3,3"] + argv)
    assert exc.value.code == 2
    assert "error" in capsys.readouterr().err
