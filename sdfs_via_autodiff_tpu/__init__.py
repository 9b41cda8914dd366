"""Recursive-utility asset-pricing solver library.

Computes wealth-consumption ratios and stochastic discount factors for
long-run-risk models (SSY, GCY) by solving the Koopmans fixed point

    T(w) = 1 + beta * (H w^theta)^(1/theta)

with autodiff-powered solvers in JAX, run on an NVIDIA GPU or the CPU.
Capability parity target: jstac/sdfs_via_autodiff (see SURVEY.md).
"""

from . import config  # noqa: F401  (enables x64 support at import)

from .models import SSY, GCY, ssy_loglinear_factory, gcy_loglinear_factory
from .operators import (
    SSYDiscretization, discretize_ssy, T_ssy_factory, dense_H_ssy,
    GCYDiscretization, discretize_gcy, T_gcy_factory, dense_H_gcy,
    next_state_ssy, T_ssy_continuous_factory,
    next_state_gcy, T_gcy_continuous_factory,
)
from .ops import build_grid_ssy, build_grid_gcy
from .drivers import (WCSolution, wc_ratio_discrete, wc_ratio_continuous,
                      wc_ratio_continuation, wc_ratio_sweep,
                      wc_ratio_differentiable, prolong_w,
                      DeGrootSolution, degroot_fixed_point)
from .sdf import (construct_wstar_callable, simulate_states,
                  simulated_w_moments, one_step_w_moments, sdf_factory_ssy,
                  expected_sdf_ssy, risk_free_rate_ssy,
                  sdf_factory_gcy, expected_sdf_gcy, risk_free_rate_gcy)
from .calibrate import calibrate_moments, one_step_moments_differentiable
from .utils import (save_solution, load_solution, existence_check,
                    stability_decomposition)
from .solvers import (
    SolveResult, solve, solver, successive_approx, newton_solver,
    anderson_solver, gradient_solver,
)

__version__ = "0.1.0"
