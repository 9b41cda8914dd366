"""Global configuration: float64 support and the persistent compile cache.

The reference code forces 64-bit floats at import time in every JAX file
(reference ``code/solvers.py:9-11``, ``code/ssy/discrete/ssy_wc_ratio.py:19-20``,
``code/ssy/continuous_junnan/ssy_wc_ratio_continuous.py:17``).  We keep that
behaviour — x64 is *enabled* so float64 arrays are representable — but unlike
the reference we make the working dtype an explicit argument everywhere:
float64 by default (native IEEE on the GPU and the CPU), float32 on request.
"""

from __future__ import annotations

import os

import jax

# Enable 64-bit support once, at package import.  This only widens the set of
# representable dtypes; code below always passes dtypes explicitly.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR by
# itself; where it is not set, the cache lives at one fixed path inside the
# checkout, so every process run from it finds what an earlier one compiled.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
