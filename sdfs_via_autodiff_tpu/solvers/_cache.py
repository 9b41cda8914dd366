"""Per-operator compilation cache for the solvers.

``solve`` is typically called repeatedly with the same operator closure
(warm starts, tolerance sweeps, benchmarking).  Naively wrapping the solver
loop in a fresh ``jax.jit`` on every call would re-trace and re-compile each
time — seconds to minutes per call for the large solver loops.
Solvers instead build their jitted loop once per (operator, static-config)
pair, keyed weakly on the operator closure so cached executables die with
the operator; dynamic quantities (initial guess, tolerance, max_iter) are
traced arguments, so changing them never recompiles.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Hashable

_CACHE: "weakref.WeakKeyDictionary[Callable, dict]" = weakref.WeakKeyDictionary()


def cached_build(anchor: Callable, key: Hashable, builder: Callable[[], Any]):
    """Return ``builder()`` memoized under (anchor, key).

    ``anchor`` is held weakly; objects that don't support weak references
    fall back to building uncached.
    """
    try:
        per = _CACHE.get(anchor)
    except TypeError:
        return builder()
    if per is None:
        per = {}
        try:
            _CACHE[anchor] = per
        except TypeError:
            return builder()
    if key not in per:
        per[key] = builder()
    return per[key]
