"""Tracing / profiling helpers (SURVEY.md §5).

The reference's only instrumentation is wall-clock timing of the
optimization loop (``cython_loops.pxi:223, 404-406``).  Here:

* ``maybe_trace(dir)`` — wraps a region in ``jax.profiler.trace`` so the
  fit can be inspected in TensorBoard / Perfetto (XLA op-level timeline).
* ``FitStats`` — per-fit throughput accounting (iterations, wall time,
  nonzeros/sec) surfaced on the model as ``fit_stats_`` after ``fit``.
* ``enable_compilation_cache()`` — persistent on-disk XLA executable
  cache, so a repeat fit, bench or restart loads the catalog-scale
  training program instead of compiling it again.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

# The cache directory when JAX_COMPILATION_CACHE_DIR is not set: one fixed
# path beside the package (the repository root in a checkout).  The path
# is part of the cache key, so it must not move between processes.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

_CACHE_ENABLED = False


def enable_compilation_cache() -> bool:
    """Turn on JAX's persistent compilation cache.  Idempotent; returns
    True when the cache is active.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    it is left alone.  Otherwise the cache lives at ``DEFAULT_CACHE_DIR``.
    ``HPFREC_XLA_CACHE=0`` (or ``off``, or empty) turns the cache off."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED:
        return True
    if os.environ.get("HPFREC_XLA_CACHE") in ("", "0", "off"):
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _CACHE_ENABLED = True
    return True


@contextlib.contextmanager
def maybe_trace(profile_dir):
    if profile_dir:
        import jax

        with jax.profiler.trace(profile_dir):
            yield
    else:
        yield


@dataclass
class FitStats:
    """End-to-end fit statistics (the ``HPF.fit_stats_`` attribute).

    ``wall_seconds`` spans the whole ``fit`` call, INCLUDING the host data
    layer, jit compiles, warm-up dispatches, and convergence evaluations,
    so ``nnz_per_second`` is an end-to-end figure — a lower bound on the
    steady-state device throughput, not a kernel benchmark.

    ``phases`` attributes each segment of the wall time (seconds):

    - ``reindex``        host triplet ingest + factorize reindex
    - ``valset``         validation-set mapping + device buffers
    - ``host_pack``      CSR builds + ELL packing + in-row sort (the two
      sides run in parallel threads; this is the span, not the CPU sum)
    - ``transfer``       host->device upload of the packed layouts and
      the initial state.  By default uploads are enqueued async and
      overlap the first dispatch's compile, so this phase records only
      the enqueue and the wait shows up under ``compile_and_warmup``;
      set ``HPFREC_PROFILE_TRANSFERS=1`` to wait for the upload here
    - ``compile_and_warmup``  first dispatch: jit compile (or persistent
      cache load), any in-flight transfers, first iteration
    - ``device``         all further optimization dispatches
    - ``metric_checks``  convergence evaluations + the final metric

    ``wall_seconds - sum(phases.values())`` is unattributed glue (id
    dicts, checkpoint writes, Python overhead).  SVI fits reuse the same
    names with epoch granularity: each epoch's dispatch loop lands in
    ``device`` (first-epoch compiles included — SVI has no separate
    warm-up dispatch), CSR staging in ``transfer``."""

    nnz: int = 0
    iterations: int = 0
    wall_seconds: float = 0.0
    phases: dict = field(default_factory=dict)
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.time()
        return self

    def stop(self, iterations: int):
        self.wall_seconds = time.time() - self._t0
        self.iterations = iterations
        return self

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate the wrapped region's wall time under ``name``."""
        t0 = time.time()
        try:
            yield
        finally:
            self.add_phase(name, time.time() - t0)

    def add_phase(self, name: str, seconds: float):
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    @property
    def nnz_per_second(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.nnz * self.iterations / self.wall_seconds

    def phase_report(self) -> str:
        """One line per phase, largest first, with share of wall time."""
        if not self.phases or self.wall_seconds <= 0:
            return ""
        lines = []
        for name, s in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append("  %-20s %8.2fs  (%4.1f%%)"
                         % (name, s, 100.0 * s / self.wall_seconds))
        other = self.wall_seconds - sum(self.phases.values())
        lines.append("  %-20s %8.2fs  (%4.1f%%)"
                     % ("(unattributed)", other,
                        100.0 * other / self.wall_seconds))
        return "\n".join(lines)
