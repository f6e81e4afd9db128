"""Multi-host initialization (SURVEY.md §2.3: jax.distributed).

Single-process multi-device needs nothing: ``HPF(mesh=...)`` over
``jax.devices()``.  Multi-host SPMD (one process per host, e.g. several
GPU hosts) needs ``jax.distributed.initialize`` before first device use;
this module wraps that and builds the global mesh.

Usage (same script on every host)::

    from hpfrec_jax.parallel import distributed
    mesh = distributed.initialize()          # env-driven (cluster launchers)
    model = HPF(k=30, mesh=mesh, shard_tables=True)
    model.fit(counts_df)                     # same data on every host

Every host must run identical code with identical data; the blocked /
ELL layouts are deterministic functions of the input, so device_put of
the globally-sharded arrays places only each host's addressable shards.
"""

from __future__ import annotations

from typing import Optional

from .mesh import make_mesh


def _already_initialized(exc: Exception) -> bool:
    return "already initialized" in str(exc).lower()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               initialization_timeout: Optional[int] = None):
    """Initialize jax.distributed (no-op if already initialized or single
    process) and return the global 1-D data mesh over all devices.

    A genuinely misconfigured multi-host job must FAIL here, not silently
    degrade to a single-host mesh that trains on 1/Nth of the devices: when
    explicit coordinator/process arguments are given, initialization errors
    propagate and the resulting ``jax.process_count()`` is checked against
    ``num_processes``.  Only the zero-argument autodetect path tolerates
    failure (it is how single-process runs reach this helper), and it says
    so at warning level."""
    import jax

    if num_processes is None and coordinator_address is None:
        # under a cluster launcher that JAX recognizes (e.g. SLURM or
        # Open MPI), jax.distributed.initialize() autodetects the job;
        # elsewhere, a single process needs nothing.
        try:
            jax.distributed.initialize()
        except Exception as e:
            if not _already_initialized(e):
                import warnings

                warnings.warn(
                    "jax.distributed autodetect did not initialize (%s); "
                    "continuing single-process. Pass coordinator_address/"
                    "num_processes/process_id explicitly for a multi-host "
                    "job." % (e,))
    else:
        kwargs = {}
        if initialization_timeout is not None:
            kwargs["initialization_timeout"] = initialization_timeout
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                **kwargs,
            )
        except Exception as e:
            if not _already_initialized(e):
                raise RuntimeError(
                    "jax.distributed.initialize failed for coordinator %r "
                    "(num_processes=%s, process_id=%s): %s"
                    % (coordinator_address, num_processes, process_id, e)
                ) from e
        if num_processes is not None and jax.process_count() != num_processes:
            raise RuntimeError(
                "jax.distributed came up with %d processes but %d were "
                "requested — refusing to train on a partial mesh."
                % (jax.process_count(), num_processes))
    return make_mesh(jax.devices())
