"""hpfrec_jax — Hierarchical Poisson Factorization on JAX (GPU or CPU).

A from-scratch JAX/XLA implementation of Hierarchical Poisson Factorization
(Gopalan, Hofman & Blei, UAI 2015) for implicit-count recommender data, with
the full capability surface of the CPU reference package ``hpfrec``
(reference ``hpfrec/__init__.py:11``): full-batch mean-field CAVI,
mini-batch stochastic variational inference, four stopping criteria,
incremental updates (``partial_fit``, ``add_user``, ``predict_factors``),
and a serving path (``predict``, ``topN``, ``eval_llk``).

Design: the per-nonzero multinomial E-step (phi) and the Gamma shape sums
are fused into dense fixed-order reductions over a degree-bucketed (ELL)
layout of each side; factor tables live in a functional ``VariationalState`` pytree;
multi-device scaling is SPMD over a ``jax.sharding.Mesh`` (nonzero blocks
sharded, tables replicated, psum of segment-sum contributions).
"""

__version__ = "0.1.0"

from .models.hpf import HPF  # noqa: F401

__all__ = ["HPF", "__version__"]
