"""Vectorized client populations (struct-of-arrays per-client state).

The port's counterpart of the JAX package's ``pop``: eligibility, speed
tiers, arrival streams, auction bids, cost-model sampling and (optionally)
lazily materialised data shards as flat numpy arrays on the host, so
scenarios scale to 100k-1M synthetic clients at O(cohort) + O(N)
vectorized work a round. The ``vectorized`` population owns the same
streams the engines seed without one (speeds ``seed+1``, arrivals
``seed+2``, cost model ``seed+3``) and draws them in the same client-id
order, so enabling it is bit-exact with the path without a population.
"""

from repro_torch.pop.data import LazyFedTask  # noqa: F401
from repro_torch.pop.population import (ClientPopulation,  # noqa: F401
                                        VectorizedPopulation, get_population)

__all__ = ["ClientPopulation", "LazyFedTask", "VectorizedPopulation", "get_population"]
