"""The ClientPopulation object: struct-of-arrays per-client state.

The port's counterpart of the JAX package's ``pop/population.py``, numpy
only and bit-exact with it. One population owns, for N clients and S
tasks:

  * ``eligibility`` — ONE boolean ``(S, N)`` array (task-major, so a
    task's eligible clients are contiguous); engines hold the transposed
    ``(N, S)`` view, which shares memory, so coordinator reads and
    population state never diverge.
  * ``speeds`` — the ``(N,)`` speed array (stream ``seed + 1``).
  * ``arrival`` — the arrival process (stream ``seed + 2``) with batched
    ``next_arrivals(clients, t)`` through ``ArrivalProcess.next_starts``.
  * ``cost_model`` — the latency model (stream ``seed + 3``, reset by the
    engine as without a population) with per-cohort ``sample_latencies``.
  * ``bids`` — one vectorized ``(N, S)`` bid matrix for
    ``core/auctions.py`` (``policy.draw_bids``).

Every stream is seeded as on the path without a population, and batched
draws go in client-id order, so enabling a population never changes
losses, event traces or auction outcomes. Cost models whose scalar draw
interleaves several distributions (``lognormal_straggler``) cannot be
filled as one array without reordering their stream, so
``sample_latencies`` calls the scalar ``sample_latency`` per cohort
member: O(cohort), not O(N), and bit-exact by construction. All of this
state stays numpy on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.api.arrivals import get_arrival_process
from repro_torch.api.costmodel import get_cost_model
from repro_torch.api.policy import draw_bids
from repro_torch.api.registry import POPULATIONS, register_population


class ClientPopulation:
    """Protocol for population plugins (see ``VectorizedPopulation``).

    A population is constructed by an engine from ``clients.population`` /
    ``clients.population_options`` and REPLACES the engine's per-client
    state: the engine aliases ``speeds``/``arrival``/``cost_model`` to the
    population-owned objects and mirrors its eligibility matrix into the
    ``(S, N)`` struct-of-arrays via ``set_eligibility``.
    """

    name = "population"

    def set_eligibility(self, elig_ks: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def next_arrivals(self, clients: np.ndarray, t: float) -> np.ndarray:
        raise NotImplementedError

    def sample_latencies(self, clients, task, base_durations, times=0.0, versions=0):
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        raise NotImplementedError


@register_population("vectorized")
class VectorizedPopulation(ClientPopulation):
    """Struct-of-arrays client state, bit-exact with the legacy dict path.

    ``lazy_data=True`` additionally asks the synthetic task family to
    materialize client shards on first dispatch (``repro_torch.pop.data``)
    instead of N upfront rows — required at ~1M clients, where eager
    partitions are tens of GB. Lazy shards use per-client derived RNG
    streams, so the DATA (not the simulation) differs from the eager
    path; parity tests therefore run with ``lazy_data=False``.
    """

    name = "vectorized"

    def __init__(
        self,
        n_clients: int,
        n_tasks: int,
        seed: int,
        speed_profile: str = "uniform",
        speed_spread: float = 4.0,
        slow_fraction: float = 0.5,
        arrival_process: str = "always_on",
        arrival_options: Optional[dict] = None,
        cost_model: Optional[str] = None,
        cost_model_options: Optional[dict] = None,
        lazy_data: bool = False,
        cache_rows: int = 4096,
    ):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        if cache_rows < 1:
            raise ValueError(f"cache_rows must be >= 1, got {cache_rows}")
        self.n_clients = int(n_clients)
        self.n_tasks = int(n_tasks)
        self.seed = int(seed)
        self.lazy_data = bool(lazy_data)
        self.cache_rows = int(cache_rows)
        self._options = {"lazy_data": self.lazy_data, "cache_rows": self.cache_rows}

        # identical streams to the legacy engine path: speeds seed+1,
        # arrivals seed+2; the cost model's seed+3 reset stays engine-side
        # (the engine calls reset() on the aliased instance).
        from repro_torch.fed.async_engine import client_speeds  # lazy: avoids api<->fed cycle

        self.speeds = client_speeds(
            speed_profile,
            self.n_clients,
            np.random.default_rng(self.seed + 1),
            spread=speed_spread,
            slow_fraction=slow_fraction,
        )
        self.arrival = get_arrival_process(arrival_process, dict(arrival_options or {}))
        self.arrival.reset(self.n_clients, np.random.default_rng(self.seed + 2))
        if cost_model is None and cost_model_options:
            raise ValueError(
                "cost_model_options were given without a cost_model; "
                "name one (e.g. 'device_tiers') or drop the options"
            )
        self.cost_model = get_cost_model(cost_model or "constant", dict(cost_model_options or {}))
        # SoA eligibility: (S, N) task-major; engines hold the (N, S) view
        self._elig = np.ones((self.n_tasks, self.n_clients), bool)

    # ------------------------------------------------------------ eligibility

    @property
    def eligibility(self) -> np.ndarray:
        """The coordinator-facing ``(N, S)`` view (shares memory with the
        ``(S, N)`` struct-of-arrays — writes through the view are seen)."""
        return self._elig.T

    def set_eligibility(self, elig_ks: np.ndarray) -> np.ndarray:
        """Adopt an ``(N, S)`` eligibility matrix (e.g. an auction result)
        into the SoA and return the shared ``(N, S)`` view to hold."""
        e = np.asarray(elig_ks, bool)
        if e.shape != (self.n_clients, self.n_tasks):
            raise ValueError(
                f"eligibility shape {e.shape} != ({self.n_clients}, {self.n_tasks})"
            )
        self._elig = np.ascontiguousarray(e.T)
        return self._elig.T

    # --------------------------------------------------------------- sampling

    def next_arrivals(self, clients: np.ndarray, t: float) -> np.ndarray:
        """Batched arrival sampling for ``clients`` (client-id order), one
        vectorized draw on the arrival process's own stream."""
        return self.arrival.next_starts(np.asarray(clients, np.int64), float(t))

    def sample_latencies(self, clients, task, base_durations, times=0.0, versions=0):
        """Cohort-batched latency sampling: ``(totals, dropouts)`` arrays
        (``task``/``base_durations``/``times``/``versions`` broadcast).

        Delegates to the scalar ``sample_latency`` per cohort member in
        client order — bit-exact with the legacy loop for every registered
        cost model, including those with interleaved per-call draws.
        """
        ids = np.asarray(clients, np.int64)
        n = len(ids)
        tasks = np.broadcast_to(np.asarray(task, np.int64), (n,))
        bases = np.broadcast_to(np.asarray(base_durations, np.float64), (n,))
        ts = np.broadcast_to(np.asarray(times, np.float64), (n,))
        vs = np.broadcast_to(np.asarray(versions, np.int64), (n,))
        totals = np.empty(n, np.float64)
        dropouts = np.zeros(n, bool)
        for i in range(n):
            lat = self.cost_model.sample_latency(
                int(ids[i]), int(tasks[i]), float(bases[i]), time=float(ts[i]), version=int(vs[i])
            )
            totals[i] = lat.total
            dropouts[i] = lat.dropout
        return totals, dropouts

    def bids(self, auction, budget=None, seed_offset: int = 0) -> np.ndarray:
        """Vectorized ``(N, S)`` bid matrix for this population's size
        (``budget`` is accepted for signature symmetry with the auction
        path; bids do not depend on it)."""
        del budget
        return draw_bids(auction, self.n_clients, self.n_tasks, seed_offset)

    # ------------------------------------------------------------- checkpoint

    def config_record(self) -> Dict[str, Any]:
        """The JSON config stamp engines embed in their checkpoints so a
        resume under a different population (or options) is refused."""
        return {"name": self.name, "options": dict(self._options)}

    def state_dict(self) -> Dict[str, Any]:
        """JSON-native snapshot: config + packed eligibility + the arrival
        and cost-model streams (so a standalone round-trip is exact; when
        riding an engine checkpoint the engine's own keys restore the
        aliased stream objects and eligibility is re-synced on load)."""
        e = np.ascontiguousarray(self._elig)
        out = {
            "name": self.name,
            "options": dict(self._options),
            "eligibility": {
                "shape": [int(s) for s in e.shape],
                "packed": np.packbits(e).tobytes().hex(),
            },
            "arrival": self.arrival.state_dict(),
        }
        if hasattr(self.cost_model, "rng"):  # reset() not yet called otherwise
            out["cost_model"] = self.cost_model.state_dict()
        return out

    def load_state(self, state: Dict[str, Any]) -> None:
        self.validate_config(state)
        enc = state["eligibility"]
        shape = tuple(int(s) for s in enc["shape"])
        if shape != (self.n_tasks, self.n_clients):
            raise ValueError(
                f"checkpoint eligibility shape {shape} != "
                f"({self.n_tasks}, {self.n_clients})"
            )
        bits = np.unpackbits(
            np.frombuffer(bytes.fromhex(enc["packed"]), np.uint8),
            count=shape[0] * shape[1],
        )
        self._elig = np.ascontiguousarray(bits.astype(bool).reshape(shape))
        if "arrival" in state:
            self.arrival.load_state(state["arrival"])
        if "cost_model" in state:
            self.cost_model.load_state(state["cost_model"])

    def validate_config(self, state: Dict[str, Any]) -> None:
        """Refuse to resume under a different population configuration."""
        if state.get("name", self.name) != self.name:
            raise ValueError(
                f"checkpoint population {state.get('name')!r} != configured {self.name!r}"
            )
        saved = state.get("options", {})
        if saved and dict(saved) != self._options:
            raise ValueError(
                f"checkpoint population options {saved} != configured {self._options}"
            )


def get_population(name: str, options: Optional[dict] = None, **engine_kw) -> ClientPopulation:
    """Instantiate a registered population from (name, spec options) plus
    the engine-derived keywords (sizes, seed, speed/arrival/cost config)."""
    cls = POPULATIONS.get(name)
    try:
        return cls(**engine_kw, **(options or {}))
    except TypeError as e:
        raise ValueError(f"bad options for population {name!r}: {e}") from e


__all__ = ["ClientPopulation", "VectorizedPopulation", "get_population"]
