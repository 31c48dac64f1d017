"""Client arrival processes: WHEN a completing client can start its next
local job.

The port's counterpart of the JAX package's ``api/arrivals.py``, numpy
only and bit-exact with it. The async engine's event queue dispatches a
client's next job at its completion time; an arrival process shifts that
start to model availability. Built-ins (``ARRIVAL_PROCESSES``):

  * ``always_on`` — the FedAST default: clients train back-to-back.
  * ``bursty``    — on/off duty cycles with per-client phase: a client
    completing inside an off window idles until its next on window.
  * ``poisson``   — partial participation: after each completion the
    client rejoins after an Exp(mean_idle) gap.

Processes draw from their own Generator (the engine seeds it with
``seed + 2``), so enabling one never perturbs the allocator's stream.
``next_starts`` is the batched draw a client population makes, and
``state_dict``/``load_state`` carry the stream through checkpoints.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.registry import ARRIVAL_PROCESSES, register_arrival_process


class ArrivalProcess:
    """Protocol: ``reset`` once per run, then ``next_start`` per dispatch.

    ``next_start(client, t)`` returns the earliest virtual time >= t at
    which ``client`` may begin its next local job. ``state_dict`` /
    ``load_state`` (JSON-native) capture the RNG stream, so a resumed run
    samples mid-sequence; subclasses with more state extend both.
    """

    def reset(self, n_clients: int, rng: np.random.Generator) -> None:
        self.n_clients = n_clients
        self.rng = rng

    def next_start(self, client: int, t: float) -> float:
        raise NotImplementedError

    def next_starts(self, clients: np.ndarray, t: float) -> np.ndarray:
        """Batched ``next_start`` over ``clients`` (client-id order). The
        default calls the scalar method per client; an override must draw
        from the stream exactly as that loop does (a numpy Generator fills
        an array element by element, so ``rng.exponential(size=n)`` equals
        n scalar draws)."""
        return np.array([self.next_start(int(c), t) for c in clients], np.float64)

    def state_dict(self) -> dict:
        return {"rng_state": self.rng.bit_generator.state}

    def load_state(self, state: dict) -> None:
        if "rng_state" in state:
            self.rng.bit_generator.state = state["rng_state"]


@register_arrival_process("always_on")
class AlwaysOn(ArrivalProcess):
    """Clients are always available."""

    def next_start(self, client: int, t: float) -> float:
        return t

    def next_starts(self, clients: np.ndarray, t: float) -> np.ndarray:
        return np.full(len(clients), float(t), np.float64)


@register_arrival_process("bursty")
class Bursty(ArrivalProcess):
    """On/off availability windows with a random per-client phase: each
    client cycles through ``period`` time units of which the first
    ``duty * period`` are "on"; a job may only START inside an on window."""

    def __init__(self, period: float = 8.0, duty: float = 0.5):
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        self.period = float(period)
        self.duty = float(duty)

    def reset(self, n_clients: int, rng: np.random.Generator) -> None:
        super().reset(n_clients, rng)
        self._phase = rng.uniform(0.0, self.period, size=n_clients)

    def next_start(self, client: int, t: float) -> float:
        pos = (t - self._phase[client]) % self.period
        if pos < self.duty * self.period:
            return t
        return t + (self.period - pos)

    def next_starts(self, clients: np.ndarray, t: float) -> np.ndarray:
        pos = (t - self._phase[np.asarray(clients, np.int64)]) % self.period
        return np.where(pos < self.duty * self.period, t, t + (self.period - pos))

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["phase"] = self._phase.tolist()
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if "phase" in state:
            self._phase = np.asarray(state["phase"], np.float64)


@register_arrival_process("poisson")
class PoissonParticipation(ArrivalProcess):
    """Poisson partial participation: Exp(mean_idle) gap per completion."""

    def __init__(self, mean_idle: float = 2.0):
        if mean_idle < 0:
            raise ValueError(f"mean_idle must be >= 0, got {mean_idle}")
        self.mean_idle = float(mean_idle)

    def next_start(self, client: int, t: float) -> float:
        if self.mean_idle == 0.0:
            return t
        return t + float(self.rng.exponential(self.mean_idle))

    def next_starts(self, clients: np.ndarray, t: float) -> np.ndarray:
        if self.mean_idle == 0.0:
            return np.full(len(clients), float(t), np.float64)
        # one array fill == len(clients) scalar draws on the same stream
        return t + self.rng.exponential(self.mean_idle, size=len(clients))


def get_arrival_process(name: str, options: dict | None = None) -> ArrivalProcess:
    """Instantiate a registered arrival process from (name, options)."""
    cls = ARRIVAL_PROCESSES.get(name)
    return cls(**(options or {}))
