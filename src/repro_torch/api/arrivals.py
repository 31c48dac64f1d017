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
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.registry import ARRIVAL_PROCESSES, register_arrival_process


class ArrivalProcess:
    """Protocol: ``reset`` once per run, then ``next_start`` per dispatch.

    ``next_start(client, t)`` returns the earliest virtual time >= t at
    which ``client`` may begin its next local job. (The reference's
    batched ``next_starts`` comes with client populations, and
    ``state_dict``/``load_state`` with checkpointing.)
    """

    def reset(self, n_clients: int, rng: np.random.Generator) -> None:
        self.n_clients = n_clients
        self.rng = rng

    def next_start(self, client: int, t: float) -> float:
        raise NotImplementedError


@register_arrival_process("always_on")
class AlwaysOn(ArrivalProcess):
    """Clients are always available."""

    def next_start(self, client: int, t: float) -> float:
        return t


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


def get_arrival_process(name: str, options: dict | None = None) -> ArrivalProcess:
    """Instantiate a registered arrival process from (name, options)."""
    cls = ARRIVAL_PROCESSES.get(name)
    return cls(**(options or {}))
