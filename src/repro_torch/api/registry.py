"""String-keyed extension registries for the port's scenario API.

The same ``Registry`` class as the JAX package's ``api/registry.py``.
It defines the registries of the ported slices: allocators, arrival
processes, auctions, task families, backends, policies, incentives,
buffer controllers, aggregators, cost models and client populations,
and renders them as the port's registry reference
(``python -m repro_torch.api.registry --dump-markdown``, committed as
``docs/REGISTRY_TORCH.md``). This module imports nothing of the package,
so built-in implementations can self-register at import time without
cycles.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class Registry:
    """A named string -> object mapping with decorator registration."""

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Any], Any]:
        """Decorator: ``@REG.register("key")`` registers the decorated
        object under ``key`` and returns it unchanged."""

        def deco(obj: Any) -> Any:
            if name in self._items and self._items[name] is not obj:
                raise ValueError(f"duplicate {self.kind} registration: {name!r}")
            self._items[name] = obj
            return obj

        return deco

    def add(self, name: str, obj: Any) -> Any:
        """Non-decorator registration (e.g. enum members)."""
        return self.register(name)(obj)

    def get(self, name: str) -> Any:
        """Lookup; unknown keys raise with the list of valid names."""
        try:
            return self._items[name]
        except KeyError:
            valid = ", ".join(self.names()) or "(none)"
            raise KeyError(f"unknown {self.kind} {name!r}; registered: {valid}") from None

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __len__(self) -> int:
        return len(self._items)


ALLOCATORS = Registry("allocator")
ARRIVAL_PROCESSES = Registry("arrival_process")
AUCTIONS = Registry("auction")
TASK_FAMILIES = Registry("task_family")
BACKENDS = Registry("backend")
POLICIES = Registry("policy")
INCENTIVES = Registry("incentive")
BUFFER_CONTROLLERS = Registry("buffer_controller")
AGGREGATORS = Registry("aggregator")
COST_MODELS = Registry("cost_model")
POPULATIONS = Registry("population")

register_allocator = ALLOCATORS.register
register_arrival_process = ARRIVAL_PROCESSES.register
register_auction = AUCTIONS.register
register_task_family = TASK_FAMILIES.register
register_backend = BACKENDS.register
register_policy = POLICIES.register
register_incentive = INCENTIVES.register
register_buffer_controller = BUFFER_CONTROLLERS.register
register_aggregator = AGGREGATORS.register
register_cost_model = COST_MODELS.register
register_population = POPULATIONS.register


# ------------------------------------------------------- docs generation

def _entry_options(obj: Any) -> str:
    """Best-effort constructor-option summary for one registered object:
    ``name=default`` pairs from the signature (classes use ``__init__``),
    or ``—`` for option-free entries (enum members, bare callables)."""
    import enum
    import inspect

    if isinstance(obj, enum.Enum):
        return "—"
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return "—"
    parts = []
    for p in sig.parameters.values():
        if p.name in ("self", "args", "kwargs"):
            continue
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.default is p.empty:
            parts.append(f"`{p.name}`")
        else:
            parts.append(f"`{p.name}={p.default!r}`")
    return ", ".join(parts) or "—"


def _entry_summary(obj: Any) -> str:
    """First docstring line of a registered object (empty if none).
    ``functools.partial`` wrappers unwrap to their target; enum members
    (whose ``__doc__`` is the class boilerplate) show member identity."""
    import enum
    import functools

    while isinstance(obj, functools.partial):
        obj = obj.func
    if isinstance(obj, enum.Enum):
        return f"`{type(obj).__name__}.{obj.name}` enum member"
    doc = getattr(obj, "__doc__", None) or ""
    first = doc.strip().splitlines()[0].strip() if doc.strip() else ""
    return first.replace("|", "\\|")


def dump_markdown() -> str:
    """Render every populated registry as a markdown reference.

    Deterministic (registries and keys are iterated sorted), so
    ``docs/REGISTRY_TORCH.md`` can be regenerated and diffed in CI.
    Importing ``repro_torch.api`` and ``repro_torch.api.engine`` (which
    registers the task families) is the caller's job; see ``python -m
    repro_torch.api.registry --dump-markdown``.
    """
    registries = [
        ("allocator", ALLOCATORS),
        ("arrival_process", ARRIVAL_PROCESSES),
        ("auction", AUCTIONS),
        ("task_family", TASK_FAMILIES),
        ("backend", BACKENDS),
        ("policy", POLICIES),
        ("incentive", INCENTIVES),
        ("buffer_controller", BUFFER_CONTROLLERS),
        ("aggregator", AGGREGATORS),
        ("cost_model", COST_MODELS),
        ("population", POPULATIONS),
    ]
    lines = [
        "# Registry reference (PyTorch port)",
        "",
        "<!-- GENERATED FILE — do not edit by hand. Regenerate with: -->",
        "<!--   PYTHONPATH=src python -m repro_torch.api.registry "
        "--dump-markdown > docs/REGISTRY_TORCH.md -->",
        "",
        "Every pluggable axis of an MMFL scenario is a string-keyed",
        "registry (`repro_torch/api/registry.py`); specs select entries by",
        "key. The axes and keys are the JAX package's (`docs/REGISTRY.md`);",
        "the execution backends also take the `device` they run on.",
        "",
    ]
    for kind, reg in registries:
        lines.append(f"## {kind} (`register_{kind}`)")
        lines.append("")
        lines.append("| key | options | summary |")
        lines.append("|---|---|---|")
        for name in reg.names():
            obj = reg._items[name]
            lines.append(
                f"| `{name}` | {_entry_options(obj)} | {_entry_summary(obj)} |"
            )
        lines.append("")
    lines += [
        "## Runtime defaults",
        "",
        "* `runtime.buffer_size` left unset derives a backend-aware default via",
        "  `resolve_buffer_size`: 4 (the FedAST paper default) on the `serial`",
        "  backend and custom backends, and on `vmap`/`sharded` the larger of 4",
        "  and the number of devices of the run's device type (the CUDA cards,",
        "  `torch.cuda.device_count()`, for the default device; 1 on the CPU), so",
        "  a flush can fill the cards. An explicit value must be >= 1.",
        "* `clients.population` selects a registered population (`vectorized`)",
        "  that holds all per-client state as struct-of-arrays; options such as",
        '  `{"lazy_data": true}` go in `clients.population_options` and require',
        "  a named population.",
        "",
    ]
    return "\n".join(lines)


def _main(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.api.registry")
    ap.add_argument(
        "--dump-markdown",
        action="store_true",
        help="print the generated registry reference (docs/REGISTRY_TORCH.md)",
    )
    args = ap.parse_args(argv)
    if not args.dump_markdown:
        ap.error("nothing to do; pass --dump-markdown")
    # populate every registry: repro_torch.api registers the spec-level
    # axes, repro_torch.api.engine the task families. Dump from the
    # canonical module: under ``python -m`` this file runs as
    # ``__main__``, whose registries the registrations never touched.
    import sys

    import repro_torch.api  # noqa: F401
    import repro_torch.api.engine  # noqa: F401
    from repro_torch.api import registry as canonical

    sys.stdout.write(canonical.dump_markdown())
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised by the drift test
    import sys

    sys.exit(_main(sys.argv[1:]))
