"""``repro_torch.analysis`` — the port's AST-based invariant linter.

The port's own copy of the JAX package's linter: the same API, the same
eight rule codes, aimed at the port's idiom (torch's global generator in
RNG01, CUDA graph captures and traces in JIT01/JIT02, the port's
registry reference in DOC01). Stdlib only (no torch, no numpy), so it
starts in milliseconds and runs where the training stack cannot import.
Rules self-register via ``@register_rule``; ``run_analysis`` is the
one-call API shared by the CLI and the tests.
"""

from repro_torch.analysis.framework import (
    Finding,
    Module,
    Project,
    RULES,
    Rule,
    load_project,
    register_rule,
    run_analysis,
    run_rules,
    select_rules,
)
from repro_torch.analysis import rules as _rules  # noqa: F401  populate RULES eagerly

__all__ = [
    "Finding",
    "Module",
    "Project",
    "RULES",
    "Rule",
    "load_project",
    "register_rule",
    "run_analysis",
    "run_rules",
    "select_rules",
]
