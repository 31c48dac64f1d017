"""The port's invariant rule set: each rule encodes one standing
convention of the port as a machine-checked static invariant. The eight
codes are the JAX package's: RP01, RNG02, CKPT01 and CKPT02 keep its
logic; RNG01 also knows torch's module-global generator; JIT01/JIT02 aim
at the bodies the port captures in a CUDA graph or traces once; DOC01
checks ``docs/REGISTRY_TORCH.md``. Rule docstrings are the canonical
catalog: ``python -m repro_torch.analysis --dump-markdown`` regenerates
``docs/ANALYSIS_TORCH.md`` from them, and a test diffs the two.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.framework import (
    ClassInfo,
    Finding,
    MethodLookup,
    Module,
    Project,
    Rule,
    register_rule,
)

# ------------------------------------------------------ shared: registrations

# decorator / helper name -> registry axis (mirrors repro_torch/api/registry.py)
_REGISTER_FNS = {
    "register_allocator": "allocator",
    "register_arrival_process": "arrival_process",
    "register_auction": "auction",
    "register_task_family": "task_family",
    "register_backend": "backend",
    "register_policy": "policy",
    "register_incentive": "incentive",
    "register_buffer_controller": "buffer_controller",
    "register_aggregator": "aggregator",
    "register_cost_model": "cost_model",
    "register_population": "population",
}
_REGISTRY_VARS = {
    "ALLOCATORS": "allocator",
    "ARRIVAL_PROCESSES": "arrival_process",
    "AUCTIONS": "auction",
    "TASK_FAMILIES": "task_family",
    "BACKENDS": "backend",
    "POLICIES": "policy",
    "INCENTIVES": "incentive",
    "BUFFER_CONTROLLERS": "buffer_controller",
    "AGGREGATORS": "aggregator",
    "COST_MODELS": "cost_model",
    "POPULATIONS": "population",
}


@dataclass
class Registration:
    """One statically-visible registry entry: ``@register_<axis>("key")``
    on a def, ``register_<axis>("key")(obj)``, ``REG.register("key")``
    or ``REG.add("key", obj)``. ``key`` is None when not a string
    literal (dynamic registrations are out of static reach)."""

    axis: str
    key: Optional[str]
    module: Module
    node: ast.AST  # for the finding location
    target: Optional[ast.AST] = None  # ClassDef/FunctionDef when known


def _registration_axis(module: Module, func: ast.AST) -> Optional[str]:
    """Axis named by a registration callee, or None."""
    name = module.resolve_or_dotted(func)
    if name is None:
        return None
    parts = name.split(".")
    if parts[-1] in _REGISTER_FNS:
        return _REGISTER_FNS[parts[-1]]
    if parts[-1] == "register" and len(parts) >= 2 and parts[-2] in _REGISTRY_VARS:
        return _REGISTRY_VARS[parts[-2]]
    return None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def collect_registrations(project: Project) -> List[Registration]:
    regs: List[Registration] = []
    for m in project.modules:
        for node in ast.walk(m.tree):
            # decorator form: @register_x("key") / @REG.register("key")
            if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if not isinstance(dec, ast.Call) or not dec.args:
                        continue
                    axis = _registration_axis(m, dec.func)
                    if axis is not None:
                        regs.append(Registration(
                            axis, _const_str(dec.args[0]), m, dec, node))
            elif isinstance(node, ast.Call):
                # call form: register_x("key")(obj)
                if (isinstance(node.func, ast.Call) and node.func.args
                        and len(node.args) == 1):
                    axis = _registration_axis(m, node.func.func)
                    if axis is not None:
                        target = None
                        if isinstance(node.args[0], ast.Name):
                            target = m.classes.get(node.args[0].id)
                        regs.append(Registration(
                            axis, _const_str(node.func.args[0]), m, node, target))
                # add form: REG.add("key", obj)
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "add" and len(node.args) >= 2):
                    base = m.dotted(node.func.value)
                    if base in _REGISTRY_VARS:
                        target = None
                        if isinstance(node.args[1], ast.Name):
                            target = m.classes.get(node.args[1].id)
                        regs.append(Registration(
                            _REGISTRY_VARS[base], _const_str(node.args[0]),
                            m, node, target))
    return regs


# ----------------------------------------------------- shared: function shape


def _accepts_positional(fn: ast.FunctionDef, n: int) -> bool:
    """Can ``fn`` be called with exactly ``n`` positional arguments
    (``self`` included for instance methods)?"""
    a = fn.args
    static = any(
        isinstance(d, ast.Name) and d.id == "staticmethod"
        for d in fn.decorator_list
    )
    if static:
        n -= 1
    pos = len(a.posonlyargs) + len(a.args)
    required = pos - len(a.defaults)
    if required > n:
        return False
    return pos >= n or a.vararg is not None


def _is_abstract_stub(fn: ast.FunctionDef) -> bool:
    """Body is (docstring +) a single ``raise NotImplementedError``."""
    body = [s for s in fn.body
            if not (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant)
                    and isinstance(s.value.value, str))]
    if len(body) != 1 or not isinstance(body[0], ast.Raise):
        return False
    exc = body[0].exc
    if isinstance(exc, ast.Call):
        exc = exc.func
    return isinstance(exc, ast.Name) and exc.id == "NotImplementedError"


def _is_super_call(node: ast.AST, method: str) -> bool:
    """``super().<method>(...)``"""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == method
            and isinstance(node.func.value, ast.Call)
            and isinstance(node.func.value.func, ast.Name)
            and node.func.value.func.id == "super")


# ---------------------------------------------------------------------- RP01


@register_rule
class RegistryProtocolRule(Rule):
    """Every ``@register_*``-decorated class must implement its axis
    protocol: the required methods (directly or via a base class in the
    scanned file set) with signatures that accept the engines' call
    shapes, no method left as a bare ``raise NotImplementedError`` stub,
    and — for stateful axes — the paired ``state_dict``/``load_state``
    contract, since every axis object rides the checkpoint payloads
    (docs/CHECKPOINTS.md) and an unpaired half silently breaks resume.

    The required-method table mirrors the protocol bases in
    ``repro_torch/api/{arrivals,costmodel,buffer,policy,aggregator,backend}.py``
    and ``repro_torch/pop/population.py``, which are the JAX package's
    protocols; covered by ``tests/test_torch_analysis.py``.
    """

    code = "RP01"
    name = "registry-protocol"
    summary = ("registered class implements its axis protocol "
               "(methods, arities, state_dict/load_state pair)")

    # axis -> ([(method, call arity incl. self, human signature)], state pair?)
    PROTOCOLS: Dict[str, Tuple[Sequence[Tuple[str, int, str]], bool]] = {
        "arrival_process": (
            (("reset", 3, "(n_clients, rng)"),
             ("next_start", 3, "(client, t)")), True),
        "cost_model": (
            (("reset", 4, "(n_clients, n_tasks, rng)"),
             ("sample_latency", 4, "(client, task, base_duration)")), True),
        "buffer_controller": (
            (("reset", 3, "(n_tasks, initial_size)"),
             ("observe", 2, "(obs)"),
             ("sizes", 1, "()")), True),
        "policy": ((("allocate", 2, "(ctx)"),), True),
        "incentive": ((("recruit", 2, "(ctx)"),), True),
        "aggregator": (
            (("init", 2, "(task_params)"),
             ("aggregate", 4, "(stacked_deltas, weights, server_state)")), True),
        "backend": (
            (("run_cohort", 4, "(task_state, client_batch, rng)"),
             ("aggregate", 3, "(stacked_updates, weights)")), False),
        "population": (
            (("set_eligibility", 2, "(elig_ks)"),
             ("next_arrivals", 3, "(clients, t)"),
             ("sample_latencies", 4, "(clients, task, base_durations)")), True),
    }

    def check(self, project: Project) -> Iterator[Finding]:
        for reg in collect_registrations(project):
            spec = self.PROTOCOLS.get(reg.axis)
            if spec is None or not isinstance(reg.target, ast.ClassDef):
                continue
            info = project.class_info(reg.module, reg.target.name)
            if info is None:
                continue
            methods, state_pair = spec
            required = list(methods)
            if state_pair:
                required += [("state_dict", 1, "()"), ("load_state", 2, "(state)")]
            label = f"{reg.axis} {reg.key!r}" if reg.key else reg.axis
            for name, arity, sig in required:
                got = project.find_method(info, name)
                if got.status == MethodLookup.UNKNOWN:
                    continue  # unresolvable base may supply it
                if got.status == MethodLookup.NOT_FOUND:
                    yield reg.module.finding(
                        self.code,
                        f"class {reg.target.name} registered as {label} is "
                        f"missing required method {name}{sig}",
                        reg.target)
                    continue
                assert got.node is not None and got.owner is not None
                if _is_abstract_stub(got.node):
                    yield reg.module.finding(
                        self.code,
                        f"class {reg.target.name} registered as {label} "
                        f"resolves {name}{sig} to the abstract "
                        f"NotImplementedError stub in "
                        f"{got.owner.node.name} — implement it",
                        reg.target)
                elif not _accepts_positional(got.node, arity):
                    yield reg.module.finding(
                        self.code,
                        f"class {reg.target.name} registered as {label}: "
                        f"{name} must accept {arity - 1} positional "
                        f"argument(s) {sig} after self",
                        got.node if got.owner is info else reg.target)


# --------------------------------------------------------------- RNG01/RNG02

_SAFE_NUMPY_RANDOM = {
    "default_rng", "Generator", "RandomState", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
}
_SAFE_STDLIB_RANDOM = {"Random", "SystemRandom"}


# torch's module-global generator: the calls that seed it, the factory
# draws that read it unless given generator=, and the in-place draws
_TORCH_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed", "torch.random.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all", "torch.cuda.seed",
    "torch.cuda.seed_all",
}
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                "multinomial", "poisson"}
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_", "bernoulli_",
                        "geometric_", "cauchy_", "log_normal_"}


def _has_generator(call: ast.Call) -> bool:
    """``generator=`` passed, and not as a literal ``None``."""
    return any(kw.arg == "generator"
               and not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
               for kw in call.keywords)


@register_rule
class GlobalRngRule(Rule):
    """No module-global RNG in ``src/repro_torch``: every stochastic axis
    draws from its OWN seeded stream, a ``numpy.random.Generator``
    (speeds ``seed+1``, arrivals ``seed+2``, cost models ``seed+3``,
    auction bids ``bid_seed + 7919*i``) or a ``prng`` key, so enabling one
    axis never perturbs another's sequence and checkpoints can serialise
    every stream. A module-global draw or an unseeded ``default_rng()``
    breaks both properties silently, and with them the port's bit-exact
    parity with the JAX package's traces.

    Flags: any ``numpy.random.*`` call except Generator/bit-generator
    construction, ``default_rng()`` with no (or ``None``) seed, stdlib
    ``random.*`` module-global calls, and torch's module-global
    generator: seeding it (``torch.manual_seed``, ``torch.seed`` and
    their ``torch.random``/``torch.cuda`` forms), the draws ``torch.rand``,
    ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
    ``multinomial`` and ``poisson`` without a ``generator=`` keyword, and
    the in-place ``.uniform_``, ``.normal_``, ``.random_``,
    ``.exponential_``, ``.bernoulli_``, ``.geometric_``, ``.cauchy_`` and
    ``.log_normal_`` without ``generator=``. Covered by
    ``tests/test_torch_analysis.py``.
    """

    code = "RNG01"
    name = "rng-discipline"
    summary = ("no module-global np.random/stdlib-random/torch-generator draws; "
               "default_rng must be seeded")

    def check(self, project: Project) -> Iterator[Finding]:
        for m in project.modules:
            for node in ast.walk(m.tree):
                if not isinstance(node, ast.Call):
                    continue
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _TORCH_INPLACE_DRAWS
                        and not _has_generator(node)):
                    yield m.finding(
                        self.code,
                        f"in-place .{node.func.attr}() without generator= — "
                        "draws from torch's module-global generator; pass a "
                        "seeded torch.Generator or draw from a prng key",
                        node)
                    continue
                q = m.resolve(node.func)
                if q is None:
                    continue
                parts = q.split(".")
                if q.startswith("numpy.random."):
                    fn = parts[-1]
                    if fn == "default_rng":
                        unseeded = (not node.args and not node.keywords) or (
                            len(node.args) == 1
                            and isinstance(node.args[0], ast.Constant)
                            and node.args[0].value is None)
                        if unseeded:
                            yield m.finding(
                                self.code,
                                "unseeded default_rng() — derive the stream "
                                "from the run seed (axis convention: "
                                "seed+1 speeds, seed+2 arrivals, "
                                "seed+3 cost models)",
                                node)
                    elif fn not in _SAFE_NUMPY_RANDOM:
                        yield m.finding(
                            self.code,
                            f"module-global numpy.random.{fn}() call — use a "
                            "seeded per-axis np.random.Generator stream",
                            node)
                elif parts[0] == "random" and len(parts) == 2:
                    if parts[-1] not in _SAFE_STDLIB_RANDOM:
                        yield m.finding(
                            self.code,
                            f"module-global random.{parts[-1]}() call — use a "
                            "seeded per-axis np.random.Generator stream",
                            node)
                elif q in _TORCH_GLOBAL_SEEDS:
                    yield m.finding(
                        self.code,
                        f"{q}() seeds torch's module-global generator, which "
                        "every unkeyed draw shares — give the axis its own "
                        "torch.Generator or prng key",
                        node)
                elif (len(parts) == 2 and parts[0] == "torch"
                      and parts[1] in _TORCH_DRAWS and not _has_generator(node)):
                    yield m.finding(
                        self.code,
                        f"module-global torch.{parts[1]}() draw without "
                        "generator= — pass a seeded torch.Generator or draw "
                        "from a prng key",
                        node)


_SeedKey = Tuple[Tuple[str, ...], float]


def _seed_key(node: ast.AST) -> _SeedKey:
    """Canonical (symbolic terms, constant offset) of a seed expression:
    ``cfg.seed + 3`` and ``3 + cfg.seed`` collide; ``seed + 2`` and
    ``seed + 3`` don't."""
    terms: List[str] = []
    const = 0.0

    def flat(n: ast.AST, sign: int) -> None:
        nonlocal const
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add):
            flat(n.left, sign)
            flat(n.right, sign)
        elif isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub):
            flat(n.left, sign)
            flat(n.right, -sign)
        elif (isinstance(n, ast.Constant)
              and isinstance(n.value, (int, float))
              and not isinstance(n.value, bool)):
            const += sign * n.value
        else:
            terms.append(("-" if sign < 0 else "") + ast.unparse(n))

    flat(node, 1)
    return tuple(sorted(terms)), const


@register_rule
class SeedOffsetCollisionRule(Rule):
    """Two different streams derived from the SAME seed offset in one
    scope are one stream wearing two hats: ``default_rng(seed + 2)`` for
    a new axis silently entangles it with the arrivals stream, and every
    "enabling axis X never perturbs axis Y" bit-exactness guarantee
    (the async traces, the population parity suite) dies without a test
    failing nearby. This rule canonicalises every ``default_rng(...)`` seed
    expression (symbolic terms + summed integer offset) and flags two
    distinct call sites in the same function scope that collide.

    Scope is the innermost function on purpose: re-deriving the same
    stream in ``load_state`` (e.g. the async engine's ``cfg.seed + 3``
    cost-model reset) is the *correct* resume idiom, not a collision.
    Covered by ``tests/test_torch_analysis.py``.
    """

    code = "RNG02"
    name = "seed-offset-collision"
    summary = "same default_rng seed offset used twice in one scope"

    def check(self, project: Project) -> Iterator[Finding]:
        for m in project.modules:
            scopes: Dict[Optional[ast.AST], List[Tuple[ast.Call, _SeedKey]]] = {}
            for node in ast.walk(m.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                if m.resolve(node.func) != "numpy.random.default_rng":
                    continue
                scope: Optional[ast.AST] = node
                while scope is not None and not isinstance(
                        scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scope = getattr(scope, "_parent", None)
                scopes.setdefault(scope, []).append(
                    (node, _seed_key(node.args[0])))
            for calls in scopes.values():
                seen: Dict[_SeedKey, ast.Call] = {}
                for call, key in sorted(
                        calls, key=lambda c: (c[0].lineno, c[0].col_offset)):
                    first = seen.get(key)
                    if first is not None and first is not call:
                        yield m.finding(
                            self.code,
                            f"seed-offset collision: "
                            f"default_rng({ast.unparse(call.args[0])}) "
                            f"already derives a stream at line "
                            f"{first.lineno} in this scope — give each "
                            "axis its own offset",
                            call)
                    else:
                        seen[key] = call


# --------------------------------------------------------------- JIT01/JIT02

# bodies run once and then replayed (a CUDA graph) or compiled (a trace);
# torch.func.vmap / torch.vmap are not here: they run the body on every call
_CAPTURES = {"torch.cuda.graph", "torch.cuda.make_graphed_callables"}
_TRACES = {"torch.jit.trace", "torch.fx.symbolic_trace", "torch.export.export"}


def _trace_reason(module: Module, func: ast.AST) -> Optional[str]:
    q = module.resolve(func)
    return q if q in _CAPTURES or q in _TRACES else None


def _how(reason: str) -> str:
    return "captured by" if reason in _CAPTURES else "traced by"


def _when(reason: str) -> str:
    return "capture" if reason in _CAPTURES else "trace"


def _collect_jit_targets(module: Module) -> Dict[ast.AST, str]:
    """Nodes whose Python bodies run once and are then replayed or
    compiled: the body of ``with torch.cuda.graph(...)`` (the ``With``
    node) and the functions it calls by name; the callables passed to
    ``torch.cuda.make_graphed_callables`` (one or a tuple); the function
    passed to ``torch.jit.trace`` / ``torch.fx.symbolic_trace`` /
    ``torch.export.export`` (a class, or an instance made in the call,
    stands for its ``forward``); and defs decorated with one of these,
    bare, called or through ``functools.partial``. Names resolve through
    enclosing scopes, so defs inside ``lru_cache``-d factories count."""
    targets: Dict[ast.AST, str] = {}
    # scope -> {name: def-node}; scope is a function node or the module tree
    defs: Dict[ast.AST, Dict[str, ast.AST]] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            scope: ast.AST = getattr(node, "_parent", module.tree)
            while not isinstance(
                    scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
                scope = getattr(scope, "_parent", module.tree)
            defs.setdefault(scope, {})[node.name] = node

    def resolve_local(name: str, at: ast.AST) -> Optional[ast.AST]:
        scope: Optional[ast.AST] = at
        while scope is not None:
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
                got = defs.get(scope, {}).get(name)
                if got is not None:
                    return got
            scope = getattr(scope, "_parent", None)
        return None

    def as_function(node: Optional[ast.AST]) -> Optional[ast.AST]:
        if isinstance(node, ast.ClassDef):
            return next((n for n in node.body if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == "forward"), None)
        return node

    def callables(arg: ast.AST, at: ast.AST) -> List[ast.AST]:
        if isinstance(arg, ast.Lambda):
            return [arg]
        if isinstance(arg, (ast.Tuple, ast.List)):
            return [fn for el in arg.elts for fn in callables(el, at)]
        if isinstance(arg, ast.Name):
            fn = as_function(resolve_local(arg.id, at))
            return [fn] if fn is not None else []
        if isinstance(arg, ast.Call):
            if module.resolve(arg.func) in ("functools.partial", "partial") and arg.args:
                return callables(arg.args[0], at)
            if isinstance(arg.func, ast.Name):
                made = resolve_local(arg.func.id, at)
                if isinstance(made, ast.ClassDef):
                    fn = as_function(made)
                    return [fn] if fn is not None else []
        return []

    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                reason = _trace_reason(module, dec)
                if reason is None and isinstance(dec, ast.Call):
                    reason = _trace_reason(module, dec.func)
                    if (reason is None and dec.args
                            and module.resolve(dec.func)
                            in ("functools.partial", "partial")):
                        reason = _trace_reason(module, dec.args[0])
                if reason is not None:
                    targets[node] = reason
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if not any(isinstance(item.context_expr, ast.Call)
                       and _trace_reason(module, item.context_expr.func) == "torch.cuda.graph"
                       for item in node.items):
                continue
            targets[node] = "torch.cuda.graph"
            for stmt in node.body:
                for call in ast.walk(stmt):
                    if isinstance(call, ast.Call) and isinstance(call.func, ast.Name):
                        fn = as_function(resolve_local(call.func.id, node))
                        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            targets.setdefault(fn, "torch.cuda.graph")
        elif isinstance(node, ast.Call):
            reason = _trace_reason(module, node.func)
            if reason is None or reason == "torch.cuda.graph" or not node.args:
                continue
            for fn in callables(node.args[0], node):
                targets[fn] = reason
    return targets


def _target_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node of a target's body: a function's whole subtree, a
    ``With``'s body statements (not its context expression)."""
    if isinstance(fn, (ast.With, ast.AsyncWith)):
        for stmt in fn.body:
            yield from ast.walk(stmt)
    else:
        yield from ast.walk(fn)


_IMPURE_BUILTINS = {"print", "breakpoint", "input"}
# tensor methods that copy to the host: each syncs with the device
_HOST_SYNCS = {"item", "tolist", "cpu", "numpy"}


def _bound_names(fn: ast.AST) -> Set[str]:
    """Every name bound anywhere inside ``fn`` (params, assignments, for/
    with/except targets, comprehensions, nested defs/imports). Union over
    nested scopes — an over-approximation that can only under-flag."""
    bound: Set[str] = set()

    def add_target(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            bound.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add_target(e)
        elif isinstance(t, ast.Starred):
            add_target(t.value)

    for node in _target_nodes(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            a = node.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                bound.add(arg.arg)
            if a.vararg:
                bound.add(a.vararg.arg)
            if a.kwarg:
                bound.add(a.kwarg.arg)
        elif isinstance(node, ast.Lambda):
            a = node.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                bound.add(arg.arg)
            if a.vararg:
                bound.add(a.vararg.arg)
            if a.kwarg:
                bound.add(a.kwarg.arg)
        elif isinstance(node, ast.ClassDef):
            bound.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                add_target(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            add_target(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            add_target(node.target)
        elif isinstance(node, ast.NamedExpr):
            add_target(node.target)
        elif isinstance(node, (ast.comprehension,)):
            add_target(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            add_target(node.optional_vars)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
        elif isinstance(node, ast.Import):
            for a2 in node.names:
                bound.add(a2.asname or a2.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a2 in node.names:
                if a2.name != "*":
                    bound.add(a2.asname or a2.name)
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        bound.discard(fn.name)
    return bound


def _fn_label(fn: ast.AST) -> str:
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return f"'{fn.name}'"
    if isinstance(fn, (ast.With, ast.AsyncWith)):
        return "the with-block"
    return "<lambda>"


@register_rule
class JitPurityRule(Rule):
    """Bodies that the port runs once and then replays or compiles must
    stay free of host effects. A CUDA graph (``with torch.cuda.graph``,
    ``torch.cuda.make_graphed_callables``) records the device work of one
    run of its Python body and replays only that; ``torch.jit.trace``,
    ``torch.fx.symbolic_trace`` and ``torch.export.export`` run the body
    once and keep the graph it traced. A host effect inside one runs at
    capture or trace time only, or pins a value to the host:
    ``print``/``breakpoint``/``input``, ``time.*``, ``numpy.random.*``,
    and the host syncs ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()`` and ``torch.cuda.synchronize()``, which a capture
    refuses outright and a trace bakes in as a constant.

    Targets: the body of ``with torch.cuda.graph(...)`` and the functions
    it calls by name, the callables passed to ``make_graphed_callables``,
    and the function (or a module class's ``forward``) passed to a trace;
    call form, decorator form (bare, called, ``functools.partial``),
    lambdas, and defs returned by ``lru_cache``-d factories, resolved
    through enclosing scopes. ``torch.func.vmap`` and ``torch.vmap`` are
    not targets: they run the Python body on every call. Covered by
    ``tests/test_torch_analysis.py``.
    """

    code = "JIT01"
    name = "jit-purity"
    summary = ("no host effects (.item/.cpu/print/time/np.random/sync) in "
               "captured or traced bodies")

    def check(self, project: Project) -> Iterator[Finding]:
        for m in project.modules:
            for fn, reason in _collect_jit_targets(m).items():
                bound = _bound_names(fn)
                where = f"inside {_fn_label(fn)} {_how(reason)} {reason}"
                for node in _target_nodes(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr in _HOST_SYNCS
                            and not node.args):
                        yield m.finding(
                            self.code,
                            f".{node.func.attr}() {where} — syncs the host: "
                            "a capture refuses it, a trace bakes the value "
                            "in as a constant",
                            node)
                        continue
                    q = m.resolve(node.func)
                    if q is not None:
                        head, fname = q.split(".")[0], q.split(".")[-1]
                        if q == "torch.cuda.synchronize":
                            yield m.finding(
                                self.code,
                                f"torch.cuda.synchronize() {where} — syncs "
                                "the host, which a capture refuses",
                                node)
                        elif head == "time":
                            yield m.finding(
                                self.code,
                                f"time.{fname}() {where} — runs once at "
                                f"{_when(reason)} time, not per call",
                                node)
                        elif q.startswith("numpy.random."):
                            yield m.finding(
                                self.code,
                                f"numpy.random.{fname} {where} — host RNG "
                                f"is baked in at {_when(reason)} time; draw "
                                "from a prng key",
                                node)
                    elif (isinstance(node.func, ast.Name)
                          and node.func.id in _IMPURE_BUILTINS
                          and node.func.id not in bound):
                        yield m.finding(
                            self.code,
                            f"{node.func.id}() {where} — executes at "
                            f"{_when(reason)} time only",
                            node)


@register_rule
class JitNonlocalMutationRule(Rule):
    """A captured or traced body must not mutate state it closes over:
    writes to ``global``/``nonlocal`` names, or element/attribute
    assignment on an object captured from an enclosing scope, happen once
    at capture or trace time and never on a replay — a cache that "works"
    on the first call and is frozen stale forever after. (Mutating
    objects passed IN as parameters is not flagged.) The targets are
    JIT01's.

    Covered by ``tests/test_torch_analysis.py``.
    """

    code = "JIT02"
    name = "jit-nonlocal-mutation"
    summary = "captured/traced bodies must not mutate closed-over/global state"

    def check(self, project: Project) -> Iterator[Finding]:
        for m in project.modules:
            for fn, reason in _collect_jit_targets(m).items():
                bound = _bound_names(fn)
                when = _when(reason)
                for node in _target_nodes(fn):
                    if isinstance(node, (ast.Global, ast.Nonlocal)):
                        kind = ("global" if isinstance(node, ast.Global)
                                else "nonlocal")
                        yield m.finding(
                            self.code,
                            f"{kind} statement inside {_fn_label(fn)} "
                            f"{_how(reason)} {reason} — {when}-time "
                            "mutation of enclosing state",
                            node)
                        continue
                    targets: List[ast.AST] = []
                    if isinstance(node, ast.Assign):
                        targets = list(node.targets)
                    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                        targets = [node.target]
                    elif isinstance(node, ast.Delete):
                        targets = list(node.targets)
                    for t in targets:
                        base = t
                        chained = False
                        while isinstance(base, (ast.Subscript, ast.Attribute)):
                            base = base.value
                            chained = True
                        if (chained and isinstance(base, ast.Name)
                                and base.id not in bound):
                            yield m.finding(
                                self.code,
                                f"{_fn_label(fn)} {_how(reason)} {reason} "
                                f"mutates enclosing-scope object "
                                f"'{base.id}' ({ast.unparse(t)}) — "
                                f"{when}-time-only side effect",
                                node)


# --------------------------------------------------------------------- CKPT01


def _walk_in_scope(fn: ast.AST) -> Iterator[ast.AST]:
    """Like ``ast.walk`` but in source order and without descending into
    nested function/class bodies — those are separate scopes with their
    own state flow, and dict-tracking is order-sensitive (``state = {}``
    must be seen before ``state["k"] = ...``)."""
    for child in ast.iter_child_nodes(fn):
        yield child
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
            yield from _walk_in_scope(child)


class _DictFlow:
    """Tracks top-level string keys written by a ``state_dict`` body."""

    def __init__(self, module: Module, fn: ast.FunctionDef) -> None:
        self.module = module
        self.fn = fn
        self.keys: Set[str] = set()
        self.dynamic = False
        self._tracked: Dict[str, Set[str]] = {}
        self._run()

    def _literal_keys(self, d: ast.Dict) -> Optional[Set[str]]:
        out: Set[str] = set()
        for k in d.keys:
            if k is None:  # **expansion
                return None
            s = _const_str(k)
            if s is None:
                return None
            out.add(s)
        return out

    def _run(self) -> None:
        for node in _walk_in_scope(self.fn):
            if isinstance(node, ast.AnnAssign) and node.value is not None:
                # `state: Dict[str, Any] = {...}` tracks like plain Assign
                node = ast.Assign(targets=[node.target], value=node.value)
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    if isinstance(node.value, ast.Dict):
                        keys = self._literal_keys(node.value)
                        if keys is None:
                            self.dynamic = True
                            return
                        self._tracked[t.id] = set(keys)
                    elif _is_super_call(node.value, "state_dict"):
                        self._tracked[t.id] = set()
                elif (isinstance(t, ast.Subscript)
                      and isinstance(t.value, ast.Name)
                      and t.value.id in self._tracked):
                    s = _const_str(t.slice)
                    if s is None:
                        self.dynamic = True
                        return
                    self._tracked[t.value.id].add(s)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if (isinstance(node.func.value, ast.Name)
                        and node.func.value.id in self._tracked):
                    if node.func.attr == "update":
                        if (len(node.args) == 1
                                and isinstance(node.args[0], ast.Dict)):
                            keys = self._literal_keys(node.args[0])
                            if keys is None:
                                self.dynamic = True
                                return
                            self._tracked[node.func.value.id] |= keys
                        else:
                            self.dynamic = True
                            return
                    elif node.func.attr == "setdefault" and node.args:
                        s = _const_str(node.args[0])
                        if s is not None:
                            self._tracked[node.func.value.id].add(s)
        for node in _walk_in_scope(self.fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            v = node.value
            if isinstance(v, ast.Dict):
                keys = self._literal_keys(v)
                if keys is None:
                    self.dynamic = True
                    return
                self.keys |= keys
            elif isinstance(v, ast.Name) and v.id in self._tracked:
                self.keys |= self._tracked[v.id]
            elif _is_super_call(v, "state_dict"):
                pass  # pure delegation; base class is checked separately
            else:
                self.dynamic = True
                return


def _load_state_reads(
    project: Project,
    info: ClassInfo,
    fn: ast.FunctionDef,
    param: str,
    visited: Optional[Set[Tuple[str, str, str]]] = None,
) -> Tuple[Set[str], bool]:
    """String keys ``fn`` reads off ``param`` (``state[k]``, ``.get(k)``,
    ``k in state``, ``.pop(k)``), following ``self.helper(state)`` calls
    one class deep. Returns (keys, dynamic?) — dynamic when the state
    flows somewhere static analysis can't see."""
    visited = visited or set()
    key = (info.module.name, info.node.name, fn.name)
    if key in visited:
        return set(), False
    visited.add(key)
    reads: Set[str] = set()
    for node in _walk_in_scope(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and node.value.id == param:
            s = _const_str(node.slice)
            if s is None:
                return reads, True
            reads.add(s)
        elif isinstance(node, ast.Compare):
            if (len(node.ops) == 1
                    and isinstance(node.ops[0], (ast.In, ast.NotIn))
                    and isinstance(node.comparators[0], ast.Name)
                    and node.comparators[0].id == param):
                s = _const_str(node.left)
                if s is not None:
                    reads.add(s)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            if isinstance(node.iter, ast.Name) and node.iter.id == param:
                return reads, True
        elif isinstance(node, ast.Call):
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == param):
                if func.attr in ("get", "pop", "setdefault") and node.args:
                    s = _const_str(node.args[0])
                    if s is None:
                        return reads, True
                    reads.add(s)
                else:  # .items()/.keys()/.values()/... — whole-dict access
                    return reads, True
                continue
            passes_param = any(
                isinstance(a, ast.Name) and a.id == param for a in node.args
            ) or any(
                isinstance(kw.value, ast.Name) and kw.value.id == param
                for kw in node.keywords
            )
            if not passes_param:
                continue
            if _is_super_call(node, "load_state"):
                continue  # symmetric with super().state_dict(); base checked
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "self"):
                got = project.find_method(info, func.attr)
                if got.status == MethodLookup.FOUND and got.node is not None:
                    helper = got.node
                    pos = next(
                        (i for i, a in enumerate(node.args)
                         if isinstance(a, ast.Name) and a.id == param), None)
                    h_args = helper.args.args
                    h_param = None
                    if pos is not None and len(h_args) > pos + 1:
                        h_param = h_args[pos + 1].arg  # skip self
                    else:
                        kw = next(
                            (k.arg for k in node.keywords
                             if isinstance(k.value, ast.Name)
                             and k.value.id == param), None)
                        h_param = kw
                    if h_param is None:
                        return reads, True
                    assert got.owner is not None
                    sub, dyn = _load_state_reads(
                        project, got.owner, helper, h_param, visited)
                    reads |= sub
                    if dyn:
                        return reads, True
                    continue
            return reads, True  # param escapes to an unresolvable callee
    return reads, False


@register_rule
class CheckpointSchemaRule(Rule):
    """``state_dict`` and ``load_state`` are two halves of one schema: a
    key the writer emits but the reader never touches is a resume bug
    waiting for the field to matter (events, refcounts and controller
    state that serialise fine and silently fail to restore). This rule statically
    extracts the top-level keys each ``state_dict`` writes (dict
    literals, ``state[k] = ...``, ``.update({...})``) and the keys its
    paired ``load_state`` reads (``state[k]``, ``.get(k)``, ``k in
    state``, helpers called with the state one class deep), and flags
    every written-but-never-read key.

    Read-but-never-written keys are deliberately allowed — tolerating
    legacy payload keys on load (``core/mmfl.py``'s legacy ``losses``)
    is a supported compatibility idiom. Classes whose payload is built
    dynamically are skipped rather than guessed at. Covered by
    ``tests/test_torch_analysis.py``.
    """

    code = "CKPT01"
    name = "checkpoint-schema"
    summary = "state_dict keys the paired load_state never reads"

    def check(self, project: Project) -> Iterator[Finding]:
        for m in project.modules:
            for cname in m.classes:
                info = project.class_info(m, cname)
                if info is None:
                    continue
                sd = info.methods.get("state_dict")
                ls = info.methods.get("load_state")
                if sd is None or ls is None:
                    continue
                if _is_abstract_stub(sd) or _is_abstract_stub(ls):
                    continue
                flow = _DictFlow(m, sd)
                if flow.dynamic:
                    continue
                args = [a.arg for a in ls.args.args if a.arg != "self"]
                if not args:
                    continue
                reads, dynamic = _load_state_reads(project, info, ls, args[0])
                if dynamic:
                    continue
                missing = sorted(flow.keys - reads)
                if missing:
                    yield m.finding(
                        self.code,
                        f"{cname}.state_dict writes key(s) "
                        f"{', '.join(repr(k) for k in missing)} that "
                        f"{cname}.load_state never reads — checkpoint "
                        "schema drift (resume silently drops state)",
                        sd)


# --------------------------------------------------------------------- CKPT02


# appends inside these methods reconstruct restored state (bounded by
# what the payload held) rather than accumulate per produced event
_RECONSTRUCTORS = ("__init__", "load_state", "reset", "_replay_history")


def _attr_accumulators(cls: ast.ClassDef) -> Set[str]:
    """``self.X`` attribute names that behave as unbounded event
    accumulators: initialised to a list somewhere in the class AND grown
    via ``.append``/``.extend`` from a non-reconstruction method — one
    entry per round/flush, so size is proportional to run length."""
    inits: Set[str] = set()
    grown: Set[str] = set()
    for node in ast.walk(cls):
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    and isinstance(value, (ast.List, ast.ListComp))):
                inits.add(t.attr)
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if method.name in _RECONSTRUCTORS:
            continue
        for node in ast.walk(method):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute):
                f = node.func
                if (f.attr in ("append", "extend")
                        and isinstance(f.value, ast.Attribute)
                        and isinstance(f.value.value, ast.Name)
                        and f.value.value.id == "self"):
                    grown.add(f.value.attr)
    return inits & grown


def _local_accumulators(fn: ast.AST) -> Set[str]:
    """Local variable names used as unbounded accumulators inside one
    function body (list-initialised + ``.append``/``.extend`` grown)."""
    inits: Set[str] = set()
    grown: Set[str] = set()
    for node in _walk_in_scope(fn):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.List, ast.ListComp)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    inits.add(t.id)
                elif isinstance(t, ast.Tuple):
                    # `a, b, c = [], [], []` multi-init
                    for el in t.elts:
                        if isinstance(el, ast.Name):
                            inits.add(el.id)
        elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Tuple):
            for t in node.targets:
                if isinstance(t, ast.Tuple) and len(t.elts) == len(
                        node.value.elts):
                    for el, v in zip(t.elts, node.value.elts):
                        if isinstance(el, ast.Name) and isinstance(
                                v, (ast.List, ast.ListComp)):
                            inits.add(el.id)
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute):
            f = node.func
            if f.attr in ("append", "extend") and isinstance(
                    f.value, ast.Name):
                grown.add(f.value.id)
    return inits & grown


def _proportional_refs(value: ast.AST, attrs: Set[str],
                       local_names: Set[str]) -> Set[str]:
    """Accumulator names the expression embeds WHOLESALE — a direct
    reference, ``list()``/``np.asarray()``-style materialisation, a
    slice, or a comprehension iterating one. Bounded derivations
    (``len(x)``, scalar indexing ``x[-1]``) are allowed."""
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(value):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    out: Set[str] = set()
    for node in ast.walk(value):
        name: Optional[str] = None
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self" and node.attr in attrs):
            name = f"self.{node.attr}"
        elif isinstance(node, ast.Name) and node.id in local_names:
            name = node.id
        if name is None:
            continue
        p = parents.get(node)
        if (isinstance(p, ast.Call) and isinstance(p.func, ast.Name)
                and p.func.id == "len"):
            continue                      # len(acc): bounded
        if isinstance(p, ast.Subscript) and p.value is node:
            sl = p.slice
            if isinstance(sl, ast.UnaryOp):
                sl = sl.operand
            if isinstance(sl, ast.Constant):
                continue                  # acc[-1]: scalar pick, bounded
        if isinstance(p, ast.IfExp) and p.test is node:
            continue                      # `acc[-1] if acc else None`
        if isinstance(p, ast.Attribute) and p.attr in ("append", "extend"):
            continue                      # growing it, not embedding it
        out.add(name)
    return out


def _payload_values(fn: ast.AST,
                    arg: ast.expr) -> Iterator[Tuple[str, ast.expr]]:
    """(key, value) pairs of the dict expression ``arg`` — a literal, or
    a name resolved to dict-literal assignments (plus ``var[k] = v``
    additions) in the same scope."""
    if isinstance(arg, ast.Dict):
        for k, v in zip(arg.keys, arg.values):
            s = _const_str(k) if k is not None else None
            yield (s or "<dynamic>"), v
        return
    if not isinstance(arg, ast.Name):
        return
    for node in _walk_in_scope(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id == arg.id
                    and isinstance(node.value, ast.Dict)):
                for k, v in zip(node.value.keys, node.value.values):
                    s = _const_str(k) if k is not None else None
                    yield (s or "<dynamic>"), v
            elif (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == arg.id):
                s = _const_str(t.slice)
                yield (s or "<dynamic>"), node.value


@register_rule
class UnboundedPayloadRule(Rule):
    """The O(1)-checkpoint contract (docs/CHECKPOINTS.md): the per-step
    payload holds only BOUNDED control state — everything that grows
    with run length streams through the ``history.jsonl`` sidecar via
    ``append_history``, and ``save`` merely commits the byte offset.
    Before the sidecar, engines embedded their whole-run curve lists in
    every step, so checkpoint size and write time grew linearly with
    run length and week-long runs spent their budget rewriting history.

    This rule flags the regression statically: an unbounded accumulator
    (a ``self`` attribute or local list that is list-initialised and
    ``.append``/``.extend``-grown per event) embedded WHOLESALE — direct
    reference, ``list()``-style materialisation, slice, or comprehension
    over it — in a ``state_dict`` return or in the ``coordinator_state``
    payload of a ``save(...)`` call. Bounded derivations (``len(acc)``,
    scalar ``acc[-1]``) are allowed, as is reading legacy embedded
    history on load. A literal ``"history"`` payload key is flagged
    unconditionally: that is the legacy layout's write path, which is
    compat-READ-only. Covered by ``tests/test_torch_analysis.py``.
    """

    code = "CKPT02"
    name = "unbounded-checkpoint-payload"
    summary = ("run-length-proportional history embedded in a step "
               "payload instead of the sidecar")

    def _check_fn(self, m: Module, cls: Optional[ast.ClassDef],
                  fn: ast.AST) -> Iterator[Finding]:
        attrs = _attr_accumulators(cls) if cls is not None else set()
        local_acc = _local_accumulators(fn)
        for node in _walk_in_scope(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "save"):
                continue
            payload: Optional[ast.expr] = None
            for kw in node.keywords:
                if kw.arg == "coordinator_state":
                    payload = kw.value
            if payload is None and len(node.args) >= 3:
                payload = node.args[2]
            if payload is None:
                continue
            for key, v in _payload_values(fn, payload):
                if key == "history":
                    yield m.finding(
                        self.code,
                        f"save() payload writes the legacy 'history' "
                        "key — embedded whole-run history is read-only "
                        "compat; stream records through append_history "
                        "so checkpoints stay O(1)",
                        node)
                    continue
                for acc in sorted(_proportional_refs(v, attrs, local_acc)):
                    yield m.finding(
                        self.code,
                        f"save() payload key {key!r} embeds the "
                        f"unbounded accumulator {acc} (grown per "
                        "event) — checkpoint size becomes O(run "
                        "length); stream it through append_history",
                        node)

    def _check_state_dict(self, m: Module,
                          cls: ast.ClassDef) -> Iterator[Finding]:
        sd = next((n for n in cls.body
                   if isinstance(n, ast.FunctionDef)
                   and n.name == "state_dict"), None)
        if sd is None or _is_abstract_stub(sd):
            return
        attrs = _attr_accumulators(cls)
        if not attrs:
            return
        for node in _walk_in_scope(sd):
            if not isinstance(node, (ast.Return, ast.Assign)):
                continue
            v = node.value
            if v is None:
                continue
            for acc in sorted(_proportional_refs(v, attrs, set())):
                yield m.finding(
                    self.code,
                    f"{cls.name}.state_dict embeds the unbounded "
                    f"accumulator {acc} (grown per event) in the step "
                    "payload — checkpoint size becomes O(run length); "
                    "expose it as sidecar records (history_records) "
                    "instead",
                    sd)
                return  # one finding per state_dict is enough

    def check(self, project: Project) -> Iterator[Finding]:
        for m in project.modules:
            seen: Set[ast.AST] = set()
            for node in ast.walk(m.tree):
                if isinstance(node, ast.ClassDef):
                    yield from self._check_state_dict(m, node)
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            seen.add(sub)
                            yield from self._check_fn(m, node, sub)
            for node in ast.walk(m.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node not in seen:
                    yield from self._check_fn(m, None, node)


# ---------------------------------------------------------------------- DOC01

_DOC_SECTION_RE = re.compile(r"^## (\w+) \(")
_DOC_ROW_RE = re.compile(r"^\| `([^`]+)`")


@register_rule
class RegistryDocRule(Rule):
    """Every statically-registered plugin key must appear in the
    generated ``docs/REGISTRY_TORCH.md``: the doc is the user-facing
    contract for what a spec may name, generated from the live registries
    and diffed by a test so it cannot drift. This rule is the static half
    of that gate — it cross-checks ``@register_*("key")`` literals
    against the doc's per-axis tables WITHOUT importing the package, so
    it still fires when an import-time failure (or a conditionally
    registered plugin) hides an entry from ``--dump-markdown``.

    Dynamically-keyed registrations (enum loops, ``add(var, ...)``) are
    out of static reach and skipped; the runtime drift check covers
    them. Covered by ``tests/test_torch_analysis.py``.
    """

    code = "DOC01"
    name = "registry-doc-drift"
    summary = "registered plugin key missing from docs/REGISTRY_TORCH.md"

    def check(self, project: Project) -> Iterator[Finding]:
        doc = project.registry_doc
        if doc is None or not doc.exists():
            return
        sections: Dict[str, Set[str]] = {}
        current: Optional[str] = None
        for line in doc.read_text().splitlines():
            sec = _DOC_SECTION_RE.match(line)
            if sec:
                current = sec.group(1)
                sections.setdefault(current, set())
                continue
            row = _DOC_ROW_RE.match(line)
            if row and current is not None:
                sections[current].add(row.group(1))
        for reg in collect_registrations(project):
            if reg.key is None:
                continue
            if reg.axis not in sections:
                yield reg.module.finding(
                    self.code,
                    f"axis {reg.axis!r} has no section in "
                    f"{doc.name} — regenerate it "
                    "(python -m repro_torch.api.registry --dump-markdown)",
                    reg.node)
            elif reg.key not in sections[reg.axis]:
                yield reg.module.finding(
                    self.code,
                    f"registered {reg.axis} {reg.key!r} is missing from "
                    f"{doc.name} — regenerate it "
                    "(python -m repro_torch.api.registry --dump-markdown)",
                    reg.node)
