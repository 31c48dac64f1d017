"""Rule framework for the port's invariant linter.

The port's correctness rests on cross-cutting conventions, as the JAX
package's does: every registry axis pairs ``state_dict`` with
``load_state``, every stochastic axis draws from its own seeded stream,
bodies that are captured or traced once stay pure, checkpoint payload
keys stay symmetric. This package turns them into machine-checked
invariants that run before any test: a shared ``ast`` walk (with
import-alias and class-inheritance resolution) feeds self-registering
rules (``@register_rule`` / ``RULES``).

It is the port's own copy of the JAX package's ``analysis`` framework,
with the same API, findings, fingerprints and ``# noqa`` handling. This
module is stdlib only (no torch, no numpy, nothing of the package), so
``python -m repro_torch.analysis`` starts in milliseconds and runs where
the training stack cannot import.
"""

from __future__ import annotations

import ast
import hashlib
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Dict, FrozenSet, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Type)

# --------------------------------------------------------------- findings


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``fingerprint`` identifies the finding across line-number churn
    (rule code + file + enclosing symbol + message hash), so a
    ``--baseline`` file keeps grandfathered findings suppressed while
    new ones still fail the scan.
    """

    code: str
    message: str
    path: str  # repo-relative, "/"-separated
    line: int
    col: int = 0
    symbol: str = ""  # innermost enclosing class/function, dotted

    @property
    def fingerprint(self) -> str:
        digest = hashlib.sha1(self.message.encode()).hexdigest()[:10]
        return f"{self.code}:{self.path}:{self.symbol}:{digest}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}:{self.col}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.code} {self.message}{sym}"


# ------------------------------------------------------------ parsed model

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?", re.IGNORECASE)


def _relative_module_name(path: Path, root: Path) -> str:
    """Dotted module name of ``path`` under ``root`` (best effort: the
    longest trailing package chain, so ``src/repro_torch/api/buffer.py``
    maps to ``repro_torch.api.buffer`` whatever the scan root)."""
    try:
        rel = path.resolve().relative_to(root.resolve())
        parts = list(rel.parts)
    except ValueError:
        parts = list(path.parts)
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts.pop()
    # strip non-package prefixes like "src"
    while parts and parts[0] in ("src", "tests", "fixtures"):
        parts.pop(0)
    return ".".join(parts)


class Module:
    """One parsed source file: AST + import-alias map + class/def index +
    per-line ``# noqa`` suppressions."""

    def __init__(self, path: Path, source: str, root: Path) -> None:
        self.path = path
        self.root = root
        self.relpath = _as_relpath(path, root)
        self.name = _relative_module_name(path, root)
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.aliases = _collect_aliases(self.tree, self.name)
        self.classes: Dict[str, ast.ClassDef] = {
            n.name: n for n in self.tree.body if isinstance(n, ast.ClassDef)
        }
        self.noqa = _collect_noqa(source)
        _attach_parents(self.tree)

    # -- name resolution ---------------------------------------------------

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Syntactic dotted form of a Name/Attribute chain (``torch.cuda.graph``),
        or None for anything else."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Fully-qualified dotted name of a Name/Attribute chain, expanding
        the leading segment through this module's import aliases
        (``np.random.default_rng`` -> ``numpy.random.default_rng``).
        Returns None when the chain's root was never imported — locals
        never masquerade as modules."""
        dotted = self.dotted(node)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        target = self.aliases.get(head)
        if target is None:
            return None
        return f"{target}.{rest}" if rest else target

    def resolve_or_dotted(self, node: ast.AST) -> Optional[str]:
        """``resolve`` with a syntactic fallback, for matching decorators
        that may be defined in the scanned file itself (test fixtures)."""
        return self.resolve(node) or self.dotted(node)

    def symbol_of(self, node: ast.AST) -> str:
        """Dotted enclosing class/function chain of ``node``."""
        parts: List[str] = []
        cur = getattr(node, "_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                parts.append(cur.name)
            cur = getattr(cur, "_parent", None)
        return ".".join(reversed(parts))

    def finding(self, code: str, message: str, node: ast.AST) -> Finding:
        return Finding(
            code=code,
            message=message,
            path=self.relpath,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            symbol=self.symbol_of(node),
        )


def _as_relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def _attach_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._parent = parent  # type: ignore[attr-defined]


def _collect_aliases(tree: ast.AST, module_name: str) -> Dict[str, str]:
    """Local name -> fully-qualified dotted target, from every import in
    the file (module- and function-level alike; later wins)."""
    aliases: Dict[str, str] = {}
    pkg_parts = module_name.split(".")[:-1] if module_name else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                target = a.name if a.asname else a.name.split(".")[0]
                aliases[local] = target
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: resolve against this module's package
                base_parts = pkg_parts[: len(pkg_parts) - node.level + 1]
                base = ".".join(base_parts + ([node.module] if node.module else []))
            else:
                base = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                local = a.asname or a.name
                aliases[local] = f"{base}.{a.name}" if base else a.name
    return aliases


def _collect_noqa(source: str) -> Dict[int, Optional[FrozenSet[str]]]:
    """Line -> suppressed codes (None = blanket ``# noqa``)."""
    out: Dict[int, Optional[FrozenSet[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if "#" not in line:
            continue
        m = _NOQA_RE.search(line)
        if not m:
            continue
        codes = m.group("codes")
        out[i] = None if codes is None else frozenset(
            c.strip().upper() for c in codes.split(",") if c.strip()
        )
    return out


# ----------------------------------------------------------- class lookup


@dataclass
class MethodLookup:
    """Result of resolving a method through a class's (parsed) MRO."""

    FOUND = "found"
    NOT_FOUND = "not_found"
    UNKNOWN = "unknown"  # some base class isn't in the scanned file set

    status: str
    node: Optional[ast.FunctionDef] = None
    owner: Optional["ClassInfo"] = None


@dataclass
class ClassInfo:
    module: Module
    node: ast.ClassDef
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for item in self.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item


class Project:
    """The scanned file set: parsed modules plus a cross-module class
    index so rules can resolve inheritance and imported base classes."""

    def __init__(
        self,
        modules: Sequence[Module],
        root: Path,
        registry_doc: Optional[Path] = None,
    ) -> None:
        self.modules = list(modules)
        self.root = root
        self.registry_doc = registry_doc
        # (module_name, class_name) -> ClassInfo; plus bare-name fallback
        self._by_module: Dict[Tuple[str, str], ClassInfo] = {}
        self._by_name: Dict[str, List[ClassInfo]] = {}
        for m in self.modules:
            for cname, cnode in m.classes.items():
                info = ClassInfo(m, cnode)
                self._by_module[(m.name, cname)] = info
                self._by_name.setdefault(cname, []).append(info)

    def class_info(self, module: Module, name: str) -> Optional[ClassInfo]:
        """Resolve a class referenced by ``name`` inside ``module``: local
        class first, then through the module's import aliases, then by
        bare name anywhere in the file set (single match only)."""
        if name in module.classes:
            return self._by_module[(module.name, name)]
        target = module.aliases.get(name)
        if target is not None:
            mod, _, cls = target.rpartition(".")
            info = self._by_module.get((mod, cls))
            if info is not None:
                return info
            candidates = self._by_name.get(cls, [])
            if len(candidates) == 1:
                return candidates[0]
            return None
        candidates = self._by_name.get(name, [])
        if len(candidates) == 1:
            return candidates[0]
        return None

    def find_method(self, info: ClassInfo, name: str) -> MethodLookup:
        """Walk ``info``'s bases (depth-first, parsed files only) for a
        method definition. UNKNOWN when an unresolvable base might supply
        it — rules must not report findings they cannot prove."""
        seen = set()

        def walk(ci: ClassInfo) -> MethodLookup:
            key = (ci.module.name, ci.node.name)
            if key in seen:
                return MethodLookup(MethodLookup.NOT_FOUND)
            seen.add(key)
            if name in ci.methods:
                return MethodLookup(MethodLookup.FOUND, ci.methods[name], ci)
            unknown = False
            for base in ci.node.bases:
                base_name = ci.module.dotted(base)
                if base_name in ("object", "Protocol", "typing.Protocol", "Generic"):
                    continue
                if base_name is None:
                    unknown = True
                    continue
                base_info = self.class_info(ci.module, base_name.split(".")[-1]
                                            if "." in base_name else base_name)
                if base_info is None:
                    unknown = True
                    continue
                got = walk(base_info)
                if got.status == MethodLookup.FOUND:
                    return got
                if got.status == MethodLookup.UNKNOWN:
                    unknown = True
            return MethodLookup(
                MethodLookup.UNKNOWN if unknown else MethodLookup.NOT_FOUND
            )

        return walk(info)


# ------------------------------------------------------------ rule registry


class Rule:
    """One invariant check. Subclasses set ``code`` (e.g. ``"RNG01"``),
    ``name`` (kebab-case slug), ``summary`` (one line), write the full
    invariant as the class docstring (it becomes the
    ``docs/ANALYSIS_TORCH.md`` catalog entry), and implement ``check(project)``."""

    code: str = ""
    name: str = ""
    summary: str = ""

    def check(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError


RULES: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    """Self-registration decorator, mirroring the repo's registry idiom:
    ``@register_rule`` keys the class by its ``code``."""
    if not cls.code:
        raise ValueError(f"rule {cls.__name__} has no code")
    if cls.code in RULES and RULES[cls.code] is not cls:
        raise ValueError(f"duplicate rule registration: {cls.code!r}")
    RULES[cls.code] = cls
    return cls


# ------------------------------------------------------------- the run loop


def find_repo_root(start: Path) -> Path:
    """Walk up from ``start`` to the nearest directory with a
    ``pyproject.toml`` (relpaths + docs discovery anchor); falls back to
    ``start`` itself."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in [cur, *cur.parents]:
        if (cand / "pyproject.toml").exists():
            return cand
    return start.resolve() if start.is_dir() else start.resolve().parent


def _iter_py_files(paths: Sequence[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def load_project(
    paths: Sequence[str | Path],
    root: Optional[Path] = None,
    registry_doc: Optional[Path] = None,
) -> Project:
    pp = [Path(p) for p in paths]
    if not pp:
        raise ValueError("no paths to analyze")
    root = root or find_repo_root(pp[0])
    modules = []
    for f in _iter_py_files(pp):
        try:
            source = f.read_text()
            modules.append(Module(f, source, root))
        except (SyntaxError, UnicodeDecodeError) as e:
            raise ValueError(f"cannot parse {f}: {e}") from None
    if registry_doc is None:
        cand = root / "docs" / "REGISTRY_TORCH.md"
        registry_doc = cand if cand.exists() else None
    return Project(modules, root, registry_doc)


def select_rules(
    select: Optional[Iterable[str]] = None,
    ignore: Optional[Iterable[str]] = None,
) -> List[Rule]:
    codes = sorted(RULES)
    chosen = set(codes)
    if select:
        wanted = {c.upper() for c in select}
        unknown = wanted - set(codes)
        if unknown:
            raise ValueError(
                f"unknown rule code(s) {sorted(unknown)}; known: {codes}"
            )
        chosen = wanted
    if ignore:
        dropped = {c.upper() for c in ignore}
        unknown = dropped - set(codes)
        if unknown:
            raise ValueError(
                f"unknown rule code(s) {sorted(unknown)}; known: {codes}"
            )
        chosen -= dropped
    return [RULES[c]() for c in sorted(chosen)]


def _suppressed(project: Project, finding: Finding) -> bool:
    for m in project.modules:
        if m.relpath == finding.path:
            if finding.line not in m.noqa:
                return False
            codes = m.noqa[finding.line]
            return codes is None or finding.code in codes
    return False


def run_rules(project: Project, rules: Sequence[Rule]) -> List[Finding]:
    findings = [
        f for rule in rules for f in rule.check(project)
        if not _suppressed(project, f)
    ]
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.code))


def run_analysis(
    paths: Sequence[str | Path],
    select: Optional[Iterable[str]] = None,
    ignore: Optional[Iterable[str]] = None,
    root: Optional[Path] = None,
    registry_doc: Optional[Path] = None,
) -> List[Finding]:
    """Parse ``paths`` and run the (selected) rule set; returns findings
    sorted by location. The one-call API the tests and the CLI share."""
    from repro_torch.analysis import rules as _rules  # noqa: F401  (self-registration)

    project = load_project(paths, root=root, registry_doc=registry_doc)
    return run_rules(project, select_rules(select, ignore))
