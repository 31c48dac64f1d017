"""The command line: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 = clean (or every finding baselined), 1 = new findings,
2 = usage/parse error. The baseline file stores line-number-independent
fingerprints so grandfathered findings stay suppressed across churn
while anything new still fails the scan. Without ``--baseline`` the CLI
reads the repo's committed ``analysis_baseline.json`` (empty by policy:
fix violations, don't grandfather them) and only reads it;
``--write-baseline PATH`` writes the current findings to PATH alone.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.framework import (
    RULES,
    Finding,
    find_repo_root,
    load_project,
    run_rules,
    select_rules,
)

BASELINE_VERSION = 1


def load_baseline(path: Path) -> Set[str]:
    """Fingerprint set from a baseline file; missing file = empty."""
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"malformed baseline {path}: expected "
                         '{"version": 1, "findings": [...]}')
    return {f["fingerprint"] for f in data["findings"]}


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    payload = {
        "version": BASELINE_VERSION,
        "findings": [
            {"fingerprint": f.fingerprint, "code": f.code, "path": f.path,
             "message": f.message}
            for f in findings
        ],
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


def dump_markdown() -> str:
    """Rule catalog for ``docs/ANALYSIS_TORCH.md``, generated from rule
    docstrings the same way ``docs/REGISTRY_TORCH.md`` is generated from
    the plugin registries; tests diff both so neither can drift."""
    import inspect

    from repro_torch.analysis import rules as _rules  # noqa: F401

    lines = [
        "# Static analysis rule catalog (PyTorch port)",
        "",
        "<!-- generated by `python -m repro_torch.analysis --dump-markdown`;"
        " do not edit by hand -->",
        "",
        "Run the linter with `PYTHONPATH=src python -m repro_torch.analysis"
        " src/repro_torch`. Suppress a single finding with `# noqa: CODE`;"
        " grandfathered findings live in `analysis_baseline.json`"
        " (committed empty — fix, don't baseline).",
        "",
        "| code | name | summary |",
        "| --- | --- | --- |",
    ]
    for code in sorted(RULES):
        cls = RULES[code]
        lines.append(f"| `{code}` | {cls.name} | {cls.summary} |")
    for code in sorted(RULES):
        cls = RULES[code]
        lines.append("")
        lines.append(f"## {code} — {cls.name}")
        lines.append("")
        lines.append(inspect.cleandoc(cls.__doc__ or ""))
    return "\n".join(lines) + "\n"


def _parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter for the PyTorch port.",
    )
    p.add_argument("paths", nargs="*", help="files or directories to scan")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--select", action="append", default=None, metavar="CODE",
                   help="run only these rule codes (repeatable, comma-ok)")
    p.add_argument("--ignore", action="append", default=None, metavar="CODE",
                   help="skip these rule codes (repeatable, comma-ok)")
    p.add_argument("--baseline", type=Path, default=None,
                   help="baseline JSON of grandfathered finding fingerprints")
    p.add_argument("--write-baseline", type=Path, default=None, metavar="PATH",
                   help="write current findings to PATH as the new baseline")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rule table and exit")
    p.add_argument("--dump-markdown", action="store_true",
                   help="print the docs/ANALYSIS_TORCH.md rule catalog and exit")
    return p.parse_args(argv)


def _split_codes(values: Optional[List[str]]) -> Optional[List[str]]:
    if not values:
        return None
    return [c.strip() for v in values for c in v.split(",") if c.strip()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse_args(argv)

    from repro_torch.analysis import rules as _rules  # noqa: F401  (self-registration)

    if args.dump_markdown:
        sys.stdout.write(dump_markdown())
        return 0
    if args.list_rules:
        for code in sorted(RULES):
            cls = RULES[code]
            print(f"{code}  {cls.name:24s} {cls.summary}")
        return 0
    if not args.paths:
        print("error: no paths to scan "
              "(try: python -m repro_torch.analysis src/repro_torch)",
              file=sys.stderr)
        return 2

    try:
        rules = select_rules(_split_codes(args.select), _split_codes(args.ignore))
        project = load_project([Path(p) for p in args.paths])
        findings = run_rules(project, rules)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline is not None:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    baseline: Set[str] = set()
    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        default = find_repo_root(Path(args.paths[0])) / "analysis_baseline.json"
        if default.exists():
            baseline = load_baseline(default)

    new = [f for f in findings if f.fingerprint not in baseline]
    old = len(findings) - len(new)

    if args.format == "json":
        print(json.dumps({
            "findings": [
                {"code": f.code, "message": f.message, "path": f.path,
                 "line": f.line, "col": f.col, "symbol": f.symbol,
                 "fingerprint": f.fingerprint}
                for f in new
            ],
            "baselined": old,
            "files_scanned": len(project.modules),
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        suffix = f" ({old} baselined)" if old else ""
        print(f"{len(new)} finding(s) in {len(project.modules)} file(s){suffix}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
