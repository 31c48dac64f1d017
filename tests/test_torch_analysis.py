"""The port's invariant linter (``repro_torch.analysis``) and its registry
reference: the rule registry laws, every rule's fixtures, the six rules
that do not trace held finding for finding against the JAX package's
linter, the torch-only forms of JIT01/JIT02/RNG01, the self-scan of
``src/repro_torch``, noqa/baseline/CLI behaviour, catalog drift,
start-up without torch, the RNG-audit anchor (two async runs give
bit-identical traces), and ``docs/REGISTRY_TORCH.md`` against the live
registries and against ``docs/REGISTRY.md``."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import RULES, Finding, Rule, run_analysis
from repro_torch.analysis.__main__ import dump_markdown, main

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
TORCH_FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"
FIXTURE_DOC = FIXTURES / "registry_doc.md"
SRC = REPO / "src" / "repro_torch"

ALL_CODES = ("CKPT01", "CKPT02", "DOC01", "JIT01", "JIT02", "RNG01",
             "RNG02", "RP01")
# the rules whose targets do not depend on what traces a body
NON_TRACING = ("RP01", "RNG01", "RNG02", "CKPT01", "CKPT02", "DOC01")


def scan(stem, codes, fixtures=FIXTURES):
    return run_analysis([fixtures / f"{stem}.py"], select=codes,
                        registry_doc=FIXTURE_DOC)


# ------------------------------------------------------------ registry laws

def test_rule_registry_complete():
    assert tuple(sorted(RULES)) == ALL_CODES


def test_rule_registry_laws():
    """Every rule: code matches its key, kebab name, one-line summary,
    full docstring (the docs/ANALYSIS_TORCH.md catalog source), check impl;
    the names are the JAX package's."""
    from repro.analysis import RULES as REF_RULES

    for code, cls in RULES.items():
        assert cls.code == code and code.isupper()
        assert cls.name and cls.name == cls.name.lower() and " " not in cls.name
        assert cls.summary and "\n" not in cls.summary
        assert cls.__doc__ and len(cls.__doc__.strip()) > 80
        assert cls.check is not Rule.check
        assert cls.name == REF_RULES[code].name


def test_duplicate_rule_code_rejected():
    from repro_torch.analysis import register_rule

    class Dup(Rule):
        code = "RNG01"
        name = "dup"
        summary = "dup"

    with pytest.raises(ValueError, match="duplicate"):
        register_rule(Dup)


def test_finding_fingerprint_ignores_line_numbers():
    """Line-independent, and the JAX package's fingerprint for the same
    finding, so a baseline reads the same in both."""
    from repro.analysis import Finding as RefFinding

    a = Finding("RNG01", "msg", "p.py", line=3, symbol="f")
    b = Finding("RNG01", "msg", "p.py", line=99, symbol="f")
    assert a.fingerprint == b.fingerprint
    assert a.fingerprint != Finding("RNG01", "other", "p.py", 3, symbol="f").fingerprint
    assert a.fingerprint == RefFinding("RNG01", "msg", "p.py", line=3, symbol="f").fingerprint


def test_axis_map_is_the_ports_registry():
    """RP01/DOC01's registration names are the port's 11 registries."""
    from repro_torch.analysis import rules
    from repro_torch.api import registry

    regs = {n: v for n, v in vars(registry).items() if isinstance(v, registry.Registry)}
    assert {n: r.kind for n, r in regs.items()} == rules._REGISTRY_VARS
    fns = {n for n in vars(registry) if n.startswith("register_")}
    assert fns == set(rules._REGISTER_FNS)
    for n, axis in rules._REGISTER_FNS.items():
        assert getattr(registry, n).__self__.kind == axis


# ------------------------------------------------- per-rule fixture checks

@pytest.mark.parametrize("stem,code,min_bad,fixtures", [
    ("rp01", "RP01", 6, FIXTURES),
    ("rng01", "RNG01", 4, FIXTURES),
    ("rng01_torch", "RNG01", 19, TORCH_FIXTURES),
    ("rng02", "RNG02", 1, FIXTURES),
    ("jit01", "JIT01", 5, TORCH_FIXTURES),
    ("jit02", "JIT02", 3, TORCH_FIXTURES),
    ("ckpt01", "CKPT01", 1, FIXTURES),
    ("ckpt02", "CKPT02", 4, FIXTURES),
    ("doc01", "DOC01", 1, FIXTURES),
])
def test_rule_fixtures(stem, code, min_bad, fixtures):
    bad = scan(f"{stem}_bad", [code], fixtures)
    assert len(bad) >= min_bad
    assert all(f.code == code for f in bad)
    assert scan(f"{stem}_good", [code], fixtures) == []


@pytest.mark.parametrize("stem", ["jit01", "jit02", "rng01_torch"])
def test_torch_good_fixtures_are_clean_under_every_rule(stem):
    assert run_analysis([TORCH_FIXTURES / f"{stem}_good.py"], registry_doc=FIXTURE_DOC) == []


@pytest.mark.parametrize("path", sorted(FIXTURES.glob("*.py")), ids=lambda p: p.name)
def test_non_tracing_rules_match_the_reference(path):
    """RP01, RNG01, RNG02, CKPT01, CKPT02 and DOC01 give the JAX package's
    findings on its fixtures: code, path, line, col, symbol and message,
    up to the name of the registry module DOC01 tells the user to run."""
    from repro.analysis import run_analysis as ref_run

    def key(f, sub=False):
        msg = f.message.replace("repro.api.registry", "repro_torch.api.registry") if sub \
            else f.message
        return (f.code, f.path, f.line, f.col, f.symbol, msg)

    want = [key(f, True) for f in ref_run([path], select=NON_TRACING, registry_doc=FIXTURE_DOC)]
    got = [key(f) for f in run_analysis([path], select=NON_TRACING, registry_doc=FIXTURE_DOC)]
    assert got == want


def test_rp01_finding_kinds():
    msgs = "\n".join(f.message for f in scan("rp01_bad", ["RP01"]))
    assert "missing required method sample_latency" in msgs
    assert "reset must accept 3 positional argument(s)" in msgs
    assert "abstract NotImplementedError stub" in msgs
    assert "missing required method load_state" in msgs  # unpaired state_dict


def test_rng01_finding_kinds():
    msgs = "\n".join(f.message for f in scan("rng01_bad", ["RNG01"]))
    assert "module-global numpy.random.rand()" in msgs
    assert msgs.count("unseeded default_rng()") == 2  # bare and explicit-None
    assert "module-global random.random()" in msgs


def test_rng01_torch_global_generator_kinds():
    """Seeding torch's global generator, the eight factory draws without
    generator= (an explicit None counts as missing), the eight in-place
    draws and ``torch.nn.init``'s in-place form."""
    msgs = "\n".join(f.message for f in scan("rng01_torch_bad", ["RNG01"], TORCH_FIXTURES))
    for seed in ("torch.manual_seed()", "torch.cuda.manual_seed_all()", "torch.seed()"):
        assert f"{seed} seeds torch's module-global generator" in msgs
    for fn in ("rand", "randn", "randint", "randperm", "normal", "bernoulli",
               "multinomial", "poisson"):
        assert f"module-global torch.{fn}() draw without generator=" in msgs
    for fn in ("uniform_", "random_", "exponential_", "bernoulli_", "geometric_",
               "cauchy_", "log_normal_"):
        assert f"in-place .{fn}() without generator=" in msgs
    assert msgs.count("in-place .normal_() without generator=") == 2  # tensor and nn.init


def test_rng02_commuted_offsets_collide():
    (f,) = scan("rng02_bad", ["RNG02"])
    assert "seed-offset collision" in f.message
    assert "line 7" in f.message


def test_jit01_catches_every_marking_form():
    found = scan("jit01_bad", ["JIT01"], TORCH_FIXTURES)
    syms = {f.symbol for f in found}
    # with-block, called by name in it, make_graphed_callables, call-form
    # trace, partial decorator, bare decorator, lru_cache'd factory,
    # partial argument, a module class's forward (and a lambda, at module level)
    assert {"captured_block", "called_in_capture", "graphed", "traced",
            "partial_decorated", "decorated", "make_step.step", "scaled",
            "Net.forward"} <= syms
    msgs = "\n".join(f.message for f in found)
    for effect in ("print()", "time.time()", ".cpu()", ".tolist()",
                   "torch.cuda.synchronize()", "numpy.random.rand", "breakpoint()",
                   ".item() inside <lambda>", ".numpy()"):
        assert effect in msgs
    for how in ("captured by torch.cuda.graph", "captured by torch.cuda.make_graphed_callables",
                "traced by torch.jit.trace", "traced by torch.fx.symbolic_trace",
                "traced by torch.export.export"):
        assert how in msgs


def test_jit02_closure_global_and_block_mutation():
    found = scan("jit02_bad", ["JIT02"], TORCH_FIXTURES)
    assert {"memoized", "make_counter.step", "uses_global", "records_in_block"} <= \
        {f.symbol for f in found}
    msgs = "\n".join(f.message for f in found)
    assert "_CACHE" in msgs and "count" in msgs and "global statement" in msgs
    assert "the with-block captured by torch.cuda.graph mutates" in msgs


def test_jax_transforms_are_not_port_targets():
    """The JAX package's JIT fixtures mark bodies with jax.jit/vmap: the
    port's JIT rules aim at captures and traces, so they find nothing."""
    for stem in ("jit01_bad", "jit02_bad"):
        assert scan(stem, ["JIT01", "JIT02"]) == []


def test_ckpt01_names_the_dropped_key():
    (f,) = scan("ckpt01_bad", ["CKPT01"])
    assert "'rng_state'" in f.message and "never reads" in f.message


def test_ckpt02_finding_kinds():
    msgs = "\n".join(f.message for f in scan("ckpt02_bad", ["CKPT02"]))
    assert "state_dict embeds the unbounded accumulator self._hist_loss" in msgs
    assert "key 'loss_curve' embeds the unbounded accumulator loss_hist" in msgs
    assert "key 'rows' embeds the unbounded accumulator self._rows" in msgs
    assert "legacy 'history' key" in msgs


def test_doc01_undocumented_key():
    (f,) = scan("doc01_bad", ["DOC01"])
    assert "'fixture_undocumented'" in f.message
    assert "python -m repro_torch.api.registry --dump-markdown" in f.message


# ---------------------------------------------------------------- self-scan

def test_self_scan_src_repro_torch_is_clean():
    """The gate: the linter finds nothing in src/repro_torch (DOC01 against
    docs/REGISTRY_TORCH.md), and the committed baseline stays empty."""
    assert run_analysis([SRC]) == []
    baseline = json.loads((REPO / "analysis_baseline.json").read_text())
    assert baseline == {"version": 1, "findings": []}


def test_rng_audit_clean():
    assert run_analysis([SRC], select=["RNG01", "RNG02"]) == []


def test_self_scan_sees_the_ports_registrations():
    """The clean self-scan is not an empty one: the port's registrations
    are found on all 11 axes, and DOC01 reads docs/REGISTRY_TORCH.md."""
    from repro_torch.analysis import load_project
    from repro_torch.analysis.rules import _collect_jit_targets, collect_registrations

    project = load_project([SRC])
    assert project.registry_doc == REPO / "docs" / "REGISTRY_TORCH.md"
    assert len({r.axis for r in collect_registrations(project)}) == 11
    assert any(_collect_jit_targets(m) for m in project.modules)  # kernels/build.py's capture


# ----------------------------------------------------- noqa / baseline / CLI

VIOLATION = "import numpy as np\n\ndef f(n):\n    return np.random.rand(n)\n"


def test_noqa_suppresses_matching_code_only(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text(VIOLATION.replace("rand(n)", "rand(n)  # noqa: RNG01"))
    assert run_analysis([ok]) == []
    wrong = tmp_path / "wrong.py"
    wrong.write_text(VIOLATION.replace("rand(n)", "rand(n)  # noqa: RP01"))
    assert [f.code for f in run_analysis([wrong])] == ["RNG01"]
    blanket = tmp_path / "blanket.py"
    blanket.write_text(VIOLATION.replace("rand(n)", "rand(n)  # noqa"))
    assert run_analysis([blanket]) == []


def test_cli_baseline_cycle(tmp_path, capsys):
    src = tmp_path / "mod.py"
    src.write_text(VIOLATION)
    assert main([str(src)]) == 1  # new finding fails the scan
    base = tmp_path / "base.json"
    assert main([str(src), "--write-baseline", str(base)]) == 0
    capsys.readouterr()
    assert main([str(src), "--baseline", str(base)]) == 0  # grandfathered
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "1 baselined" in out
    src.write_text(VIOLATION + "\ndef g():\n    return np.random.randn()\n")
    assert main([str(src), "--baseline", str(base)]) == 1


def test_cli_reads_the_committed_baseline_only(tmp_path, capsys):
    """Without --baseline the CLI reads the repo's analysis_baseline.json
    and leaves it as it is; --write-baseline writes only its own path."""
    committed = REPO / "analysis_baseline.json"
    before = committed.read_bytes()
    fixture = TORCH_FIXTURES / "jit02_bad.py"
    assert main([str(fixture), "--select", "JIT02"]) == 1
    out = tmp_path / "new.json"
    assert main([str(fixture), "--select", "JIT02", "--write-baseline", str(out)]) == 0
    assert len(json.loads(out.read_text())["findings"]) == 4
    assert committed.read_bytes() == before


def test_cli_json_format(tmp_path, capsys):
    src = tmp_path / "mod.py"
    src.write_text(VIOLATION)
    assert main([str(src), "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["files_scanned"] == 1 and payload["baselined"] == 0
    (f,) = payload["findings"]
    assert f["code"] == "RNG01" and f["fingerprint"].startswith("RNG01:")


def test_cli_select_ignore(tmp_path, capsys):
    src = tmp_path / "mod.py"
    src.write_text(VIOLATION)
    assert main([str(src), "--select", "RP01"]) == 0
    assert main([str(src), "--ignore", "RNG01"]) == 0
    assert main([str(src), "--select", "NOPE"]) == 2
    assert main(["--list-rules"]) == 0
    assert len(capsys.readouterr().out.splitlines()) >= len(RULES)
    assert main([]) == 2


def test_cli_syntax_error_is_usage_error(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert main([str(bad)]) == 2
    assert "cannot parse" in capsys.readouterr().err


def test_cli_starts_without_torch_or_numpy():
    """``python -m repro_torch.analysis`` is stdlib only: with torch and
    numpy blocked it lists its rules and exits 0."""
    code = ("import sys, runpy\n"
            "sys.modules['torch'] = None\nsys.modules['numpy'] = None\n"
            "sys.argv = ['repro_torch.analysis', '--list-rules']\n"
            "runpy.run_module('repro_torch.analysis', run_name='__main__', alter_sys=True)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=60)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == len(ALL_CODES)


# ------------------------------------------------------------- docs catalog

def test_analysis_catalog_in_sync():
    """docs/ANALYSIS_TORCH.md is generated from the rule docstrings."""
    assert (REPO / "docs" / "ANALYSIS_TORCH.md").read_text() == dump_markdown()


def test_catalog_covers_every_rule():
    md = dump_markdown()
    for code, cls in RULES.items():
        assert f"## {code} — {cls.name}" in md
        assert cls.summary in md


# ---------------------------------------------------------- registry reference

def _registry_tables(text):
    """{axis: {key: options}} from a generated registry reference."""
    tables, axis = {}, None
    for line in text.splitlines():
        sec = re.match(r"^## (\w+) \(", line)
        if sec:
            axis = sec.group(1)
            tables[axis] = {}
            continue
        row = re.match(r"^\| `([^`]+)` \| (.*?) \| ", line)
        if row and axis is not None:
            tables[axis][row.group(1)] = row.group(2)
    return tables


def test_registry_reference_in_sync():
    import repro_torch.api  # noqa: F401
    import repro_torch.api.engine  # noqa: F401
    from repro_torch.api.registry import dump_markdown as registry_markdown

    assert (REPO / "docs" / "REGISTRY_TORCH.md").read_text() == registry_markdown()


def test_registry_reference_matches_the_reference_doc():
    """The same 11 axes, the same keys and the same options as
    docs/REGISTRY.md, except that the backends also take ``device``
    (and ``sharded`` its ``mesh``)."""
    port = _registry_tables((REPO / "docs" / "REGISTRY_TORCH.md").read_text())
    ref = _registry_tables((REPO / "docs" / "REGISTRY.md").read_text())
    assert list(port) == list(ref) and len(port) == 11
    for axis in ref:
        assert sorted(port[axis]) == sorted(ref[axis]), axis
        for key, opts in ref[axis].items():
            got = port[axis][key]
            if axis == "backend":
                extra = "`device=None`, `mesh=None`" if key == "sharded" else "`device=None`"
                assert (got, opts) == (extra, "—"), key
            else:
                assert got == opts, (axis, key)


# ------------------------------------------- RNG-audit bit-identity anchor

def test_async_run_bit_identical():
    """The property the RNG rules guard: with every stream seeded and
    offset-disjoint, two identical async runs of the port produce
    bit-identical traces."""
    import numpy as np

    from repro_torch.api import (ClientPopulationSpec, RuntimeSpec, ScenarioSpec,
                                 TaskSpec, run_scenario)

    def spec():
        return ScenarioSpec(
            name="rng-audit",
            seed=3,
            tasks=[TaskSpec("synth-mnist", options={"n_range": [40, 60]}),
                   TaskSpec("synth-fmnist", options={"n_range": [40, 60]})],
            clients=ClientPopulationSpec(n_clients=8, speed_profile="bimodal"),
            runtime=RuntimeSpec(mode="async", tau=2, total_arrivals=24, buffer_size=3),
        )

    a, b = run_scenario(spec(), device="cpu"), run_scenario(spec(), device="cpu")
    np.testing.assert_array_equal(a.loss, b.loss)
    np.testing.assert_array_equal(a.acc, b.acc)
    np.testing.assert_array_equal(a.time, b.time)
    np.testing.assert_array_equal(a.arrivals, b.arrivals)
    assert a.assignments == b.assignments
