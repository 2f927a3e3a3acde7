"""raylint for the port (ray_tpu_torch/devtools/lint/): the tree-is-clean
gate over ray_tpu_torch/, the rule fixtures, and the analyzer held
against the reference (ray_tpu/devtools/lint/).

- (a) parity: every reference fixture (tests/lint_fixtures/) is copied
  with ``ray_tpu`` renamed ``ray_tpu_torch``; the port's findings on the
  copy equal the reference's on the original (rule, line, column,
  severity, message, hint and SPMD facts, names renamed). The positive
  fixtures of the three rules whose defects are JAX calls (jax.jit,
  shard_map, lax collectives) are left out: the port's rules are aimed
  at its own idioms there, and (b) holds them instead.
- (b) the re-aimed rules: each torch fixture pair (tests/
  torch_lint_fixtures/) translates the reference's pair line for line;
  on those lines the port flags the defects the reference flags in its
  JAX pair, with the same axis, arity, root or schedule facts (the
  schedule's ops translated, ``REF_TO_PORT_OPS``); lines below them hold
  the port's further forms, each marked. Negative fixtures stay silent.
- (c) the reference's own cases re-aimed at the port: cache, call graph,
  suppressions, the CLI's JSON schema and exit codes, the SPMD extract,
  and three defects injected into real port sources.
- (d) the gate: 0 unsuppressed findings and 0 parse errors over more
  than 100 files, with the cold and warm tree runs shared by a module
  fixture (the warm run within 20% of the cold one).

The reference is loaded through stub parent packages ``ray_tpu`` and
``ray_tpu.devtools`` (``import ray_tpu`` fails on Python >= 3.11, see
test_torch_support.py); it is pure ``ast`` and imports no JAX.
"""

import ast
import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap
import time
import tokenize
import types

import pytest

from ray_tpu_torch.devtools.lint import all_rules, rule_ids, run_lint
from ray_tpu_torch.devtools.lint import engine as lint_engine
from ray_tpu_torch.devtools.lint.callgraph import ProjectGraph
from ray_tpu_torch.devtools.lint.engine import LintReport, collect_files
from ray_tpu_torch.devtools.lint.summaries import summarize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ray_tpu_torch")
TESTS = os.path.dirname(os.path.abspath(__file__))
REF_FIXTURES = os.path.join(TESTS, "lint_fixtures")
FIXTURES = os.path.join(TESTS, "torch_lint_fixtures")

# rules whose fixture pair is the port's own translation (b)
REAIMED = ("mesh-axis-consistency", "spec-arity", "host-effect-in-jit",
           "divergent-collective", "collective-schedule-divergence",
           "large-closure-capture")
# reference positives whose defects are JAX calls the port does not see
JAX_ONLY_POS = ("mesh_axis_consistency_pos.py", "spec_arity_pos.py",
                "host_effect_in_jit_pos.py")
# the op vocabulary of the reference's schedules, in the torch fixtures
REF_TO_PORT_OPS = {("allreduce", "grads"): ("all_reduce", "dp"),
                   ("barrier", "grads"): ("broadcast", "dp"),
                   ("psum", "dp"): ("all_reduce", "dp"),
                   ("all_gather", "dp"): ("all_to_all", "dp")}
_RENAME = re.compile(r"\bray_tpu\b")


def _renamed(text: str) -> str:
    return _RENAME.sub("ray_tpu_torch", text)


# ---- the reference analyzer, through stub parent packages -----------------

_REF_MODULES: dict = {}


def _is_ray_tpu(name: str) -> bool:
    return name == "ray_tpu" or name.startswith("ray_tpu.")


@contextlib.contextmanager
def reference_lint():
    """The reference's ``ray_tpu.devtools.lint`` package with its stub
    parents importable; every ``ray_tpu*`` entry of sys.modules is put
    back as it was on exit (xdist runs other files in this process).
    Every module of the analyzer is imported up front and kept between
    uses, so its rule registry is built once."""
    saved = {k: v for k, v in sys.modules.items() if _is_ray_tpu(k)}
    for k in saved:
        del sys.modules[k]
    try:
        if _REF_MODULES:
            sys.modules.update(_REF_MODULES)
        else:
            for name in ("ray_tpu", "ray_tpu.devtools"):
                m = types.ModuleType(name)
                m.__path__ = [os.path.join(REPO, *name.split("."))]
                sys.modules[name] = m
            for name in ("lint", "lint.engine", "lint.callgraph",
                         "lint.summaries", "lint.rules", "lint.cli"):
                importlib.import_module(f"ray_tpu.devtools.{name}")
            _REF_MODULES.update({k: v for k, v in sys.modules.items()
                                 if _is_ray_tpu(k)})
        yield sys.modules["ray_tpu.devtools.lint"]
    finally:
        for k in [k for k in sys.modules if _is_ray_tpu(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def _key(f, rename=False):
    fix = _renamed if rename else (lambda s: s)
    return (f.rule, f.line, f.col, f.severity, fix(f.message), fix(f.hint),
            json.dumps(f.spmd, sort_keys=True), f.suppressed)


def _ref_fixture_copy(tmp_path, name: str) -> str:
    """A reference fixture copied into tmp with ray_tpu renamed."""
    with open(os.path.join(REF_FIXTURES, name), encoding="utf-8") as fh:
        src = fh.read()
    dest = tmp_path / name
    dest.write_text(_renamed(src))
    return str(dest)


def _fixture(rule_id: str, kind: str, tmp_path=None) -> str:
    """The port's fixture of a rule: its own translation for a re-aimed
    rule, else the reference's (renamed into tmp_path when given)."""
    name = f"{rule_id.replace('-', '_')}_{kind}.py"
    if rule_id in REAIMED:
        return os.path.join(FIXTURES, name)
    if tmp_path is None:
        return os.path.join(REF_FIXTURES, name)
    return _ref_fixture_copy(tmp_path, name)


@pytest.fixture(scope="module")
def tree_runs(tmp_path_factory):
    """(cold_report, warm_report, cold_seconds, warm_seconds) over
    ray_tpu_torch/ with a shared result cache."""
    cache = str(tmp_path_factory.mktemp("raylint_cache"))
    t0 = time.perf_counter()
    cold = run_lint([PKG], cache_dir=cache)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = run_lint([PKG], cache_dir=cache)
    t_warm = time.perf_counter() - t0
    return cold, warm, t_cold, t_warm


# ---- (d) the gate -----------------------------------------------------------

def test_ray_tpu_torch_tree_is_clean(tree_runs):
    report = tree_runs[0]
    assert report.files_scanned > 100, "lint saw too few files — broken walk?"
    unsuppressed = report.unsuppressed
    msg = "\n".join(f.render() for f in unsuppressed)
    assert not unsuppressed, f"raylint findings in ray_tpu_torch/:\n{msg}"
    assert report.parse_errors == 0


def _directives(path):
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT and "raylint:" in tok.string:
            yield tok.start[0], tok.string


def test_every_suppression_in_the_tree_gives_its_reason(tree_runs):
    bare = [f"{path}:{line}: {text}"
            for path in collect_files([PKG])
            for line, text in _directives(path)
            if " -- " not in text]
    assert not bare, "suppressions without a `-- reason`:\n" + \
        "\n".join(bare)
    # each suppression the tree carries is used by a finding
    assert tree_runs[0].suppressed
    assert not [f for f in tree_runs[0].findings
                if f.rule == "useless-suppression"]


# ---- result cache ----------------------------------------------------------

def test_warm_run_serves_every_file_from_cache(tree_runs):
    cold, warm = tree_runs[0], tree_runs[1]
    assert cold.files_from_cache == 0
    assert warm.files_from_cache == warm.files_scanned == cold.files_scanned
    assert sorted(f.render() for f in warm.findings) == \
        sorted(f.render() for f in cold.findings)


def test_warm_run_is_fast(tree_runs):
    _, _, t_cold, t_warm = tree_runs
    assert t_warm < 0.20 * t_cold, (
        f"warm cache run took {t_warm:.2f}s vs {t_cold:.2f}s cold "
        f"({100 * t_warm / t_cold:.0f}%, budget 20%)")


def _spy(monkeypatch):
    analyzed = []
    real = lint_engine._analyze_file

    def spy(pf, file_rules, need_summary):
        analyzed.append(pf.path)
        return real(pf, file_rules, need_summary)

    monkeypatch.setattr(lint_engine, "_analyze_file", spy)
    return analyzed


def test_cache_hit_skips_reanalysis(tmp_path, monkeypatch):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    return 1\n")
    cache = str(tmp_path / "cache")
    analyzed = _spy(monkeypatch)
    run_lint([str(p)], cache_dir=cache)
    assert analyzed == [str(p)]
    rep = run_lint([str(p)], cache_dir=cache)
    assert analyzed == [str(p)], "cache hit must not re-analyze"
    assert rep.files_from_cache == 1
    p.write_text("def f():\n    return 2\n")
    run_lint([str(p)], cache_dir=cache)
    assert len(analyzed) == 2, "content change must invalidate"


def test_ruleset_version_bump_invalidates_cache(tmp_path, monkeypatch):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    return 1\n")
    cache = str(tmp_path / "cache")
    analyzed = _spy(monkeypatch)
    run_lint([str(p)], cache_dir=cache)
    run_lint([str(p)], cache_dir=cache)
    assert len(analyzed) == 1
    monkeypatch.setattr(lint_engine, "RULESET_VERSION",
                        lint_engine.RULESET_VERSION + 1)
    rep = run_lint([str(p)], cache_dir=cache)
    assert len(analyzed) == 2, "version bump must invalidate every entry"
    assert rep.files_from_cache == 0


def test_spmd_extract_edit_invalidates_cache(tmp_path, monkeypatch):
    """Editing the SPMD-extract source (summaries.py) must flush warm
    cache entries — the fingerprint hashes the analyzer's own source,
    not just RULESET_VERSION."""
    import ray_tpu_torch.devtools.lint.summaries as summaries_mod

    p = tmp_path / "m.py"
    p.write_text("def f():\n    return 1\n")
    cache = str(tmp_path / "cache")
    analyzed = _spy(monkeypatch)
    run_lint([str(p)], cache_dir=cache)
    run_lint([str(p)], cache_dir=cache)
    assert len(analyzed) == 1

    fp_before = lint_engine.ruleset_fingerprint(all_rules())
    real_getsource = lint_engine.inspect.getsource

    def edited(obj):
        src = real_getsource(obj)
        if obj is summaries_mod:
            return src + "\n# edited: schedule tokens gain a field\n"
        return src

    monkeypatch.setattr(lint_engine.inspect, "getsource", edited)
    assert lint_engine.ruleset_fingerprint(all_rules()) != fp_before
    rep = run_lint([str(p)], cache_dir=cache)
    assert len(analyzed) == 2, "edited SPMD extract must re-analyze"
    assert rep.files_from_cache == 0


# ---- (e) the catalog ---------------------------------------------------------

def test_rule_ids_are_the_references():
    with reference_lint() as ref:
        want = ref.rule_ids()
    assert rule_ids() == want
    assert len(want) == 17


def test_every_rule_has_fixtures():
    """New rules can't ship untested: both fixture files must exist."""
    missing = [f"{rid}: {kind}" for rid in rule_ids()
               for kind in ("pos", "neg")
               if not os.path.exists(_fixture(rid, kind))]
    assert not missing, f"rules without fixtures: {missing}"
    ours = {f[:-len("_pos.py")].replace("_", "-")
            for f in os.listdir(FIXTURES) if f.endswith("_pos.py")}
    assert ours == set(REAIMED)
    assert not [f for f in os.listdir(FIXTURES) if f.startswith("test_")]


@pytest.mark.parametrize("rule_id", rule_ids())
def test_rules(rule_id, tmp_path):
    rule = next(r for r in all_rules() if r.id == rule_id)
    pos = run_lint([_fixture(rule_id, "pos", tmp_path)], rules=[rule])
    hits = [f for f in pos.unsuppressed if f.rule == rule_id]
    assert hits, f"{rule_id}: positive fixture triggered nothing"
    for f in hits:
        assert f.line > 0 and f.message and f.path.endswith("_pos.py")
        assert f.severity == rule.severity

    neg = run_lint([_fixture(rule_id, "neg", tmp_path)], rules=[rule])
    bad = [f.render() for f in neg.unsuppressed if f.rule == rule_id]
    assert not bad, f"{rule_id}: negative fixture flagged:\n" + "\n".join(bad)


# ---- (a) reference parity ----------------------------------------------------

_PARITY = sorted(f for f in os.listdir(REF_FIXTURES)
                 if f.endswith(".py") and f not in JAX_ONLY_POS)


@pytest.mark.parametrize("name", _PARITY)
def test_reference_parity_on_its_fixtures(name, tmp_path):
    """Every rule runs on the fixture; the findings are the same."""
    copy = _ref_fixture_copy(tmp_path, name)
    with reference_lint() as ref:
        want = sorted(_key(f, rename=True)
                      for f in ref.run_lint([os.path.join(REF_FIXTURES,
                                                          name)]).findings)
    got = sorted(_key(f) for f in run_lint([copy]).findings)
    assert got == want
    if name.endswith("_pos.py"):
        assert got, f"{name}: the positive fixture raised nothing"


# ---- (b) the re-aimed rules' torch pairs ------------------------------------

def _facts(rule_id, f):
    """The facts a re-aimed rule's finding must share with the
    reference's on the same line."""
    sp = f.spmd
    if rule_id == "mesh-axis-consistency":
        return sp["axis"], tuple(sp["declared_axes"])
    if rule_id == "spec-arity":
        return (sp["in_specs"], sp["out_specs"], tuple(sp["params"]),
                sp["returns"], f.message.split(": ", 1)[1])
    if rule_id == "host-effect-in-jit":
        return sp["jit_root"], sp["effect"]
    if rule_id == "collective-schedule-divergence":
        return tuple(tuple(t) for t in sp["schedule_true"]), \
            tuple(tuple(t) for t in sp["schedule_false"])
    if rule_id == "large-closure-capture":
        return f.message
    return ()


def _translated(rule_id, facts):
    if rule_id == "collective-schedule-divergence":
        return tuple(tuple(REF_TO_PORT_OPS[t] for t in arm)
                     for arm in facts)
    return facts


# the further forms below each torch fixture's translated part:
# {rule: {line: facts}}
_EXTRA = {
    "mesh-axis-consistency": {
        34: ("tpp", ("dp", "tp")), 35: ("fdsp", ("dp", "tp")),
        36: ("pd", ("dp", "tp")), 37: ("sq", ("dp", "tp")),
        38: ("tpx", ("dp", "tp")), 39: ("spx", ("dp", "tp")),
        40: ("ssp", ("dp", "tp"))},
    "spec-arity": {
        37: (3, -1, (2, 2, 0, "x"), -1, "in_specs has 3 spec(s) but the "
             "wrapped function takes 2 positional argument(s)"),
        43: (1, -1, (2, 2, 0, "x"), -1, "in_specs has 1 spec(s) but the "
             "wrapped function takes 2 positional argument(s)"),
        51: (2, 3, (2, 2, 0, "x"), 2, "out_specs has 3 spec(s) but the "
             "wrapped function returns a 2-tuple")},
    "host-effect-in-jit": {
        46: ("the torch.cuda.graph capture in capture (line 52)", "metric"),
        54: ("the torch.cuda.graph capture in capture (line 52)",
             "wall-clock"),
        60: ("_paced", "sleep")},
    "divergent-collective": {31: (), 43: ()},
    "collective-schedule-divergence": {},
    "large-closure-capture": {
        27: "remote project captures module-level array 'WEIGHTS' "
            "(defined line 22) in its closure — serialized per task"},
}


def _by_line(report, rule_id):
    out = {}
    for f in report.unsuppressed:
        if f.rule == rule_id:
            out.setdefault(f.line, []).append(f)
    return out


@pytest.mark.parametrize("rule_id", REAIMED)
def test_reaimed_rule_flags_the_references_defects(rule_id):
    name = f"{rule_id.replace('-', '_')}_pos.py"
    rule = next(r for r in all_rules() if r.id == rule_id)
    ref_path = os.path.join(REF_FIXTURES, name)
    with open(ref_path, encoding="utf-8") as fh:
        n_ref = len(fh.read().splitlines())
    with reference_lint() as ref:
        ref_rule = next(r for r in ref.all_rules() if r.id == rule_id)
        want = {line: sorted(_translated(rule_id, _facts(rule_id, f))
                             for f in fs)
                for line, fs in _by_line(ref.run_lint(
                    [ref_path], rules=[ref_rule]), rule_id).items()}
    got = _by_line(run_lint([os.path.join(FIXTURES, name)], rules=[rule]),
                   rule_id)
    assert want, f"{rule_id}: the reference's positive fixture is silent"
    assert {line: sorted(_facts(rule_id, f) for f in fs)
            for line, fs in got.items() if line <= n_ref} == want
    assert {line: [_facts(rule_id, f) for f in fs]
            for line, fs in got.items() if line > n_ref} == \
        {line: [facts] for line, facts in _EXTRA[rule_id].items()}


@pytest.mark.parametrize("rule_id", REAIMED)
def test_reaimed_rule_is_silent_on_its_negative(rule_id):
    name = f"{rule_id.replace('-', '_')}_neg.py"
    rep = run_lint([os.path.join(FIXTURES, name)])
    assert not [f.render() for f in rep.unsuppressed]


def test_port_does_not_read_jax_idioms():
    """The reference's JAX positives (jax.jit, shard_map, lax collectives)
    are not the port's idioms: its re-aimed rules see none of them, and
    raise nothing else either."""
    for name in JAX_ONLY_POS:
        rep = run_lint([os.path.join(REF_FIXTURES, name)])
        got = [(f.rule, f.spmd.get("axis")) for f in rep.unsuppressed]
        # a PartitionSpec literal is the one form both packages share
        assert got == ([("mesh-axis-consistency", "fdsp")]
                       if name.startswith("mesh") else [])


# ---- call graph ------------------------------------------------------------

def _graph(sources, depth=6):
    files = []
    for mod, src in sources.items():
        src = textwrap.dedent(src)
        files.append(summarize(ast.parse(src), src, f"{mod}.py"))
    return ProjectGraph(files, depth=depth)


def test_callgraph_actor_method_resolution():
    g = _graph({"mods": """
        import ray_tpu_torch

        class Base:
            def ping(self):
                return 1

        @ray_tpu_torch.remote
        class Worker(Base):
            def work(self):
                return self.ping()

        class Driver:
            def __init__(self):
                self._w = Worker.remote()
    """})
    # inherited method resolves through the base class
    assert g.method_node("Worker", "ping") == "mods:Base.ping"
    succ = {callee for callee, _ in g.successors(
        g.method_node("Worker", "work"))}
    assert "mods:Base.ping" in succ
    # actor-method index and handle typing
    assert g.actor_methods["work"] == ["Worker"]
    assert g.attr_type("Driver", "_w") == ("actor:W" + "orker", "mods",
                                           "Driver")


def test_callgraph_depth_cap_and_cycles():
    chain = "\n".join(
        [f"def f{i}():\n    return f{i + 1}()" for i in range(5)]
        + ["def f5():\n    return 0"])
    g = _graph({"chain": chain}, depth=2)
    reached = {nid for nid, _ in g.reach("chain:f0")}
    assert "chain:f2" in reached and "chain:f3" not in reached

    # mutual recursion terminates and reaches both nodes
    g2 = _graph({"loop": """
        def a():
            return b()

        def b():
            return a()
    """})
    assert {nid for nid, _ in g2.reach("loop:a")} == {"loop:a", "loop:b"}


def test_callgraph_cross_module_import_resolution():
    g = _graph({
        "helpers": """
            def deep():
                return 1
        """,
        "caller": """
            from helpers import deep

            def top():
                return deep()
        """})
    assert g.resolve_call("caller", "", "deep") == "helpers:deep"
    path = dict(g.reach("caller:top"))["helpers:deep"]
    assert [site[0] for site in path] == ["deep"]


def test_module_names_anchor_on_the_port():
    from ray_tpu_torch.devtools.lint.summaries import module_name_for

    assert module_name_for(os.path.join(PKG, "serve", "controller.py")) == \
        "ray_tpu_torch.serve.controller"
    assert module_name_for(os.path.join(PKG, "collective",
                                        "__init__.py")) == \
        "ray_tpu_torch.collective"
    assert module_name_for("/tmp/x/fixture_pos.py") == "fixture_pos"


# ---- suppressions ----------------------------------------------------------

def test_suppressed_findings_counted_not_fatal(tmp_path):
    src = textwrap.dedent("""\
        def kick(actor, x):
            actor.go.remote(x)  # raylint: disable=leaked-object-ref -- why
    """)
    p = tmp_path / "supp.py"
    p.write_text(src)
    report = run_lint([str(p)])
    assert not report.unsuppressed
    assert [f.rule for f in report.suppressed] == ["leaked-object-ref"]


def test_suppression_comment_above(tmp_path):
    src = textwrap.dedent("""\
        def kick(actor, x):
            # raylint: disable=leaked-object-ref -- fire and forget
            actor.go.remote(x)
    """)
    p = tmp_path / "supp2.py"
    p.write_text(src)
    report = run_lint([str(p)])
    assert not report.unsuppressed and len(report.suppressed) == 1


def test_wrong_rule_suppression_does_not_mask(tmp_path):
    src = ("def kick(a, x):\n"
           "    a.go.remote(x)  # raylint: disable=pep479-stopiteration\n")
    p = tmp_path / "supp3.py"
    p.write_text(src)
    report = run_lint([str(p)])
    rules = [f.rule for f in report.unsuppressed]
    assert "leaked-object-ref" in rules       # the real finding survives
    assert "useless-suppression" in rules     # and the stale disable is debt


def test_directive_in_string_literal_is_inert(tmp_path):
    src = textwrap.dedent('''\
        DOC = """example: # raylint: disable=leaked-object-ref"""


        def kick(a, x):
            a.go.remote(x)
    ''')
    p = tmp_path / "supp4.py"
    p.write_text(src)
    report = run_lint([str(p)])
    assert [f.rule for f in report.unsuppressed] == ["leaked-object-ref"]


# ---- resilience ------------------------------------------------------------

def test_syntax_error_reported_not_crash(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("def ok():\n    return 1\n")
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    report = run_lint([str(tmp_path)])
    assert report.parse_errors == 1
    assert report.files_scanned == 1  # good.py still analyzed
    assert any(f.rule == "syntax-error" and f.path.endswith("bad.py")
               for f in report.findings)


def test_skips_pycache_and_generated(tmp_path):
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "junk.py").write_text("x.go.remote(1)\n")
    (tmp_path / "schema_pb2.py").write_text("x.go.remote(1)\n")
    (tmp_path / "protobuf").mkdir()
    (tmp_path / "protobuf" / "msgs.py").write_text("x.go.remote(1)\n")
    (tmp_path / ".raylint_cache").mkdir()
    (tmp_path / ".raylint_cache" / "stale.py").write_text("x.go.remote(1)\n")
    (tmp_path / "real.py").write_text("y = 1\n")
    files = collect_files([str(tmp_path)])
    assert [os.path.basename(f) for f in files] == ["real.py"]


# ---- CLI: --json schema + severity + summary line -------------------------

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", "--no-cache",
         *args],
        capture_output=True, text=True, cwd=REPO, timeout=300)


def test_cli_json_schema(tmp_path):
    proc = _run_cli("--json", _fixture("leaked-object-ref", "pos", tmp_path))
    assert proc.returncode == 1, proc.stderr  # unsuppressed findings
    doc = json.loads(proc.stdout)  # stdout is pure JSON...
    assert "RAYLINT" in proc.stderr  # ...summary one-liner on stderr
    assert doc["version"] == 3
    summary = doc["summary"]
    for key in ("files_scanned", "files_skipped", "files_from_cache",
                "parse_errors", "findings", "suppressed", "by_rule"):
        assert key in summary
    assert summary["findings"] >= 1
    assert summary["by_rule"].get("leaked-object-ref", 0) >= 1
    for f in doc["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message",
                          "hint", "severity", "suppressed", "spmd"}
        assert f["severity"] in ("error", "warn")
        assert isinstance(f["line"], int) and isinstance(f["suppressed"], bool)
        assert isinstance(f["spmd"], dict)


def test_cli_json_carries_spmd_facts():
    """v3 findings from the SPMD pack carry their backing facts: the
    declared-axes universe for axis findings, the per-arm schedule diff
    for divergence findings."""
    proc = _run_cli("--json", "--rule", "mesh-axis-consistency",
                    _fixture("mesh-axis-consistency", "pos"))
    doc = json.loads(proc.stdout)
    axes = [f for f in doc["findings"]
            if f["rule"] == "mesh-axis-consistency"]
    assert axes and all(
        f["spmd"]["axis"] and f["spmd"]["declared_axes"] for f in axes)
    assert axes[0]["spmd"]["declared_axes"] == ["dp", "tp"]

    proc = _run_cli("--json", "--rule", "collective-schedule-divergence",
                    _fixture("collective-schedule-divergence", "pos"))
    doc = json.loads(proc.stdout)
    div = [f for f in doc["findings"]
           if f["rule"] == "collective-schedule-divergence"]
    assert div
    sp = div[0]["spmd"]
    assert sp["schedule_true"] == [["all_reduce", "dp"],
                                   ["broadcast", "dp"]]
    assert sp["schedule_false"] == [["broadcast", "dp"],
                                    ["all_reduce", "dp"]]


def test_report_reads_v1_v2_documents():
    v1 = {"version": 1,
          "summary": {"files_scanned": 1, "findings": 1},
          "findings": [{"rule": "leaked-object-ref", "path": "x.py",
                        "line": 3, "col": 4, "message": "m", "hint": "",
                        "suppressed": False}]}
    rep = LintReport.from_dict(v1)
    assert rep.findings[0].severity == "error"  # v1 default
    assert rep.findings[0].line == 3
    v2 = {"version": 2,
          "summary": {"files_scanned": 1, "findings": 1},
          "findings": [{"rule": "leaked-object-ref", "path": "x.py",
                        "line": 3, "col": 4, "message": "m", "hint": "",
                        "severity": "warn", "suppressed": False}]}
    rep2 = LintReport.from_dict(v2)
    assert rep2.findings[0].severity == "warn"
    assert rep2.findings[0].spmd == {}          # v2 default
    rep3 = LintReport.from_dict(rep2.to_dict())  # v3 round-trip
    assert rep3.findings[0].severity == "warn"


def test_cli_fail_on_threshold(tmp_path):
    pos = _fixture("useless-suppression", "pos", tmp_path)
    on_warn = _run_cli("--rule", "useless-suppression", pos)
    assert on_warn.returncode == 1, on_warn.stdout + on_warn.stderr
    on_error = _run_cli("--rule", "useless-suppression",
                        "--fail-on", "error", pos)
    assert on_error.returncode == 0, on_error.stdout + on_error.stderr
    assert "useless-suppression" in on_error.stdout  # still reported


def test_cli_summary_line_and_exit_codes(tmp_path):
    clean = _run_cli(_fixture("leaked-object-ref", "neg", tmp_path))
    assert clean.returncode == 0, clean.stdout + clean.stderr
    last = clean.stdout.strip().splitlines()[-1]
    assert last.startswith("RAYLINT files=1 findings=0"), last

    dirty = _run_cli(_fixture("leaked-object-ref", "pos", tmp_path))
    assert dirty.returncode == 1
    assert "RAYLINT" in dirty.stdout.strip().splitlines()[-1]

    usage = _run_cli("--rule", "no-such-rule", PKG)
    assert usage.returncode == 2
    assert "no-such-rule" in usage.stderr


def test_cli_list_rules():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rid in rule_ids():
        assert rid in proc.stdout


def test_cli_changed_only_runs():
    # smoke: flag must not crash whether or not git sees changes
    proc = _run_cli("--changed-only", FIXTURES)
    assert proc.returncode in (0, 1), proc.stderr
    assert "RAYLINT" in proc.stdout


def test_cli_lint_subcommand(tmp_path):
    def port_lint(*args):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.cli", "lint", *args],
            capture_output=True, text=True, cwd=REPO, timeout=300)

    clean = port_lint("--no-cache",
                      _fixture("leaked-object-ref", "neg", tmp_path))
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "RAYLINT" in clean.stdout
    dirty = port_lint("--no-cache",
                      _fixture("leaked-object-ref", "pos", tmp_path))
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    rules = port_lint("--", "--list-rules")     # the `lint -- --flags` form
    assert rules.returncode == 0, rules.stderr
    assert all(rid in rules.stdout for rid in rule_ids())


def test_lint_imports_neither_jax_nor_torch():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, ray_tpu_torch.devtools.lint as L; "
         "L.all_rules(); "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'torch', 'ray_tpu')))"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ---- SPMD plane: summary extract ------------------------------------------

def _summary_of(src, name):
    src = textwrap.dedent(src)
    fs = summarize(ast.parse(src), src, "spmd_mod.py")
    for f in fs.functions:
        if f.qualname == name:
            return f
    raise AssertionError(f"no function {name!r} in summary")


def test_spmd_axis_declarations():
    src = """
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

        from ray_tpu_torch.parallel.mesh import MeshSpec

        AXIS_ORDER: tuple = ("dp", "pp")    # AnnAssign form
        EXTRA_AXES = ("sp",)                # plain Assign form

        def build(layout):
            spec = MeshSpec(fsdp=4, tp=2)
            return DeviceMesh("cuda", layout, mesh_dim_names=("dp", "tp")), \\
                init_device_mesh("cuda", (2,), mesh_dim_names=("ep",)), spec
    """
    src = textwrap.dedent(src)
    fs = summarize(ast.parse(src), src, "axes_mod.py")
    module_axes = {ax for ax, _ in fs.spmd["axis_decls"]}
    assert module_axes == {"dp", "pp", "sp"}
    g = ProjectGraph([fs])
    # graph view unions module constants with in-function constructions
    assert set(g.declared_axes()) == {"dp", "pp", "sp", "fsdp", "tp", "ep"}


def test_spmd_axis_uses_of_the_port():
    s = _summary_of("""
        from ray_tpu_torch.parallel import spmd
        from ray_tpu_torch.parallel.mesh import mesh_axis_size
        from ray_tpu_torch.parallel.sharding import PartitionSpec as P
        from ray_tpu_torch.parallel.sharding import mesh_groups

        def uses(mesh, rules):
            a = spmd.Axis.of(mesh, "sp")
            b = spmd.Axis.local(name="pp")
            c = mesh_axis_size(mesh, "tp")
            d = mesh.get_group("fsdp"), mesh.get_local_rank(mesh_dim="dp")
            e = mesh["dp", "tp"], mesh_groups(mesh, ["fsdp"])
            f = P(None, ("dp", "fsdp")), rules.with_(seq="sp")
            return a, b, c, d, e, f
    """, "uses")
    got = [(ax, ctx) for ax, _ln, _col, ctx in s.spmd["axis_uses"]]
    assert sorted(got) == sorted([
        ("sp", "axis-of"), ("pp", "axis-of"), ("tp", "axis-query"),
        ("fsdp", "axis-query"), ("dp", "axis-query"), ("dp", "axis-query"),
        ("tp", "axis-query"), ("fsdp", "mesh-groups"),
        ("dp", "partition-spec"), ("fsdp", "partition-spec"),
        ("sp", "rules-value")])


def test_spmd_jit_detection_through_decorator_stacking():
    s = _summary_of("""
        import functools

        import torch

        @functools.partial(torch.compile, mode="max-autotune")
        def stacked(x, a, b):
            return x
    """, "stacked")
    assert s.spmd["jit"]["kind"] == "compile"

    s = _summary_of("""
        from ray_tpu_torch.parallel.presets import sharded_jit
        from ray_tpu_torch.parallel.sharding import PartitionSpec as P

        @sharded_jit(in_specs=(P("dp"), P()), out_specs=P("dp"))
        def step(state, batch):
            return state
    """, "step")
    jd = s.spmd["jit"]
    assert jd["kind"] == "sharded_jit"
    assert jd["in_arity"] == 2
    # single out spec: not a tuple literal, arity unknown
    assert jd["out_arity"] == -1

    for src in ("""
        import torch

        def plain(x):
            return x
    """, """
        @compile                  # the builtin's name, not torch's
        def plain(x):
            return x
    """):
        assert "jit" not in _summary_of(src, "plain").spmd


def test_spmd_jit_wrap_call_sites():
    s = _summary_of("""
        import torch
        from torch.distributed.tensor.experimental import local_map
        from ray_tpu_torch.parallel.presets import _shard_map
        from ray_tpu_torch.parallel.sharding import PartitionSpec as P

        def local(a, b):
            return a

        def outer(mesh, xs, sample):
            f = _shard_map(local, mesh, (P("dp"), P()), P())
            g = torch.compile(local)
            h = torch.compile(lambda x: x)      # lambda target: not recorded
            k = local_map(local, out_placements=(None, None),
                          in_placements=(None, None, None))
            m = torch.cuda.make_graphed_callables((local, outer),
                                                  (sample, sample))
            return f, g, h, k, m
    """, "outer")
    wraps = {(k, t, ia, oa) for k, t, _ln, ia, oa in s.spmd["jit_wraps"]}
    assert wraps == {("_shard_map", "local", 2, -1),
                     ("compile", "local", -1, -1),
                     ("local_map", "local", 3, 2),
                     ("graphed", "local", -1, -1),
                     ("graphed", "outer", -1, -1)}


def test_spmd_capture_blocks_are_recorded():
    s = _summary_of("""
        import torch

        def run(g, x):
            y = x * 2
            with torch.cuda.graph(g):
                z = x + 1
                w = z * 3
            return y, w
    """, "run")
    assert s.spmd["captures"] == [[6, 8]]


def test_spmd_schedule_linearization():
    g = _graph({"sched": """
        from ray_tpu_torch import collective as col

        def prep(x):
            col.allreduce(x, "g")
            finish(x)                 # nested helper: inlined too

        def finish(x):
            col.barrier("g")

        def step(rank, x):
            if rank == 0:
                prep(x)
            else:
                col.allreduce(x, "g")
                col.barrier("g")
    """})
    s = g.summary("sched:step")
    arms = s.spmd["rank_scheds"][0]["arms"]
    assert g.linearize_events("sched", "", arms[0]) == \
        g.linearize_events("sched", "", arms[1]) == \
        [("allreduce", "g"), ("barrier", "g")]

    # cycles terminate, depth caps inlining
    g2 = _graph({"loop": """
        from ray_tpu_torch import collective as col

        def a(x):
            col.barrier("g")
            b(x)

        def b(x):
            a(x)
    """})
    sched = g2.summary("loop:a").spmd["schedule"]
    assert g2.linearize_events("loop", "", sched) == \
        [("barrier", "g"), ("barrier", "g")]


def test_spmd_device_collectives_in_schedule():
    s = _summary_of("""
        import torch.distributed as dist
        from ray_tpu_torch.parallel import spmd
        from ray_tpu_torch.parallel.spmd import Axis, ppermute

        def device_step(x, mesh, perm):
            axis = Axis.of(mesh, "pp")
            y = spmd.all_reduce(x, spmd.Axis.of(mesh, "dp"))
            z = spmd.all_to_all(y, 1, 2, axis=spmd.Axis.of(mesh, "sp"))
            w = ppermute(z, perm, axis)
            dist.all_reduce(w)
            dist.barrier()
            spmd.shift(w, 1, None, 0, mesh)   # an axis not visible
            return w
    """, "device_step")
    ops = [(e[1], e[2]) for e in s.spmd["schedule"] if e[0] == "op"]
    assert ops == [("all_reduce", "dp"), ("all_to_all", "sp"),
                   ("ppermute", "pp"), ("all_reduce", ""), ("barrier", ""),
                   ("shift", "")]
    assert [c[:2] for c in sorted(s.device_collectives,
                                  key=lambda c: c[2:])] == [
        ["all_reduce", "dp"], ["all_to_all", "sp"], ["ppermute", "pp"],
        ["all_reduce", ""], ["barrier", ""], ["shift", ""]]
    assert s.collectives == []     # none of them is a host collective


# ---- SPMD plane: injected defects against real tree sources ---------------

def _inject(tmp_path, rel, replacements=()):
    """Copy a real ray_tpu_torch/ source into tmp with defects injected;
    the anchors must exist so the test fails loudly if the tree drifts."""
    with open(os.path.join(PKG, rel), encoding="utf-8") as fh:
        src = fh.read()
    for old, new in replacements:
        assert old in src, f"injection anchor missing from {rel}: {old!r}"
        src = src.replace(old, new)
    dest = tmp_path / os.path.basename(rel)
    dest.write_text(src)
    return str(dest)


def _rule(rule_id):
    return next(r for r in all_rules() if r.id == rule_id)


def test_injected_axis_typo_in_spmd_axis_is_caught(tmp_path):
    _inject(tmp_path, os.path.join("parallel", "mesh.py"))  # AXIS_ORDER
    clean = run_lint([str(tmp_path)],
                     rules=[_rule("mesh-axis-consistency")])
    assert not clean.unsuppressed
    _inject(tmp_path, os.path.join("models", "llama.py"),
            [('sp = spmd.Axis.of(mesh, "sp")',
              'sp = spmd.Axis.of(mesh, "spp")')])
    rep = run_lint([str(tmp_path)], rules=[_rule("mesh-axis-consistency")])
    hits = [f for f in rep.unsuppressed
            if f.rule == "mesh-axis-consistency"]
    assert hits and all(f.spmd["axis"] == "spp" for f in hits)
    assert "sp" in hits[0].spmd["declared_axes"]


def test_injected_all_reduce_order_mismatch_is_caught(tmp_path):
    p = tmp_path / "ddstep.py"
    p.write_text(textwrap.dedent("""\
        from ray_tpu_torch.parallel import spmd

        def _exchange_then_sum(x, axis):
            y = spmd.all_to_all(x, 0, 1, axis)
            return spmd.all_reduce(y, axis)

        def step(rank, x, mesh):
            axis = spmd.Axis.of(mesh, "dp")
            if rank == 0:
                y = spmd.all_reduce(x, axis)
                out = spmd.all_to_all(y, 0, 1, axis)
            else:
                out = _exchange_then_sum(x, spmd.Axis.of(mesh, "dp"))
            return out
    """))
    rep = run_lint([str(p)],
                   rules=[_rule("collective-schedule-divergence")])
    hits = [f for f in rep.unsuppressed
            if f.rule == "collective-schedule-divergence"]
    assert hits
    assert hits[0].spmd["schedule_true"] == [["all_reduce", "dp"],
                                             ["all_to_all", "dp"]]
    # the helper's own `axis` parameter is not a literal axis there
    assert hits[0].spmd["schedule_false"] == [["all_to_all", ""],
                                              ["all_reduce", ""]]


def test_injected_hardcoded_group_on_elastic_path_is_caught(tmp_path):
    _inject(tmp_path, os.path.join("train", "elastic.py"),
            [('group.init_host_collective(group_name=col_group)',
              'group.init_host_collective(group_name="train")')])
    rep = run_lint([str(tmp_path)], rules=[_rule("hardcoded-group-name")])
    hits = [f for f in rep.unsuppressed
            if f.rule == "hardcoded-group-name"]
    assert hits and hits[0].spmd["group"] == "train"
