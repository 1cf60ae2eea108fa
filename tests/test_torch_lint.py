"""The port's static analysis (``hbbft_tpu_torch/lint/``) against the JAX
package's (``hbbft_tpu/lint/``), on the CPU.

- fixture parity — every fixture of ``tests/lint_fixtures/``, re-rooted
  under ``hbbft_tpu_torch/``, draws the same (rule, line, message) from
  both suites;
- framework parity — rule table, scopes, fingerprints, the JSON, text and
  baseline renderings agree apart from the package name;
- framework behaviour — suppressions, baseline drift, syntax errors,
  ``--write-baseline`` and ``--changed-only`` (in a throwaway git repo),
  each held equal to the reference on the same synthetic tree;
- the gate — ``python -m hbbft_tpu_torch.lint --json`` over the repo is
  clean with no stale baseline entry;
- marker parity — with every ``# hblint:`` comment stripped from copies of
  both packages, both report the same findings, apart from the port-only
  lines listed here with their reasons: the port carries every one of the
  reference's suppressions and adds only those;
- the metrics shim and the import rule.
"""

import collections
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tokenize
from dataclasses import dataclass

import pytest

import hbbft_tpu.lint as ref_lint
import hbbft_tpu.lint.asyncio_hazard as ref_async
import hbbft_tpu.lint.bounded_ingress as ref_ingress
import hbbft_tpu.lint.core as ref_core
import hbbft_tpu.lint.determinism as ref_det
import hbbft_tpu.lint.fault_accounting as ref_fault
import hbbft_tpu.lint.metric_convention as ref_metric
import hbbft_tpu.lint.reporters as ref_reporters
import hbbft_tpu.lint.wire_completeness as ref_wire
import hbbft_tpu_torch.lint as port_lint
import hbbft_tpu_torch.lint.asyncio_hazard as port_async
import hbbft_tpu_torch.lint.bounded_ingress as port_ingress
import hbbft_tpu_torch.lint.core as port_core
import hbbft_tpu_torch.lint.determinism as port_det
import hbbft_tpu_torch.lint.fault_accounting as port_fault
import hbbft_tpu_torch.lint.metric_convention as port_metric
import hbbft_tpu_torch.lint.reporters as port_reporters
import hbbft_tpu_torch.lint.wire_completeness as port_wire
from hbbft_tpu.lint import __main__ as ref_cli
from hbbft_tpu_torch.lint import __main__ as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "lint_fixtures")
REF, PORT = "hbbft_tpu", "hbbft_tpu_torch"

#: findings the port's own lines draw that the reference has no counterpart
#: of, each suppressed in the port for the reason given
PORT_ONLY = [
    ("fault-swallowed-drop", "net/cluster.py", "except OSError as exc:",
     "_listening's bind probe returns its verdict from the errno "
     "(EADDRINUSE: a listener holds the port); it drops no input"),
]


def swap(text: str) -> str:
    """The reference's package name replaced by the port's."""
    return re.sub(r"\bhbbft_tpu\b", PORT, text)


def _write(root, rel, text):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)
    return path


# ---------------------------------------------------------------------------
# fixture parity


MODULE_FIXTURES = sorted(
    os.path.relpath(os.path.join(d, f), FIXTURES).replace(os.sep, "/")
    for d, _dirs, files in os.walk(FIXTURES)
    if "metric_" not in os.path.relpath(d, FIXTURES)
    for f in files if f.endswith(".py")
)


def _module_findings(core, wire, root, rel):
    """(checker, rule, line, message) of every per-module checker of a
    suite on one file, and the wire checker's AST sweep with the fixtures'
    one registered class."""
    mod = core.ModuleSource(root, rel)
    assert mod.parse_error is None
    out = []
    for chk in sorted(core.all_checkers(), key=lambda c: c.name):
        out += [(f.checker, f.rule, f.line, f.message)
                for f in chk.check_module(mod)]
    out += [(f.checker, f.rule, f.line, f.message) for f in
            wire.WireCompletenessChecker().ast_unregistered(
                mod, registered={"PlainMsg"})]
    return out


def test_fixture_set_is_the_references():
    assert len(MODULE_FIXTURES) == 12
    assert {"det_bad.py", "async_good.py", "ingress_bad.py", "wire_good.py",
            "hbbft_tpu/net/scheduler_bad.py",
            "hbbft_tpu/net/fault_good.py"} <= set(MODULE_FIXTURES)


@pytest.mark.parametrize("rel", MODULE_FIXTURES)
def test_fixture_parity(rel, tmp_path):
    port_rel = swap(rel)
    with open(os.path.join(FIXTURES, rel), encoding="utf-8") as fh:
        _write(tmp_path, port_rel, swap(fh.read()))
    ref = _module_findings(ref_core, ref_wire, FIXTURES, rel)
    port = _module_findings(port_core, port_wire, str(tmp_path), port_rel)
    assert port == [(c, r, ln, swap(m)) for c, r, ln, m in ref]
    # the fixtures are not vacuous: a bad one fires, a good one is quiet
    # under its own checker
    own = {"det": "determinism", "async": "asyncio-hazard",
           "ingress": "bounded-ingress", "wire": "wire-completeness",
           "scheduler": "asyncio-hazard", "fault": "fault-accounting"}
    stem = os.path.basename(rel).split("_")[0]
    fired = [f for f in port if f[0] == own[stem]]
    assert bool(fired) == rel.endswith("_bad.py"), fired


@pytest.mark.parametrize("name", ["metric_bad", "metric_good"])
def test_metric_fixture_parity(name, tmp_path):
    src = os.path.join(FIXTURES, name)
    for dirpath, _dirs, files in os.walk(src):
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), src)
            with open(os.path.join(dirpath, fn), encoding="utf-8") as fh:
                _write(tmp_path, swap(rel.replace(os.sep, "/")),
                       swap(fh.read()))
    ref = ref_metric.check_metrics(src, check_faults=False)
    port = port_metric.check_metrics(str(tmp_path), check_faults=False)
    problems, n, labels = ref
    assert port == ([(swap(m), swap(p) if p else p, ln)
                     for m, p, ln in problems], n, labels)
    assert n == 1 and bool(problems) == (name == "metric_bad")


# ---------------------------------------------------------------------------
# framework parity


def test_rule_table_is_the_references():
    table = port_core.rule_table()
    assert table == ref_core.rule_table()
    assert len(table) == 18


def test_cli_list_rules_is_the_references(capsys):
    ref = _main(ref_cli, capsys, "--list-rules")
    port = _main(port_cli, capsys, "--list-rules")
    assert port == ref and port[0] == 0
    assert len(port[1].splitlines()) == 18


@pytest.mark.parametrize("ref_cls,port_cls", [
    (ref_det.DeterminismChecker, port_det.DeterminismChecker),
    (ref_async.AsyncioHazardChecker, port_async.AsyncioHazardChecker),
    (ref_ingress.BoundedIngressChecker, port_ingress.BoundedIngressChecker),
    (ref_fault.FaultAccountingChecker, port_fault.FaultAccountingChecker),
    (ref_wire.WireCompletenessChecker, port_wire.WireCompletenessChecker),
    (ref_metric.MetricConventionChecker, port_metric.MetricConventionChecker),
], ids=lambda c: c.name)
def test_checker_scopes_are_the_references(ref_cls, port_cls):
    assert port_cls.name == ref_cls.name
    assert port_cls.rules == ref_cls.rules
    assert port_cls.scope == tuple(swap(p) for p in ref_cls.scope)
    assert getattr(port_cls, "DROP_SCOPE", ()) == tuple(
        swap(p) for p in getattr(ref_cls, "DROP_SCOPE", ()))


def test_module_constants_are_the_references():
    assert port_wire._WIRE_PATH == swap(ref_wire._WIRE_PATH)
    assert port_metric.NAME_CONVENTION.pattern == \
        ref_metric.NAME_CONVENTION.pattern
    assert port_metric._REG_RE.pattern == ref_metric._REG_RE.pattern
    assert port_core._SUPPRESS_RE.pattern == ref_core._SUPPRESS_RE.pattern
    assert port_core.DEFAULT_PATHS == ("hbbft_tpu_torch", "chip_smoke.py")
    assert port_core._SKIP_DIRS == ref_core._SKIP_DIRS | {"build"}
    assert port_core.default_root() == ROOT
    assert port_core.DEFAULT_BASELINE == os.path.join(
        ROOT, "hbbft_tpu_torch", "lint", "baseline.txt")
    for path in ("hbbft_tpu_torch/net/scheduler.py",
                 "hbbft_tpu_torch/net/transport.py", "x/scheduler.py"):
        assert port_async._is_pump_module(path) == \
            ref_async._is_pump_module(path)
    assert set(port_lint.__all__) == set(ref_lint.__all__)


def test_fingerprints_and_baseline_rendering_are_the_references():
    fields = [("determinism", "det-wall-clock", "hbbft_tpu_torch/protocols/x.py",
               4, "m1", "    return time.time()"),
              ("core", "syntax-error", "hbbft_tpu_torch/y.py", 1, "m2", "")]
    ref = [ref_core.Finding(*f) for f in fields]
    port = [port_core.Finding(*f) for f in fields]
    assert [f.fingerprint for f in port] == [f.fingerprint for f in ref]
    assert [f.as_dict() for f in port] == [f.as_dict() for f in ref]
    assert port_core.render_baseline(port) == swap(
        ref_core.render_baseline(ref))


def test_wire_registry_invariants_are_the_references():
    @dataclass(frozen=True)
    class GoodM:
        x: int

    @dataclass
    class MutableM:
        x: int

    class UnhashableM:
        __hash__ = None

    tags = {GoodM: (0x01, None), MutableM: (0x01, None),
            UnhashableM: (0x02, None)}
    decoders = {0x01: None, 0x07: None}
    runs = [mod.WireCompletenessChecker().registry_findings(
        tags, decoders, locate=lambda cls: ("x.py", 1, ""))
        for mod in (ref_wire, port_wire)]
    ref, port = ([(f.rule, f.path, f.line, f.message) for f in r]
                 for r in runs)
    assert port == [(r, swap(p), ln, m) for r, p, ln, m in ref]
    assert sorted(r for r, *_ in port).count("wire-missing-codec") == 2


def test_port_wire_registry_is_clean():
    from hbbft_tpu_torch.protocols import wire

    wire.ensure_registered()
    out = port_wire.WireCompletenessChecker().registry_findings(
        dict(wire._MSG_TAGS), dict(wire._MSG_DECODERS),
        locate=lambda cls: ("x.py", 0, ""))
    assert out == [], [f.message for f in out]


# ---------------------------------------------------------------------------
# framework behaviour, held to the reference on the same synthetic tree

_VIOLATION = "import time\n\ndef f():\n    return time.time()\n"


SUITES = ((REF, ref_core, ref_det, ref_fault),
          (PORT, port_core, port_det, port_fault))


def _summary(result):
    return ([(swap(f.path), f.line, f.rule, swap(f.message))
             for f in result.findings],
            [(swap(f.path), f.rule) for f in result.baselined],
            result.suppressed, result.files_scanned, result.stale_baseline)


def _both(tmp_path, files, checker="determinism", baseline=None):
    """Lay ``files`` ({package-relative path: text}) out under each
    package's name in its own root, lint both with one checker, assert the
    results agree apart from the package name, and return (reference
    result, port result)."""
    out = []
    for pkg, core, det, fault in SUITES:
        root = tmp_path / pkg
        for rel, text in files.items():
            _write(root, f"{pkg}/{rel}", text)
        chk = (det.DeterminismChecker() if checker == "determinism"
               else fault.FaultAccountingChecker())
        out.append(core.run_lint(
            root=str(root), paths=[pkg], checkers=[chk],
            baseline_path=str(root / baseline) if baseline else None))
    ref, port = out
    assert _summary(port) == _summary(ref)
    return ref, port


def test_scope_and_basic_finding(tmp_path):
    _, port = _both(tmp_path, {"protocols/x.py": _VIOLATION,
                               "net/y.py": _VIOLATION})
    assert [f.path for f in port.findings] == [
        "hbbft_tpu_torch/protocols/x.py"]
    assert (port.findings[0].rule, port.findings[0].line) == (
        "det-wall-clock", 4)


def test_chaos_and_trace_scopes(tmp_path):
    _, port = _both(tmp_path, {"chaos/z.py": _VIOLATION,
                               "obs/trace.py": _VIOLATION,
                               "obs/other.py": _VIOLATION})
    assert [f.path for f in port.findings] == [
        "hbbft_tpu_torch/chaos/z.py", "hbbft_tpu_torch/obs/trace.py"]
    drop = ("def f(x):\n    try:\n        return x()\n"
            "    except ValueError:\n        return None\n")
    _, port = _both(tmp_path, {"chaos/drop.py": drop,
                               "obs/critpath.py": drop,
                               "parallel/drop.py": drop},
                    checker="fault-accounting")
    assert [(f.path, f.rule) for f in port.findings] == [
        ("hbbft_tpu_torch/chaos/drop.py", "fault-swallowed-drop"),
        ("hbbft_tpu_torch/obs/critpath.py", "fault-swallowed-drop")]


@pytest.mark.parametrize("text,suppressed", [
    ("import time\n\ndef f():\n"
     "    return time.time()  # hblint: disable=det-wall-clock (why)\n", 1),
    ("import time\n\ndef f():\n"
     "    # hblint: disable=det-wall-clock (justification)\n"
     "    return time.time()\n", 1),
    ("# hblint: disable-file=det-wall-clock\n" + _VIOLATION, 1),
    ("# hblint: disable-file=all\n" + _VIOLATION, 1),
    ("import time\n\ndef f():\n    return time.time()  "
     "# hblint: disable=det-set-iteration all timers are benign\n", 0),
    ("import time\n\ndef f():\n"
     "    return time.time()  # hblint: disable=det-set-iteration\n", 0),
], ids=["same-line", "comment-above", "file", "file-all",
        "justification-words-are-not-rules", "wrong-rule"])
def test_suppression(tmp_path, text, suppressed):
    _, port = _both(tmp_path, {"protocols/x.py": text})
    assert port.suppressed == suppressed
    assert [f.rule for f in port.findings] == ["det-wall-clock"] * (
        1 - suppressed)


def test_baseline_grandfathers_and_survives_line_drift(tmp_path):
    files = {"protocols/x.py": _VIOLATION}
    for (pkg, core, *_), first in zip(SUITES, _both(tmp_path, files)):
        (tmp_path / pkg / "baseline.txt").write_text(
            core.render_baseline(first.findings))
    _, port = _both(tmp_path, files, baseline="baseline.txt")
    assert port.findings == [] and len(port.baselined) == 1
    assert port.stale_baseline == 0
    # unrelated edits shift the line: the content fingerprint still holds
    _, port = _both(tmp_path, {"protocols/x.py": "# a\n# b\n" + _VIOLATION},
                    baseline="baseline.txt")
    assert port.findings == [] and len(port.baselined) == 1
    # editing the anchored line itself invalidates the entry, on purpose
    _, port = _both(tmp_path, {"protocols/x.py": _VIOLATION.replace(
        "return time.time()", "return 1 + time.time()")},
        baseline="baseline.txt")
    assert len(port.findings) == 1 and port.stale_baseline == 1


def test_syntax_error_is_reported_not_fatal(tmp_path):
    _, port = _both(tmp_path, {"protocols/x.py": "def broken(:\n"})
    assert [f.rule for f in port.findings] == ["syntax-error"]


def test_reporters_are_the_references(tmp_path):
    ref, port = _both(tmp_path, {"protocols/x.py": _VIOLATION,
                                 "protocols/y.py": _VIOLATION,
                                 "chaos/z.py": "# hblint: disable-file=all\n"
                                               + _VIOLATION})
    docs = [json.loads(r.render_json(res)) for r, res in
            ((ref_reporters, ref), (port_reporters, port))]
    for doc in docs:
        for f in doc["findings"]:
            f.pop("fingerprint")
    assert docs[1] == json.loads(swap(json.dumps(docs[0])))
    doc = docs[1]
    assert doc["version"] == 1 and doc["tool"] == "hblint"
    assert doc["summary"]["findings"] == 2 and doc["summary"]["clean"] is False
    for verbose in (False, True):
        assert port_reporters.render_text(port, verbose) == swap(
            ref_reporters.render_text(ref, verbose))


def _main(cli, capsys, *args):
    """(exit code, stdout, stderr) of a suite's CLI ``main`` in-process."""
    capsys.readouterr()
    rc = cli.main(list(args))
    out, err = capsys.readouterr()
    return rc, out, err


def _git(cwd, *args):
    return subprocess.run(
        ["git", *args], cwd=cwd, capture_output=True, text=True, check=True,
        env=dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
                 GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t"))


def _metric_tree(root):
    """A tree the project-wide checkers pass: one documented metric."""
    _write(root, "hbbft_tpu_torch/obs/m.py",
           "def setup(r):\n"
           "    return r.counter(\"hbbft_obs_fixture_total\", \"doc\")\n")
    _write(root, "README.md", "## Observability\n\n`hbbft_obs_fixture_total`\n")


def test_changed_only_includes_untracked_files(tmp_path, capsys):
    """--changed-only is the pre-commit path: in a git repo, a committed
    unchanged violation is skipped, a brand-new untracked one is scanned,
    and the CLI exits 1 on it."""
    _git(tmp_path, "init", "-q")
    _metric_tree(tmp_path)
    _write(tmp_path, "hbbft_tpu_torch/protocols/old.py", _VIOLATION)
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "seed")
    _write(tmp_path, "hbbft_tpu_torch/protocols/fresh.py", _VIOLATION)
    result = port_core.run_lint(
        root=str(tmp_path), paths=["hbbft_tpu_torch"],
        checkers=[port_det.DeterminismChecker()], baseline_path=None,
        changed_only="HEAD")
    assert [f.path for f in result.findings] == [
        "hbbft_tpu_torch/protocols/fresh.py"]
    rc, out, err = _main(port_cli, capsys, "--json", "--no-baseline",
                         "--changed-only", "HEAD", "--root", str(tmp_path))
    assert rc == 1, out + err
    assert [(f["path"], f["rule"]) for f in json.loads(out)["findings"]] == [
        ("hbbft_tpu_torch/protocols/fresh.py", "det-wall-clock")]
    # without --changed-only the committed one is found too
    rc, out, _err = _main(port_cli, capsys, "--json", "--no-baseline",
                          "--root", str(tmp_path))
    assert len(json.loads(out)["findings"]) == 2


def test_changed_only_outside_git_is_a_usage_error(tmp_path, monkeypatch,
                                                   capsys):
    _metric_tree(tmp_path)
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    rc, _out, err = _main(port_cli, capsys, "--changed-only", "HEAD",
                          "--root", str(tmp_path))
    assert rc == 2 and "hblint: error:" in err


def test_write_baseline(tmp_path, capsys):
    _metric_tree(tmp_path)
    _write(tmp_path, "hbbft_tpu_torch/protocols/x.py", _VIOLATION)
    out = tmp_path / "b.txt"
    rc, stdout, err = _main(port_cli, capsys, "--write-baseline",
                            "--baseline", str(out), "--root", str(tmp_path))
    assert rc == 0, err
    assert "wrote 1 entries" in stdout
    text = out.read_text()
    assert text.splitlines()[2] == (
        "# Regenerate with: python -m hbbft_tpu_torch.lint --write-baseline")
    (entry,) = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert entry.split()[1:3] == ["det-wall-clock",
                                  "hbbft_tpu_torch/protocols/x.py"]
    # the written baseline grandfathers it
    rc, stdout, _err = _main(port_cli, capsys, "--json", "--baseline",
                             str(out), "--root", str(tmp_path))
    assert rc == 0
    summary = json.loads(stdout)["summary"]
    assert (summary["findings"], summary["baselined"]) == (0, 1)


@pytest.mark.parametrize("args", [("hbbft_tpu_torch/obs", "--write-baseline"),
                                  ("--changed-only", "HEAD",
                                   "--write-baseline")],
                         ids=["path", "changed-only"])
def test_write_baseline_refuses_restricted_scan(args, capsys):
    rc, _out, err = _main(port_cli, capsys, *args)
    assert rc == 2
    assert "full scan" in err


# ---------------------------------------------------------------------------
# the gate, via the module entry point


# ``python -m hbbft_tpu_torch.lint --json`` in a fresh interpreter, which then
# reports the modules of JAX or the JAX package that the run loaded
_GATE = """
import json, runpy, sys
sys.argv = ["hbbft_tpu_torch.lint", "--json"]
try:
    runpy.run_module("hbbft_tpu_torch.lint", run_name="__main__",
                     alter_sys=True)
    code = 0
except SystemExit as exc:
    code = exc.code
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "hbbft_tpu"))
assert "hbbft_tpu_torch.protocols.wire" in sys.modules
print(json.dumps(loaded), file=sys.stderr)
sys.exit(code)
"""


@pytest.fixture(scope="module")
def gate():
    return subprocess.run([sys.executable, "-c", _GATE], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)


def test_lint_repo_clean(gate):
    """No finding and no stale baseline entry over the port's tree, through
    the module entry point (so the CLI path stays exercised)."""
    assert gate.returncode == 0, gate.stdout + gate.stderr
    doc = json.loads(gate.stdout)
    assert doc["findings"] == [], doc["findings"]
    summary = doc["summary"]
    assert summary["clean"] is True and summary["stale_baseline"] == 0
    assert summary["baselined"] <= 10
    assert set(doc["checkers"]) == {
        "determinism", "asyncio-hazard", "wire-completeness",
        "fault-accounting", "metric-convention", "bounded-ingress",
    }
    assert {f["path"] for f in doc["baselined"]} == {
        "hbbft_tpu_torch/net/client.py", "hbbft_tpu_torch/net/transport.py"}


def test_baseline_keeps_the_references_justifications():
    def entries(path):
        with open(path, encoding="utf-8") as fh:
            return {ln.split()[1] + " " + ln.split()[2].split("/", 1)[1]:
                    ln.split("#", 1)[1].strip()
                    for ln in fh if ln.strip() and not ln.startswith("#")}

    assert entries(port_core.DEFAULT_BASELINE) == entries(
        ref_core.DEFAULT_BASELINE)


# ---------------------------------------------------------------------------
# marker parity


def _strip_markers(src_dir, dst_dir):
    """Copy the ``.py`` files of ``src_dir`` with every ``# hblint:``
    comment blanked (strings untouched)."""
    for dirpath, dirnames, files in os.walk(src_dir):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build", "native")]
        for fn in files:
            if not fn.endswith(".py"):
                continue
            src = os.path.join(dirpath, fn)
            with open(src, encoding="utf-8") as fh:
                text = fh.read()
            lines = text.split("\n")
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT and "hblint:" in tok.string:
                    row, col = tok.start
                    lines[row - 1] = lines[row - 1][:col]
            _write(dst_dir, os.path.relpath(src, src_dir), "\n".join(lines))


def _stripped_findings(core, pkg, tmp_path):
    root = tmp_path / pkg
    _strip_markers(os.path.join(ROOT, pkg), root / pkg)
    shutil.copy(os.path.join(ROOT, "README.md"), root / "README.md")
    result = core.run_lint(root=str(root), paths=[pkg], baseline_path=None)
    assert result.suppressed == 0
    return collections.Counter(
        (f.rule, f.path.split("/", 1)[1], swap(f.snippet.strip()))
        for f in result.findings)


def test_marker_parity(tmp_path):
    ref = _stripped_findings(ref_core, REF, tmp_path)
    port = _stripped_findings(port_core, PORT, tmp_path)
    assert sum(ref.values()) == 53
    assert ref - port == collections.Counter()
    assert port - ref == collections.Counter(
        (rule, path, line) for rule, path, line, _why in PORT_ONLY)
    # and each port-only line carries a justified suppression
    for rule, path, line, _why in PORT_ONLY:
        with open(os.path.join(ROOT, PORT, path), encoding="utf-8") as fh:
            text = fh.read().splitlines()
        at = [i for i, ln in enumerate(text) if ln.strip() == line]
        assert len(at) == 1
        above = "\n".join(text[max(0, at[0] - 4):at[0]])
        assert f"# hblint: disable={rule} (" in above


def test_port_carries_every_reference_marker():
    """Each ``# hblint:`` comment of the reference stands in the port word
    for word, as often."""
    def markers(pkg):
        out = collections.Counter()
        for dirpath, _dirs, files in os.walk(os.path.join(ROOT, pkg)):
            if os.sep + "lint" in dirpath:
                continue
            for fn in files:
                if fn.endswith(".py"):
                    with open(os.path.join(dirpath, fn),
                              encoding="utf-8") as fh:
                        for ln in fh:
                            if "# hblint:" in ln:
                                out[(os.path.relpath(
                                    os.path.join(dirpath, fn),
                                    os.path.join(ROOT, pkg)),
                                    swap(ln.strip()))] += 1
        return out

    ref, port = markers(REF), markers(PORT)
    assert sum(ref.values()) == 48
    assert ref - port == collections.Counter()
    assert [path for path, _ln in port - ref] == ["net/cluster.py"]


# ---------------------------------------------------------------------------
# the metrics shim


def test_metrics_shim_passes_on_the_repo(capsys):
    import tools_check_metrics as ref_shim
    from hbbft_tpu_torch import tools_check_metrics as port_shim

    assert port_shim.main() == 0
    port_out = capsys.readouterr().out
    assert port_out.startswith("tools_check_metrics: OK — ")
    assert ref_shim.main() == 0
    assert port_out == capsys.readouterr().out  # same names, same labels
    assert sorted({n for n, _p in port_shim.registered_metric_names()}) == \
        sorted({n for n, _p in ref_shim.registered_metric_names()})


def test_metrics_shim_fails_like_the_reference(tmp_path, monkeypatch, capsys):
    import tools_check_metrics as ref_shim
    from hbbft_tpu_torch import tools_check_metrics as port_shim

    src = os.path.join(FIXTURES, "metric_bad")
    _write(tmp_path, "README.md",
           open(os.path.join(src, "README.md"), encoding="utf-8").read())
    _write(tmp_path, "hbbft_tpu_torch/m.py", open(
        os.path.join(src, "hbbft_tpu", "m.py"), encoding="utf-8").read())
    monkeypatch.setattr(ref_shim, "REPO", src)
    assert ref_shim.main() == 1
    ref_out = capsys.readouterr().out
    monkeypatch.setattr(port_shim, "REPO", str(tmp_path))
    assert port_shim.main() == 1
    port_out = capsys.readouterr().out
    assert port_out == swap(ref_out)
    assert port_out.splitlines()[0] == "tools_check_metrics: FAIL"
    assert "violates the naming convention" in port_out


def test_metrics_shim_module_entry_point(capsys):
    import runpy

    with pytest.raises(SystemExit) as exc:
        runpy.run_path(os.path.join(ROOT, PORT, "tools_check_metrics.py"),
                       run_name="__main__")
    assert exc.value.code == 0
    assert capsys.readouterr().out.startswith("tools_check_metrics: OK")


# ---------------------------------------------------------------------------
# the import rule


def test_lint_loads_neither_jax_nor_the_jax_package(gate):
    """The gate's interpreter, which ran the port's lint over the repo (the
    registry cross-checks import the port's modules), loaded no module of
    ``jax``, ``jaxlib`` or ``hbbft_tpu``."""
    assert gate.returncode == 0, gate.stderr
    assert json.loads(gate.stderr.strip().splitlines()[-1]) == []


def test_lint_package_imports_no_torch():
    """The checkers themselves are stdlib-only: only the two registry
    cross-checks, inside functions, import the port's modules."""
    import ast

    lint_dir = os.path.join(ROOT, PORT, "lint")
    for fn in sorted(os.listdir(lint_dir)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(lint_dir, fn), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in tree.body:
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots = {(node.module or "").split(".")[0]}
                if roots == {PORT}:
                    assert node.module.startswith(f"{PORT}.lint"), fn
            else:
                continue
            assert not roots & {"torch", "jax", "jaxlib", "hbbft_tpu"}, fn
