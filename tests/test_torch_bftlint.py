"""The invariant linter (tools/bftlint) over the port.

``tools.bftlint`` scopes six of its rules to ``cometbft_tpu/`` paths.
Here every checker runs over ``cometbft_tpu_torch/`` on its own copy
with those scopes rebased to the port (the cwd-write tools exemption,
the monotonic-clock persistence allowlist and the wire-tag drift prefix
too); the tool itself is not edited.  The findings are held to
``tests/bftlint_torch_baseline.json``: no new finding, no stale entry,
every entry justified, and an entry whose function holds the same
finding in the JAX package's ``bftlint_baseline.json`` carries the JAX
justification.  The wire-tag rule holds the port's descriptors to
``tools/bftlint/wire_manifest.json``, its paths rebased.

A bare ``create_task`` planted in a copy of a port reactor, and a
renumbered field in a copy of a port descriptor, each fail the gate.

    python tests/test_torch_bftlint.py --write

rewrites the baseline from the current findings, keeping each entry's
justification (a new entry gets the JAX one where the JAX baseline has
the same rule, function and path, else a placeholder the test refuses).
"""
import ast
import copy
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools.bftlint import baseline as baseline_mod  # noqa: E402
from tools.bftlint.checkers import ALL_CHECKERS  # noqa: E402
from tools.bftlint.checkers import monotonic_clock, wire_tag  # noqa: E402
from tools.bftlint.core import Checker, FileContext, lint_paths  # noqa: E402

JAX, PORT = "cometbft_tpu/", "cometbft_tpu_torch/"
PORT_DIR = REPO / "cometbft_tpu_torch"
BASELINE = REPO / "tests" / "bftlint_torch_baseline.json"
JAX_BASELINE = REPO / "bftlint_baseline.json"


def _rebase(path: str) -> str:
    return PORT + path[len(JAX):] if path.startswith(JAX) else path


def port_checkers():
    """Every bftlint checker, each a copy rebased onto the port."""
    out = []
    for checker in ALL_CHECKERS:
        c = copy.copy(checker)
        c.scope = tuple(_rebase(p) for p in checker.scope)
        if c.rule == "cwd-write":
            c.in_scope = lambda lp, c=c: \
                not lp.startswith(PORT + "tools/") and \
                Checker.in_scope(c, lp)
        elif c.rule == "monotonic-clock":
            allow = {(_rebase(p), fn)
                     for p, fn in monotonic_clock.PERSISTENCE_ALLOWLIST}
            c.check = lambda ctx, inner=checker.check: (
                f for f in inner(ctx) if (f.path, f.scope) not in allow)
        elif c.rule == "wire-tag":
            c._DRIFT_PREFIX = PORT
            c._manifest = {
                name: {**e, "path": _rebase(e["path"])}
                for name, e in wire_tag.load_manifest().items()}
        out.append(c)
    return out


def lint(paths=(str(PORT_DIR),)):
    return lint_paths(list(paths), port_checkers(), repo_root=str(REPO))


def _key(fingerprint: str) -> tuple:
    """(rule, path, function) of a fingerprint, the JAX path rebased."""
    rule, path, scope = fingerprint.split("::", 3)[:3]
    return rule, _rebase(path), scope


def jax_justifications() -> dict:
    out = {}
    for fp, e in baseline_mod.load(str(JAX_BASELINE)).items():
        out.setdefault(_key(fp), e["justification"])
    return out


def write_baseline() -> int:
    result = lint()
    prev = baseline_mod.load(str(BASELINE))
    jax = jax_justifications()
    entries = {}
    for f in result.findings:
        e = entries.setdefault(f.fingerprint, {
            "fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
            "count": 0,
            "justification": prev.get(f.fingerprint, {}).get(
                "justification") or jax.get(
                _key(f.fingerprint), baseline_mod.DEFAULT_JUSTIFICATION)})
        e["count"] += 1
    BASELINE.write_text(json.dumps(
        {"schema": baseline_mod.SCHEMA,
         "generated_by": "python tests/test_torch_bftlint.py --write",
         "entries": [entries[k] for k in sorted(entries)]},
        indent=2, sort_keys=True) + "\n")
    return len(entries)


# ----------------------------------------------------------------------

def test_the_port_has_no_new_finding_and_no_stale_entry():
    result = lint()
    assert not result.parse_errors
    assert result.files_scanned > 150
    diff = baseline_mod.diff(result.findings,
                             baseline_mod.load(str(BASELINE)))
    assert not diff.new, "\n".join(
        f"{f.location()} {f.rule}: {f.message}" for f in diff.new)
    assert not diff.stale, diff.stale


def test_every_entry_is_justified_and_keeps_the_jax_reason():
    jax = jax_justifications()
    entries = baseline_mod.load(str(BASELINE))
    assert entries
    carried = 0
    for fp, e in entries.items():
        assert fp.split("::")[1].startswith(PORT), fp
        assert e["justification"] != baseline_mod.DEFAULT_JUSTIFICATION, fp
        if _key(fp) in jax:
            assert e["justification"] == jax[_key(fp)], fp
            carried += 1
    assert carried > len(entries) // 2


def test_the_scoped_rules_reach_the_port():
    """The six path-scoped rules now judge port files, and what the
    port's first lint found under supervised-spawn, blocking-in-async
    and monotonic-clock is repaired or disabled inline as the JAX
    package disables it: none of those is left or baselined."""
    checkers = port_checkers()
    scoped = {c.rule: c for c in checkers if c.scope}
    assert set(scoped) == {"supervised-spawn", "monotonic-clock",
                           "await-atomicity", "blocking-in-async",
                           "cwd-write"}
    files = [str(p.relative_to(REPO)) for p in PORT_DIR.rglob("*.py")]
    for c in scoped.values():
        assert all(p.startswith(PORT) for p in c.scope), c.rule
        assert any(c.in_scope(f) for f in files), c.rule
    assert next(c for c in checkers
                if c.rule == "wire-tag")._DRIFT_PREFIX == PORT
    rules = {f.rule for f in lint().findings}
    assert not rules & {"supervised-spawn", "blocking-in-async",
                        "monotonic-clock", "wire-tag", "cwd-write"}


def _plant(tmp_path, rel, source):
    """A copy of a port file holding ``source``, its logical path the
    original's."""
    out = tmp_path / Path(rel).name
    out.write_text(f"# bftlint: path={PORT}{rel}\n" + source)
    return out


def _new(path):
    return baseline_mod.diff(lint([str(path)]).findings,
                             baseline_mod.load(str(BASELINE))).new


def test_a_bare_create_task_in_a_port_reactor_fails_the_gate(tmp_path):
    rel = "mempool/reactor.py"
    src = (PORT_DIR / rel).read_text()
    assert not _new(_plant(tmp_path, rel, src))
    new = _new(_plant(tmp_path, rel, src + (
        "\n\nasync def _planted(coro):\n"
        "    asyncio.get_running_loop().create_task(coro)\n")))
    assert [(f.rule, f.scope) for f in new] == \
        [("supervised-spawn", "_planted")]


def test_a_renumbered_field_in_a_port_descriptor_fails_the_gate(tmp_path):
    rel = "wire/consensus_pb.py"
    src = (PORT_DIR / rel).read_text()
    assert not _new(_plant(tmp_path, rel, src))
    ctx = FileContext(str(PORT_DIR / rel), src, repo_root=str(REPO))
    decl = next(d for d in wire_tag.extract_messages(ctx)
                if len(d.fields) >= 2)
    num = max(decl.fields)
    f_call = next(a for a in decl.node.args[1:]
                  if isinstance(a, ast.Call) and a.args[0].value == num)
    lines = src.splitlines(keepends=True)
    lines[f_call.lineno - 1] = lines[f_call.lineno - 1].replace(
        f"F({num},", f"F({num + 40},", 1)
    new = _new(_plant(tmp_path, rel, "".join(lines)))
    assert [f.rule for f in new] == ["wire-tag"]
    assert decl.name in new[0].message and "drifted" in new[0].message


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        print(f"{write_baseline()} entries written to {BASELINE}")
    else:
        sys.exit("usage: python tests/test_torch_bftlint.py --write")
