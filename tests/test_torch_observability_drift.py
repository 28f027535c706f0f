"""Drift guards for the port's observability surface: the JAX package's
tests/test_observability_drift.py over cometbft_tpu_torch/.

  * the span and marker tables of the port's tools/trace_report.py (and
    the instants its fleet report keys on) match the names the port's
    modules emit, found with the JAX guard's own regex; the port emits
    the JAX package's consensus, mempool, p2p and supervisor names, and
    its crypto span set is pinned as it stands (``prep_pack`` and
    ``prep_c`` added inside ``host_prep``, no ``kernel_compile``);
  * the port's metrics catalog (tools/metrics_catalog.py) is the table
    tier-1 pins (tests/torch_catalog.py), and that table is the JAX
    generator's row for row but for the four families the port leaves
    out, each with its reason, each on ROADMAP.md's list;
  * each guard fails on a doctored table: a renamed span, a dropped
    marker, an extra or a missing family;
  * the port's three readers carry every top-level name of the
    repository's tools of the same names.
"""
import ast
import importlib.util
import json
import os
import re

import pytest

from cometbft_tpu_torch.tools import metrics_catalog
from cometbft_tpu_torch.tools import trace_report
from torch_catalog import LEFT_OUT, TABLE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "cometbft_tpu_torch")
JAX = os.path.join(ROOT, "cometbft_tpu")


def _load(mod_name):
    """The repository's tools/<mod_name>.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{mod_name}", os.path.join(ROOT, "tools",
                                              f"{mod_name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R_TRACE = _load("trace_report")

# the port's crypto spans, as they stand: the JAX set without the
# compile span (nvcc builds at load, outside any verification), with the
# packing and the C prep inside host_prep
PORT_CRYPTO_SPANS = {"batch_verify", "host_prep", "prep_pack", "prep_c",
                     "kernel_execute"}

_CALL = re.compile(
    r"tracing\.(instant|span|record_span)\(\s*"
    r"tracing\.([A-Z0-9_]+)\s*,\s*[fF]?\"([^\"]+)\"", re.S)


def _emitted(category: str, root: str = PORT) -> tuple[set, set]:
    """(span_names, instant_names) for one category, by scanning a
    package's source for tracing calls.  F-string names are truncated
    at the first placeholder (``step:{...}`` -> ``step:``)."""
    spans: set = set()
    instants: set = set()
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                src = f.read()
            for kind, cat_const, name in _CALL.findall(src):
                if cat_const != category:
                    continue
                name = name.split("{")[0]
                (instants if kind == "instant" else spans).add(name)
    return spans, instants


# -- the guards, as functions of what they compare ------------------------------

def bucket_problems(buckets: dict, spans: set) -> list[str]:
    """Emitted consensus spans without a bucket, and buckets of names
    nothing emits ("step:*" spans match by prefix)."""
    out = [f"consensus span {n!r} is emitted but has no bucket"
           for n in sorted(spans)
           if not n.startswith("step:") and n not in buckets]
    out += [f"the report buckets {n!r} but nothing emits it"
            for n in sorted(buckets)
            if n not in spans and not n.startswith("step:")]
    return out


def marker_problems(markers, instants: set) -> list[str]:
    """Emitted consensus instants the marker table lacks, and table
    entries nothing emits."""
    markers = set(markers)
    out = [f"emitted but not a marker: {n!r}"
           for n in sorted(instants - markers)]
    out += [f"a marker nothing emits: {n!r}"
            for n in sorted(markers - instants)]
    return out


def catalog_problems(port_rows: list, reference_rows: list,
                     left_out: dict) -> list[str]:
    """The port's rows must be the reference's, in order, but for the
    families ``left_out`` names; a left-out family must be one the
    reference has."""
    def name(row):
        return row.split("`")[1] if row.startswith("| `") else None
    ref_names = {name(r) for r in reference_rows}
    want = [r for r in reference_rows if name(r) not in left_out]
    out = [f"left out but not in the reference: {n}"
           for n in sorted(left_out) if n not in ref_names]
    out += [f"only in the port: {r}" for r in port_rows if r not in want]
    out += [f"missing from the port: {r}" for r in want
            if r not in port_rows]
    if not out and port_rows != want:
        out.append("the rows are in another order")
    return out


# -- the report's tables against the names the port emits -----------------------

def test_consensus_spans_all_bucketed():
    spans, _ = _emitted("CONSENSUS")
    assert spans, "census found no consensus spans"
    assert bucket_problems(trace_report.CONSENSUS_SPAN_BUCKETS, spans) == []


def test_consensus_instants_all_marked():
    _, instants = _emitted("CONSENSUS")
    assert instants, "census found no consensus instants"
    assert marker_problems(trace_report.CONSENSUS_MARKERS, instants) == []


def test_fleet_report_keys_on_emitted_names():
    """The cluster critical path is keyed on these instants; if one is
    renamed at the emit site the fleet report silently loses that
    column."""
    spans, instants = _emitted("CONSENSUS")
    for needed in ("proposal_broadcast", "proposal_recv", "vote_recv",
                   "commit"):
        assert needed in instants, needed
    assert "step:" in spans  # step:{...} spans incl. Propose


def test_peer_attributed_mempool_instants_emitted():
    _, instants = _emitted("MEMPOOL")
    for needed in ("txs_recv", "have_recv", "want_recv"):
        assert needed in instants, needed


def test_crypto_spans_pinned():
    spans, instants = _emitted("CRYPTO")
    assert spans == PORT_CRYPTO_SPANS and not instants
    assert _emitted("CRYPTO", JAX)[0] - spans == {"kernel_compile"}


@pytest.mark.parametrize("category", ["CONSENSUS", "MEMPOOL", "P2P",
                                      "SUPERVISOR", "ABCI", "NEMESIS"])
def test_the_port_emits_the_reference_names(category):
    assert _emitted(category) == _emitted(category, JAX)


def test_the_report_tables_are_the_reference_tables():
    assert trace_report.CONSENSUS_SPAN_BUCKETS == R_TRACE.CONSENSUS_SPAN_BUCKETS
    assert trace_report.CONSENSUS_MARKERS == R_TRACE.CONSENSUS_MARKERS
    assert trace_report._VERIFY_NAMES == R_TRACE._VERIFY_NAMES


# -- the catalog ----------------------------------------------------------------

def test_catalog_generator_gives_the_pinned_table():
    assert metrics_catalog.to_markdown(
        metrics_catalog.collect_catalog()) == TABLE


def test_catalog_is_the_reference_row_for_row():
    ref = _load("metrics_catalog")
    rows = ref.to_markdown(ref.collect_catalog()).splitlines()
    assert len(rows) - 2 == len(TABLE.splitlines()) - 2 + len(LEFT_OUT)
    assert catalog_problems(TABLE.splitlines(), rows, LEFT_OUT) == []


def test_left_out_families_are_on_the_roadmap():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    listed = roadmap[roadmap.index("Deliberately not ported"):]
    for name, reason in LEFT_OUT.items():
        assert reason.strip()
        assert f"`{name}`" in listed, name


def test_catalog_json_holds_the_rows(capsys):
    assert metrics_catalog.main(["--json"]) == 0
    cat = json.loads(capsys.readouterr().out)
    assert metrics_catalog.to_markdown(cat) == TABLE
    assert all(f["help"].strip() for f in cat)


# -- each guard fails on a doctored table ----------------------------------------

def _doctored(kind):
    spans, instants = _emitted("CONSENSUS")
    buckets = dict(trace_report.CONSENSUS_SPAN_BUCKETS)
    markers = set(trace_report.CONSENSUS_MARKERS)
    rows = TABLE.splitlines()
    ref = _load("metrics_catalog")
    ref_rows = ref.to_markdown(ref.collect_catalog()).splitlines()
    if kind == "renamed span":
        buckets["save_blocks"] = buckets.pop("save_block")
        return bucket_problems(buckets, spans)
    if kind == "span emitted under a new name":
        return bucket_problems(buckets, (spans - {"apply_block"}) |
                               {"apply_blocks"})
    if kind == "dropped marker":
        return marker_problems(markers - {"vote_recv"}, instants)
    if kind == "extra family":
        extra = "| `cometbft_crypto_extra` | counter | — | An extra one. |"
        return catalog_problems(rows[:5] + [extra] + rows[5:], ref_rows,
                                LEFT_OUT)
    if kind == "missing family":
        return catalog_problems(rows[:5] + rows[6:], ref_rows, LEFT_OUT)
    if kind == "changed help":
        return catalog_problems(
            [r.replace("Size of the latest block.", "Block size.")
             for r in rows], ref_rows, LEFT_OUT)
    if kind == "stale left-out entry":
        return catalog_problems(rows, ref_rows,
                                {**LEFT_OUT, "cometbft_gone": "reason"})
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "renamed span", "span emitted under a new name", "dropped marker",
    "extra family", "missing family", "changed help",
    "stale left-out entry"])
def test_guards_fail_on_a_doctored_table(kind):
    assert _doctored(kind)


# -- the readers carry the repository tools' names -------------------------------

def _top_level_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names - {"_REPO_ROOT"}   # the reference's sys.path fix-up


@pytest.mark.parametrize("name", ["trace_report", "metrics_catalog",
                                  "fleet_report"])
def test_the_readers_carry_the_reference_tools_names(name):
    ref = _top_level_names(os.path.join(ROOT, "tools", f"{name}.py"))
    mine = _top_level_names(os.path.join(PORT, "tools", f"{name}.py"))
    assert ref and ref <= mine, sorted(ref - mine)
