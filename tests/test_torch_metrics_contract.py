"""The JAX package's metrics contract (tests/test_metrics_contract.py)
held on the port's metrics (cometbft_tpu_torch/libs/metrics.py):

  * the renderer's unit contracts: label and help escaping, the
    histogram contract and its exemplars, the OpenMetrics ``_total``
    suffix, ``render_merged``'s deduplication;
  * the cardinality guard: every family the port registers has help and
    labels from the bounded allowlist, the child cap collapses excess
    label values into one overflow series, the default cap is sane, and
    the batch-verify histogram's pad buckets are the kernel's own ladder
    (ops/ed25519._bucket);
  * the full exposition of a live 3-validator net of port ``Node``s on
    the CPU: ``/metrics`` and ``/metrics?exemplars=1`` parsed whole by the
    contract's parser (tests/torch_exposition.py), the live histogram
    families observed, exemplars at heights that had begun;
  * the parser refuses the broken pages the contract is about;
  * chip_smoke.py's phase 23 rehearsed on the CPU.

The nodes run ``device="cpu"`` with the accept-all stand-in kernel.
"""
import asyncio

import pytest
import torch

import chip_smoke
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.metrics import (
    Registry, _CHILDREN_MAX, render_merged,
)
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.tools import metrics_catalog
from cometbft_tpu_torch.types import vote as vote_mod
from torch_catalog import LEFT_OUT
from torch_exposition import (assert_exposition_contract, exemplar_heights,
                              hist_count, parse_exposition)
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _stand_in(a, r, s, k):
    """The accept-all stand-in kernel; counts a launch."""
    ek.launches += 1
    return torch.ones(a.shape[1], dtype=torch.bool)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(ek, "verify_cols", _stand_in)
    vote_mod._VERIFIED.clear()
    vote_mod._REJECTED.clear()
    old = tracing.recorder()
    yield
    tracing.set_recorder(old)
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


# -- renderer unit contracts -----------------------------------------------------

class TestExpositionFormat:
    def test_label_escaping_roundtrip(self):
        reg = Registry()
        c = reg.counter("t", "esc", "escaping test", labels=("who",))
        hostile = 'mon"iker\\with\nnewline'
        c.with_labels(hostile).add(3)
        fams = assert_exposition_contract(reg.render())
        (_, labels, value), = fams["cometbft_t_esc"]["samples"]
        assert labels["who"] == hostile
        assert value == 3

    def test_help_escaping(self):
        reg = Registry()
        reg.gauge("t", "h", "line one\nline two")
        fams = parse_exposition(reg.render())
        assert fams["cometbft_t_h"]["help"] == "line one\nline two"

    def test_histogram_contract_and_exemplars(self):
        reg = Registry()
        h = reg.histogram("t", "lat", "latency", labels=("be",),
                          buckets=(0.1, 1.0))
        old = tracing.set_recorder(tracing.Recorder())
        try:
            tracing.set_height(42)
            h.with_labels("cpu").observe(0.05)
            h.with_labels("cpu").observe(3.0)
        finally:
            tracing.set_recorder(old)
        assert_exposition_contract(reg.render())
        # default render carries no exemplar syntax
        assert " # {" not in reg.render()
        out = reg.render(exemplars=True)
        assert 'trace_height="42"' in out
        # the exemplar rides the bucket the observation fell into
        line = [ln for ln in out.splitlines()
                if 'le="0.1"' in ln][0]
        assert "# {" in line and " 0.05 " in line
        fams = assert_exposition_contract(out + "# EOF\n", openmetrics=True)
        exemplars = {lab["le"]: (ex, v) for _, lab, ex, v, _
                     in fams["cometbft_t_lat"]["exemplars"]}
        assert exemplars == {"0.1": ({"trace_height": "42"}, 0.05),
                             "+Inf": ({"trace_height": "42"}, 3.0)}

    def test_openmetrics_counter_total_suffix(self):
        """The exemplar page is OpenMetrics: counter samples carry the
        mandatory _total suffix and already-suffixed names don't double
        it."""
        reg = Registry()
        reg.counter("t", "ops", "plain counter").add(3)
        reg.counter("t", "bytes_total", "pre-suffixed").add(7)
        om = reg.render(exemplars=True)
        assert "cometbft_t_ops_total 3" in om
        assert "# TYPE cometbft_t_ops counter" in om
        assert "cometbft_t_bytes_total 7" in om
        assert "# TYPE cometbft_t_bytes counter" in om
        assert "bytes_total_total" not in om
        # default text-format render is unchanged
        plain = reg.render()
        assert "cometbft_t_ops 3" in plain
        assert "cometbft_t_ops_total" not in plain
        fams = assert_exposition_contract(om + "# EOF\n", openmetrics=True)
        assert fams["cometbft_t_ops"]["samples"] == \
            [("cometbft_t_ops_total", {}, 3.0)]

    def test_render_merged_dedups_families(self):
        a, b = Registry(), Registry()
        a.counter("t", "x", "from a").add(1)
        b.counter("t", "x", "from b").add(5)
        b.counter("t", "y", "only b").add(2)
        out = render_merged(a, b)
        assert out.count("# TYPE cometbft_t_x counter") == 1
        assert "cometbft_t_x 1" in out       # first registry wins
        assert "cometbft_t_y 2" in out
        assert_exposition_contract(out)


# -- cardinality / help guards -----------------------------------------------------

# label names whose value sets are bounded by construction: protocol
# enums, claimed channel ids, config-capped peer slots, app-declared
# lanes (all further capped by the per-family child ceiling).  The JAX
# package's list but for the breaker's two, "breaker" and "state": the
# port has no breaker.
_ALLOWED_LABELS = {
    "step", "peer_id", "chID", "lane", "matches_current",
    "proposer_address", "status", "vote_type", "is_timely", "method",
    "conn", "type", "supervisor", "kind", "task", "backend",
    "pad_bucket", "phase", "kernel", "warm", "name", "le",
    "worker",       # verification workers: hard-coded names at the
                    # SupervisedWorker construction sites
}


class TestCardinalityGuard:
    def test_every_family_has_help_and_bounded_labels(self):
        catalog = metrics_catalog.collect_catalog()
        assert len(catalog) >= 100
        for fam in catalog:
            assert fam["help"].strip(), \
                f"{fam['name']}: empty help text"
            for label in fam["labels"]:
                assert label in _ALLOWED_LABELS, (
                    f"{fam['name']}: label {label!r} not in the "
                    f"bounded-label allowlist")

    def test_child_cap_collapses_into_overflow_series(self):
        reg = Registry()
        c = reg.counter("t", "churn", "per-peer churn",
                        labels=("peer_id",))
        c.max_children = 8
        for i in range(100):
            c.with_labels(f"peer-{i}").add()
        fams = parse_exposition(reg.render())
        samples = fams["cometbft_t_churn"]["samples"]
        assert len(samples) == 9        # 8 distinct + 1 overflow
        overflow = [v for _, labels, v in samples
                    if labels["peer_id"] == "overflow"]
        assert overflow == [100 - 8]
        # total observations survive the collapse
        assert sum(v for _, _, v in samples) == 100

    def test_default_cap_is_sane(self):
        assert 512 <= _CHILDREN_MAX <= 16384

    def test_pad_bucket_matches_kernel_buckets(self):
        """crypto/batch.pad_bucket is the kernel's live ladder
        (ops/ed25519._bucket), so the histogram's label is the bucket a
        batch launched at, refined buckets included."""
        assert tuple(crypto_batch.PAD_BUCKETS) == oe._BASE_BUCKETS
        ns = (1, 63, 64, 65, 200, 1024, 5000, 10240, 10241, 10**6)
        for n in ns:
            assert crypto_batch.pad_bucket(n) == oe._bucket(n)
        assert [crypto_batch.pad_bucket(n) for n in ns] == \
            [64, 64, 64, 1024, 1024, 1024, 10240, 10240, 16384, 16384]
        try:
            oe._BUCKETS.insert(1, 256)      # a refined bucket
            assert crypto_batch.pad_bucket(200) == oe._bucket(200) == 256
        finally:
            oe.reset_bucket_tuning()
        assert crypto_batch.pad_bucket(200) == 1024


# -- the parser refuses what the contract is about -----------------------------------

_H = ("# HELP cometbft_t_h help\n# TYPE cometbft_t_h histogram\n")
BROKEN = {
    "buckets not monotonic": _H + 'cometbft_t_h_bucket{le="1"} 3\n'
    'cometbft_t_h_bucket{le="2"} 2\ncometbft_t_h_bucket{le="+Inf"} 3\n'
    "cometbft_t_h_sum 1\ncometbft_t_h_count 3\n",
    "+Inf is not _count": _H + 'cometbft_t_h_bucket{le="1"} 1\n'
    'cometbft_t_h_bucket{le="+Inf"} 2\ncometbft_t_h_sum 1\n'
    "cometbft_t_h_count 3\n",
    "no _sum": _H + 'cometbft_t_h_bucket{le="+Inf"} 2\n'
    "cometbft_t_h_count 2\n",
    "sample without HELP": "cometbft_t_x 1\n",
    "TYPE before HELP": "# TYPE cometbft_t_x counter\ncometbft_t_x 1\n",
    "empty HELP": "# HELP cometbft_t_x \n# TYPE cometbft_t_x counter\n"
    "cometbft_t_x 1\n",
    "unquoted label": "# HELP cometbft_t_x x\n# TYPE cometbft_t_x counter\n"
    "cometbft_t_x{a=b} 1\n",
    "stray comment": "# HELP cometbft_t_x x\n# TYPE cometbft_t_x counter\n"
    "# note\ncometbft_t_x 1\n",
    "exemplar on a 0.0.4 page": _H + 'cometbft_t_h_bucket{le="+Inf"} 1 '
    '# {trace_height="1"} 0.5 1.0\ncometbft_t_h_sum 1\n'
    "cometbft_t_h_count 1\n",
}
BROKEN_OM = {
    "no EOF": "# HELP cometbft_t_x x\n# TYPE cometbft_t_x counter\n"
    "cometbft_t_x_total 1\n",
    "counter without _total": "# HELP cometbft_t_x x\n"
    "# TYPE cometbft_t_x counter\ncometbft_t_x 1\n# EOF\n",
    "exemplar above its bucket": _H + 'cometbft_t_h_bucket{le="1"} 1 '
    '# {trace_height="1"} 1.5 1.0\ncometbft_t_h_bucket{le="+Inf"} 1\n'
    "cometbft_t_h_sum 1.5\ncometbft_t_h_count 1\n# EOF\n",
    "exemplar off a bucket": _H + 'cometbft_t_h_bucket{le="+Inf"} 1\n'
    'cometbft_t_h_sum 1 # {trace_height="1"} 1 1.0\n'
    "cometbft_t_h_count 1\n# EOF\n",
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_the_parser_refuses_a_broken_page(name):
    with pytest.raises(AssertionError):
        assert_exposition_contract(BROKEN[name])


@pytest.mark.parametrize("name", sorted(BROKEN_OM))
def test_the_parser_refuses_a_broken_openmetrics_page(name):
    with pytest.raises(AssertionError):
        assert_exposition_contract(BROKEN_OM[name], openmetrics=True)


# -- acceptance: the full exposition of a live multi-validator run --------------------

@pytest.fixture(scope="module")
def port_pages(tmp_path_factory):
    """chip_smoke._obs_run's record of the live 3-validator port net
    (its pages, the highest height begun at the scrape, the run's start),
    on the stand-in kernel."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ek, "verify_cols", _stand_in)
        vote_mod._VERIFIED.clear()
        vote_mod._REJECTED.clear()
        old = tracing.recorder()
        try:
            run = asyncio.run(chip_smoke._obs_run(
                str(tmp_path_factory.mktemp("obs")), "cpu"))
        finally:
            tracing.set_recorder(old)
            pipeline.reset_workers()
            oe.reset_bucket_tuning()
    return run


@pytest.fixture(scope="module")
def reference_page(tmp_path_factory):
    """/metrics of the JAX package's live contract net (three validators,
    four txs, its cpu backend), run to the port net's height."""
    from cometbft_tpu.crypto import batch as r_batch
    from cometbft_tpu.node.node import Node as RNode
    from cometbft_tpu.rpc.client import HTTPClient as RHTTPClient
    from cometbft_tpu.types import vote as r_vote_mod
    from cometbft_tpu.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu.types.timestamp import Timestamp
    from test_metrics_contract import _fetch, _mk_cfg
    d = str(tmp_path_factory.mktemp("jax-obs"))
    r_batch.set_backend("cpu")
    r_vote_mod._VERIFIED.clear()
    r_vote_mod._REJECTED.clear()

    async def go():
        cfgs = [_mk_cfg(d, f"n{i}") for i in range(3)]
        gen = GenesisDoc(chain_id="contract-chain",
                         genesis_time=Timestamp.now(),
                         validators=[GenesisValidator(
                             address=b"", pub_key=pv.get_pub_key(),
                             power=10) for _, pv in cfgs])
        for cfg, _ in cfgs:
            gen.save_as(cfg.base.path(cfg.base.genesis_file))
        nodes = [RNode(cfg) for cfg, _ in cfgs]
        for n in nodes:
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.switch.dial_peer(b.switch.listen_addr)
            cli = RHTTPClient(f"http://{nodes[0]._rpc_server.listen_addr}",
                              timeout=30.0)
            for i in range(chip_smoke.OBS_TXS):
                await cli.broadcast_tx_sync(b"contract%d=v" % i)
            top = chip_smoke.OBS_HEIGHT
            await chip_smoke._nodes_until(
                [], lambda: all(n.height >= top for n in nodes),
                "the JAX net", 90.0)
            return await _fetch(nodes[0]._rpc_server.listen_addr,
                                "/metrics")
        finally:
            for n in nodes:
                await n.stop()
    try:
        return asyncio.run(go())
    finally:
        r_batch.set_backend("auto")


def test_live_page_serves_the_reference_families(port_pages,
                                                  reference_page):
    """Every family a live JAX net serves, the port's live net serves
    with the same type, help and label names; the port serves more only
    where the JAX package registers a family on first use (the port
    registers it at import): its page holds the whole catalog.  The
    families the port leaves out are set aside (the JAX package serves
    them once anything in the process has made them)."""
    mine = parse_exposition(port_pages["metrics"])
    theirs = {name: fam for name, fam in
              parse_exposition(reference_page).items()
              if name not in LEFT_OUT}
    assert set(theirs) <= set(mine), sorted(set(theirs) - set(mine))

    def label_names(fam):
        return {tuple(sorted(k for k in labels if k != "le"))
                for _, labels, _ in fam["samples"]}
    for name, fam in theirs.items():
        assert (mine[name]["type"], mine[name]["help"]) == \
            (fam["type"], fam["help"]), name
        a, b = label_names(mine[name]), label_names(fam)
        assert not (a and b) or a == b, (name, a, b)
    catalog = {f["name"] for f in metrics_catalog.collect_catalog()}
    assert set(mine) == catalog


def test_live_multi_validator_metrics_contract(port_pages):
    """GET /metrics on a live 3-validator net of port Nodes passes the
    full exposition contract AND serves the histogram families the perf
    analyses hang off: consensus step duration, quorum-prevote delay,
    block interval, rounds per height, ABCI call latency, CheckTx
    latency, p2p send size, batch-verify latency (by backend and pad
    bucket) and the p2p stall family's bucket ladder; the exemplar page
    passes the OpenMetrics contract, every exemplar at a height that had
    begun."""
    metrics, om = port_pages["metrics"], port_pages["om"]
    fams = assert_exposition_contract(metrics)
    for name, labels in chip_smoke.OBS_HISTOGRAMS:
        assert hist_count(fams, name, **labels) > 0, name
    # batch-verify rode the live commit-verification path, labelled by
    # backend (the device's type) and pad bucket
    assert hist_count(fams, "cometbft_crypto_batch_verify_seconds",
                      backend="cpu", pad_bucket="64") > 0
    # the stall family serves its full bucket ladder before any stall
    stall = fams["cometbft_p2p_queue_stall_seconds"]
    assert any(s.endswith("_bucket") for s, _, _ in stall["samples"])
    # exemplar mode: OpenMetrics, bucket observations link to a height
    assert 'trace_height="' in om
    om_fams = assert_exposition_contract(om, openmetrics=True)
    heights = exemplar_heights(om_fams, since=port_pages["since"])
    assert heights and 1 <= min(heights)
    assert max(heights) <= port_pages["in_progress"]
    assert len(fams) == len(om_fams) == len(
        metrics_catalog.collect_catalog())


def test_phase_23_rehearsed_on_the_cpu(stand_in):
    """chip_smoke.py's phase 23 with device="cpu" and the stand-in
    kernel: its per-height lines, the span count held to the launches,
    both pages through the contract and the catalog pinned by tier-1."""
    launches = chip_smoke._observability_phases(0, "CPU", device="cpu")
    key = f"observability_{chip_smoke.OBS_VALIDATORS}x{chip_smoke.OBS_HEIGHT}"
    assert list(launches) == [key] and launches[key] > 0
