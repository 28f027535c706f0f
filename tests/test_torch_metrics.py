"""The port's trimmed metrics and tracing (cometbft_tpu_torch/libs)
against the JAX package's (cometbft_tpu/libs):

  * for the same observations both registries render the same
    Prometheus text, escaping included, and estimate the same quantiles;
  * every family the port registers has the reference's name, kind,
    help, labels and buckets, so ``/metrics`` reads the same;
  * the verification path records into them: the commit-verify
    histogram by kind, the batch-verify histogram and span by backend,
    the signature-cache counters;
  * spans are recorded, filtered by category, carry an error attribute,
    and cost nothing when disabled.
"""
import pytest
import torch

from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import bls12381 as r_bls
from cometbft_tpu.crypto import pipeline as r_pipeline
from cometbft_tpu.libs import metrics as r_metrics
from cometbft_tpu.libs.workers import SupervisedWorker as RWorker
from cometbft_tpu.ops import ed25519_jax as r_ej
from cometbft_tpu.types import signature_cache as r_cache
from cometbft_tpu.types import validation as r_validation
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.libs import metrics as p_metrics
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.workers import SupervisedWorker as PWorker
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types import signature_cache as p_cache
from cometbft_tpu_torch.types import validation as pv
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.configure()
    yield
    tracing.configure()


def _fill(mod, scenario):
    """One registry of ``mod`` (either package's metrics module) with
    the observations of ``scenario``."""
    reg = mod.Registry()
    if scenario == "counters":
        reg.counter("crypto", "plain", "A counter.").add(3)
        c = reg.counter("p2p", "by_peer", 'Per "peer"\\ bytes.\nTwo lines.',
                        labels=("peer", "ch"))
        c.with_labels('a"b', "1").add(2)
        c.with_labels("back\\slash", "2").add(0.5)
        c.with_labels("new\nline", "3").add()
    elif scenario == "gauges":
        g = reg.gauge("crypto", "depth", "Depth.", labels=("worker",))
        g.with_labels("w1").set(4)
        g.with_labels("w0").set(0.25)
        reg.gauge("crypto", "level", "Level.").set(-2)
    elif scenario == "histograms":
        h = reg.histogram("crypto", "seconds", "Seconds.",
                          labels=("phase", "bucket"),
                          buckets=(0.001, 0.01, 0.1, 1.0))
        for v in (0.0005, 0.002, 0.002, 0.05, 0.5, 3.0):
            h.with_labels("host_prep", "64").observe(v)
        h.with_labels("kernel_execute", "4096").observe(0.01)
        plain = reg.histogram("crypto", "ratio", "Ratio.")
        for v in (0.9, 1.0, 1.7, 12.0):
            plain.observe(v)
    return reg


@pytest.mark.parametrize("scenario", ["counters", "gauges", "histograms"])
def test_render_matches_reference(scenario):
    assert _fill(p_metrics, scenario).render() == \
        _fill(r_metrics, scenario).render()


@pytest.mark.parametrize("q", [0.01, 0.5, 0.9, 0.99, 1.0])
def test_quantile_matches_reference(q):
    hp = _fill(p_metrics, "histograms").histogram(
        "crypto", "seconds", labels=("phase", "bucket"))
    hr = _fill(r_metrics, "histograms").histogram(
        "crypto", "seconds", labels=("phase", "bucket"))
    assert hp.with_labels("host_prep", "64").quantile(q) == \
        hr.with_labels("host_prep", "64").quantile(q)


def _reference_families():
    """The reference's lazily registered families of this path."""
    r_pipeline._dispatch_histogram()
    r_pipeline.overlap_histogram()
    r_ej._refine_counter()
    r_batch.verify_seconds_histogram()
    r_validation.commit_verify_histogram()
    r_cache._metrics()
    r_bls._agg_pk_metrics()
    reg = r_metrics.Registry()
    RWorker("w", registry=reg).stop()
    return {m.name: m for m in r_metrics.DEFAULT.families() +
            reg.families()}


def _port_families():
    reg = p_metrics.Registry()
    PWorker("w", registry=reg).stop()
    return {m.name: m for m in p_metrics.DEFAULT.families() +
            reg.families()}


PORT_FAMILIES = [
    "cometbft_consensus_commit_verify_seconds",
    "cometbft_crypto_agg_pubkey_cache_evictions",
    "cometbft_crypto_agg_pubkey_cache_hits",
    "cometbft_crypto_agg_pubkey_cache_misses",
    "cometbft_crypto_batch_verify_seconds",
    "cometbft_crypto_kernel_dispatch_seconds",
    "cometbft_crypto_pad_bucket_refinements",
    "cometbft_crypto_verify_executor_depth",
    "cometbft_crypto_verify_overlap_ratio",
    "cometbft_crypto_verify_queue_wait_seconds",
    "cometbft_light_signature_cache_evictions",
    "cometbft_light_signature_cache_hits",
    "cometbft_light_signature_cache_misses",
]


def test_port_registers_exactly_these_families():
    assert sorted(_port_families()) == PORT_FAMILIES


@pytest.mark.parametrize("name", PORT_FAMILIES)
def test_family_matches_reference(name):
    mine, theirs = _port_families()[name], _reference_families()[name]
    assert (mine.kind, mine.help, mine.label_names) == \
        (theirs.kind, theirs.help, theirs.label_names)
    assert getattr(mine, "buckets", None) == getattr(theirs, "buckets", None)


def _commit(n):
    privs = [p_ed.Ed25519PrivKey(bytes([i + 1]) * 32) for i in range(n)]
    vals = ValidatorSet([Validator.new(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(b"b" * 32, PartSetHeader(1, b"p" * 32))
    commit = Commit(height=3, round=0, block_id=bid,
                    signatures=[CommitSig.absent() for _ in range(n)])
    sigs = []
    for i, v in enumerate(vals.validators):
        commit.signatures[i] = CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                                         Timestamp(1_700_000_000 + i, 0), b"")
        sig = by_addr[v.address].sign(commit.vote_sign_bytes("c", i))
        sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                              Timestamp(1_700_000_000 + i, 0), sig))
    return vals, bid, Commit(height=3, round=0, block_id=bid,
                             signatures=sigs)


def test_verification_path_records(monkeypatch):
    """A 4-validator commit (batch kind), twice with one cache, and a
    1-validator commit (single kind); the kernel accepts every lane."""
    monkeypatch.setattr(ek, "verify_cols", lambda a, r, s, k:
                        torch.ones(a.shape[1], dtype=torch.bool))
    commit_hist = pv.commit_verify_histogram()
    batch_hist = pbatch.verify_seconds_histogram()
    n_batch = commit_hist.with_labels("batch").count
    n_single = commit_hist.with_labels("single").count
    n_cpu = batch_hist.with_labels("cpu", "64").count
    hits, misses = p_cache._HITS.value, p_cache._MISSES.value

    vals, bid, commit = _commit(4)
    cache = p_cache.SignatureCache()
    pv.verify_commit("c", vals, bid, 3, commit, cache=cache, device="cpu")
    pv.verify_commit("c", vals, bid, 3, commit, cache=cache, device="cpu")
    vals1, bid1, commit1 = _commit(1)
    pv.verify_commit("c", vals1, bid1, 3, commit1, device="cpu")

    assert commit_hist.with_labels("batch").count == n_batch + 2
    assert commit_hist.with_labels("single").count == n_single + 1
    # the second call finds every signature in the cache: no batch
    assert batch_hist.with_labels("cpu", "64").count == n_cpu + 1
    assert (p_cache._HITS.value - hits, p_cache._MISSES.value - misses) == \
        (4, 4)
    spans = [e for e in tracing.snapshot(category=tracing.CRYPTO)
             if e["name"] == "batch_verify"]
    assert len(spans) == 1
    assert spans[0]["attrs"] == {"batch": 4, "backend": "cpu"}


def test_cache_evictions_counted():
    before = p_cache._EVICTIONS.value
    cache = p_cache.SignatureCache(capacity=2)
    for i in range(5):
        cache.add(bytes([i]) * 64, p_cache.SignatureCacheValue(b"a", b"m"))
    assert cache.evictions == 3
    assert p_cache._EVICTIONS.value - before == 3


def test_traced_verifier_wraps_and_keeps_len():
    priv = p_ed.Ed25519PrivKey(bytes(32))
    bv = pbatch.create_batch_verifier(priv.pub_key(), device="cpu")
    assert isinstance(bv, pbatch.TracedBatchVerifier)
    bv.add(priv.pub_key(), b"m", priv.sign(b"m"))
    assert len(bv) == 1


def test_spans_recorded_in_order_with_attrs():
    with tracing.span(tracing.CRYPTO, "outer", batch=3, extra=1):
        with tracing.span(tracing.CRYPTO, "inner"):
            pass
    t0 = tracing.now_ns()
    tracing.record_span(tracing.P2P, "given", t0, t0 + 5, peer="x")
    events = tracing.snapshot()
    assert [e["name"] for e in events] == ["outer", "inner", "given"]
    assert events[0]["attrs"] == {"batch": 3, "extra": 1}
    assert events[0]["dur_ns"] >= events[1]["dur_ns"]
    assert events[2]["dur_ns"] == 5 and events[2]["category"] == "p2p"
    assert [e["name"] for e in tracing.snapshot(limit=1)] == ["given"]
    tracing.clear()
    assert tracing.snapshot() == []


def test_span_records_the_error():
    with pytest.raises(KeyError):
        with tracing.span(tracing.CRYPTO, "boom", batch=1):
            raise KeyError("x")
    (ev,) = tracing.snapshot()
    assert ev["attrs"] == {"batch": 1, "error": "KeyError"}


def test_disabled_or_filtered_spans_record_nothing():
    tracing.configure(enabled=False)
    with tracing.span(tracing.CRYPTO, "off"):
        pass
    tracing.record_span(tracing.CRYPTO, "off", 0, 1)
    assert tracing.snapshot() == []
    tracing.configure(categories="p2p")
    with tracing.span(tracing.CRYPTO, "filtered"):
        pass
    with tracing.span(tracing.P2P, "kept"):
        pass
    assert [e["name"] for e in tracing.snapshot()] == ["kept"]


def test_ring_keeps_the_newest():
    tracing.configure(buffer_size=3)
    for i in range(5):
        tracing.record_span(tracing.CRYPTO, f"e{i}", i, i + 1)
    assert [e["name"] for e in tracing.snapshot()] == ["e2", "e3", "e4"]



# -- the label ceiling, exemplars, descriptors, Timer --------------------------

def _churn(mod_p2p, mod_cons, mod_metrics, peers):
    """One registry of either package fed ``peers`` distinct peer ids
    through the p2p families labelled by peer and consensus's
    ``block_parts``."""
    reg = mod_metrics.Registry()
    p2p, cons = mod_p2p.Metrics(reg), mod_cons.Metrics(reg)
    for i in range(peers):
        peer = f"{i:040x}"
        p2p.peer_pending_send_bytes.with_labels(peer).set(i)
        p2p.recv_rate_limiter_delay.with_labels(peer).add(0.5)
        p2p.send_rate_limiter_delay.with_labels(peer).add(0.25)
        cons.block_parts.with_labels(peer).add()
    return reg, p2p, cons


def test_peer_churn_stops_at_the_ceiling():
    """C.9: 2,100 peer ids leave at most 2,048 + 1 series in each family
    labelled by peer, the last 52 ids sharing the ``overflow`` series,
    and the page reads as the JAX package's (exact text equality)."""
    from cometbft_tpu.consensus import metrics as r_cons
    from cometbft_tpu.p2p import metrics as r_p2p
    from cometbft_tpu_torch.consensus import metrics as p_cons
    from cometbft_tpu_torch.p2p import metrics as p_p2p
    reg, p2p, cons = _churn(p_p2p, p_cons, p_metrics, 2100)
    r_reg, r_p2p_m, r_cons_m = _churn(r_p2p, r_cons, r_metrics, 2100)
    for fam in (p2p.peer_pending_send_bytes, p2p.recv_rate_limiter_delay,
                p2p.send_rate_limiter_delay, cons.block_parts):
        assert fam.max_children == p_metrics._CHILDREN_MAX == 2048
        assert fam.series_count() == 2049
    over = cons.block_parts.with_labels("overflow")
    assert over.value == 52
    assert r_cons_m.block_parts.with_labels("overflow").value == 52
    assert reg.render() == r_reg.render()
    assert reg.collect() == r_reg.collect()


def test_a_lowered_ceiling_collapses_new_values_only():
    c = p_metrics.Registry().counter("p2p", "x", "X.", labels=("a", "b"))
    c.max_children = 2
    c.with_labels("p", "1").add()
    c.with_labels("q", "2").add()
    c.with_labels("r", "3").add()
    c.with_labels("p", "1").add()
    c.with_labels("s", "4").add(2)
    assert c.with_labels("overflow", "overflow").value == 3
    assert c.with_labels("p", "1").value == 2
    assert c.series_count() == 3


def _exemplar_story(mod, trc):
    """The same observations in either package, at recorder heights 0,
    7 and 9 (``trc`` is that package's tracing module)."""
    reg = mod.Registry()
    h = reg.histogram("consensus", "step_seconds", "Step.",
                      labels=("step",), buckets=(0.01, 0.1, 1.0))
    plain = reg.histogram("crypto", "seconds", "Seconds.",
                          buckets=(0.5, 2.0))
    reg.counter("p2p", "bytes_total", "Bytes.").add(5)
    reg.counter("p2p", "frames", "Frames.", labels=("ch",)) \
        .with_labels("0x20").add(3)
    reg.gauge("p2p", "peers", "Peers.").set(4)
    trc.set_height(0)
    h.with_labels("propose").observe(0.005)
    trc.set_height(7)
    h.with_labels("propose").observe(0.05)
    h.with_labels("commit").observe(3.0)
    plain.observe(0.2)
    trc.set_height(9)
    h.with_labels("propose").observe(0.004)
    plain.observe(1.5, exemplar={"trace_height": 2, "peer": 'a"b'})
    trc.set_height(0)
    return reg


def _mask_timestamps(page: str) -> str:
    """Each exemplar's wall-clock timestamp (its last field) masked."""
    out = []
    for line in page.splitlines():
        if " # {" in line:
            line = line.rsplit(" ", 1)[0] + " TS"
        out.append(line)
    return "\n".join(out)


def test_exemplars_match_reference():
    """Exact text equality once each exemplar's wall-clock timestamp is
    masked; the default render carries no exemplar at all."""
    from cometbft_tpu.libs import tracing as r_tracing
    r_tracing.configure()
    try:
        reg = _exemplar_story(p_metrics, tracing)
        r_reg = _exemplar_story(r_metrics, r_tracing)
    finally:
        r_tracing.configure()
    page = reg.render(exemplars=True)
    assert _mask_timestamps(page) == \
        _mask_timestamps(r_reg.render(exemplars=True))
    assert 'propose",le="0.01"} 2 # {trace_height="9"} 0.004 ' in page
    assert '{le="2"} 2 # {trace_height="2",peer="a\\"b"} 1.5 ' in page
    assert "p2p_bytes_total 5" in page and "TYPE cometbft_p2p_bytes " \
        "counter" in page and "cometbft_p2p_frames_total{" in page
    assert reg.render() == r_reg.render()
    assert " # {" not in reg.render()
    merged = p_metrics.render_merged(reg, p_metrics.Registry(),
                                     exemplars=True)
    assert _mask_timestamps(merged) == _mask_timestamps(
        r_metrics.render_merged(r_reg, r_metrics.Registry(),
                                exemplars=True))


def test_collect_matches_reference():
    reg, r_reg = _fill(p_metrics, "histograms"), _fill(r_metrics,
                                                      "histograms")
    assert reg.collect() == r_reg.collect()
    assert reg.collect()[1] == {
        "name": "cometbft_crypto_seconds", "kind": "histogram",
        "help": "Seconds.", "labels": ["phase", "bucket"], "series": 2}
    for scenario in ("counters", "gauges"):
        assert _fill(p_metrics, scenario).collect() == \
            _fill(r_metrics, scenario).collect()


def test_timer_observes_elapsed_seconds(monkeypatch):
    clock = iter([10.0, 10.25])
    monkeypatch.setattr(p_metrics.time, "perf_counter", lambda: next(clock))
    h = p_metrics.Registry().histogram("x", "y", "Y.", buckets=(0.1, 1.0))
    with p_metrics.Timer(h) as t:
        assert t.hist is h
    assert (h.count, h.sum) == (1, 0.25)
    assert h._counts == [0, 1]
