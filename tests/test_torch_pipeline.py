"""The port's tiled verification pipeline, its worker and its records,
against the JAX package's (tests/test_verify_pipeline.py:256-471):

  * a batch over several tiles gives the mask of one tile and of the
    ZIP-215 golden model (cometbft_tpu/crypto/_ed25519_ref.py);
  * every tile records host_prep / kernel_execute spans and
    ``crypto_kernel_dispatch_seconds`` observations, labelled by phase,
    kernel, pad bucket and warm flag; a multi-tile run observes its
    overlap ratio; measured pad-bucket refinement fires and resets;
  * a failed launch or a fault surfacing at a tile's event raises;
  * ``verify_async`` gives ``verify()``'s result while an event loop
    keeps ticking; ``SupervisedWorker`` returns results, captures and
    logs exceptions, drains on stop and brings its depth back to 0;
  * the JAX package's tile variable does not reach the port.

Where a test checks the pipeline's bookkeeping and not verdicts, the
kernel is a stand-in that accepts every lane (``_fake_kernel``).  The
``cuda``-marked test holds the pipelined verdicts to serial ones on the
card.  Verdicts are booleans: exact equality.
"""
import asyncio
import logging
import threading
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.libs import metrics as libmetrics
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.workers import SupervisedWorker
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

TILE_ENV = "COMETBFT_TPU_TORCH_VERIFY_TILE"


@pytest.fixture(autouse=True)
def _clean():
    tracing.configure()
    yield
    pipeline.reset_workers()
    oe.reset_bucket_tuning()
    tracing.configure()


def _signed(n, seed):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(4)]
    out = []
    for i in range(n):
        k = keys[i % 4]
        msg = rng.bytes(int(rng.integers(0, 200)))
        out.append((ref.public_key(k), msg, ref.sign(k, msg)))
    return out


def _with_faults(items):
    items = list(items)
    pub, msg, sig = items[3]
    items[3] = (pub, msg + b"!", sig)                       # tampered
    items[40] = (b"short",) + items[40][1:]                 # wrong length
    s = int.from_bytes(items[77][2][32:], "little") + ref.L
    items[77] = items[77][:2] + (items[77][2][:32] +
                                 s.to_bytes(32, "little"),)  # S >= L
    return items


def _fake_kernel(monkeypatch, module=ek, delay=0.0):
    """Replace ``module.verify_cols`` by a stand-in that accepts every
    lane (after ``delay`` seconds); returns the lane counts it saw."""
    calls = []

    def verify_cols(a, r, s, k):
        calls.append(a.shape[1])
        if delay:
            time.sleep(delay)
        return torch.ones(a.shape[1], dtype=torch.bool)

    monkeypatch.setattr(module, "verify_cols", verify_cols)
    return calls


def _children(hist):
    return {k: c for k, c in hist._children.items()}


def test_multi_tile_mask_matches_one_tile_and_reference(monkeypatch):
    items = _with_faults(_signed(130, 1))
    golden = [ref.verify(*it) for it in items]
    assert golden.count(False) == 3
    ok1, one_tile = oe.verify_batch(items, device="cpu")
    calls = []
    plain = ek.verify_cols_plain
    monkeypatch.setattr(ek, "verify_cols_plain",
                        lambda *a: calls.append(a[0].shape[1]) or plain(*a))
    monkeypatch.setenv(TILE_ENV, "64")
    ok3, tiled = oe.verify_batch(items, device="cpu")
    assert calls == [64, 64, 64]                 # 3 balanced tiles of 44
    assert tiled == one_tile == golden
    assert not ok1 and not ok3


@pytest.mark.parametrize("choice", ["cuda", "cuda8"])
def test_spans_and_dispatch_histogram(monkeypatch, choice):
    monkeypatch.setenv(oe.KERNEL_ENV, choice)
    monkeypatch.setenv(TILE_ENV, "64")
    calls = _fake_kernel(monkeypatch, ek if choice == "cuda" else ek8)
    hist = pipeline.dispatch_histogram()
    before = {k: c.count for k, c in _children(hist).items()}
    items = _signed(4, 2) * 40                   # 160 items: 3 tiles
    ok, mask = oe.verify_batch(items, device="cpu")
    assert ok and calls == [64, 64, 64]
    spans = tracing.snapshot(category=tracing.CRYPTO)
    names = [e["name"] for e in spans]
    assert names.count("host_prep") == names.count("kernel_execute") == 3
    assert names.count("prep_pack") == names.count("prep_c") == 3
    # tile 2 is prepped before tile 1 settles
    order = [n for n in names if n in ("host_prep", "kernel_execute")]
    assert order == ["host_prep", "host_prep", "kernel_execute",
                     "host_prep", "kernel_execute", "kernel_execute"]
    for e in spans:
        if e["name"] == "kernel_execute":
            assert e["attrs"]["kernel"] == choice
            assert e["attrs"]["bucket"] == 64
            assert e["attrs"]["pipelined"] is True
            assert e["attrs"]["batch"] in (52, 54)
    after = _children(hist)
    for phase in ("host_prep", "kernel_execute"):
        n = sum(c.count - before.get(k, 0) for k, c in after.items()
                if k[:3] == (phase, choice, "64"))
        assert n == 3, phase
    assert {k[3] for k in after if k[1] == choice} <= {"0", "1"}


def test_warm_label_after_first_dispatch(monkeypatch):
    _fake_kernel(monkeypatch)
    hist = pipeline.dispatch_histogram()
    oe._SEEN_SHAPES.discard(("cuda", 64))
    items = _signed(3, 3)
    oe.verify_batch(items, device="cpu")
    cold = hist.with_labels("host_prep", "cuda", "64", "0").count
    warm = hist.with_labels("host_prep", "cuda", "64", "1").count
    oe.verify_batch(items, device="cpu")
    assert hist.with_labels("host_prep", "cuda", "64", "0").count == cold
    assert hist.with_labels("host_prep", "cuda", "64", "1").count == warm + 1


def test_overlap_ratio_observed_for_multi_tile_runs(monkeypatch):
    _fake_kernel(monkeypatch, delay=0.002)
    ov = pipeline.overlap_histogram()
    n0, s0 = ov.count, ov.sum
    items = _signed(4, 4) * 20                   # 80 items
    oe.verify_batch(items, device="cpu")         # one tile: not observed
    assert ov.count == n0
    monkeypatch.setenv(TILE_ENV, "64")
    oe.verify_batch(items, device="cpu")         # two tiles
    assert ov.count == n0 + 1
    # the CPU path runs each kernel inside its dispatch, which no phase
    # counts: nothing overlaps and the ratio stays below 1
    assert 0.0 < ov.sum - s0 < 1.0


def test_bucket_refinement_fires_and_resets(monkeypatch):
    """Warm single-tile dispatches of 100 items padded to 1,024 whose
    kernel phase outweighs host prep refine a 128-lane bucket."""
    _fake_kernel(monkeypatch, delay=0.005)
    counter = oe._REFINED
    refined = counter.value
    items = _signed(4, 5) * 25
    assert oe._bucket(100) == 1024
    for _ in range(1 + oe._TUNE_MIN_SAMPLES):   # the first one is cold
        oe.verify_batch(items, device="cpu")
    assert oe._bucket(100) == 128
    assert counter.value == refined + 1
    oe.reset_bucket_tuning()
    assert oe._bucket(100) == 1024
    assert oe._BUCKETS == list(oe._BASE_BUCKETS)


def test_failed_launch_raises(monkeypatch):
    def broken(*_):
        raise RuntimeError("ed25519_verify launch failed: too many "
                           "resources requested for launch (7)")

    monkeypatch.setattr(ek, "verify_cols", broken)
    monkeypatch.setenv(TILE_ENV, "64")
    with pytest.raises(RuntimeError, match="launch failed"):
        oe.verify_batch(_signed(4, 6) * 20, device="cpu")


def test_fault_at_tile_event_raises(monkeypatch):
    """A fault the device reports only when the tile's event is
    synchronised raises from verify_batch; no mask comes back."""
    class FaultyEvent:
        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    real = oe._dispatch
    seen = []

    def dispatch(*args):
        ok, _ = real(*args)
        seen.append(len(ok))
        return ok, FaultyEvent() if len(seen) == 2 else None

    _fake_kernel(monkeypatch)
    monkeypatch.setattr(oe, "_dispatch", dispatch)
    monkeypatch.setenv(TILE_ENV, "64")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        oe.verify_batch(_signed(4, 7) * 50, device="cpu")
    assert seen == [64, 64, 64]     # tile 2 is settled after tile 3 left


def _batch_verifier(items):
    bv = pbatch.create_batch_verifier(p_ed.Ed25519PubKey(items[0][0]),
                                      device="cpu")
    for pub, msg, sig in items:
        bv.add(p_ed.Ed25519PubKey(pub), msg, sig)
    return bv


def test_verify_async_matches_verify():
    items = _signed(6, 8)
    pub, msg, sig = items[3]
    items[3] = (pub, msg, bytes([sig[0] ^ 1]) + sig[1:])
    bv = _batch_verifier(items)

    async def go():
        return await bv.verify_async()

    ok, mask = asyncio.run(go())
    assert (ok, list(mask)) == (False, [True, True, True, False, True, True])
    assert bv.verify() == (ok, mask)


def test_loop_stays_responsive_during_verify_async():
    """A 1 ms ticker's longest gap while a batch verifies off the loop
    stays far below the batch's own duration."""
    bv = _batch_verifier(_signed(40, 9))

    async def go():
        t0 = time.perf_counter()
        ok, _ = bv.verify()
        sync_s = time.perf_counter() - t0
        assert ok
        max_gap = 0.0
        done = asyncio.Event()

        async def ticker():
            nonlocal max_gap
            last = time.perf_counter()
            while not done.is_set():
                await asyncio.sleep(0.001)
                now = time.perf_counter()
                max_gap = max(max_gap, now - last)
                last = now

        t = asyncio.ensure_future(ticker())
        await asyncio.sleep(0.02)
        max_gap = 0.0
        ok, _ = await asyncio.wait_for(bv.verify_async(), timeout=120)
        done.set()
        await t
        assert ok
        return sync_s, max_gap

    sync_s, gap = asyncio.run(go())
    assert gap < max(0.5 * sync_s, 0.02), (sync_s, gap)


def test_worker_result_and_metrics():
    reg = libmetrics.Registry()
    w = SupervisedWorker("t_basic", registry=reg)
    try:
        assert w.submit(lambda a, b: a + b, 2, 3).result(5) == 5
        fam = reg.histogram("crypto", "verify_queue_wait_seconds",
                            labels=("worker",))
        assert fam.with_labels("t_basic").count == 1
    finally:
        w.stop()


def test_worker_exception_captured_logged_and_survived(caplog):
    w = SupervisedWorker("t_crash", registry=libmetrics.Registry())
    try:
        with caplog.at_level(logging.ERROR):
            fut = w.submit(lambda: 1 / 0)
            with pytest.raises(ZeroDivisionError):
                fut.result(5)
        assert w.submit(lambda: 41 + 1).result(5) == 42
        assert any("t_crash" in r.getMessage() and r.exc_info
                   for r in caplog.records)
    finally:
        w.stop()


def test_worker_stop_drains_queued_tasks():
    w = SupervisedWorker("t_drain", registry=libmetrics.Registry())
    futs = [w.submit(time.sleep, 0.01) for _ in range(3)]
    last = w.submit(lambda: "done")
    w.stop()
    assert last.result(5) == "done"
    assert all(f.done() for f in futs)
    assert not w._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        w.submit(lambda: None)


def test_worker_depth_returns_to_zero():
    reg = libmetrics.Registry()
    w = SupervisedWorker("t_depth", registry=reg)
    gauge = reg.gauge("crypto", "verify_executor_depth",
                      labels=("worker",)).with_labels("t_depth")
    try:
        gate = threading.Event()
        first = w.submit(gate.wait, 5)
        rest = [w.submit(lambda: None) for _ in range(3)]
        assert w.depth() == 4 and gauge.value == 4
        gate.set()
        first.result(5)
        for f in rest:
            f.result(5)
        deadline = time.monotonic() + 5
        while w.depth() and time.monotonic() < deadline:
            time.sleep(0.001)
        assert w.depth() == 0 and gauge.value == 0
    finally:
        w.stop()


def test_reset_workers_stops_the_stage_thread():
    assert pipeline.submit(lambda: 7).result(5) == 7
    stage = pipeline._STAGE
    pipeline.reset_workers()
    assert pipeline._STAGE is None and not stage._thread.is_alive()


@pytest.mark.parametrize("env, value, tile", [
    ("COMETBFT_TPU_VERIFY_TILE", "64", 4096),   # the JAX package's
    (TILE_ENV, "64", 64),
    (TILE_ENV, "63", 4096),
    (TILE_ENV, "abc", 4096),
])
def test_tile_size_reads_only_the_ports_variable(monkeypatch, env, value,
                                                 tile):
    monkeypatch.delenv(TILE_ENV, raising=False)
    monkeypatch.setenv(env, value)
    assert pipeline.tile_size() == tile


def test_reference_tile_variable_does_not_split_a_batch(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_VERIFY_TILE", "64")
    calls = _fake_kernel(monkeypatch)
    oe.verify_batch(_signed(4, 10) * 20, device="cpu")
    assert calls == [1024]


@pytest.mark.parametrize("n, tile, sizes", [
    (10000, 4096, [3334, 3334, 3332]),
    (10, 64, [10]),
    (128, 64, [64, 64]),
    (0, 64, []),
])
def test_tile_plan_balanced(n, tile, sizes):
    plan = pipeline.tile_plan(n, tile)
    assert [hi - lo for lo, hi in plan] == sizes
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("choice", ["cuda", "cuda8"])
def test_pipelined_matches_serial_on_card(monkeypatch, choice):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    monkeypatch.setenv(oe.KERNEL_ENV, choice)
    kernel = oe.KERNELS[choice]
    items = _with_faults(_signed(200, 11))
    a, r, s, k, bad = oe.prep_arrays(items, oe._bucket(len(items)))
    dev = torch.device("cuda")
    serial = kernel.verify_cols(*[oe.to_cols(x, dev) for x in (a, r, s, k)])
    serial = serial.cpu().numpy()[:len(items)] & ~bad[:len(items)]
    monkeypatch.setenv(TILE_ENV, "64")
    before = kernel.launches
    ok, mask = oe.verify_batch(items)
    assert kernel.launches == before + 4
    assert mask == serial.tolist() == [ref.verify(*it) for it in items]
    assert not ok
