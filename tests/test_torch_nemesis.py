"""The nemesis over the port: every scenario of tests/test_nemesis.py,
with the same name, seed, steps, fuzz, WAL, key type, params and
recovery budget, run by tests/torch_nemesis.py against in-process nets
of ``cometbft_tpu_torch`` nodes.

Every scenario asserts BOTH properties:
  * safety  -- no two honest nodes commit conflicting blocks at any
              height (full-history check);
  * liveness -- the chain commits `recovery_blocks` more blocks within
              a bounded time after the faults heal.

The nodes run ``device="cpu"`` with the accept-all stand-in kernel (its
launches are counted); the sweeps are `slow`, as in the JAX file.
``test_every_jax_scenario_has_an_identical_port_counterpart`` reads both
files with ``ast`` and fails when a JAX ``Scenario(...)`` literal has no
identical copy here.
"""
import ast
import asyncio
from pathlib import Path

import pytest

from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.types import vote as vote_mod
from torch_chain import accept_all
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from torch_nemesis import ARCHIVE_ENV, Scenario
from torch_nemesis import run_scenario as _run_scenario

pytestmark = pytest.mark.nemesis

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def _cpu_stand_in(monkeypatch, tmp_path):
    monkeypatch.setenv(ARCHIVE_ENV, str(tmp_path / "archive"))
    vote_mod._VERIFIED.clear()
    vote_mod._REJECTED.clear()
    yield accept_all(monkeypatch)
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def run_scenario(s):
    return _run_scenario(s, device="cpu")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class TestNemesisScenarios:
    def test_asymmetric_partition_stalls_then_heals(self):
        """One-way 2|2 cut: {0,1} frames never reach {2,3}, the
        reverse direction stays up.  Neither side can assemble a
        quorum (votes flow one way only), so the chain must STALL —
        committing through an asymmetric half-cut would be a safety
        smell — and after heal the vote-catchup gossip must revive
        the wedged round within the recovery budget."""
        run(run_scenario(Scenario(
            name="asym-partition-2x2",
            seed=7,
            steps=(
                ("wait_blocks", 2),
                ("partition", (0, 1), (2, 3)),
                ("expect_stall", 1.5, 1),
                ("heal",),
            ),
            recovery_blocks=3)))

    def test_crash_restart_mid_height(self):
        """Hard-kill a validator mid-height; the 3/4 supermajority
        keeps committing; the crashed node restarts on its durable
        stores and converges onto the same chain."""
        run(run_scenario(Scenario(
            name="crash-restart",
            seed=11,
            steps=(
                ("wait_blocks", 2),
                ("crash", 3),
                ("expect_progress", (0, 1, 2), 3, 60.0),
                ("restart", 3),
            ),
            recovery_blocks=2)))

    def test_reorder_duplicate_drop_links(self):
        """Every link reorders, duplicates, delays, and drops frames
        (seeded); the stack must keep committing through the noise
        and the histories must agree."""
        run(run_scenario(Scenario(
            name="faulty-links",
            seed=23,
            fuzz=dict(prob_reorder=0.05, prob_duplicate=0.05,
                      prob_drop_write=0.02, prob_delay=0.05,
                      max_delay_s=0.02),
            steps=(
                ("wait_blocks", 4),
            ),
            recovery_blocks=2)))

    def test_pipelined_commit_crash_reorder(self):
        """Two heights in flight (pipelined commit, the default) under
        reorder/duplicate link fuzz, plus a hard crash that ABORTS an
        in-flight background apply and restarts through the real
        recovery path (file WAL + ABCI handshake + catchup replay).
        Safety (identical chains) and bounded recovery must hold; the
        restarted node's replayed app hashes converge with the nodes
        that executed serially-in-order — the WAL-replay-equals-
        pipelined-execution half of the claim is pinned byte-exactly
        in test_pipeline.py."""
        run(run_scenario(Scenario(
            name="pipelined-commit",
            seed=17,
            use_wal=True,
            fuzz=dict(prob_reorder=0.06, prob_duplicate=0.06,
                      prob_delay=0.04, max_delay_s=0.01),
            steps=(
                ("wait_blocks", 3),
                ("crash", 2),
                ("expect_progress", (0, 1, 3), 2, 60.0),
                ("restart", 2),
                ("wait_blocks", 2),
            ),
            recovery_blocks=3)))

    def test_aggregate_commit_crash_restart_fuzz(self):
        """Aggregate-commit chain (BLS valset, one aggregate signature
        + signer bitmap per commit — docs/aggregate_commits.md) under
        reorder/duplicate link fuzz plus a hard crash/restart through
        the REAL recovery path (file WAL + ABCI handshake + catchup
        replay).  Restart recovery replays blocks whose LastCommit is
        the aggregate form from the store, and the node keeps
        proposing/validating aggregates afterwards.  Gated on zero
        safety violations and bounded recovery, like every tier-1
        scenario."""
        from cometbft_tpu_torch.types.params import (
            ConsensusParams, FeatureParams, ValidatorParams,
        )
        run(run_scenario(Scenario(
            name="aggregate-commit",
            seed=29,
            use_wal=True,
            key_type="bls12_381",
            consensus_params=ConsensusParams(
                validator=ValidatorParams(
                    pub_key_types=["bls12_381"]),
                feature=FeatureParams(
                    pbts_enable_height=1,
                    aggregate_commit_enable_height=1)),
            fuzz=dict(prob_reorder=0.05, prob_duplicate=0.05,
                      prob_delay=0.03, max_delay_s=0.01),
            steps=(
                ("wait_blocks", 3),
                ("crash", 1),
                ("expect_progress", (0, 2, 3), 2, 90.0),
                ("restart", 1),
                ("wait_blocks", 2),
            ),
            recovery_blocks=3,
            recovery_timeout_s=120.0)))

    def test_statetree_crash_restart_fuzz(self):
        """The kvstore's storage engine is the committed
        state tree, so every header's app_hash IS a tree root.
        Hard-crash a node mid-height under reorder/duplicate link
        fuzz; the restart rebuilds the app from its durable db and
        ABCI handshake replay (plus WAL catchup) must converge on the
        exact roots the live nodes committed — checked
        header-by-header after the run, on top of the runner's
        zero-safety-violations and bounded-recovery gates."""
        net = run(run_scenario(Scenario(
            name="statetree-crash",
            seed=37,
            use_wal=True,
            fuzz=dict(prob_reorder=0.06, prob_duplicate=0.06,
                      prob_delay=0.03, max_delay_s=0.01),
            steps=(
                ("wait_blocks", 3),
                ("crash", 1),
                ("expect_progress", (0, 2, 3), 2, 60.0),
                ("restart", 1),
                ("wait_blocks", 2),
            ),
            recovery_blocks=3)))
        # every committed tree version must chain to the NEXT block's
        # header app_hash — i.e. handshake replay on the restarted
        # node reproduced byte-identical roots, not just "a" state
        checked = 0
        for n in net.nodes:
            for v in n.app.tree.versions():
                if v < 1:
                    continue
                meta = n.block_store.load_block_meta(v + 1)
                if meta is None:
                    continue
                assert meta.header.app_hash == \
                    n.app.tree.reported_hash(v), \
                    f"node {n.idx}: version {v} root diverges " \
                    f"from header {v + 1}"
                checked += 1
        assert checked >= 4, "app-hash chain check found no headers"

    def test_recon_gossip_under_fuzz_and_partition(self):
        """Have/want tx gossip + compact-block proposals
        (the mempool reactor, negotiated by default) running under
        reorder/duplicate link fuzz and a transient asymmetric
        partition.  The load injector puts every tx in exactly ONE
        node's pool, so blocks only fill if reconciliation moves txs
        across the fuzzed links; liveness, bounded recovery, and
        zero conflicting commits (the runner's full-history hash
        check) must all hold."""
        run(run_scenario(Scenario(
            name="recon-gossip",
            seed=31,
            mempool_gossip=True,
            fuzz=dict(prob_reorder=0.05, prob_duplicate=0.05,
                      prob_delay=0.04, max_delay_s=0.015),
            steps=(
                ("wait_blocks", 3),
                ("partition", (0,), (2, 3)),
                ("sleep", 1.0),
                ("heal",),
                ("wait_blocks", 2),
            ),
            recovery_blocks=2)))

    def test_mute_validator_routes_around(self):
        """Asymmetric single-node mute: node 3's frames reach nobody,
        but it still hears the net.  The other three form a quorum and
        progress must CONTINUE during the fault (gossip routes around
        the mute), and node 3 still follows the chain passively."""
        run(run_scenario(Scenario(
            name="mute-one",
            seed=13,
            steps=(
                ("wait_blocks", 2),
                ("partition", (3,), (0, 1, 2)),
                ("expect_progress", (0, 1, 2), 3, 60.0),
                ("heal",),
            ),
            recovery_blocks=2)))


class TestFailureArchive:
    def test_failed_scenario_archives_flight_record(
            self, tmp_path, monkeypatch):
        """A scenario that misses its liveness budget must leave a
        flight-record archive named after the scenario+seed (ROADMAP
        open item: liveness regressions come with timelines
        attached)."""
        import json
        import os

        from cometbft_tpu_torch.libs import tracing

        monkeypatch.setenv(ARCHIVE_ENV, str(tmp_path))
        old = tracing.set_recorder(tracing.Recorder())
        try:
            with pytest.raises(AssertionError) as exc_info:
                run(run_scenario(Scenario(
                    name="archive-probe",
                    seed=41,
                    # unreachable liveness target: fail fast
                    recovery_blocks=10_000,
                    recovery_timeout_s=0.2)))
        finally:
            tracing.set_recorder(old)
        import glob
        matches = glob.glob(os.path.join(
            str(tmp_path), "nemesis-archive-probe-seed41-*.json"))
        assert len(matches) == 1, os.listdir(str(tmp_path))
        path = matches[0]
        assert str(path) in str(exc_info.value)
        with open(path) as f:
            record = json.load(f)
        assert record["extra"]["scenario"] == "archive-probe"
        assert record["extra"]["seed"] == 41
        assert "liveness" in record["extra"]["error"]
        # fleet observability: per-node state + clock anchors ride in
        # the archive so fleet_report can place it on a wall timeline
        assert record["extra"]["nodes"], "per-node state missing"
        assert all("height" in n for n in record["extra"]["nodes"])
        assert record["anchors"], "clock anchors missing"
        # the archive carries a real timeline, not an empty ring
        assert record["events"], "archived flight record is empty"

    def test_archive_names_are_run_unique(self, tmp_path,
                                          monkeypatch):
        """Re-running the same scenario+seed must never overwrite the
        previous run's archive (the old fixed naming silently lost
        the first failure's evidence)."""
        import glob
        import os

        from cometbft_tpu_torch.libs import tracing
        from torch_nemesis import _archive_flight_record

        monkeypatch.setenv(ARCHIVE_ENV, str(tmp_path))
        old = tracing.set_recorder(tracing.Recorder())
        try:
            s = Scenario(name="dup-probe", seed=7)
            p1 = _archive_flight_record(s, RuntimeError("first"))
            p2 = _archive_flight_record(s, RuntimeError("second"))
        finally:
            tracing.set_recorder(old)
        assert p1 and p2 and p1 != p2
        matches = glob.glob(os.path.join(
            str(tmp_path), "nemesis-dup-probe-seed7-*.json"))
        assert len(matches) == 2


@pytest.mark.slow
class TestNemesisSweeps:
    def test_partition_sweep_seeded(self):
        """Sweep cut patterns x seeds: every asymmetric cut must heal
        into a safe, live chain."""
        cuts = (
            ((0,), (1, 2, 3)),          # mute one
            ((0, 1), (2, 3)),           # half split
            ((0, 1, 2), (3,)),          # isolate one's inbound
        )
        for seed in (1, 2):
            for srcs, dsts in cuts:
                run(run_scenario(Scenario(
                    name=f"sweep-{srcs}-{dsts}-s{seed}",
                    seed=seed,
                    steps=(
                        ("wait_blocks", 2),
                        ("partition", srcs, dsts),
                        ("sleep", 1.0),
                        ("heal",),
                    ),
                    recovery_blocks=3)))

    def test_compound_fuzz_plus_crash(self):
        """Compose link noise with a crash/restart — the schedules
        must not mask each other."""
        run(run_scenario(Scenario(
            name="fuzz+crash",
            seed=29,
            fuzz=dict(prob_reorder=0.03, prob_duplicate=0.03,
                      prob_drop_write=0.01),
            steps=(
                ("wait_blocks", 2),
                ("crash", 1),
                ("expect_progress", (0, 2, 3), 2, 60.0),
                ("restart", 1),
                ("wait_blocks", 2),
            ),
            recovery_blocks=2)))


def _scenario_literals(path):
    """``ast.dump`` of every ``Scenario(...)`` call in a file, and the
    test names of each class."""
    tree = ast.parse(path.read_text())
    calls = [ast.dump(n) for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
             and n.func.id == "Scenario"]
    tests = {c.name: sorted(f.name for f in c.body
                            if isinstance(f, ast.FunctionDef)
                            and f.name.startswith("test_"))
             for c in tree.body if isinstance(c, ast.ClassDef)}
    return calls, tests


def test_every_jax_scenario_has_an_identical_port_counterpart():
    theirs, their_tests = _scenario_literals(HERE / "test_nemesis.py")
    mine, my_tests = _scenario_literals(HERE / "test_torch_nemesis.py")
    assert len(theirs) >= 12
    missing = [c for c in theirs if c not in mine]
    assert not missing, f"JAX scenarios without a port copy: {missing}"
    for cls, names in their_tests.items():
        assert set(names) <= set(my_tests.get(cls, ())), cls


def test_chip_smoke_runs_the_jax_scenarios_verbatim():
    theirs, _ = _scenario_literals(HERE / "test_nemesis.py")
    smoke, _ = _scenario_literals(HERE.parent / "chip_smoke.py")
    assert len(smoke) == 2 and all(c in theirs for c in smoke)


def test_phase_22_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 22 on the CPU: the two scenarios with B1
    replaced by a memoised golden-model check that counts a launch a
    tile (so 22a's corrupted lane is refused), every stored commit
    verified again, and the crash sweep's node processes on the CPU."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from torch_chain import cs

    memo = {}

    def verify_batch(items, device=None, **kw):
        ek.launches += len(tile_plan(len(items), DEFAULT_TILE))
        mask = []
        for item in items:
            if item not in memo:
                memo[item] = ref.verify(*item)
            mask.append(memo[item])
        return all(mask), mask

    monkeypatch.setattr(oe, "verify_batch", verify_batch)
    launches = cs._fault_phases(0, "CPU", device="cpu")
    assert set(launches) == {"nemesis_faulty-links",
                             "nemesis_pipelined-commit"}
    assert all(n > 0 for n in launches.values())
    out = capsys.readouterr().out
    assert out.count("B1 mask == plain B1 mask") == 2
    assert out.count(": rc 99 after") == 4
    assert "torn WAL: repaired with a .corrupted copy" in out
