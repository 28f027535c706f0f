"""The port's light client (cometbft_tpu_torch/light/client.py) against
the JAX package's (cometbft_tpu/light/client.py), both syncing the same
chain from providers that record what they are asked:

  * skipping and sequential syncs over a chain of 8 validators and 40
    heights, a quarter of the set replaced every 8 heights: the same
    heights fetched in the same order from the primary and the
    witnesses, the same stored heights and the same final header hash;
    ``verify_light_block_at_height`` between stored blocks and
    ``update``;
  * B1 launches per hop (the wrapper ``verify_cols`` counted) equal to
    the JAX package's batch verifications per hop;
  * the sync-wide signature cache: a hop's 2/3 check adds only what its
    trusting check has not proved;
  * a lunatic witness: the same DivergenceError, the same evidence hash
    reported to both providers, the witness dropped on both sides;
  * backwards verification below the trust root;
  * a corrupted signature rejected with the same text (B1's plain
    version), and a kernel that raises: the error leaves
    ``verify_to_height`` as itself and nothing is stored;
  * chip_smoke.py's ``_skipping_plan`` gives the heights the JAX client
    fetches and stores, so the smoke's check on the card holds the port
    to the JAX algorithm; its fast signer equals the golden model.

The port runs ``device="cpu"`` with the accept-all stand-in kernel
where verdicts do not matter; the JAX side its CPU backend.
"""
import asyncio
import sys
from pathlib import Path

import pytest
import torch

from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import pipeline as r_pipeline
from cometbft_tpu.db.db import MemDB as RMemDB
from cometbft_tpu.light import client as r_client
from cometbft_tpu.light import verifier as r_verifier
from cometbft_tpu.light.provider import LightBlockNotFoundError as RNotFound
from cometbft_tpu.light.provider import Provider as RProvider
from cometbft_tpu.light.store import TrustedStore as RTrustedStore
from cometbft_tpu.types import block as r_block
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.crypto import batch as p_batch
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.light import client as p_client
from cometbft_tpu_torch.light import verifier as p_verifier
from cometbft_tpu_torch.light.store import TrustedStore
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types.block import LightBlock, SignedHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

T0 = cs.LIGHT_T0
PERIOD_NS = 24 * 3600 * 10**9
DRIFT_NS = 10 * 10**9
NOW = Timestamp(T0 + 100, 0)
TOP = 40


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    _native_loader.load()


@pytest.fixture(autouse=True)
def _fresh():
    r_batch.set_backend("cpu")
    yield
    r_batch.set_backend("auto")
    pipeline.reset_workers()
    r_pipeline.reset_workers()
    oe.reset_bucket_tuning()


@pytest.fixture(scope="module")
def chain():
    return cs._LightChain.rotating("light-client", 8, TOP, 8, 2, 21,
                                   cs._Signer())


@pytest.fixture
def launches(monkeypatch):
    """The accept-all stand-in kernel; counts its launches and the real
    lanes of each batch."""
    rec = {"launches": 0, "lanes": []}

    def verify_cols(a, r, s, k):
        rec["launches"] += 1
        return torch.ones(a.shape[1], dtype=torch.bool)

    real = p_batch.CudaBatchVerifier.verify

    def verify(self):
        rec["lanes"].append(len(self))
        return real(self)

    monkeypatch.setattr(ek, "verify_cols", verify_cols)
    monkeypatch.setattr(p_batch.CudaBatchVerifier, "verify", verify)
    return rec


@pytest.fixture
def batches(monkeypatch):
    """The JAX package's batch verifications and the entries of each."""
    rec = {"lanes": []}
    real = r_batch.create_batch_verifier

    class Counting:
        def __init__(self, inner):
            self.inner = inner

        def add(self, pub_key, msg, sig):
            self.inner.add(pub_key, msg, sig)

        def __len__(self):
            return len(self.inner)

        def verify(self):
            rec["lanes"].append(len(self.inner))
            return self.inner.verify()

    monkeypatch.setattr(r_batch, "create_batch_verifier",
                        lambda pk: Counting(real(pk)))
    return rec


class RProviderOf(RProvider):
    """The JAX side of chip_smoke's provider: the same chain, the same
    forks, carried across through the proto."""

    def __init__(self, chain, name, forks=None):
        self.chain, self.name, self.forks = chain, name, forks or {}
        self.requests, self.evidence = [], []

    async def light_block(self, height):
        self.requests.append(height)
        height = height or self.chain.top
        if height in self.forks:
            lb = self.forks[height]
        elif not 1 <= height <= self.chain.top:
            raise RNotFound(f"no light block at height {height}")
        else:
            lb = self.chain.light_block(height)
        return r_block.LightBlock.from_proto(lb.to_proto())

    async def report_evidence(self, ev):
        self.evidence.append(ev)

    def id(self):
        return self.name


class Pair:
    """The same client on both sides: primary, witnesses, store."""

    def __init__(self, chain, root, mode="skipping", witnesses=2,
                 forks=None, period_ns=PERIOD_NS):
        forks = forks or {}
        names = [f"witness-{i}" for i in range(witnesses)]
        self.p_primary = cs._chain_provider(chain, "primary")
        self.r_primary = RProviderOf(chain, "primary")
        self.p_wits = [cs._chain_provider(chain, n, forks.get(n))
                       for n in names]
        self.r_wits = [RProviderOf(chain, n, forks.get(n)) for n in names]
        root_hash = chain.headers[root].hash()
        self.p = p_client.Client(
            chain.chain_id, p_client.TrustOptions(period_ns, root,
                                                  root_hash),
            self.p_primary, self.p_wits, TrustedStore(MemDB()),
            verification_mode=mode, max_clock_drift_ns=DRIFT_NS,
            device="cpu")
        self.r = r_client.Client(
            chain.chain_id, r_client.TrustOptions(period_ns, root,
                                                  root_hash),
            self.r_primary, self.r_wits, RTrustedStore(RMemDB()),
            verification_mode=mode, max_clock_drift_ns=DRIFT_NS)

    def run(self, method, *args, now=NOW):
        """(port outcome, JAX outcome) of client.<method>(*args)."""
        out = []
        for c, ts in ((self.p, now), (self.r, RTimestamp(*now))):
            try:
                lb = asyncio.run(getattr(c, method)(*args, now=ts))
                out.append(("ok", lb.hash() if lb is not None else None))
            except Exception as e:  # noqa: BLE001 — compared below
                out.append((type(e).__name__, str(e)))
        return out

    def same(self):
        assert self.p_primary.requests == self.r_primary.requests
        assert [w.requests for w in self.p_wits] == \
            [w.requests for w in self.r_wits]
        assert self.p.store.heights() == self.r.store.heights()
        for h in self.p.store.heights():
            assert self.p.store.light_block(h).to_proto() == \
                self.r.store.light_block(h).to_proto()
        assert [w.id() for w in self.p.witnesses] == \
            [w.id() for w in self.r.witnesses]


@pytest.mark.parametrize("mode,target", [
    ("skipping", TOP), ("skipping", 17), ("skipping", 2),
    ("sequential", 12)])
def test_sync_matches_reference(chain, launches, batches, mode, target):
    pair = Pair(chain, 1, mode)
    got, want = pair.run("initialize")
    assert got == want == ("ok", chain.headers[1].hash())
    got, want = pair.run("verify_to_height", target)
    assert got == want == ("ok", chain.headers[target].hash())
    pair.same()
    assert launches["lanes"] == batches["lanes"]
    assert launches["launches"] == len(batches["lanes"])
    if mode == "skipping" and target == TOP:
        assert len(pair.p.store.heights()) > 2       # it had to bisect


def test_plan_is_the_jax_clients(chain, launches):
    for root, target in ((1, TOP), (1, 30), (5, 33), (9, 10)):
        pair = Pair(chain, root, witnesses=1)
        pair.run("initialize")
        got, want = pair.run("verify_to_height", target)
        assert got == want and got[0] == "ok"
        fetched, stored, tried, refused = cs._skipping_plan(chain, root,
                                                            target)
        assert pair.r.store.heights() == stored
        assert pair.r_primary.requests == [root] + fetched
        assert pair.r_wits[0].requests == [target]
        pair.same()


def test_launches_per_hop_match(chain, launches, batches, monkeypatch):
    per_hop = {"port": [], "jax": []}

    def counting(module, side, counter):
        real = module.verify

        def hop(*a, **kw):
            before = counter()
            try:
                return real(*a, **kw)
            finally:
                per_hop[side].append(counter() - before)

        monkeypatch.setattr(module, "verify", hop)

    counting(p_client, "port", lambda: launches["launches"])
    counting(r_client, "jax", lambda: len(batches["lanes"]))
    pair = Pair(chain, 1)
    pair.run("initialize")
    got, want = pair.run("verify_to_height", TOP)
    assert got == want
    assert per_hop["port"] == per_hop["jax"]
    # a refused hop stops before its batch; an accepted one runs two
    assert set(per_hop["port"]) <= {0, 1, 2} and 2 in per_hop["port"]


def test_shared_cache_skips_the_overlap(launches, batches):
    """4 equal validators: the trusting check stops after 2 signatures,
    the 2/3 check finds them in the cache and adds 1 (the JAX package's
    tests/test_light_skipping.py:158)."""
    small = cs._LightChain.rotating("light-cache", 4, 10, 100, 1, 22,
                                    cs._Signer())
    pair = Pair(small, 1, witnesses=0)
    pair.run("initialize")
    got, want = pair.run("verify_to_height", 10)
    assert got == want and got[0] == "ok"
    assert launches["lanes"] == batches["lanes"] == [2, 1]
    pair.same()


def test_verify_at_height_between_stored_blocks_and_update(chain, launches):
    pair = Pair(chain, 1)
    pair.run("initialize")
    got, want = pair.run("verify_to_height", 30)
    assert got == want
    for method, args in (("verify_light_block_at_height", (20,)),
                         ("verify_light_block_at_height", (30,)),
                         ("update", ()), ("update", ()),
                         ("verify_light_block_at_height", (0,))):
        got, want = pair.run(method, *args)
        assert got == want, method
        pair.same()


def test_lunatic_witness_matches_reference(chain, launches):
    h = 14
    hdr = chain.headers[h]
    fork_hdr = cs._light_header(chain.chain_id, h, chain.vals_of(h),
                                chain.vals_of(h + 1), hdr.last_block_id,
                                app=b"lunatic")
    fork = cs._signed_light_block(fork_hdr, chain.vals_of(h),
                                  chain.seed_of, chain.signer,
                                  signers=[0, 1, 3, 4, 6, 7])
    pair = Pair(chain, 1, forks={"witness-1": {h: fork}})
    pair.run("initialize")
    got, want = pair.run("verify_to_height", h)
    assert got == want == ("DivergenceError",
                           "witness witness-1 diverges from primary")
    pair.same()
    assert [w.id() for w in pair.p.witnesses] == ["witness-0"]
    (pev,), (rev,) = pair.p_primary.evidence, pair.r_primary.evidence
    assert pair.p_wits[1].evidence == [pev]
    assert pair.r_wits[1].evidence == [rev]
    assert not pair.p_wits[0].evidence
    assert pev.hash() == rev.hash() and pev.bytes() == rev.bytes()
    # the common block is the root: its set's signers of the fork
    signers = {chain.vals_of(h).validators[i].address
               for i in (0, 1, 3, 4, 6, 7)}
    common = {v.address for v in chain.vals_of(1).validators}
    assert pev.common_height == 1
    assert {v.address for v in pev.byzantine_validators} == \
        signers & common != signers


def test_backwards_matches_reference(chain, launches):
    pair = Pair(chain, 30, witnesses=1)
    pair.run("initialize")
    got, want = pair.run("verify_light_block_at_height", 12)
    assert got == want == ("ok", chain.headers[12].hash())
    pair.same()
    assert pair.p.store.heights() == list(range(12, 31))
    assert launches["launches"] == 0


def test_expired_root_and_drift_match(chain, launches):
    pair = Pair(chain, 1, witnesses=0)
    got, want = pair.run("initialize", now=Timestamp(T0 + 1, 0).add_ns(
        PERIOD_NS))
    assert got == want == ("LightClientError", "trusted header is expired")
    pair.run("initialize")
    late = Timestamp(T0 + 1, 0).add_ns(PERIOD_NS + 1)
    for target in (20, 2):
        got, want = pair.run("verify_to_height", target, now=late)
        assert got == want and got[0] == "OldHeaderExpiredError"
    got, want = pair.run("verify_to_height", 20, now=Timestamp(T0 + 10, 0))
    assert got == want == ("InvalidHeaderError",
                           "header time exceeds max clock drift")
    pair.same()
    assert launches["launches"] == 0


def test_corrupted_signature_matches_reference(chain):
    """B1's plain version: the real verdict names the index."""
    lb = chain.light_block(7)
    bad = LightBlock(SignedHeader(lb.signed_header.header,
                                  cs._corrupted(lb.signed_header.commit,
                                                [2])), lb.validator_set)
    pair = Pair(chain, 1, witnesses=0)
    pair.p_primary = cs._chain_provider(chain, "primary", {7: bad})
    pair.p.primary = pair.p_primary
    pair.r_primary.forks = {7: bad}
    pair.run("initialize")
    got, want = pair.run("verify_to_height", 7)
    assert got == want
    assert got[0] == "InvalidHeaderError" and \
        got[1].startswith("wrong signature (#2): ")
    pair.same()
    assert pair.p.store.heights() == [1]


def test_kernel_failure_raises_out_of_the_sync(chain, monkeypatch):
    def broken(*_):
        raise RuntimeError("ed25519_verify launch failed: unspecified "
                           "launch failure")

    monkeypatch.setattr(ek, "verify_cols", broken)
    for mode in ("skipping", "sequential"):
        pair = Pair(chain, 1, mode)
        asyncio.run(pair.p.initialize(now=NOW))
        with pytest.raises(RuntimeError, match="launch failed"):
            asyncio.run(pair.p.verify_to_height(TOP, now=NOW))
        assert pair.p.store.heights() == [1]
        assert pair.p_primary.requests[:2] == [1, TOP if mode == "skipping"
                                               else 2]
        assert not any(w.requests for w in pair.p_wits)


def test_client_runs_on_the_card_by_default(chain):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_client.Client(chain.chain_id,
                        p_client.TrustOptions(PERIOD_NS, 1,
                                              chain.headers[1].hash()),
                        cs._chain_provider(chain, "primary"), [],
                        TrustedStore(MemDB()))


def test_bad_trust_level_matches_reference(chain):
    from cometbft_tpu.types.validation import Fraction as RFraction
    from cometbft_tpu_torch.types.validation import Fraction
    outs = []
    for mod, frac, store in ((p_client, Fraction, TrustedStore(MemDB())),
                             (r_client, RFraction,
                              RTrustedStore(RMemDB()))):
        try:
            mod.Client(chain.chain_id, mod.TrustOptions(PERIOD_NS, 1, b""),
                       None, [], store, trust_level=frac(1, 5))
        except Exception as e:  # noqa: BLE001 — compared below
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]
    assert outs[0][0] == "LightClientError"
    assert issubclass(p_client.DivergenceError, p_verifier.LightClientError)
    assert r_verifier.LightClientError.__name__ == "LightClientError"


@pytest.mark.parametrize("i", range(3))
def test_smoke_signer_is_the_golden_model(i):
    seed = cs._seed(5, i)
    msg = b"chip-smoke light %d" % i * (i * 50 + 1)
    assert cs._fast_pub_job(seed) == ref.public_key(seed)
    assert cs._fast_sign_job((seed, msg)) == ref.sign(seed, msg)
