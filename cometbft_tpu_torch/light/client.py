"""Light client: a header tracker over a trusted store.

Reference: light/client.go (:1179) — sequential or skipping (bisection)
verification against a primary provider, witness cross-checking
(detector.go), trust-period handling, backwards verification below the
trust root; through cometbft_tpu/light/client.py, step for step: the
same heights are fetched in the same order and the same blocks stored.

``Client`` takes ``device=None`` (the card; it raises at construction
where CUDA is absent) and hands it to every commit check, so each hop's
checks run on B1.  Only light-client errors steer the sync: a kernel
that fails to build or launch raises out of ``verify_to_height`` as
itself, before the hop's block is stored.
"""
from __future__ import annotations

from typing import Optional

from ..device import resolve
from ..libs.log import Logger, new_logger
from ..types.block import LightBlock
from ..types.evidence import LightClientAttackEvidence
from ..types.signature_cache import SignatureCache
from ..types.timestamp import Timestamp
from ..types.validation import Fraction
from .provider import Provider, ProviderError
from .store import TrustedStore
from .verifier import (
    DEFAULT_TRUST_LEVEL, LightClientError, NewValSetCantBeTrustedError,
    header_expired, validate_trust_level, verify, verify_backwards,
)

_S = 1_000_000_000
DEFAULT_MAX_CLOCK_DRIFT_NS = 10 * _S

SEQUENTIAL = "sequential"
SKIPPING = "skipping"


class DivergenceError(LightClientError):
    """A witness disagrees with the primary — a possible attack
    (reference: detector.go ErrConflictingHeaders)."""

    def __init__(self, witness: Provider, evidence=None):
        super().__init__(f"witness {witness.id()} diverges from primary")
        self.witness = witness
        self.evidence = evidence


class TrustOptions:
    """Reference: light.TrustOptions — a period and a (height, hash)
    root."""

    def __init__(self, period_ns: int, height: int, header_hash: bytes):
        self.period_ns = period_ns
        self.height = height
        self.hash = header_hash


class Client:
    def __init__(self, chain_id: str, trust_options: TrustOptions,
                 primary: Provider, witnesses: list[Provider],
                 trusted_store: TrustedStore,
                 verification_mode: str = SKIPPING,
                 trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                 max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
                 logger: Optional[Logger] = None, device=None):
        validate_trust_level(trust_level)
        self.device = resolve(device)
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = trusted_store
        self.mode = verification_mode
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.logger = logger if logger is not None else \
            new_logger("light")

    # ------------------------------------------------------------------
    async def initialize(self,
                         now: Optional[Timestamp] = None) -> LightBlock:
        """Fetch and pin the trust root (reference:
        initializeWithTrustOptions)."""
        now = now or Timestamp.now()
        existing = self.store.light_block(self.trust_options.height)
        if existing is not None:
            return existing
        lb = await self.primary.light_block(self.trust_options.height)
        if lb.signed_header.header.hash() != self.trust_options.hash:
            raise LightClientError(
                "trusted header hash does not match the trust options")
        lb.validate_basic(self.chain_id)
        if header_expired(lb.signed_header,
                          self.trust_options.period_ns, now):
            raise LightClientError("trusted header is expired")
        self.store.save_light_block(lb)
        return lb

    # ------------------------------------------------------------------
    async def verify_light_block_at_height(
            self, height: int,
            now: Optional[Timestamp] = None) -> LightBlock:
        """Reference: VerifyLightBlockAtHeight."""
        return await self._verify_at(height, now, cache=None)

    async def _verify_at(self, height: int, now: Optional[Timestamp],
                         cache: Optional[SignatureCache]
                         ) -> LightBlock:
        now = now or Timestamp.now()
        if height <= 0:
            raise LightClientError("height must be positive")
        existing = self.store.light_block(height)
        if existing is not None:
            return existing
        latest = self.store.latest()
        if latest is None:
            raise LightClientError("client not initialized")
        if height < latest.height:
            first = self.store.first()
            if first is not None and height < first.height:
                return await self._backwards(first, height)
            # between stored blocks: forward from the closest one below
            base = self._closest_below(height)
            return await self._verify_forward(base, height, now,
                                              cache=cache)
        return await self._verify_forward(latest, height, now,
                                          cache=cache)

    async def update(self, now: Optional[Timestamp] = None
                     ) -> Optional[LightBlock]:
        """Verify the primary's latest header (reference: Update)."""
        now = now or Timestamp.now()
        latest = self.store.latest()
        if latest is None:
            raise LightClientError("client not initialized")
        new = await self.primary.light_block(0)
        if new.height <= latest.height:
            return None
        return await self._verify_forward(latest, new.height, now,
                                          prefetched=new)

    async def verify_to_height(self, height: int,
                               now: Optional[Timestamp] = None
                               ) -> LightBlock:
        """Sync to ``height`` with ONE signature cache over every hop:
        each hop's trusting and 2/3 checks walk the same commit with
        overlapping sets, and a commit that bisection examines again
        skips the signatures already proved."""
        return await self._verify_at(height, now,
                                     cache=SignatureCache())

    # ------------------------------------------------------------------
    def _closest_below(self, height: int) -> LightBlock:
        best = None
        for h in self.store.heights():
            if h <= height:
                best = h
        if best is None:
            raise LightClientError("no trusted block below target")
        return self.store.light_block(best)

    def _verify(self, trusted: LightBlock, candidate: LightBlock,
                now: Timestamp, cache: Optional[SignatureCache]) -> None:
        verify(trusted.signed_header, trusted.validator_set,
               candidate.signed_header, candidate.validator_set,
               self.trust_options.period_ns, now, self.max_clock_drift_ns,
               self.trust_level, cache=cache, device=self.device)

    async def _verify_forward(self, trusted: LightBlock, height: int,
                              now: Timestamp,
                              prefetched: Optional[LightBlock] = None,
                              cache: Optional[SignatureCache] = None
                              ) -> LightBlock:
        trace: list[LightBlock] = [trusted]
        if self.mode == SEQUENTIAL:
            lb = await self._verify_sequential(trusted, height, now,
                                               trace, cache)
        else:
            lb = await self._verify_skipping(trusted, height, now,
                                             prefetched, trace, cache)
        await self._detect_divergence(lb, now, trace)
        return lb

    async def _verify_sequential(self, trusted: LightBlock,
                                 height: int, now: Timestamp,
                                 trace: Optional[list] = None,
                                 cache: Optional[SignatureCache] = None
                                 ) -> LightBlock:
        """Verify every header from trusted to height (reference:
        verifySequential)."""
        current = trusted
        for h in range(trusted.height + 1, height + 1):
            nxt = await self.primary.light_block(h)
            self._verify(current, nxt, now, cache)
            self.store.save_light_block(nxt)
            if trace is not None:
                trace.append(nxt)
            current = nxt
        return current

    async def _verify_skipping(self, trusted: LightBlock, height: int,
                               now: Timestamp,
                               prefetched: Optional[LightBlock] = None,
                               trace: Optional[list] = None,
                               cache: Optional[SignatureCache] = None
                               ) -> LightBlock:
        """Bisection (reference: verifySkipping): jump straight to the
        target; where the trusted set cannot vouch for it, bisect."""
        target = prefetched if prefetched is not None and \
            prefetched.height == height else \
            await self.primary.light_block(height)
        verified = trusted
        pivots = [target]
        while pivots:
            candidate = pivots[-1]
            try:
                self._verify(verified, candidate, now, cache)
            except NewValSetCantBeTrustedError as e:
                pivot_height = (verified.height + candidate.height) // 2
                if pivot_height in (verified.height, candidate.height):
                    raise LightClientError(
                        "bisection failed: no trust path to target"
                    ) from e
                pivots.append(
                    await self.primary.light_block(pivot_height))
                continue
            self.store.save_light_block(candidate)
            if trace is not None:
                trace.append(candidate)
            verified = candidate
            pivots.pop()
        return verified

    async def _backwards(self, first: LightBlock,
                         height: int) -> LightBlock:
        """Verify below the oldest trusted block by hash links
        (reference: backwards)."""
        current = first
        for h in range(first.height - 1, height - 1, -1):
            older = await self.primary.light_block(h)
            verify_backwards(older.signed_header.header,
                             current.signed_header.header)
            self.store.save_light_block(older)
            current = older
        return current

    # ------------------------------------------------------------------
    async def _detect_divergence(self, verified: LightBlock,
                                 now: Timestamp,
                                 trace: Optional[list] = None) -> None:
        """Cross-check the verified header against the witnesses; on a
        divergence, walk OUR trace against the witness to the common
        block, attribute the attack, report the evidence to both sides
        and drop the witness (reference: detector.go detectDivergence,
        examineConflictingHeaderAgainstTrace :236,
        newLightClientAttackEvidence :420)."""
        if not self.witnesses:
            return
        h = verified.height
        target_hash = verified.signed_header.header.hash()
        trace = trace or [verified]
        bad: list[Provider] = []
        for w in self.witnesses:
            try:
                wlb = await w.light_block(h)
            except ProviderError:
                continue
            if wlb.signed_header.header.hash() == target_hash:
                continue
            ev = await self._build_attack_evidence(w, wlb, trace)
            try:
                await self.primary.report_evidence(ev)
                await w.report_evidence(ev)
            except ProviderError:
                pass
            bad.append(w)
        if bad:
            for w in bad:
                self.witnesses.remove(w)
            raise DivergenceError(bad[0], evidence=None)

    async def _build_attack_evidence(self, witness: Provider,
                                     conflicting: LightBlock,
                                     trace: list
                                     ) -> LightClientAttackEvidence:
        """The common block is the LAST block of the trace the witness
        agrees with; the trusted block is the verified end of the trace
        (reference: examineConflictingHeaderAgainstTrace)."""
        common = trace[0]
        for tb in trace:
            try:
                wb = await witness.light_block(tb.height)
            except ProviderError:
                break
            if wb.signed_header.header.hash() != \
                    tb.signed_header.header.hash():
                break
            common = tb
        trusted = trace[-1]
        if conflicting.height != common.height:
            common_height = common.height
            timestamp = common.signed_header.header.time
            total_power = common.validator_set.total_voting_power()
        else:
            common_height = trusted.height
            timestamp = trusted.signed_header.header.time
            total_power = trusted.validator_set.total_voting_power()
        ev = LightClientAttackEvidence(
            conflicting_block=conflicting,
            common_height=common_height,
            byzantine_validators=[],
            total_voting_power=total_power,
            timestamp=timestamp)
        ev.byzantine_validators = ev.get_byzantine_validators(
            common.validator_set, trusted.signed_header)
        return ev
