"""Measured adaptive consensus timeouts.

The static ``timeout_propose`` (3 s) / ``timeout_vote`` (1 s) defaults
are sized for a hostile WAN; on a healthy net they are pure padding —
QA_r05's 16-node rig spent most of its 7.2 s block interval waiting
out timeouts sized an order of magnitude above the measured quorum
delay.  This module derives the timeouts from the same signal the
``consensus_quorum_prevote_delay_seconds`` histogram records: the
interval between a proposal's timestamp and the earliest prevote that
achieved a quorum.

Formula (docs/pipeline.md):

    p95   = 95th percentile of the last ``window`` quorum delays
    ewma  = max(p95, alpha * p95 + (1 - alpha) * ewma)   (first: p95)
    base  = clamp(max(margin * ewma, p95), floor, ceiling)

The EWMA rises instantly and decays geometrically (the TCP-RTO
shape): delays are only measured on *successful* rounds, so an
estimator that lags upward keeps under-deadlining a net that just
got slower — every churned round it causes produces no sample to
correct it.  QA_r07's rig showed exactly that failure: a fast idle
boot locked the symmetric EWMA low, and the first loaded heights
paid a round-churn tax until enough slow successes dragged it up.

* the propose timeout uses ``margin = 2.0`` (the proposer must build
  AND gossip the block inside it), vote timeouts ``margin = 1.5``,
  the commit padding ``margin = 1.0``;
* ``base`` never shrinks below the current window's measured p95 (a
  timeout below the delay we are actually observing would churn
  rounds), and the per-round escalation deltas from the static config
  still apply so liveness under asynchrony is preserved;
* with no observations (fresh node, WAL replay, a net that has never
  reached quorum) every query returns ``None`` and callers fall back
  to the static config;
* the commit padding only ever *shrinks* the static padding — the
  app's ``next_block_delay`` contract is a minimum spacing decision
  that adaptivity must not inflate.

Off by default (``consensus.adaptive_timeouts``).  The port's copy of
cometbft_tpu/consensus/adaptive.py: the same arithmetic, so both
packages derive equal floats from equal samples.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

_PROPOSE_MARGIN = 2.0
_VOTE_MARGIN = 1.5
_COMMIT_MARGIN = 1.0


class AdaptiveTimeouts:
    def __init__(self, floor_ns: int, ceiling_ns: int,
                 window: int = 64, alpha: float = 0.25):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if floor_ns < 0 or ceiling_ns < floor_ns:
            raise ValueError(
                f"need 0 <= floor <= ceiling, got "
                f"{floor_ns}..{ceiling_ns}")
        self.floor_ns = floor_ns
        self.ceiling_ns = ceiling_ns
        self.alpha = alpha
        self._window: deque[float] = deque(maxlen=window)
        self._ewma_s: Optional[float] = None

    # ------------------------------------------------------------------
    def observe(self, delay_s: float) -> None:
        """Feed one measured quorum-prevote delay (seconds)."""
        self._window.append(max(0.0, float(delay_s)))
        p95 = self.p95_s()
        if self._ewma_s is None:
            self._ewma_s = p95
        else:
            # fast-rise / slow-decay: an estimator below the current
            # p95 snaps up immediately (under-deadlining churns
            # rounds, and churned rounds produce no correcting
            # sample); decay toward a faster net stays geometric
            self._ewma_s = max(p95, self.alpha * p95 +
                               (1.0 - self.alpha) * self._ewma_s)

    @property
    def samples(self) -> int:
        return len(self._window)

    def p95_s(self) -> float:
        """p95 of the current window (0.0 when empty)."""
        if not self._window:
            return 0.0
        xs = sorted(self._window)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def ewma_s(self) -> Optional[float]:
        return self._ewma_s

    # ------------------------------------------------------------------
    def _derive_ns(self, margin: float) -> Optional[int]:
        if self._ewma_s is None:
            return None
        base_s = max(margin * self._ewma_s, self.p95_s())
        ns = int(base_s * 1e9)
        return max(self.floor_ns, min(self.ceiling_ns, ns))

    def propose_timeout_ns(self) -> Optional[int]:
        """Round-0 propose timeout; None = use static config."""
        return self._derive_ns(_PROPOSE_MARGIN)

    def vote_timeout_ns(self) -> Optional[int]:
        """Round-0 prevote/precommit wait timeout; None = static."""
        return self._derive_ns(_VOTE_MARGIN)

    def commit_padding_ns(self, static_ns: int) -> int:
        """Post-commit padding before the next height's round 0.

        Adaptivity only ever shrinks the static padding (the app /
        operator set it as a minimum-spacing decision); with no
        measurements the static value passes through unchanged."""
        derived = self._derive_ns(_COMMIT_MARGIN)
        if derived is None:
            return static_ns
        return min(static_ns, derived)
