"""The port's light/verifier against the JAX package's
(cometbft_tpu/light/verifier.py): one scenario table over
``verify_adjacent``, ``verify_non_adjacent``, ``verify``,
``verify_backwards``, ``validate_trust_level`` and ``header_expired``,
each case run through both packages on the same light blocks and held to
the same outcome: the exception's class name and text, or acceptance.

The chain comes from chip_smoke.py's ``_LightChain.rotating`` (with
its providers' fixed-base signer held to the golden model): 6
validators, a third of them replaced every 10 heights.  The port runs
``device="cpu"``: the accept-all stand-in kernel where verdicts do not
matter, B1's plain version in the cases of a wrong signature.  The JAX
side runs its CPU backend with its native module built.
"""
import sys
from pathlib import Path

import pytest
import torch

from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import pipeline as r_pipeline
from cometbft_tpu.light import verifier as r_verifier
from cometbft_tpu.types import block as r_block
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.validation import Fraction as RFraction
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.light import verifier as p_verifier
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types.block import LightBlock, SignedHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validation import Fraction
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

T0 = cs.LIGHT_T0
HOUR_NS = 3600 * 10**9
PERIOD_NS = 24 * HOUR_NS
DRIFT_NS = 10 * 10**9
NOW = Timestamp(T0 + 100, 0)


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
    return cs._LightChain.rotating("light-verify", 6, 40, 10, 2, 9,
                                   cs._Signer())


def _jax(x):
    """The JAX package's object of the port's x, through its proto."""
    name = type(x).__name__
    if name == "SignedHeader":
        return r_block.SignedHeader.from_proto(x.to_proto())
    if name == "Header":
        return r_block.Header.from_proto(x.to_proto())
    if name == "ValidatorSet":
        return RValidatorSet.from_proto(x.to_proto())
    if name == "Timestamp":
        return RTimestamp(*x)
    if name == "Fraction":
        return RFraction(*x)
    return x


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the text is what is compared
        return type(e).__name__, str(e)
    return "ok", out


def _copy(lb):
    return LightBlock.from_proto(lb.to_proto())


def _sh(chain, h):
    return _copy(chain.light_block(h)).signed_header


def _vals(chain, h):
    return _copy(chain.light_block(h)).validator_set


def _resigned(chain, h, **fields):
    """Height h of the chain with header fields replaced, signed anew by
    its set."""
    hdr = chain.headers[h]
    new = cs._light_header(chain.chain_id, h, chain.vals_of(h),
                           chain.vals_of(h + 1), hdr.last_block_id)
    for k, v in fields.items():
        setattr(new, k, v)
    return cs._signed_light_block(new, chain.vals_of(h), chain.seed_of,
                                  chain.signer)


def _corrupted(chain, h, idx):
    lb = _copy(chain.light_block(h))
    lb.signed_header.commit = cs._corrupted(lb.signed_header.commit, [idx])
    return lb


def _with(sh, **fields):
    sh = SignedHeader.from_proto(sh.to_proto())
    for k, v in fields.items():
        setattr(sh.header, k, v)
    return sh


def _hop(fn, a, b, now=NOW, level=None):
    """fn(trusted a, [its set], untrusted b, its set, ...) args."""
    def args(chain):
        ta = a(chain) if callable(a) else (_sh(chain, a), _vals(chain, a))
        ub = b(chain) if callable(b) else (_sh(chain, b), _vals(chain, b))
        if fn == "verify_adjacent":
            out = [ta[0], ub[0], ub[1], PERIOD_NS, now, DRIFT_NS]
        else:
            out = [ta[0], ta[1], ub[0], ub[1], PERIOD_NS, now, DRIFT_NS]
            if level is not None:
                out.append(level)
        return fn, out, True
    return args


def _lb(make):
    """(signed header, set) of a light block made from the chain."""
    def pair(chain):
        lb = make(chain)
        return lb.signed_header, lb.validator_set
    return pair


def _plain(fn, *make):
    def args(chain):
        return fn, [m(chain) if callable(m) else m for m in make], False
    return args


EXPIRED = Timestamp(T0 + 1, 0).add_ns(PERIOD_NS)
SCENARIOS = {
    # acceptance
    "adjacent_ok": _hop("verify_adjacent", 5, 6),
    "non_adjacent_ok": _hop("verify_non_adjacent", 1, 8),
    "verify_across_rotation": _hop("verify", 1, 15),
    "verify_adjacent_across_rotation": _hop("verify", 10, 11),
    # expired
    "expired_non_adjacent": _hop("verify_non_adjacent", 1, 8, now=EXPIRED),
    "expired_adjacent": _hop("verify_adjacent", 1, 2, now=EXPIRED),
    "expired_verify": _hop("verify", 1, 9, now=EXPIRED.add_ns(1)),
    # order
    "adjacent_not_adjacent": _hop("verify_adjacent", 5, 7),
    "non_adjacent_adjacent": _hop("verify_non_adjacent", 5, 6),
    "height_not_monotonic": _hop("verify_non_adjacent", 8, 3),
    "time_not_monotonic": _hop(
        "verify_non_adjacent", 3,
        _lb(lambda c: _resigned(c, 8, time=Timestamp(T0 + 3, 0)))),
    "time_equal": _hop(
        "verify_adjacent", 3,
        _lb(lambda c: _resigned(c, 4, time=Timestamp(T0 + 3, 0)))),
    # clock drift
    "clock_drift": _hop("verify_non_adjacent", 1, 30,
                        now=Timestamp(T0 + 20, 0)),
    "clock_drift_edge": _hop("verify_adjacent", 1, 2,
                             now=Timestamp(T0 + 2, 0).add_ns(-DRIFT_NS)),
    "clock_drift_inside": _hop("verify_adjacent", 1, 2,
                               now=Timestamp(T0 + 2, 1).add_ns(-DRIFT_NS)),
    # validator-set hashes
    "vals_hash_mismatch": _hop(
        "verify_non_adjacent", 1,
        lambda c: (_sh(c, 8), _vals(c, 25))),
    "next_vals_hash_mismatch": _hop(
        "verify_adjacent",
        lambda c: (_with(_sh(c, 5), next_validators_hash=b"\x01" * 32),
                   _vals(c, 5)), 6),
    "next_vals_at_rotation": _hop(
        "verify_adjacent",
        lambda c: (_with(_sh(c, 10),
                         next_validators_hash=c.vals_of(1).hash()),
                   _vals(c, 10)), 11),
    # trust
    "trust_below_one_third": _hop("verify_non_adjacent", 1, 25),
    "trust_below_one_third_verify": _hop("verify", 3, 30),
    "trust_two_thirds_refused": _hop("verify_non_adjacent", 1, 15,
                                     level=Fraction(2, 3)),
    "trust_one_half": _hop("verify_non_adjacent", 1, 15,
                           level=Fraction(1, 2)),
    "trust_level_ok": _plain("validate_trust_level", Fraction(1, 3)),
    "trust_level_low": _plain("validate_trust_level", Fraction(1, 4)),
    "trust_level_high": _plain("validate_trust_level", Fraction(4, 3)),
    "trust_level_zero": _plain("validate_trust_level", Fraction(0, 0)),
    "trust_level_one": _plain("validate_trust_level", Fraction(1, 1)),
    # chain id and structure
    "wrong_chain_id": _hop(
        "verify_non_adjacent", 1,
        _lb(lambda c: _resigned(c, 8, chain_id="other-chain"))),
    "header_differs_from_commit": _hop(
        "verify_non_adjacent", 1,
        lambda c: (_with(_sh(c, 8), app_hash=b"x"), _vals(c, 8))),
    # the trusted header is not validated again: height 0 passes
    "zero_height_trusted": _hop(
        "verify",
        lambda c: (_with(_sh(c, 1), height=0), _vals(c, 1)), 3),
    # backwards
    "backwards_ok": _plain("verify_backwards",
                           lambda c: c.headers[7], lambda c: c.headers[8]),
    "backwards_broken_link": _plain("verify_backwards",
                                    lambda c: c.headers[6],
                                    lambda c: c.headers[8]),
    "backwards_time": _plain(
        "verify_backwards",
        lambda c: _resigned(c, 7, time=Timestamp(T0 + 9, 0))
        .signed_header.header, lambda c: c.headers[8]),
    "backwards_chain_id": _plain(
        "verify_backwards",
        lambda c: _resigned(c, 7, chain_id="other").signed_header.header,
        lambda c: c.headers[8]),
    "backwards_invalid": _plain(
        "verify_backwards",
        lambda c: _with(_sh(c, 7), proposer_address=b"\x01").header,
        lambda c: c.headers[8]),
    # expiry by itself
    "header_expired_false": _plain("header_expired", lambda c: _sh(c, 1),
                                   PERIOD_NS, EXPIRED.add_ns(-1)),
    "header_expired_true": _plain("header_expired", lambda c: _sh(c, 1),
                                  PERIOD_NS, EXPIRED),
}

# cases whose verdict needs real signature checks: B1's plain version
REAL = {
    "wrong_signature_non_adjacent": _hop(
        "verify_non_adjacent", 1, _lb(lambda c: _corrupted(c, 8, 1))),
    "wrong_signature_adjacent": _hop(
        "verify", 7, _lb(lambda c: _corrupted(c, 8, 4))),
}


def _accept_all(monkeypatch):
    def verify_cols(a, r, s, k):
        return torch.ones(a.shape[1], dtype=torch.bool)

    monkeypatch.setattr(ek, "verify_cols", verify_cols)


def _run(chain, scenario):
    fn, pargs, on_device = scenario(chain)
    kw = {"device": "cpu"} if on_device else {}
    want = _outcome(getattr(r_verifier, fn), *[_jax(a) for a in pargs])
    got = _outcome(getattr(p_verifier, fn), *pargs, **kw)
    return got, want


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_scenario_matches_reference(case, chain, monkeypatch):
    _accept_all(monkeypatch)
    got, want = _run(chain, SCENARIOS[case])
    assert got == want
    accepted = case.endswith("_ok") or case in (
        "verify_across_rotation", "verify_adjacent_across_rotation",
        "clock_drift_inside", "trust_one_half", "trust_level_one",
        "header_expired_false", "header_expired_true",
        "zero_height_trusted")
    assert (got[0] == "ok") == accepted, got


@pytest.mark.parametrize("case", sorted(REAL))
def test_wrong_signature_matches_reference(case, chain):
    got, want = _run(chain, REAL[case])
    assert got == want
    assert got[0] == "InvalidHeaderError" and "wrong signature (#" in got[1]


def test_verifier_runs_on_the_card_by_default(chain):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_verifier.verify(_sh(chain, 1), _vals(chain, 1), _sh(chain, 8),
                          _vals(chain, 8), PERIOD_NS, NOW, DRIFT_NS)
