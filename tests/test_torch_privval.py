"""The port's privval (cometbft_tpu_torch/privval/) against the JAX
package's: FilePV's key and state files byte for byte over a seeded sign
history, every LastSignState outcome with the JAX text, the remote
signer's frames byte for byte, the JAX TestSignerProtocol cases on the
port, and each package's SignerServer serving the other's SignerClient
over a local socket.  Signing runs on the host (no kernel is involved).
"""
import asyncio
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cometbft_tpu.crypto import encoding as r_encoding
from cometbft_tpu.privval import file as r_file
from cometbft_tpu.privval import signer as r_signer
from cometbft_tpu.types import block_id as r_block_id
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types import part_set as r_part_set
from cometbft_tpu.types import proposal as r_proposal
from cometbft_tpu.types import timestamp as r_timestamp
from cometbft_tpu.types import vote as r_vote
from cometbft_tpu_torch.crypto import encoding as p_encoding
from cometbft_tpu_torch.privval import file as p_file
from cometbft_tpu_torch.privval import signer as p_signer
from cometbft_tpu_torch.types import block_id as p_block_id
from cometbft_tpu_torch.types import canonical as p_canonical
from cometbft_tpu_torch.types import part_set as p_part_set
from cometbft_tpu_torch.types import proposal as p_proposal
from cometbft_tpu_torch.types import timestamp as p_timestamp
from cometbft_tpu_torch.types import vote as p_vote

from torch_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


class Pkg:
    """One package's privval surface and the types it signs."""

    def __init__(self, name, enc, file, signer, bid, canonical, ps, prop, ts,
                 vote):
        self.name, self.enc, self.file, self.signer = name, enc, file, signer
        self.bid, self.canonical, self.ps, self.prop = bid, canonical, ps, prop
        self.ts, self.vote_mod = ts, vote

    def vote(self, height, round_=0, hash_=b"\x11" * 32, type_=None,
             ts=(1700000000, 0)):
        return self.vote_mod.Vote(
            type=type_ or self.canonical.PRECOMMIT_TYPE, height=height,
            round=round_,
            block_id=self.bid.BlockID(
                hash=hash_,
                part_set_header=self.ps.PartSetHeader(1, b"\x22" * 32)),
            timestamp=self.ts.Timestamp(*ts),
            validator_address=b"\x01" * 20, validator_index=0)

    def proposal(self, height, round_=0, hash_=b"\x11" * 32,
                 ts=(1700000000, 0)):
        return self.prop.Proposal(
            height=height, round=round_, pol_round=-1,
            block_id=self.bid.BlockID(
                hash=hash_,
                part_set_header=self.ps.PartSetHeader(1, b"\x22" * 32)),
            timestamp=self.ts.Timestamp(*ts))


PORT = Pkg("port", p_encoding, p_file, p_signer, p_block_id, p_canonical,
           p_part_set, p_proposal, p_timestamp, p_vote)
JAX = Pkg("jax", r_encoding, r_file, r_signer, r_block_id, r_canonical,
          r_part_set, r_proposal, r_timestamp, r_vote)


def _pv(pkg, d, raw, key_type="ed25519"):
    priv = pkg.enc.priv_key_from_type_and_bytes(key_type, raw)
    pv = pkg.file.FilePV(priv, os.path.join(d, f"{pkg.name}_key.json"),
                         os.path.join(d, f"{pkg.name}_state.json"))
    pv.save()
    return pv


def _files(pv):
    with open(pv.key_file_path, "rb") as f, \
            open(pv.state_file_path, "rb") as g:
        return f.read(), g.read()


def _history(rng, n):
    """A seeded sign history: steps forward in height, round and step,
    proposals among the votes, and repeats of the last request (same
    bytes, or the same vote with another timestamp)."""
    steps, h, r = [], 1, 0
    for _ in range(n):
        kind = rng.integers(0, 5)
        if kind == 0:
            steps.append(("proposal", h, r, bytes([rng.integers(1, 255)]) * 32,
                          int(rng.integers(1, 1 << 30))))
        elif kind in (1, 2):
            type_ = "prevote" if kind == 1 else "precommit"
            steps.append((type_, h, r, bytes([rng.integers(1, 255)]) * 32,
                          int(rng.integers(1, 1 << 30))))
        elif kind == 3 and steps:
            steps.append(steps[-1][:4] + (steps[-1][4] + 7,))
        else:
            if rng.integers(0, 2):
                h += 1
                r = 0
            else:
                r += 1
    return steps


def _sign(pkg, pv, chain_id, step):
    kind, h, r, hash_, secs = step
    if kind == "proposal":
        p = pkg.proposal(h, r, hash_, ts=(1700000000 + secs, 0))
        pv.sign_proposal(chain_id, p)
        return p.signature, (p.timestamp.seconds, p.timestamp.nanos)
    type_ = pkg.canonical.PREVOTE_TYPE if kind == "prevote" else \
        pkg.canonical.PRECOMMIT_TYPE
    v = pkg.vote(h, r, hash_, type_=type_, ts=(1700000000 + secs, 0))
    pv.sign_vote(chain_id, v, False)
    return v.signature, (v.timestamp.seconds, v.timestamp.nanos)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filepv_files_equal_the_jax_ones_over_a_seeded_history(tmp_path,
                                                               seed):
    rng = np.random.default_rng(seed)
    raw = rng.bytes(32)
    ppv, rpv = _pv(PORT, tmp_path, raw), _pv(JAX, tmp_path, raw)
    assert _files(ppv) == _files(rpv)
    for step in _history(rng, 40):
        outs = []
        for pkg, pv in ((PORT, ppv), (JAX, rpv)):
            try:
                outs.append(("ok",) + _sign(pkg, pv, "pv-chain", step))
            except pkg.file.PrivValidatorError as e:
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1], step
        assert _files(ppv) == _files(rpv), step
    # the files load back into the same signer in each package
    for pkg, pv in ((PORT, ppv), (JAX, rpv)):
        back = pkg.file.FilePV.load(pv.key_file_path, pv.state_file_path)
        assert back.last_sign_state == pv.last_sign_state
        assert back.get_pub_key().bytes() == pv.get_pub_key().bytes()


@pytest.mark.parametrize("key_type", ["ed25519", "secp256k1", "secp256k1eth"])
def test_key_files_of_each_type_equal_the_jax_ones(tmp_path, key_type):
    rng = np.random.default_rng(7)
    raw = rng.bytes(32)
    assert _files(_pv(PORT, tmp_path, raw, key_type)) == \
        _files(_pv(JAX, tmp_path, raw, key_type))
    assert p_encoding.supported_key_types() == \
        r_encoding.supported_key_types()
    for pkg in (PORT, JAX):
        with pytest.raises(pkg.enc.EncodingError) as e:
            pkg.enc.gen_priv_key_by_type("rsa")
        assert str(e.value) == (
            "unsupported key type rsa; supported: "
            "['bls12_381', 'ed25519', 'secp256k1', 'secp256k1eth']")
    gen = p_file.FilePV.generate(str(tmp_path / "g" / "k.json"),
                                 str(tmp_path / "g" / "s.json"), key_type)
    assert gen.get_pub_key().type() == key_type
    assert r_file.FilePV.load(gen.key_file_path, gen.state_file_path) \
        .get_pub_key().bytes() == gen.get_pub_key().bytes()


# (what was signed last, what is asked now): the HRS rules' outcomes
SIGN_CASES = {
    "height regression": (("vote", 5, 1), ("vote", 4, 1)),
    "round regression": (("vote", 5, 2), ("vote", 5, 1)),
    "step regression": (("precommit", 5, 0), ("prevote", 5, 0)),
    "same HRS, another block": (("vote", 5, 0), ("vote", 5, 0, b"\x99" * 32)),
    "same HRS, only the timestamp": (("vote", 5, 0),
                                     ("vote", 5, 0, None, 1700000500)),
    "same HRS, the same bytes": (("vote", 5, 0), ("vote", 5, 0)),
    "proposal, another block": (("proposal", 6, 0),
                                ("proposal", 6, 0, b"\x55" * 32)),
    "proposal, only the timestamp": (("proposal", 6, 0),
                                     ("proposal", 6, 0, None, 1700000900)),
    "proposal after its prevote": (("prevote", 6, 0), ("proposal", 6, 0)),
}


def _request(pkg, spec):
    kind, h, r = spec[:3]
    hash_ = spec[3] if len(spec) > 3 and spec[3] else b"\x11" * 32
    ts = (spec[4], 0) if len(spec) > 4 else (1700000000, 0)
    if kind == "proposal":
        return pkg.proposal(h, r, hash_, ts=ts)
    type_ = pkg.canonical.PREVOTE_TYPE if kind == "prevote" else \
        pkg.canonical.PRECOMMIT_TYPE
    return pkg.vote(h, r, hash_, type_=type_, ts=ts)


def _outcome(pkg, pv, req):
    try:
        if isinstance(req, pkg.prop.Proposal):
            pv.sign_proposal("c", req)
        else:
            pv.sign_vote("c", req, False)
    except pkg.file.PrivValidatorError as e:
        return type(e).__name__, str(e)
    return "signed", req.signature, req.timestamp.seconds


@pytest.mark.parametrize("case", list(SIGN_CASES))
def test_last_sign_state_outcomes_equal_the_jax_ones(tmp_path, case):
    first, second = SIGN_CASES[case]
    raw = np.random.default_rng(3).bytes(32)
    outs = []
    for pkg in (PORT, JAX):
        pv = _pv(pkg, tmp_path, raw)
        assert _outcome(pkg, pv, _request(pkg, first))[0] == "signed"
        sig0 = pv.last_sign_state.signature
        outs.append(_outcome(pkg, pv, _request(pkg, second)) + (sig0,))
    assert outs[0] == outs[1]
    if "regression" in case or "another block" in case or "after" in case:
        assert outs[0][0] == "DoubleSignError"
    if "only the timestamp" in case or "same bytes" in case:
        # the stored signature and the first request's timestamp come back
        assert outs[0][0] == "signed" and outs[0][1] == outs[0][3]
        assert outs[0][2] == 1700000000


def test_check_hrs_without_sign_bytes_raises_the_jax_texts():
    for pkg in (PORT, JAX):
        lss = pkg.file.LastSignState(height=3, round=0, step=2)
        with pytest.raises(pkg.file.PrivValidatorError,
                           match="^no SignBytes found$"):
            lss.check_hrs(3, 0, 2)
        lss.sign_bytes = b"x"
        with pytest.raises(pkg.file.PrivValidatorError,
                           match="^signature is empty but sign bytes are "
                                 "not$"):
            lss.check_hrs(3, 0, 2)
        assert lss.check_hrs(4, 0, 1) is False


def _messages(pkg):
    v = pkg.vote(9, 1)
    v.signature = b"\x05" * 64
    p = pkg.proposal(9, 1)
    return [
        {"ping_request": {}}, {"ping_response": {}},
        {"pub_key_request": {"chain_id": "frame-chain"}},
        {"pub_key_response": {"pub_key_bytes": b"\x07" * 32,
                              "pub_key_type": "ed25519"}},
        {"sign_vote_request": {"vote": v.to_proto(), "chain_id": "c",
                               "skip_extension_signing": True}},
        {"signed_vote_response": {"vote": v.to_proto()}},
        {"signed_vote_response": {"vote": {}, "error": {
            "code": 3, "description": "conflicting vote data at 9/1/3"}}},
        {"sign_proposal_request": {"proposal": p.to_proto(),
                                   "chain_id": "c"}},
        {"signed_proposal_response": {"proposal": p.to_proto()}},
        {"sign_bytes_request": {"value": b"abc" * 100}},
        {"sign_bytes_response": {"signature": b"\x09" * 64}},
    ]


def test_privval_frames_equal_the_jax_ones():
    for mine, theirs in zip(_messages(PORT), _messages(JAX)):
        raw = p_signer._frame(mine)
        assert raw == r_signer._frame(theirs)

        async def read(mod, data=raw):
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            return await mod._read_frame(reader), await mod._read_frame(
                reader)
        (p_msg, p_eof), (r_msg, r_eof) = asyncio.run(read(p_signer)), \
            asyncio.run(read(r_signer))
        assert p_msg == r_msg and p_eof is None and r_eof is None


@pytest.mark.parametrize("data, text", [
    (b"\x80", "EOF inside length prefix"),
    (b"\xff" * 11, "length prefix too long"),
    (b"\x80\x80\x80\x01", "message too large: 2097152"),
])
def test_torn_frames_raise_the_jax_texts(data, text):
    for mod in (p_signer, r_signer):
        async def read():
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            return await mod._read_frame(reader)
        with pytest.raises(mod.RemoteSignerError, match=f"^{text}$"):
            asyncio.run(read())


# (node side, signer side): the port alone, and each package serving the
# other's client
PAIRS = [(PORT, PORT), (JAX, PORT), (PORT, JAX)]
PAIR_IDS = ["port-port", "jax_client-port_signer", "port_client-jax_signer"]


async def _signer(node, sig, d, chain_id, pv=None):
    pv = pv or sig.file.FilePV.generate(os.path.join(d, "k.json"),
                                        os.path.join(d, "s.json"))
    ep = node.signer.SignerListenerEndpoint("tcp://127.0.0.1:0")
    await ep.start()
    srv = sig.signer.SignerServer(ep.listen_addr, chain_id, pv)
    await srv.start()
    await ep.wait_for_signer(10)
    return pv, ep, srv


@pytest.mark.parametrize("node, sig", PAIRS, ids=PAIR_IDS)
def test_ping_pubkey_sign_and_double_sign_refusal(tmp_path, node, sig):
    async def run():
        pv, ep, srv = await _signer(node, sig, tmp_path, "sig-chain")
        cli = node.signer.SignerClient(ep, "sig-chain")
        await cli.ping()
        pub = await cli.fetch_pub_key()
        assert pub.bytes() == pv.get_pub_key().bytes()
        v = node.vote(5)
        await cli.sign_vote_async("sig-chain", v, False)
        assert pub.verify_signature(v.sign_bytes("sig-chain"), v.signature)
        with pytest.raises(node.file.DoubleSignError,
                           match="^conflicting vote data at 5/0/3$"):
            await cli.sign_vote_async("sig-chain", node.vote(
                5, hash_=b"\x99" * 32), False)
        with pytest.raises(node.file.DoubleSignError,
                           match="^height regression: got 4, last 5$"):
            await cli.sign_vote_async("sig-chain", node.vote(4), False)
        p = node.proposal(6)
        await cli.sign_proposal_async("sig-chain", p)
        assert pub.verify_signature(p.sign_bytes("sig-chain"), p.signature)
        await srv.stop()
        await ep.stop()
    asyncio.run(run())


@pytest.mark.parametrize("node, sig", PAIRS, ids=PAIR_IDS)
def test_retry_wrapper_never_retries_double_sign(tmp_path, node, sig):
    async def run():
        pv, ep, srv = await _signer(node, sig, tmp_path, "c")
        calls = []
        inner = node.signer.SignerClient(ep, "c")
        real = inner.sign_vote_async

        async def counted(*a):
            calls.append(1)
            return await real(*a)
        inner.sign_vote_async = counted
        cli = node.signer.RetrySignerClient(inner)
        await cli.fetch_pub_key()
        await cli.sign_vote_async("c", node.vote(7), False)
        before = pv.last_sign_state.height
        with pytest.raises(node.file.DoubleSignError):
            await cli.sign_vote_async("c", node.vote(7, hash_=b"\x77" * 32),
                                      False)
        assert pv.last_sign_state.height == before and len(calls) == 2
        await srv.stop()
        await ep.stop()
    asyncio.run(run())


@pytest.mark.parametrize("node, sig", PAIRS, ids=PAIR_IDS)
def test_hrs_protection_survives_signer_restart(tmp_path, node, sig):
    async def run():
        pv, ep, srv = await _signer(node, sig, tmp_path, "c")
        cli = node.signer.SignerClient(ep, "c")
        await cli.fetch_pub_key()
        await cli.sign_vote_async("c", node.vote(9), False)
        await srv.stop()
        ep._drop_conn()
        pv2 = sig.file.FilePV.load(pv.key_file_path, pv.state_file_path)
        srv2 = sig.signer.SignerServer(ep.listen_addr, "c", pv2)
        await srv2.start()
        await ep.wait_for_signer(10)
        with pytest.raises(node.file.DoubleSignError):
            await cli.sign_vote_async("c", node.vote(8), False)
        v = node.vote(9)
        await cli.sign_vote_async("c", v, False)
        assert v.signature == pv.last_sign_state.signature
        await srv2.stop()
        await ep.stop()
    asyncio.run(run())


def test_retry_client_gives_up_with_the_jax_text_when_the_signer_is_gone():
    async def run(mod):
        ep = mod.SignerListenerEndpoint("tcp://127.0.0.1:0")
        await ep.start()
        cli = mod.RetrySignerClient(mod.SignerClient(ep, "c"), retries=3,
                                    delay_s=0.0)
        try:
            await cli.fetch_pub_key()
        except mod.RemoteSignerError as e:
            return str(e)
        finally:
            await ep.stop()
    assert asyncio.run(run(p_signer)) == asyncio.run(run(r_signer)) == \
        "no signer connected"


def test_signer_process_serves_a_port_client(tmp_path):
    """``python -m cometbft_tpu_torch.privval.signer`` dials the node's
    listener and signs from its files."""
    pv = p_file.FilePV.generate(str(tmp_path / "k.json"),
                                str(tmp_path / "s.json"))

    async def run():
        ep = p_signer.SignerListenerEndpoint("tcp://127.0.0.1:0")
        await ep.start()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cometbft_tpu_torch.privval.signer",
             "--address", ep.listen_addr, "--chain-id", "proc-chain",
             "--key-file", pv.key_file_path,
             "--state-file", pv.state_file_path],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            await ep.wait_for_signer(60)
            cli = p_signer.RetrySignerClient(
                p_signer.SignerClient(ep, "proc-chain"))
            pub = await cli.fetch_pub_key()
            v = PORT.vote(3)
            await cli.sign_vote_async("proc-chain", v, False)
            assert pub.verify_signature(v.sign_bytes("proc-chain"),
                                        v.signature)
        finally:
            proc.terminate()
            proc.wait(10)
            await ep.stop()
    asyncio.run(run())
    state = p_file.FilePV.load(pv.key_file_path, pv.state_file_path)
    assert (state.last_sign_state.height, state.last_sign_state.step) == \
        (3, p_file.STEP_PRECOMMIT)
