"""The port's p2p stack (p2p/, libs/flowrate.py, the host AEAD
ops/aead_host.py and its plain version crypto/_aead_ref.py) against the
JAX package's.

  * tests/test_p2p.py's seven cases, run against the port;
  * the AEAD library equal to its plain version and to the
    ``cryptography`` package on the RFC 8439 vector and on seeded
    inputs, a flipped tag bit refused by all three;
  * a port SecretConnection completing the handshake with a JAX one over
    a localhost socket in both directions, the JAX side once on OpenSSL
    and once on its own X25519 / HKDF / AEAD (``_HAVE_OPENSSL`` off in
    the test), the messages crossing unchanged; the low-order key refused
    with the JAX text;
  * MConnection packets (the scheduler's order included) and
    ``NodeInfo.to_json()`` byte-equal to the JAX ones;
  * a port Switch and a JAX Switch exchanging messages on an echo
    reactor, each dialing the other;
  * RateLimiter against the JAX one on a fake clock;
  * AddrBook bucket indices, ``pick_addresses`` under one seed and the
    JSON file's round trips.

Every socket binds ``127.0.0.1:0``; every wait has a bound.
"""
import asyncio
import dataclasses
import json
import os
import random

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers.aead import (
    ChaCha20Poly1305 as OsslAEAD)

from cometbft_tpu.config import P2PConfig as RP2PConfig
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.libs import flowrate as r_flowrate
from cometbft_tpu.p2p import conn as r_conn
from cometbft_tpu.p2p import pex as r_pex
from cometbft_tpu.p2p import secret_connection as r_sc
from cometbft_tpu.p2p import switch as r_switch
from cometbft_tpu.p2p.key import NodeKey as RNodeKey
from cometbft_tpu_torch.config import Config, P2PConfig
from cometbft_tpu_torch.crypto import _aead_ref
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.libs import flowrate as p_flowrate
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import aead_host
from cometbft_tpu_torch.p2p import conn as p_conn
from cometbft_tpu_torch.p2p import pex as p_pex
from cometbft_tpu_torch.p2p import secret_connection as p_sc
from cometbft_tpu_torch.p2p import switch as p_switch
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor, MConnection
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.secret_connection import (
    SecretConnection, SecretConnectionError)
from cometbft_tpu_torch.p2p.switch import NodeInfo, Reactor, Switch
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

RFC_KEY = bytes(range(0x80, 0xa0))
RFC_NONCE = bytes([7, 0, 0, 0]) + bytes(range(0x40, 0x48))
RFC_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
RFC_CT = bytes.fromhex(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116"
    "1ae10b594f09e26a7e902ecbd0600691")
# the secret connection's own edges: empty, a packet header, one byte
# short of a frame, a frame, a frame and a packet header
EDGE_LENS = (0, 1, 3, 15, 16, 17, 63, 64, 65, 1023, 1024, 1027, 1028, 1044,
             4100)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _pipe_pair():
    """Two connected (reader, writer) pairs over a localhost socket."""
    server_side = asyncio.Queue()

    async def on_conn(r, w):
        await server_side.put((r, w))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    cr, cw = await asyncio.open_connection("127.0.0.1", port)
    sr, sw = await asyncio.wait_for(server_side.get(), 10)
    return (cr, cw), (sr, sw), server


# -- tests/test_p2p.py against the port ---------------------------------------

class TestSecretConnection:
    def test_handshake_and_roundtrip(self):
        async def go():
            (cr, cw), (sr, sw), server = await _pipe_pair()
            k1, k2 = p_ed.gen_priv_key(), p_ed.gen_priv_key()
            sc1, sc2 = await asyncio.wait_for(asyncio.gather(
                SecretConnection.make(cr, cw, k1),
                SecretConnection.make(sr, sw, k2)), 10)
            # mutual authentication
            assert sc1.remote_pub_key == k2.pub_key()
            assert sc2.remote_pub_key == k1.pub_key()
            await sc1.write_msg(b"hello")
            assert await asyncio.wait_for(sc2.read_msg(), 5) == b"hello"
            big = b"\xab" * 2048
            await sc2.write_msg(big)
            assert await asyncio.wait_for(sc1.read_msg(), 5) == big
            big2 = bytes(range(256)) * 40
            await sc1.write_msg(big2)
            assert await asyncio.wait_for(sc2.read_msg(), 5) == big2
            sc1.close()
            sc2.close()
            server.close()
        run(go())

    def test_tampered_ciphertext_rejected(self):
        async def go():
            (cr, cw), (sr, sw), server = await _pipe_pair()
            k1, k2 = p_ed.gen_priv_key(), p_ed.gen_priv_key()
            sc1, sc2 = await asyncio.wait_for(asyncio.gather(
                SecretConnection.make(cr, cw, k1),
                SecretConnection.make(sr, sw, k2)), 10)
            sw.write(b"\x00" * 1044)
            await sw.drain()
            with pytest.raises(aead_host.AEADInvalidTag):
                await asyncio.wait_for(sc1.read_msg(), 5)
            sc1.close()
            sc2.close()
            server.close()
        run(go())


class TestMConnection:
    def test_multiplexed_channels(self):
        async def go():
            (cr, cw), (sr, sw), server = await _pipe_pair()
            k1, k2 = p_ed.gen_priv_key(), p_ed.gen_priv_key()
            sc1, sc2 = await asyncio.wait_for(asyncio.gather(
                SecretConnection.make(cr, cw, k1),
                SecretConnection.make(sr, sw, k2)), 10)
            chans = [ChannelDescriptor(id=0x20, priority=5),
                     ChannelDescriptor(id=0x21, priority=1)]
            got = asyncio.Queue()

            async def recv2(cid, msg):
                await got.put((cid, msg))

            async def recv1(cid, msg):
                pass

            m1 = MConnection(sc1, chans, recv1, lambda e: None)
            m2 = MConnection(sc2, chans, recv2, lambda e: None)
            m1.start()
            m2.start()
            try:
                assert m1.send(0x20, b"on-chan-20")
                assert m1.send(0x21, b"x" * 5000)   # multi-packet
                out = {}
                for _ in range(2):
                    cid, msg = await asyncio.wait_for(got.get(), 5)
                    out[cid] = msg
                assert out[0x20] == b"on-chan-20"
                assert out[0x21] == b"x" * 5000
            finally:
                m1.close()
                m2.close()
                server.close()
        run(go())


class EchoReactor(Reactor):
    CHAN = 0x77

    def __init__(self, name="echo", channel_descriptor=ChannelDescriptor):
        super().__init__(name)
        self.received = asyncio.Queue()
        self.peers = []
        self._desc = channel_descriptor

    def get_channels(self):
        return [self._desc(id=self.CHAN, priority=1)]

    async def add_peer(self, peer):
        self.peers.append(peer)

    async def receive(self, chan_id, peer, msg_bytes):
        await self.received.put((peer.id, msg_bytes))


class REchoReactor(r_switch.Reactor):
    """The same echo reactor on the JAX package's Reactor."""
    CHAN = EchoReactor.CHAN
    get_channels = EchoReactor.get_channels
    add_peer = EchoReactor.add_peer
    receive = EchoReactor.receive

    def __init__(self, name="echo"):
        r_switch.Reactor.__init__(self, name)
        self.received = asyncio.Queue()
        self.peers = []
        self._desc = r_conn.ChannelDescriptor


class TestSwitch:
    def test_two_switches_exchange(self):
        async def go():
            nk1, nk2 = NodeKey.generate(), NodeKey.generate()
            s1 = Switch(nk1, "testnet", listen_addr="127.0.0.1:0")
            s2 = Switch(nk2, "testnet", listen_addr="127.0.0.1:0")
            r1, r2 = EchoReactor("echo"), EchoReactor("echo")
            s1.add_reactor(r1)
            s2.add_reactor(r2)
            try:
                await s1.start()
                await s2.start()
                await asyncio.wait_for(s2.dial_peer(s1.listen_addr), 10)
                await asyncio.sleep(0.05)
                assert s1.num_peers() == 1
                assert s2.num_peers() == 1
                assert list(s1.peers)[0] == nk2.id
                assert list(s2.peers)[0] == nk1.id
                s2.broadcast(EchoReactor.CHAN, b"hello-from-2")
                pid, msg = await asyncio.wait_for(r1.received.get(), 5)
                assert pid == nk2.id
                assert msg == b"hello-from-2"
            finally:
                await s1.stop()
                await s2.stop()
        run(go())

    def test_network_mismatch_rejected(self):
        async def go():
            nk1, nk2 = NodeKey.generate(), NodeKey.generate()
            s1 = Switch(nk1, "chain-A", listen_addr="127.0.0.1:0")
            s2 = Switch(nk2, "chain-B", listen_addr="127.0.0.1:0")
            s1.add_reactor(EchoReactor())
            s2.add_reactor(EchoReactor())
            try:
                await s1.start()
                await s2.start()
                with pytest.raises(p_switch.SwitchError) as err:
                    await asyncio.wait_for(s2.dial_peer(s1.listen_addr), 10)
                assert str(err.value) == ("incompatible peer: peer network "
                                          "'chain-A' != 'chain-B'")
                await asyncio.sleep(0.05)
                assert s1.num_peers() == 0
            finally:
                await s1.stop()
                await s2.stop()
        run(go())

    def test_self_dial_rejected(self):
        async def go():
            nk = NodeKey.generate()
            s = Switch(nk, "net", listen_addr="127.0.0.1:0")
            s.add_reactor(EchoReactor())
            try:
                await s.start()
                with pytest.raises(p_switch.SwitchError,
                                   match="^connected to self$"):
                    await asyncio.wait_for(s.dial_peer(s.listen_addr), 10)
            finally:
                await s.stop()
        run(go())


class TestNodeKey:
    def test_save_load(self, tmp_path):
        p = str(tmp_path / "node_key.json")
        nk = NodeKey.load_or_gen(p)
        nk2 = NodeKey.load_or_gen(p)
        assert nk.id == nk2.id
        assert len(nk.id) == 40

    def test_file_shared_with_the_jax_package(self, tmp_path):
        seed = np.random.default_rng(5).bytes(32)
        mine, theirs = str(tmp_path / "p.json"), str(tmp_path / "r.json")
        NodeKey(p_ed.Ed25519PrivKey(seed)).save_as(mine)
        RNodeKey(r_ed.Ed25519PrivKey(seed)).save_as(theirs)
        assert open(mine).read() == open(theirs).read()
        assert oct(os.stat(mine).st_mode & 0o777) == "0o600"
        assert NodeKey.load(theirs).id == RNodeKey.load(mine).id == \
            RNodeKey(r_ed.Ed25519PrivKey(seed)).id


# -- the AEAD library, its plain version and OpenSSL -------------------------

def _seeded_inputs(seed, n):
    rng = np.random.default_rng(seed)
    lens = list(EDGE_LENS) + [int(x) for x in rng.integers(0, 3000, n)]
    for i, length in enumerate(lens):
        yield (rng.bytes(32), rng.bytes(12), rng.bytes(int(i % 5) * 7),
               rng.bytes(length))


def test_aead_library_selftest_and_rfc8439_vector():
    _build.load_aead()
    assert _build.aead_build_info["path"].endswith(".so")
    assert _build.load_aead().aead_selftest() == 1
    for aead in (aead_host.ChaCha20Poly1305(RFC_KEY),
                 _aead_ref.ChaCha20Poly1305(RFC_KEY), OsslAEAD(RFC_KEY)):
        assert aead.encrypt(RFC_NONCE, RFC_PT, RFC_AAD) == RFC_CT
        assert aead.decrypt(RFC_NONCE, RFC_CT, RFC_AAD) == RFC_PT


@pytest.mark.parametrize("seed", [0, 1])
def test_aead_library_equals_plain_and_openssl(seed):
    for key, nonce, aad, msg in _seeded_inputs(seed, 40):
        lib, plain = (aead_host.ChaCha20Poly1305(key),
                      _aead_ref.ChaCha20Poly1305(key))
        sealed = lib.encrypt(nonce, msg, aad)
        assert sealed == plain.encrypt(nonce, msg, aad) == \
            OsslAEAD(key).encrypt(nonce, msg, aad or None)
        assert len(sealed) == len(msg) + 16
        assert lib.decrypt(nonce, sealed, aad) == msg
        bit = len(msg) * 8 + (len(msg) % 128)   # a bit of the tag
        flipped = bytearray(sealed)
        flipped[bit // 8] ^= 1 << (bit % 8)
        for aead, exc in ((lib, aead_host.AEADInvalidTag),
                          (plain, _aead_ref.AEADInvalidTag)):
            with pytest.raises(exc, match="authentication failed"):
                aead.decrypt(nonce, bytes(flipped), aad)
        if msg:
            flipped = bytearray(sealed)
            flipped[0] ^= 0x80                  # a ciphertext bit
            with pytest.raises(aead_host.AEADInvalidTag):
                lib.decrypt(nonce, bytes(flipped), aad)


def test_aead_library_rejects_bad_sizes():
    lib = aead_host.ChaCha20Poly1305(bytes(32))
    with pytest.raises(aead_host.AEADInvalidTag, match="shorter"):
        lib.decrypt(bytes(12), b"x" * 15, None)
    with pytest.raises(ValueError, match="32 bytes"):
        aead_host.ChaCha20Poly1305(bytes(31))
    with pytest.raises(ValueError, match="12 bytes"):
        lib.encrypt(bytes(8), b"m", None)


def test_x25519_and_hkdf_equal_openssl():
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PrivateFormat, PublicFormat, NoEncryption)
    rng = np.random.default_rng(3)
    for _ in range(4):
        a = X25519PrivateKey.from_private_bytes(rng.bytes(32))
        b = X25519PrivateKey.generate()
        a_raw = a.private_bytes(Encoding.Raw, PrivateFormat.Raw,
                                NoEncryption())
        b_pub = b.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        assert _aead_ref.x25519(a_raw, b_pub) == a.exchange(
            X25519PublicKey.from_public_bytes(b_pub))
        ikm, salt = rng.bytes(32), rng.bytes(64)
        assert _aead_ref.hkdf_sha256(ikm, salt, p_sc._HKDF_INFO, 96) == \
            HKDF(algorithm=hashes.SHA256(), length=96, salt=salt,
                 info=p_sc._HKDF_INFO).derive(ikm)


# -- the secret connection against the JAX package's -------------------------

@pytest.mark.parametrize("openssl", [True, False], ids=["openssl", "native"])
@pytest.mark.parametrize("port_dials", [True, False],
                         ids=["port-dials", "jax-dials"])
def test_secret_connection_with_jax_peer(monkeypatch, openssl, port_dials):
    if not openssl:
        monkeypatch.setattr(r_sc, "_HAVE_OPENSSL", False)
    assert r_sc._HAVE_OPENSSL is openssl
    msgs = [b"", b"hello", b"\x01" * 1023, b"\x02" * 1024,
            bytes(range(256)) * 40, b"\x03" * 1027]

    async def go():
        (cr, cw), (sr, sw), server = await _pipe_pair()
        pk, rk = p_ed.gen_priv_key(), r_ed.gen_priv_key()
        port_rw, jax_rw = ((cr, cw), (sr, sw)) if port_dials else \
            ((sr, sw), (cr, cw))
        psc, rsc = await asyncio.wait_for(asyncio.gather(
            SecretConnection.make(*port_rw, pk),
            r_sc.SecretConnection.make(*jax_rw, rk)), 20)
        assert psc.remote_pub_key.bytes() == rk.pub_key().bytes()
        assert rsc.remote_pub_key.bytes() == pk.pub_key().bytes()
        for m in msgs:
            await psc.write_msg(m)
            assert await asyncio.wait_for(rsc.read_msg(), 5) == m
            await rsc.write_msg(m[::-1])
            assert await asyncio.wait_for(psc.read_msg(), 5) == m[::-1]
        assert psc._send_nonce == rsc._recv_nonce
        assert psc._recv_nonce == rsc._send_nonce
        psc.close()
        rsc.close()
        server.close()
    run(go())


def test_frame_layout_equals_the_jax_package():
    key, nonce = bytes(range(32)), 5
    for n in (0, 3, 1023, 1024):
        chunk = bytes([n % 251]) * n
        psc = SecretConnection(None, None, aead_host.ChaCha20Poly1305(key),
                               None, None)
        rsc = r_sc.SecretConnection(None, None, r_sc._new_aead(key), None,
                                    None)
        psc._send_nonce = rsc._send_nonce = nonce
        sealed = psc._seal_chunk(chunk)
        assert sealed == rsc._seal_chunk(chunk)
        assert len(sealed) == p_sc.SEALED_FRAME_SIZE == 1044
        assert _aead_ref.ChaCha20Poly1305(key).decrypt(
            nonce.to_bytes(12, "little"), sealed, None) == \
            len(chunk).to_bytes(4, "little") + chunk + \
            bytes(1024 - len(chunk))


@pytest.mark.parametrize("point", [bytes(32), (1).to_bytes(32, "little")],
                         ids=["zero", "one"])
def test_low_order_peer_key_refused(monkeypatch, point):
    monkeypatch.setattr(r_sc, "_HAVE_OPENSSL", False)
    texts = []
    for mod in (p_sc, r_sc):
        with pytest.raises(mod.SecretConnectionError) as err:
            mod._dh(bytes(range(32)), point)
        texts.append(str(err.value))
    assert texts == ["x25519: low-order peer public key"] * 2

    async def go():
        (cr, cw), (sr, sw), server = await _pipe_pair()
        sw.write(point)
        await sw.drain()
        with pytest.raises(SecretConnectionError,
                           match="^x25519: low-order peer public key$"):
            await asyncio.wait_for(SecretConnection.make(
                cr, cw, p_ed.gen_priv_key()), 10)
        cw.close()
        sw.close()
        server.close()
    run(go())


# -- MConnection packets and NodeInfo -----------------------------------------

class _Recorder:
    """A secret connection that records each message written and never
    delivers one."""

    def __init__(self):
        self.sent = []
        self._never = asyncio.Event()

    async def write_msg(self, data):
        self.sent.append(bytes(data))

    async def read_msg(self):
        await self._never.wait()

    def close(self):
        pass


def test_mconnection_packets_equal_the_jax_package():
    rng = np.random.default_rng(9)
    plan = [(0x20, rng.bytes(10)), (0x21, rng.bytes(5000)),
            (0x22, rng.bytes(1024)), (0x21, rng.bytes(3)),
            (0x20, rng.bytes(2049)), (0x22, b""), (0x23, rng.bytes(700))]
    descs = [(0x20, 6, 200), (0x21, 10, 100), (0x22, 7, 800), (0x23, 1, 2)]

    async def packets(mod):
        rec = _Recorder()

        async def on_receive(cid, msg):
            pass

        mc = mod.MConnection(
            rec, [mod.ChannelDescriptor(id=i, priority=p,
                                        send_queue_capacity=c)
                  for i, p, c in descs], on_receive, lambda e: None)
        for cid, msg in plan:
            assert mc.send(cid, msg)
        mc.start()
        for _ in range(200):
            await asyncio.sleep(0)
        total = sum(len(m) for _, m in plan)
        assert sum(len(p) - 3 for p in rec.sent) == total
        mc.close()
        return rec.sent

    mine, theirs = run(packets(p_conn)), run(packets(r_conn))
    assert mine == theirs
    assert max(len(p) for p in mine) == 1027
    assert {p[0] for p in mine} == {0x03}
    assert [p[1:3] for p in mine if p[1] == 0x21] == \
        [b"\x21\x00"] * 4 + [b"\x21\x01", b"\x21\x01"]


def test_ping_pong_packets():
    async def go(mod):
        msgs = [bytes([0x01])]

        class _Pinger(_Recorder):
            async def read_msg(self):
                if msgs:
                    return msgs.pop()
                await self._never.wait()

        pinger = _Pinger()

        async def on_receive(cid, msg):
            pass

        mc = mod.MConnection(pinger, [mod.ChannelDescriptor(id=1)],
                             on_receive, lambda e: None)
        mc.start()
        for _ in range(20):
            await asyncio.sleep(0)
        mc.close()
        return pinger.sent
    assert run(go(p_conn)) == run(go(r_conn)) == [b"\x02"]


def test_node_info_json_equals_the_jax_package():
    kw = dict(node_id="ab" * 20, listen_addr="127.0.0.1:26656",
              network="chain-x", channels=bytes([0x00, 0x20, 0x21, 0x22,
                                                 0x23]),
              moniker="m", features=("aggcommit/1", "compactblocks/1",
                                     "votebatch/1"))
    mine, theirs = NodeInfo(**kw), r_switch.NodeInfo(**kw)
    assert mine.to_json() == theirs.to_json()
    assert mine.p2p_version == theirs.p2p_version == 9
    assert NodeInfo.from_json(theirs.to_json()) == mine
    other = r_switch.NodeInfo(**{**kw, "network": "chain-y"})
    assert mine.compatible_with(NodeInfo.from_json(other.to_json())) == \
        theirs.compatible_with(other) == \
        "peer network 'chain-y' != 'chain-x'"
    no_chan = r_switch.NodeInfo(**{**kw, "channels": b"\x77"})
    assert mine.compatible_with(NodeInfo.from_json(no_chan.to_json())) == \
        theirs.compatible_with(no_chan) == "no common channels"


# -- a port Switch and a JAX Switch ------------------------------------------

@pytest.mark.parametrize("port_dials", [True, False],
                         ids=["port-dials", "jax-dials"])
def test_switch_exchanges_with_jax_switch(port_dials):
    async def go():
        pk, rk = NodeKey.generate(), RNodeKey.generate()
        ps = Switch(pk, "mixed", listen_addr="127.0.0.1:0")
        rs = r_switch.Switch(rk, "mixed", listen_addr="127.0.0.1:0")
        pr, rr = EchoReactor(), REchoReactor()
        ps.add_reactor(pr)
        rs.add_reactor(rr)
        try:
            await ps.start()
            await rs.start()
            if port_dials:
                await asyncio.wait_for(ps.dial_peer(rs.listen_addr), 20)
            else:
                await asyncio.wait_for(rs.dial_peer(ps.listen_addr), 20)

            async def both():
                while ps.num_peers() != 1 or rs.num_peers() != 1:
                    await asyncio.sleep(0.01)
            await asyncio.wait_for(both(), 10)
            assert list(ps.peers) == [rk.id] and list(rs.peers) == [pk.id]
            assert ps.peers[rk.id].outbound is port_dials
            for i, size in enumerate((5, 1024, 5000)):
                ps.broadcast(EchoReactor.CHAN, bytes([i]) * size)
                rs.broadcast(EchoReactor.CHAN, bytes([i + 7]) * size)
                got_r = await asyncio.wait_for(rr.received.get(), 5)
                got_p = await asyncio.wait_for(pr.received.get(), 5)
                assert got_r == (pk.id, bytes([i]) * size)
                assert got_p == (rk.id, bytes([i + 7]) * size)
            sent = ps.metrics.message_send_bytes_total.with_labels(
                "0x77").value
            assert sent == 7 * 3 + 5 + 1024 + 5000   # 7 packets
        finally:
            await ps.stop()
            await rs.stop()
    run(go())


def test_persistent_dial_redials_and_conn_wrapper_sees_each_link():
    async def go():
        nk1, nk2 = NodeKey.generate(), NodeKey.generate()
        s1 = Switch(nk1, "net", listen_addr="127.0.0.1:0")
        s2 = Switch(nk2, "net", listen_addr="127.0.0.1:0",
                    config=P2PConfig(send_rate=6_000_000,
                                     recv_rate=7_000_000))
        wrapped = []

        def wrapper(sconn, node_id, outbound):
            wrapped.append((node_id, outbound))
            return sconn

        s2.conn_wrapper = wrapper
        for sw in (s1, s2):
            sw.add_reactor(EchoReactor())
        try:
            await s1.start()
            await s2.start()
            s2.dial_peers_async([s1.listen_addr])

            async def peers(n):
                while s1.num_peers() != n or s2.num_peers() != n:
                    await asyncio.sleep(0.01)
            await asyncio.wait_for(peers(1), 10)
            # drop the link from the listening side: the dial loop redials
            await s1.stop_peer(s1.peers[nk2.id], "test drop")
            await asyncio.wait_for(peers(0), 10)
            await asyncio.wait_for(peers(1), 10)
            assert wrapped == [(nk1.id, True), (nk1.id, True)]
            assert s2.peers[nk1.id].outbound
            assert not s1.peers[nk2.id].outbound
            # the switch meters each link at its config's rates
            mconn = s2.peers[nk1.id].mconn
            assert (mconn.send_limiter.rate, mconn.recv_limiter.rate) == \
                (6_000_000, 7_000_000)
            mconn = s1.peers[nk2.id].mconn
            assert mconn.send_limiter.rate == P2PConfig().send_rate
        finally:
            await s1.stop()
            await s2.stop()
    run(go())


def test_a_handshake_that_ends_after_stop_adds_no_peer(monkeypatch):
    """C.7: an inbound handshake still in flight when the switch stops
    finishes after it.  The stopped switch adds no peer, calls no
    reactor's add_peer and starts no task (reference: Switch.addPeer
    ignores a peer once the switch is not running); before, the peer
    and its reactors' tasks outlived the stop."""
    class Recording(EchoReactor):
        added = []

        async def add_peer(self, peer):
            self.added.append(peer.id)

    async def go():
        nk1, nk2 = NodeKey.generate(), NodeKey.generate()
        s1 = Switch(nk1, "net", listen_addr="127.0.0.1:0")
        s2 = Switch(nk2, "net", listen_addr="127.0.0.1:0")
        s1.add_reactor(Recording())
        s2.add_reactor(EchoReactor())
        release, entered = asyncio.Event(), asyncio.Event()
        real_make = p_sc.SecretConnection.make

        async def held_make(reader, writer, priv):
            sc = await real_make(reader, writer, priv)
            if priv == nk1.priv_key:
                entered.set()
                await release.wait()
            return sc
        monkeypatch.setattr(p_sc.SecretConnection, "make", held_make)
        await s1.start()
        await s2.start()
        dial = asyncio.ensure_future(s2.dial_peer(s1.listen_addr))
        try:
            await asyncio.wait_for(entered.wait(), 10)
            await s1.stop()
            release.set()
            try:    # the dialer may finish its side or see the close
                await asyncio.wait_for(dial, 10)
            except (OSError, p_switch.SwitchError,
                    asyncio.IncompleteReadError):
                pass
            await asyncio.sleep(0.05)
            assert s1.peers == {} and Recording.added == []
            assert s1.supervisor.live_count() == 0
        finally:
            release.set()
            await s1.stop()
            await s2.stop()
    run(go())


def test_p2p_config_equals_the_jax_one_and_is_read():
    mine, theirs = P2PConfig(), RP2PConfig()
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert Config().p2p == mine
    pex, rpex = p_pex.PexReactor(p_pex.AddrBook()), \
        r_pex.PexReactor(r_pex.AddrBook())
    assert (pex.seed_mode, pex.max_outbound) == \
        (rpex.seed_mode, rpex.max_outbound)
    pex = p_pex.PexReactor(p_pex.AddrBook(), P2PConfig(
        seed_mode=True, max_num_outbound_peers=3))
    assert (pex.seed_mode, pex.max_outbound) == (True, 3)


# -- flow control -------------------------------------------------------------

def test_rate_limiter_equals_the_jax_one_on_a_fake_clock(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr("time.monotonic", lambda: clock[0])
    slept = []

    async def fake_sleep(s):
        slept.append(s)

    monkeypatch.setattr(asyncio, "sleep", fake_sleep)
    script = [("take", 3000, 0.0), ("try", 500, 0.1), ("take", 1500, 0.0),
              ("try", 10, 0.0), ("take", 20000, 0.3), ("try", 900, 0.7),
              ("take", 1, 1.2), ("take", 4096, 0.05), ("try", 4096, 2.0)]

    def drive(mod, rate):
        clock[0] = 1000.0
        slept.clear()
        lim, out = mod.RateLimiter(rate), []
        loop = asyncio.new_event_loop()
        try:
            for op, n, dt in script:
                clock[0] += dt
                if op == "take":
                    loop.run_until_complete(lim.take(n))
                else:
                    out.append(lim.try_take(n))
                out.append((lim.total, lim.measured_rate, lim._tokens))
        finally:
            loop.close()
        return out, list(slept)

    for rate in (4096, 5_120_000, 0):
        assert drive(p_flowrate, rate) == drive(r_flowrate, rate)


# -- the address book ---------------------------------------------------------

def _fill(book, rng_seed, n=120):
    rng = random.Random(rng_seed)
    ids = [f"{rng.getrandbits(160):040x}" for _ in range(n)]
    for i, nid in enumerate(ids):
        book.add_address(nid, f"10.0.{i // 250}.{i % 250 + 1}", 26656 + i)
    for nid in ids[::3]:
        book.mark_good(nid)
    for nid in ids[1::7]:
        book.mark_attempt(nid)
    return ids


def _entries(book):
    return sorted((a.node_id, a.ip, a.port, a.attempts, a.is_old, a.bucket)
                  for a in book._addrs.values())


def test_addr_book_buckets_and_picks_equal(monkeypatch):
    key = "00112233445566778899aabb"
    mine, theirs = p_pex.AddrBook(key=key), r_pex.AddrBook(key=key)
    ids = _fill(mine, 4)
    assert _fill(theirs, 4) == ids
    for nid in ids:
        for old in (False, True):
            assert mine._bucket_index(nid, old) == \
                theirs._bucket_index(nid, old)
    assert _entries(mine) == _entries(theirs)
    random.seed(11)
    for n, bias in ((10, 30), (50, 0), (200, 100), (7, 50)):
        excl = set(ids[:5])
        st = random.getstate()
        got = [a.node_id for a in mine.pick_addresses(n, excl, bias)]
        random.setstate(st)
        want = [a.node_id for a in theirs.pick_addresses(n, excl, bias)]
        assert got == want and len(got) == min(n, len(ids) - 5)
    # a full NEW bucket evicts the same entry in both
    full = [nid for nid in (f"{i:040x}" for i in range(40_000))
            if mine._bucket_index(nid, False) == 0][:70]
    assert len(full) == 70
    for nid in full:
        assert mine.add_address(nid, "10.1.1.1", 1) == \
            theirs.add_address(nid, "10.1.1.1", 1)
    assert _entries(mine) == _entries(theirs)
    assert len(mine._bucket_members(False, 0)) == 64
    assert not mine.add_address("", "10.1.1.1", 1)
    assert not mine.add_address("x", "0.0.0.0", 1)


def test_addr_book_file_round_trips(tmp_path):
    key = "feedfacefeedfacefeedface"
    mine = p_pex.AddrBook(str(tmp_path / "p.json"), key=key)
    theirs = r_pex.AddrBook(str(tmp_path / "r.json"), key=key)
    _fill(mine, 8, 40)
    _fill(theirs, 8, 40)
    mine.save()
    theirs.save()

    def fields(path):
        d = json.load(open(path))
        return d["key"], [{k: v for k, v in a.items() if k != "last_seen"}
                          for a in d["addrs"]]
    assert fields(tmp_path / "p.json") == fields(tmp_path / "r.json")
    # each package loads the other's file to the same book
    back_p = p_pex.AddrBook(str(tmp_path / "r.json"))
    back_r = r_pex.AddrBook(str(tmp_path / "p.json"))
    assert back_p.key == back_r.key == key
    assert _entries(back_p) == _entries(back_r) == _entries(mine)


def test_pex_reactor_exchanges_addresses_with_jax():
    async def go():
        pk, rk = NodeKey.generate(), RNodeKey.generate()
        ps = Switch(pk, "pex", listen_addr="127.0.0.1:0")
        rs = r_switch.Switch(rk, "pex", listen_addr="127.0.0.1:0")
        pbook, rbook = p_pex.AddrBook(strict=False), \
            r_pex.AddrBook(strict=False)
        rbook.add_address("cd" * 20, "10.9.9.9", 26656)
        ps.add_reactor(p_pex.PexReactor(pbook))
        rs.add_reactor(r_pex.PexReactor(rbook))
        try:
            await ps.start()
            await rs.start()
            await asyncio.wait_for(ps.dial_peer(rs.listen_addr), 20)

            async def learned():
                while pbook.size() < 2 or rbook.size() < 2:
                    await asyncio.sleep(0.01)
            await asyncio.wait_for(learned(), 10)
            assert "cd" * 20 in pbook._addrs
            assert rk.id in pbook._addrs and pk.id in rbook._addrs
        finally:
            await ps.stop()
            await rs.stop()
    run(go())
