"""The port's proof-serving light path against the JAX package's:

  * ``Multiproof`` and its builders (crypto/merkle.py): dicts, roots and
    verdicts for trees of 0, 1, 2, 3, 7, 200 and 1,000 leaves over seeded
    index sets, tampered and non-canonical proofs refused with the same
    texts; ``ValueOp`` / ``ProofOperators``;
  * the state tree's proof envelopes (statetree/proof.py, ``prove``) and
    the kvstore's ``/multistore`` query on twin kvstores fed the same txs:
    present and absent keys, every version, heights 0 and above the
    latest, tampered envelopes refused with the same texts;
  * ``ResponseCache`` (lightserve/cache.py): hits, misses, evictions,
    ``heights()`` and the metric family under one seeded sequence;
  * the routes ``light_block``, ``multiproof`` and ``abci_query_batch``
    and ``block`` / ``commit`` through ``_cached`` (rpc/core.py) over twin
    chains whose holders keep a cache, as JSON; a height the block store
    pruned after it was cached;
  * ``LightProxy`` (light/proxy.py) against the JAX proxy over the same
    port servers, and a primary that attaches a forged tx to a real
    header;
  * the port's ``HttpProvider`` taking one round trip a light block from a
    port server.

The port verifies on ``device="cpu"`` (the accept-all stand-in kernel
where verdicts do not matter), the JAX package on its ``cpu`` backend.
Nothing here is floating point: equality is exact.
"""
import asyncio
import base64
import hashlib
import json
import time

import numpy as np
import pytest

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import merkle as r_merkle
from cometbft_tpu.libs.metrics import Registry as RRegistry
from cometbft_tpu.light import proxy as r_proxy
from cometbft_tpu.light import state_proof as r_state_proof
from cometbft_tpu.lightserve import cache as r_cache
from cometbft_tpu.lightserve import core as r_ls
from cometbft_tpu.rpc import core as r_core
from cometbft_tpu.rpc import server as r_server
from cometbft_tpu.statetree import proof as r_proof
from cometbft_tpu_torch.abci import types as p_abci
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import RPCConfig
from cometbft_tpu_torch.crypto import merkle as p_merkle
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.libs.metrics import Registry
from cometbft_tpu_torch.light import proxy as p_proxy
from cometbft_tpu_torch.light import state_proof as p_state_proof
from cometbft_tpu_torch.light.provider import HttpProvider
from cometbft_tpu_torch.lightserve import cache as p_cache
from cometbft_tpu_torch.lightserve import core as p_ls
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.rpc import core as p_core
from cometbft_tpu_torch.rpc import server as p_server
from cometbft_tpu_torch.statetree import proof as p_proof
from torch_chain import RChain, accept_all, cs, port_chain, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "lightserve-parity"
N, TOP, KEYS = 8, 8, 12
SIZES = [0, 1, 2, 3, 7, 200, 1000]


@pytest.fixture(autouse=True)
def _fresh():
    r_batch.set_backend("cpu")
    yield
    r_batch.set_backend("auto")
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _outcome(fn, *a, **kw):
    """What a call did: ("ok", result) or (error type name, text)."""
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e))


# -- multiproofs --------------------------------------------------------------

def _index_sets(n, rng):
    """Seeded index sets for a tree of n leaves: none, the ends, a spread,
    an unsorted run with repeats, and every leaf (up to 256)."""
    sets = [[]]
    if n:
        sets += [[0], [n - 1], sorted(rng.choice(
            n, size=min(n, 5), replace=False).tolist()),
            rng.integers(0, n, size=min(2 * n, 40)).tolist(),
            list(range(min(n, 256)))]
    return sets


def _tampered(d, n):
    """Multiproof dicts a verifier must refuse (or, for the untouched one,
    accept): flipped, dropped and surplus aunts, a changed total, and
    non-canonical index lists."""
    out = [dict(d)]
    if d["aunts"]:
        a = list(d["aunts"])
        a[0] = ("0" if a[0][0] != "0" else "1") + a[0][1:]
        out.append({**d, "aunts": a})
        out.append({**d, "aunts": d["aunts"][:-1]})
    out.append({**d, "aunts": d["aunts"] + ["00" * 32]})
    out.append({**d, "total": d["total"] + 1})
    idx = d["indices"]
    if len(idx) >= 2:
        out.append({**d, "indices": idx[::-1]})
        out.append({**d, "indices": [idx[0]] + idx[:-1]})
    out.append({**d, "indices": idx + [n]})
    out.append({**d, "indices": [-1] + idx})
    return out


@pytest.mark.parametrize("n", SIZES)
def test_multiproofs_equal_the_jax_ones(n):
    rng = np.random.default_rng(1600 + n)
    items = [rng.bytes(int(rng.integers(0, 40))) for _ in range(n)]
    assert p_merkle.hash_from_byte_slices(items) == \
        r_merkle.hash_from_byte_slices(items)
    for idx in _index_sets(n, rng):
        root, mp = p_merkle.multiproof_from_byte_slices(items, idx)
        rroot, rmp = r_merkle.multiproof_from_byte_slices(items, idx)
        assert root == rroot == p_merkle.hash_from_byte_slices(items)
        # the same JSON, key order and hex case included
        assert json.dumps(mp.to_dict()) == json.dumps(rmp.to_dict())
        assert mp.indices == sorted(set(idx))
        leaves = [items[i] for i in mp.indices]
        hashes = [p_merkle.leaf_hash(x) for x in leaves]
        assert p_merkle.Multiproof.from_dict(mp.to_dict()) == mp
        for d in _tampered(mp.to_dict(), n):
            for args in ((root, leaves), (b"\xee" * 32, leaves),
                         (root, [b"forged"] + leaves[1:]),
                         (root, leaves[:-1])):
                mine = _outcome(p_merkle.Multiproof.from_dict(d).verify,
                                *args)
                theirs = _outcome(r_merkle.Multiproof.from_dict(d).verify,
                                  *args)
                assert mine == theirs, (d, args)
            assert _outcome(p_merkle.Multiproof.from_dict(d)
                            .verify_hashes, root, hashes) == \
                _outcome(r_merkle.Multiproof.from_dict(d).verify_hashes,
                         root, hashes)
        assert _outcome(mp.verify, root, leaves) == ("ok", None)
    for bad in ([n], [-1], [0, n + 3]):
        assert _outcome(p_merkle.multiproof_from_byte_slices, items, bad) \
            == _outcome(r_merkle.multiproof_from_byte_slices, items, bad)
        assert _outcome(p_merkle.multiproof_from_byte_slices, items,
                        bad)[0] == "ValueError"


def test_value_op_and_proof_operators_equal_the_jax_ones():
    rng = np.random.default_rng(1611)
    pairs = sorted((rng.bytes(6), rng.bytes(9)) for _ in range(9))
    leaves = [p_merkle.value_op_leaf(k, v) for k, v in pairs]
    assert leaves == [r_merkle.value_op_leaf(k, v) for k, v in pairs]
    root, proofs = p_merkle.proofs_from_byte_slices(leaves)
    rroot, rproofs = r_merkle.proofs_from_byte_slices(leaves)
    assert root == rroot
    for i, (k, v) in enumerate(pairs):
        assert proofs[i].to_dict() == rproofs[i].to_dict()
        assert p_merkle.Proof.from_dict(proofs[i].to_dict()) == proofs[i]
        ops = p_merkle.ProofOperators([p_merkle.ValueOp(k, proofs[i])])
        rops = r_merkle.ProofOperators([r_merkle.ValueOp(k, rproofs[i])])
        for args in ((root, [k], v), (root, [k], b"x"), (root, [b"z"], v),
                     (b"\x01" * 32, [k], v), (root, [b"a", k], v)):
            assert _outcome(ops.verify_value, *args) == \
                _outcome(rops.verify_value, *args)
        assert _outcome(ops[0].run, [v, v]) == _outcome(rops[0].run, [v, v])


# -- proof envelopes on twin kvstores -----------------------------------------

def _history(seed=1620, heights=6):
    """Seeded blocks of keyed txs, some keys written again."""
    rng = np.random.default_rng(seed)
    blocks = []
    for h in range(heights):
        txs = []
        for _ in range(int(rng.integers(4, 9))):
            k = b"k%02d" % int(rng.integers(0, 30))
            txs.append(k + b"=v" + rng.bytes(3).hex().encode())
        blocks.append(txs)
    return blocks


def _twin_apps(blocks):
    async def go(app, a):
        for h, txs in enumerate(blocks, 1):
            await app.finalize_block(a.FinalizeBlockRequest(txs=txs,
                                                            height=h))
            await app.commit(a.CommitRequest())
        return app
    return run(go(KVStoreApplication(), p_abci)), run(go(RKVStore(), r_abci))


def _request_sets(app, rng):
    keys = [k for k, _ in app.tree.pairs()]
    picked = [keys[i] for i in rng.choice(len(keys), 5, replace=False)]
    return [[], [keys[0]], [keys[-1]], [b"\x00"], [b"\xff" * 4],
            [keys[2], b"k05x", keys[0] + b"\x00", keys[2]],
            picked + [b"absent-%d" % i for i in range(3)]]


def _tamper_envelope(env):
    """Envelopes a verifier must refuse: a flipped value, a swapped pair
    of neighbours, a moved absence arm, a stale root."""
    out = []
    if env["values"]:
        e = json.loads(json.dumps(env))
        v = e["values"][0]
        e["values"][0] = ("0" if v[:1] != "0" else "1") + v[1:] if v \
            else "00"
        out.append(e)
    if len(env["keys"]) >= 2:
        e = json.loads(json.dumps(env))
        e["keys"][0], e["keys"][1] = e["keys"][1], e["keys"][0]
        e["values"][0], e["values"][1] = e["values"][1], e["values"][0]
        out.append(e)
    for arm in env["absent"]:
        if arm["left"] is not None and arm["right"] is not None:
            e = json.loads(json.dumps(env))
            for a in e["absent"]:       # a key asked twice has two arms
                if a["key"] == arm["key"]:
                    a["right"] = a["left"] + 2
            out.append(e)
            break
    e = json.loads(json.dumps(env))
    e["root"] = "11" * 32
    out.append(e)
    return out


def test_proof_envelopes_equal_the_jax_ones():
    port, jax = _twin_apps(_history())
    assert port.tree.root() == jax.tree.root()
    rng = np.random.default_rng(1621)
    for v in range(1, port.tree.latest_version + 1):
        for req in _request_sets(port, rng):
            env = port.tree.prove(req, v)
            assert env == jax.tree.prove(req, v), (v, req)
            present = [(bytes.fromhex(k), bytes.fromhex(x))
                       for k, x in zip(env["keys"], env["values"])
                       if bytes.fromhex(k) in req]
            absent = [k for k in req if port.tree.get(k, v) is None]
            assert [bytes.fromhex(a["key"]) for a in env["absent"]] == absent
            root = port.tree.root(v)
            for args in ({"present": present, "absent": absent},
                         {"present": present, "absent": absent,
                          "expected_root": root},
                         {"present": [(k, x + b"!") for k, x in present]},
                         {"absent": [k for k, _ in present]},
                         {"absent": [b"never-asked"]},
                         {"present": [(b"never-asked", b"")]},
                         {"expected_root": b"\x01" * 32}):
                assert _outcome(p_proof.verify_proof_envelope, env,
                                **args) == \
                    _outcome(r_proof.verify_proof_envelope, env, **args)
            assert _outcome(p_proof.verify_proof_envelope, env,
                            present=present, absent=absent,
                            expected_root=root) == ("ok", None)
            for bad in _tamper_envelope(env):
                mine = _outcome(p_proof.verify_proof_envelope, bad,
                                present=present, absent=absent,
                                expected_root=root)
                assert mine[0] == "ValueError"
                assert mine == _outcome(r_proof.verify_proof_envelope, bad,
                                        present=present, absent=absent,
                                        expected_root=root)
    # a version the tree does not hold
    assert _outcome(port.tree.prove, [b"a"], 99) == \
        _outcome(jax.tree.prove, [b"a"], 99)


def test_multistore_queries_equal_the_jax_ones():
    port, jax = _twin_apps(_history())
    empty_p, empty_r = KVStoreApplication(), RKVStore()
    keys = [k.hex() for k, _ in port.tree.pairs()[:3]] + [b"zz".hex()]

    async def ask(app, a, data, height):
        r = await app.query(a.QueryRequest(path="/multistore", data=data,
                                           height=height, prove=True))
        return (r.code, r.log, r.key, r.value, r.height)
    for data in (json.dumps({"keys": keys}).encode(),
                 json.dumps({"keys": []}).encode(), b"{not json",
                 json.dumps({"keys": ["zz-not-hex"]}).encode(),
                 json.dumps({"nokeys": 1}).encode()):
        for h in (0, 1, 3, 6, 7, 99):
            mine = run(ask(port, p_abci, data, h))
            assert mine == run(ask(jax, r_abci, data, h)), (data, h)
            if mine[0] == 0 and mine[3] and 1 <= h <= 6:
                env = json.loads(mine[3])
                assert (env["version"], env["header_height"]) == \
                    (str(h), str(h + 1))
        assert run(ask(empty_p, p_abci, data, 0)) == \
            run(ask(empty_r, r_abci, data, 0))
        assert run(ask(empty_p, p_abci, data, 2)) == \
            run(ask(empty_r, r_abci, data, 2))


def test_state_proof_checks_equal_the_jax_ones():
    """verify_state_proof binds an envelope of version V to the header at
    V + 1; the lightserve ``verify_kv_multiproof`` too, and it refuses an
    envelope without the header binding when a header is given (the JAX
    function checks such an envelope against its own root)."""
    from types import SimpleNamespace
    port, _ = _twin_apps(_history())
    v = 4
    req = [k for k, _ in port.tree.pairs(v)[:2]] + [b"absent"]
    env = port.tree.prove(req, v)
    present = [(k, port.tree.get(k, v)) for k in req[:2]]
    hdr = SimpleNamespace(height=v + 1, app_hash=port.tree.root(v))
    other = SimpleNamespace(height=v + 2, app_hash=port.tree.root(v))
    forged = dict(env, root="11" * 32)
    legacy = {k: x for k, x in env.items() if k != "header_height"}
    for h, e in ((hdr, env), (other, env), (hdr, forged), (hdr, legacy)):
        args = {"present": present, "absent": [b"absent"]}
        assert _outcome(p_state_proof.verify_state_proof, h, e, **args) == \
            _outcome(r_state_proof.verify_state_proof, h, e, **args)
        assert _outcome(p_ls.verify_kv_multiproof, e, present, [b"absent"],
                        verified_header=h) == \
            _outcome(r_ls.verify_kv_multiproof, e, present, [b"absent"],
                     verified_header=h)
    assert _outcome(p_state_proof.verify_state_proof, hdr, env,
                    present=present, absent=[b"absent"]) == ("ok", None)
    # an envelope of the multiproof-only form: the JAX function ignores
    # the header, the port refuses to pass it unchained
    bare = {"root": env["root"], "multiproof": env["multiproof"]}
    leaves = [(bytes.fromhex(k), bytes.fromhex(x))
              for k, x in zip(env["keys"], env["values"])]
    assert _outcome(r_ls.verify_kv_multiproof, bare, leaves,
                    verified_header=hdr) == ("ok", None)
    assert _outcome(p_ls.verify_kv_multiproof, bare, leaves,
                    verified_header=hdr)[0] == "ValueError"
    assert _outcome(p_ls.verify_kv_multiproof, bare, leaves) == \
        _outcome(r_ls.verify_kv_multiproof, bare, leaves) == ("ok", None)


# -- the response cache -------------------------------------------------------

def _cache_story(mod, registry):
    rng = np.random.default_rng(1630)
    c = mod.ResponseCache(max_bytes=4096, metrics=mod.Metrics(registry))
    out = []
    for _ in range(300):
        h = int(rng.integers(0, 14))
        method = ("block", "commit", "light_block")[int(rng.integers(0, 3))]
        extra = () if rng.random() < 0.7 else (int(rng.integers(0, 3)),)
        if rng.random() < 0.5:
            out.append(("get", c.get(method, h, extra)))
        else:
            value = {"v": "y" * int(rng.integers(0, 700)), "h": h}
            out.append(("put", c.put(method, h, extra, value,
                                     latest_height=int(rng.integers(8,
                                                                    14)))))
        out.append((sorted(c.heights()), sorted(c.heights("block")),
                    len(c), c.size_bytes))
    out.append(c.stats())
    c.clear()
    out.append((len(c), c.size_bytes, c.stats()))
    assert mod.ResponseCache(max_bytes=0).put("block", 1, (), {}, 5) is False
    return out


def test_response_cache_equals_the_jax_one():
    reg, rreg = Registry(), RRegistry()
    mine = _cache_story(p_cache, reg)
    assert mine == _cache_story(r_cache, rreg)
    stats = mine[-2]
    assert stats["hits"] > 0 and stats["misses"] > 0 and \
        stats["evictions"] > 0
    page = [ln for ln in reg.render().splitlines() if "lightserve" in ln]
    assert page == [ln for ln in rreg.render().splitlines()
                    if "lightserve" in ln]
    assert f"cometbft_lightserve_cache_hits_total {stats['hits']}" in page


# -- the routes over twin chains ----------------------------------------------

class Holder:
    """A node holder with the JAX Node's attribute names the lightserve
    routes read, and a response cache the kvstore's version_pin reads."""

    def __init__(self, chain, cache_mod):
        self.block_store, self.state_store = chain.block_store, \
            chain.state_store
        self.app_conns, self.genesis_doc = chain.conns, chain.doc
        self.lightserve_cache = cache_mod.ResponseCache()
        chain.app.version_pin = self.lightserve_cache.heights


def _keyed_txs(h):
    return [b"ls%02d=%d.%d" % ((h * 5 + j) % KEYS, h, j) for j in range(4)]


@pytest.fixture(scope="module")
def twins():
    key_seeds = seeds(N, 161)
    t0 = int(time.time()) - 300
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        mp.setattr(cs, "EXEC_T0", t0)
        p = port_chain(CHAIN_ID, key_seeds, t0=t0)
        r = RChain(CHAIN_ID, key_seeds)
        for h in range(1, TOP + 1):
            assert p.step(_keyed_txs(h))[0].hash() == \
                r.step(_keyed_txs(h)).hash()
        pipeline.reset_workers()
    return {"p": p, "r": r, "seeds": key_seeds, "t0": t0}


def _route_calls():
    present = ",".join("0x" + (b"ls%02d" % i).hex() for i in (0, 3, 7))
    calls = []
    for h in ("0", "1", "3", str(TOP - 1), str(TOP), "99"):
        calls += [("light_block", {"height": h}), ("block", {"height": h}),
                  ("commit", {"height": h})]
    for h in ("2", str(TOP - 1), str(TOP)):
        for idx in ("0", "3,1,3", "", "0,1,2,3"):
            calls.append(("multiproof", {"height": h, "indices": idx}))
    calls += [("multiproof", {"height": "2", "indices": "7"}),
              ("multiproof", {"height": "2", "indices": "a,b"})]
    for h in ("0", "2", str(TOP - 1), "99"):
        for prove in ("true", False):
            calls.append(("abci_query_batch", {
                "data": present + ",0x" + b"nope".hex(), "height": h,
                "prove": prove}))
    calls += [("abci_query_batch", {"data": ""}),
              ("abci_query_batch", {"data": "0x00", "height": "x"})]
    return calls


def _answer(routes, name, params):
    async def go():
        try:
            res = await routes[name](**params)
        except (p_server.RPCError, r_server.RPCError) as e:
            return ["error", e.code, e.message, e.data]
        return ["result", json.loads(json.dumps(res))]
    return asyncio.run(go())


def test_routes_through_the_cache_answer_as_the_jax_routes(twins):
    """Each call twice, so the second of a settled height is a cache hit:
    the same JSON and errors, the same cache counters and heights."""
    p, r = twins["p"], twins["r"]
    pn, rn = Holder(p, p_cache), Holder(r, r_cache)
    proutes = p_core.routes(p_core.Environment(pn))
    rroutes = r_core.routes(r_core.Environment(rn))
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        for name, params in _route_calls() * 2:
            mine = _answer(proutes, name, params)
            assert mine == _answer(rroutes, name, params), (name, params)
    stats = pn.lightserve_cache.stats()
    assert stats == rn.lightserve_cache.stats()
    assert stats["hits"] > 0 and stats["entries"] > 0
    assert pn.lightserve_cache.heights() == rn.lightserve_cache.heights()
    assert TOP not in pn.lightserve_cache.heights()
    # the multiproof verifies against the header's data_hash
    res = _answer(proutes, "multiproof", {"height": "3",
                                          "indices": "0,2"})[1]
    mp_ = p_merkle.Multiproof.from_dict(res["multiproof"])
    hdr = p.block_store.load_block_meta(3).header
    mp_.verify(hdr.data_hash, [hashlib.sha256(base64.b64decode(t)).digest()
                               for t in res["txs"]])
    # the proven batch verifies against the header at version + 1
    res = _answer(proutes, "abci_query_batch", {
        "data": "0x" + b"ls03".hex() + ",0x" + b"nope".hex(),
        "height": "4", "prove": "true"})[1]
    proof = res["proof"]
    p_state_proof.verify_state_proof(
        p.block_store.load_block_meta(5).header, proof,
        present=[(b"ls03", base64.b64decode(res["responses"][0]["value"]))],
        absent=[b"nope"])


def test_a_pruned_height_is_not_served_from_the_cache(twins):
    """A height cached and then pruned from the block store: the JAX
    ``_cached`` still serves it from the cache; the port answers from the
    stores, with their error, as the reference (no cache) answers a pruned
    height."""
    base = {"p": twins["p"], "r": twins["r"]}
    out = {}
    for name, chain, cache_mod, core in (("p", base["p"], p_cache, p_core),
                                         ("r", base["r"], r_cache, r_core)):
        holder = Holder(_store_copy(chain), cache_mod)
        routes = core.routes(core.Environment(holder))
        first = [_answer(routes, m, {"height": "2"})
                 for m in ("block", "commit", "light_block")]
        holder.block_store.prune_blocks(4)
        out[name] = first, [_answer(routes, m, {"height": "2"})
                            for m in ("block", "commit", "light_block")]
    (pfirst, pafter), (rfirst, rafter) = out["p"], out["r"]
    assert pfirst == rfirst and all(a[0] == "result" for a in pfirst)
    assert rafter == rfirst                      # the JAX cache serves it
    assert [a[:2] for a in pafter] == [["error", -32603]] * 3
    assert pafter[0][2] == "block at height 2 not found"
    assert pafter[1][2] == "commit for height 2 not found"
    assert pafter[2][2] == "no light block at height 2"


def _store_copy(chain):
    """The chain's holder parts over copies of its block store rows."""
    from types import SimpleNamespace
    bs_cls, db_cls = type(chain.block_store), type(chain.dbs["block"])
    db = db_cls()
    for k, v in chain.dbs["block"].iterator():
        db.set(k, v)
    return SimpleNamespace(block_store=bs_cls(db),
                           state_store=chain.state_store, conns=chain.conns,
                           doc=chain.doc, app=SimpleNamespace())


# -- the light proxy ----------------------------------------------------------

async def _servers(chain, n=2, forge=False):
    """Port RPC servers over the chain's stores; ``forge`` makes the first
    attach a forged tx to every block it serves."""
    from chip_smoke import _StoreNode
    out = []
    for i in range(n):
        srv = p_server.RPCServer(_StoreNode(chain),
                                 RPCConfig(laddr="tcp://127.0.0.1:0"))
        await srv.start()
        if forge and i == 0:
            real = srv.routes["block"]

            async def block(height="0", real=real):
                res = await real(height=height)
                res["block"]["data"]["txs"] = \
                    res["block"]["data"]["txs"] + [
                        base64.b64encode(b"forged=1").decode()]
                return res
            srv.routes["block"] = block
        out.append(srv)
    return out


def _proxy_calls():
    calls = [("health", {})] + [("commit", {"height": str(h)})
                                for h in (2, 5, TOP)]
    calls += [("block", {"height": str(h)}) for h in (2, 5, TOP)]
    calls += [("validators", {"height": "5", "page": str(pg),
                              "per_page": "3"}) for pg in (1, 2, 3)]
    calls += [("abci_query", {"path": "", "data": (b"ls03").hex()})]
    return calls


def test_light_proxy_answers_as_the_jax_proxy(twins):
    """Both proxies over the same two port servers: the same answers (the
    validators' priorities aside, which the JAX codec recomputes; the
    port's keep the server's, the stores' own); a forging primary is
    refused with the JAX text by both."""
    from cometbft_tpu_torch.rpc.client import HTTPClient
    p = twins["p"]
    trust = p.block_store.load_block_meta(1).block_id.hash

    async def go():
        servers = await _servers(p)
        forgers = await _servers(p, forge=True)
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        furls = [f"http://127.0.0.1:{s.port}" for s in forgers]
        proxies = {
            "port": p_proxy.LightProxy(CHAIN_ID, urls[0], urls[1:], 1, trust,
                                       "tcp://127.0.0.1:0", device="cpu"),
            "jax": r_proxy.LightProxy(CHAIN_ID, urls[0], urls[1:], 1, trust,
                                      "tcp://127.0.0.1:0")}
        forged = {
            "port": p_proxy.LightProxy(CHAIN_ID, furls[0], furls[1:], 1,
                                       trust, "tcp://127.0.0.1:0",
                                       device="cpu"),
            "jax": r_proxy.LightProxy(CHAIN_ID, furls[0], furls[1:], 1,
                                      trust, "tcp://127.0.0.1:0")}
        out = {}
        try:
            for name in ("port", "jax"):
                await proxies[name].start()
                await forged[name].start()
                cli = HTTPClient(
                    f"http://{proxies[name].rpc_listen_addr}")
                answers = []
                for method, params in _proxy_calls():
                    answers.append(json.loads(json.dumps(
                        await cli.call(method, **params))))
                errs = []
                for h in (2, TOP):
                    try:
                        await forged[name].client.block(h)
                    except Exception as e:  # noqa: BLE001 — compared
                        errs.append((type(e).__name__, str(e)))
                fcli = HTTPClient(f"http://{forged[name].rpc_listen_addr}")
                try:
                    await fcli.call("block", height="3")
                except Exception as e:  # noqa: BLE001 — compared
                    errs.append(str(e)[:len("Internal error (-32603)")])
                out[name] = answers, errs
        finally:
            for px in list(proxies.values()) + list(forged.values()):
                await px.stop()
            for s in servers + forgers:
                await s.stop()
        return out

    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        out = run(go())
    (mine, merrs), (theirs, terrs) = out["port"], out["jax"]
    # the port's priorities are the stores' own
    vals = p.state_store.load_validators(5)
    got = [v["proposer_priority"] for call, ans in zip(_proxy_calls(), mine)
           if call[0] == "validators" for v in ans["validators"]]
    assert got == [str(v.proposer_priority) for v in vals.validators]
    for (method, params), a, b in zip(_proxy_calls(), mine, theirs):
        if method == "validators":
            for x in a["validators"] + b["validators"]:
                x.pop("proposer_priority")
        assert a == b, (method, params)
    assert merrs == terrs
    assert merrs[:2] == [("LightProxyError",
                          f"block {h} data does not hash to the verified "
                          f"data_hash") for h in (2, TOP)]
    assert merrs[2] == "Internal error (-32603)"
    # each signed header the port's proxy served is the stores' own (the
    # proxies call every verified commit canonical, the tip's too)
    for (method, params), a in zip(_proxy_calls(), mine):
        if method == "commit":
            want = _answer(p_core.routes(p_core.Environment(
                Holder(p, p_cache))), "commit", params)[1]
            assert a["signed_header"] == want["signed_header"]


def test_http_provider_takes_one_round_trip_a_light_block(twins):
    """A port server serves ``light_block``: the port's HttpProvider asks
    nothing else, one call a light block, and brings the stores' own."""
    from chip_smoke import _RpcCount
    from cometbft_tpu_torch.wire import encode, pb
    p = twins["p"]

    async def go():
        servers = await _servers(p, n=1)
        try:
            with _RpcCount(servers) as count:
                prov = HttpProvider(f"http://127.0.0.1:{servers[0].port}",
                                    CHAIN_ID)
                per = []
                for h in range(1, TOP + 1):
                    lb = await prov.light_block(h)
                    want = await _node_provider(p).light_block(h)
                    assert encode(pb.SIGNED_HEADER,
                                  lb.signed_header.to_proto()) == \
                        encode(pb.SIGNED_HEADER,
                               want.signed_header.to_proto())
                    assert lb.validator_set.hash() == \
                        want.validator_set.hash()
                    per.append(count.take()[0])
        finally:
            for s in servers:
                await s.stop()
        return per, prov._has_light_block

    per, has = run(go())
    assert has and per == [{"light_block": 1}] * TOP


def _node_provider(chain):
    from cometbft_tpu_torch.light.provider import NodeProvider
    return NodeProvider(chain.block_store, chain.state_store, CHAIN_ID)
