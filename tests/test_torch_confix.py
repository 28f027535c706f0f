"""The port's config tree and confix (cometbft_tpu_torch/{config,confix}.py)
against the JAX package's:

  * every section's fields, types and defaults equal, ``test_config`` and
    ``default_config`` too;
  * ``validate_basic`` gives the JAX text (or accepts) on a table of bad
    configs;
  * tests/test_confix_grammar.py's ``TestConfix*`` cases run in both
    packages on the same input, giving equal change logs, equal
    config.json bytes and equal values.

Tolerance is equality.
"""
import dataclasses
import json
import os

import pytest

from cometbft_tpu import config as r_config
from cometbft_tpu import confix as r_confix
from cometbft_tpu_torch import config as p_config
from cometbft_tpu_torch import confix as p_confix
from torch_helpers import one_torch_thread  # noqa: F401

PACKAGES = {"port": (p_config, p_confix), "jax": (r_config, r_confix)}


def _tree(cfg) -> dict:
    return {f.name: [(g.name, g.type, getattr(getattr(cfg, f.name), g.name))
                     for g in dataclasses.fields(getattr(cfg, f.name))]
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("make", ["Config", "default_config",
                                  "test_config"])
def test_every_section_equals_the_jax_one(make):
    mine = _tree(getattr(p_config, make)())
    theirs = _tree(getattr(r_config, make)())
    assert list(mine) == list(theirs)
    for section in theirs:
        assert mine[section] == theirs[section], section
    # the consensus timeout arithmetic
    pc, rc = p_config.Config().consensus, r_config.Config().consensus
    for r in range(4):
        assert (pc.propose_timeout_ns(r), pc.prevote_timeout_ns(r),
                pc.precommit_timeout_ns(r), pc.wait_for_txs()) == \
            (rc.propose_timeout_ns(r), rc.prevote_timeout_ns(r),
             rc.precommit_timeout_ns(r), rc.wait_for_txs())
    assert p_config.BaseConfig(home="/h").path("config/x") == \
        r_config.BaseConfig(home="/h").path("config/x") == "/h/config/x"
    assert p_config.BaseConfig(home="/h").path("/abs") == "/abs"


BAD = [
    ("base", "db_backend", "leveldbx"),
    ("base", "abci_call_timeout_ns", -1),
    ("base", "abci_call_retries", -1),
    ("base", "signature_cache_size", 0),
    ("rpc", "max_body_bytes", 0),
    ("rpc", "timeout_broadcast_tx_commit_ns", 0),
    ("p2p", "send_rate", -1),
    ("p2p", "max_num_inbound_peers", -1),
    ("mempool", "size", 0),
    ("mempool", "max_tx_bytes", 0),
    ("mempool", "max_txs_bytes", -1),
    ("mempool", "recheck_max_age_blocks", 0),
    ("mempool", "recheck_batch_size", 0),
    ("mempool", "recon_advert_max_ids", 0),
    ("mempool", "recon_want_timeout_ns", 0),
    ("mempool", "recon_push_peers", -1),
    ("mempool", "recon_salt_epoch_blocks", 0),
    ("consensus", "timeout_propose_ns", -1),
    ("consensus", "peer_query_maj23_sleep_duration_ns", -1),
    ("consensus", "create_empty_blocks_interval_ns", -1),
    ("consensus", "adaptive_timeout_floor_ns", 20 * 10**9),
    ("consensus", "compact_block_grace_ns", -1),
    ("consensus", "vote_batch_max", -1),
    ("tx_index", "indexer", "sql"),
    ("instrumentation", "trace_buffer_size", 0),
    ("instrumentation", "trace_anchor_interval_s", 0),
    ("instrumentation", "loop_lag_interval_s", -1),
    ("statesync", "enable", True),
    ("statesync", "*", {"enable": True, "rpc_servers": ["a"]}),
    ("statesync", "*", {"enable": True, "rpc_servers": ["a"],
                        "trust_height": 1, "trust_hash": "zz"}),
    ("statesync", "*", {"enable": True, "rpc_servers": ["a"],
                        "trust_height": 1}),
    ("statesync", "*", {"enable": True, "rpc_servers": ["a"],
                        "trust_height": 1, "trust_hash": "ab",
                        "trust_period_ns": 0}),
    ("instrumentation", "*", {"prometheus": True,
                              "prometheus_listen_addr": ""}),
    ("statesync", "*", {"enable": True, "rpc_servers": ["a"],
                        "trust_height": 1, "trust_hash": "ab"}),
]


def _verdict(mod, section, key, value):
    cfg = mod.Config()
    items = value.items() if key == "*" else [(key, value)]
    for k, v in items:
        setattr(getattr(cfg, section), k, v)
    try:
        mod.validate_basic(cfg)
    except mod.ConfigError as e:
        return str(e)
    return None


@pytest.mark.parametrize("section,key,value", BAD,
                         ids=[f"{s}.{k}-{i}" for i, (s, k, _) in
                              enumerate(BAD)])
def test_validate_basic_gives_the_jax_text(section, key, value):
    mine = _verdict(p_config, section, key, value)
    theirs = _verdict(r_config, section, key, value)
    assert mine == theirs
    if (section, key) != ("statesync", "*") or \
            value.get("trust_hash") != "ab" or "trust_period_ns" in value:
        assert mine is not None
    assert p_config.validate_basic(p_config.Config()) is None


# -- tests/test_confix_grammar.py TestConfix*, in both packages ---------------

def _write(home, overrides):
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    with open(os.path.join(home, "config", "config.json"), "w") as f:
        json.dump(overrides, f)


def _file(home) -> bytes:
    with open(os.path.join(home, "config", "config.json"), "rb") as f:
        return f.read()


def _both(tmp_path, fn):
    """fn(confix, home) in each package on its own home: (port, jax)."""
    out = []
    for name, (_, cx) in PACKAGES.items():
        home = str(tmp_path / name)
        os.makedirs(home, exist_ok=True)
        out.append(fn(cx, home))
    return out


def test_migrate_renames_durations_and_drops(tmp_path):
    def go(cx, home):
        _write(home, {
            "base": {"fast_sync": False, "log_level": "debug"},
            "consensus": {"timeout_propose": "3s",
                          "timeout_prevote": "500ms"},
            "mempool": {"version": "v1", "size": 2000},
            "junk": {"x": 1},
        })
        log = cx.migrate(home)
        cfg = cx.effective_config(home)
        assert cfg.blocksync.enable is False
        assert cfg.consensus.timeout_propose_ns == 3_000_000_000
        assert cfg.consensus.timeout_vote_ns == 500_000_000
        assert cfg.mempool.size == 2000
        assert cx.migrate(home) == []
        return log, _file(home), cx.config_to_dict(cfg)
    mine, theirs = _both(tmp_path, go)
    assert mine[0] == theirs[0]
    assert any("renamed base.fast_sync" in line for line in mine[0])
    assert mine[1] == theirs[1]
    mine[2]["base"].pop("home"), theirs[2]["base"].pop("home")
    assert mine[2] == theirs[2]


def test_dry_run_leaves_file_untouched(tmp_path):
    def go(cx, home):
        _write(home, {"mempool": {"version": "v1"}})
        before = _file(home)
        log = cx.migrate(home, dry_run=True)
        assert log and _file(home) == before
        return log
    mine, theirs = _both(tmp_path, go)
    assert mine == theirs


def test_get_set_diff(tmp_path):
    def go(cx, home):
        cx.set_value(home, "mempool.size", "7000")
        cx.set_value(home, "consensus.timeout_propose_ns", "2s")
        got = (cx.get_value(home, "mempool.size"),
               cx.get_value(home, "consensus.timeout_propose_ns"))
        with pytest.raises(KeyError):
            cx.set_value(home, "mempool.nope", "1")
        with pytest.raises(KeyError):
            cx.get_value(home, "nope.size")
        return got, cx.diff_from_defaults(home), _file(home)
    mine, theirs = _both(tmp_path, go)
    assert mine == theirs
    assert mine[0] == (7000, 2_000_000_000)
    assert mine[1]["mempool"]["size"]["status"] == "changed"


@pytest.mark.parametrize("order", [("timeout_prevote", "timeout_vote_ns"),
                                   ("timeout_vote_ns", "timeout_prevote")])
def test_explicit_key_beats_legacy_alias_any_order(tmp_path, order):
    vals = {"timeout_prevote": "500ms", "timeout_vote_ns": 2_000_000_000}

    def go(cx, home):
        _write(home, {"consensus": {k: vals[k] for k in order}})
        log = cx.migrate(home)
        return log, cx.get_value(home, "consensus.timeout_vote_ns"), \
            _file(home)
    mine, theirs = _both(tmp_path, go)
    assert mine == theirs
    assert mine[1] == 2_000_000_000
    assert any("conflict" in line for line in mine[0])


def test_set_rejects_values_the_node_would_refuse(tmp_path):
    def go(cx, home):
        texts = []
        for key, raw in [("tx_index.indexer", "bogus"),
                         ("mempool.size", '"abc"'),
                         ("rpc.max_body_bytes", "-5"),
                         ("consensus.timeout_vote_ns", "soon")]:
            with pytest.raises(ValueError) as e:
                cx.set_value(home, key, raw)
            texts.append(str(e.value))
        cx.set_value(home, "mempool.size", "123")
        return texts, cx.get_value(home, "mempool.size")
    mine, theirs = _both(tmp_path, go)
    assert mine == theirs
    assert mine[1] == 123


def test_null_section_tolerated(tmp_path):
    def go(cx, home):
        _write(home, {"base": None})
        return cx.effective_config(home).mempool.size
    assert _both(tmp_path, go) == [5000, 5000]


@pytest.mark.parametrize("raw", ["500ms", "3s", "1.5m", "2h", "7", 2.5, True,
                                 "10us", "abc", "5 s"])
def test_parse_duration_equals_the_jax_one(raw):
    assert p_confix.parse_duration_ns(raw) == r_confix.parse_duration_ns(raw)
