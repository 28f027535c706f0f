"""The port's WAL (consensus/wal.py) against the JAX package's.

  * the same records (timeouts, round states, messages, end-height
    barriers) written by both packages give byte-identical files, and
    each package reads the other's back record for record;
  * rotation at a small head limit gives the same group of files in both
    packages, pruned to the same total, and ``iter_group`` /
    ``search_for_end_height`` of either package read either group;
  * a torn tail: both packages stop at the same frame, refuse it when
    strict, ``repair_wal_file`` cuts the same bytes (a ``.corrupted``
    stash beside it), and a WAL reopened after a torn write appends
    behind the last good frame; mid-file corruption is an error in both.
"""
import json
import os
import shutil

import numpy as np
import pytest

from cometbft_tpu.consensus import wal as r_wal
from cometbft_tpu_torch.consensus import messages as pm
from cometbft_tpu_torch.consensus import wal as p_wal
from cometbft_tpu_torch.consensus.round_state import STEP_PREVOTE
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _records(heights=3, votes=4, seed=321):
    """What a node logs: a height's timeout, round states, votes (as the
    receive routine's to_wal gives them) and its end-height barrier."""
    rng = np.random.default_rng(seed)
    out = []
    for h in range(1, heights + 1):
        out.append({"type": "timeout", "height": h, "round": 0, "step": 1})
        out.append({"type": "round_state", "height": h, "round": 0,
                    "step": "NewRound"})
        bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
        for i in range(votes):
            v = Vote(type=1, height=h, round=0, block_id=bid,
                     timestamp=Timestamp(1_700_000_000 + h, i),
                     validator_address=rng.bytes(20), validator_index=i,
                     signature=rng.bytes(64))
            out.append(pm.VoteMessage(v).to_wal())
        out.append({"type": "round_state", "height": h, "round": 0,
                    "step": "Prevote"})
        out.append({"type": "end_height", "height": h})
    return out


def _write(mod, path, records, **kw):
    w = mod.WAL(str(path), **kw)
    for rec in records:
        if rec["type"] == "end_height":
            w.write_end_height(rec["height"])
        elif rec["type"] == "timeout":
            w.write_sync(rec)
        else:
            w.write(rec)
    w.close()


def _group_bytes(mod, path):
    return [(os.path.basename(f), open(f, "rb").read())
            for f in mod.WAL.group_files(str(path))]


def test_same_records_give_identical_files(tmp_path):
    recs = _records()
    _write(p_wal, tmp_path / "p" / "wal", recs)
    _write(r_wal, tmp_path / "r" / "wal", recs)
    mine = (tmp_path / "p" / "wal").read_bytes()
    assert mine == (tmp_path / "r" / "wal").read_bytes()
    assert list(p_wal.WAL.iter_messages(str(tmp_path / "r" / "wal"))) == \
        recs == list(r_wal.WAL.iter_messages(str(tmp_path / "p" / "wal")))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_group(tmp_path, writer):
    recs = _records(heights=6, votes=10)
    mod, other = (p_wal, r_wal) if writer == "port" else (r_wal, p_wal)
    path = tmp_path / "wal"
    _write(mod, path, recs, head_size_limit=2048, total_size_limit=10**9)
    assert len(mod.WAL.group_files(str(path))) > 3
    assert list(other.WAL.iter_group(str(path))) == recs
    for h in range(0, 8):
        assert other.WAL.search_for_end_height(str(path), h) == \
            mod.WAL.search_for_end_height(str(path), h)
    tail = other.WAL.search_for_end_height(str(path), 4)
    assert tail[0] == {"type": "timeout", "height": 5, "round": 0,
                       "step": 1}
    assert tail[-1] == {"type": "end_height", "height": 6}
    assert other.WAL.search_for_end_height(str(path), 9) is None


def test_rotation_and_pruning_equal(tmp_path):
    recs = _records(heights=8, votes=12)
    kw = dict(head_size_limit=3000, total_size_limit=9000)
    _write(p_wal, tmp_path / "p" / "wal", recs, **kw)
    _write(r_wal, tmp_path / "r" / "wal", recs, **kw)
    mine = _group_bytes(p_wal, tmp_path / "p" / "wal")
    assert mine == _group_bytes(r_wal, tmp_path / "r" / "wal")
    assert 2 < len(mine)
    assert sum(len(b) for _, b in mine[:-1]) <= 9000
    # the oldest files were pruned: the group starts past height 1
    first = next(p_wal.WAL.iter_group(str(tmp_path / "p" / "wal")))
    assert first.get("height", 0) > 1


def _torn(tmp_path, name):
    recs = _records()
    path = tmp_path / name / "wal"
    _write(p_wal, path, recs)
    good = path.read_bytes()
    torn = good + p_wal._frame(json.dumps({"type": "x"}).encode())[:9]
    path.write_bytes(torn)
    return path, recs, good, torn


def test_torn_tail_read_and_repair_equal(tmp_path):
    path, recs, good, torn = _torn(tmp_path, "a")
    assert list(p_wal.WAL.iter_messages(str(path))) == recs == \
        list(r_wal.WAL.iter_messages(str(path)))
    for mod in (p_wal, r_wal):
        with pytest.raises(mod.CorruptWALError, match="truncated frame"):
            list(mod.WAL.iter_messages(str(path), strict=True))
    twin = tmp_path / "b" / "wal"
    twin.parent.mkdir()
    shutil.copy(path, twin)
    assert p_wal.repair_wal_file(str(path)) == \
        r_wal.repair_wal_file(str(twin)) == len(torn) - len(good)
    assert path.read_bytes() == twin.read_bytes() == good
    assert (tmp_path / "a" / "wal.corrupted").read_bytes() == torn
    assert list(r_wal.WAL.iter_messages(str(path), strict=True)) == recs


def test_reopen_after_a_torn_write_appends_behind_the_good_frames(tmp_path):
    path, recs, good, torn = _torn(tmp_path, "a")
    w = p_wal.WAL(str(path))
    w.write_end_height(99)
    w.close()
    assert list(r_wal.WAL.iter_messages(str(path), strict=True)) == \
        recs + [{"type": "end_height", "height": 99}]
    assert (tmp_path / "a" / "wal.corrupted").read_bytes() == \
        torn[len(good):]


def test_mid_file_corruption_is_an_error_in_both(tmp_path):
    recs = _records()
    path = tmp_path / "wal"
    _write(p_wal, path, recs)
    data = bytearray(path.read_bytes())
    data[20] ^= 0xFF                       # inside the first payload
    path.write_bytes(bytes(data))
    errors = []
    for mod in (p_wal, r_wal):
        with pytest.raises(mod.CorruptWALError) as e:
            list(mod.WAL.iter_messages(str(path)))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "crc mismatch at offset 0"


def test_message_too_big_and_nil_wal(tmp_path):
    w = p_wal.WAL(str(tmp_path / "wal"))
    big = {"type": "x", "blob": "a" * p_wal.MAX_MSG_SIZE_BYTES}
    with pytest.raises(p_wal.WALError) as e1:
        w.write(big)
    w.close()
    rw = r_wal.WAL(str(tmp_path / "rwal"))
    with pytest.raises(r_wal.WALError) as e2:
        rw.write(big)
    rw.close()
    assert str(e1.value) == str(e2.value)
    nil = p_wal.NilWAL()
    nil.write({"type": "x"})
    nil.write_sync({"type": "x"})
    nil.write_end_height(1)
    nil.flush_and_sync()
    nil.close()
    assert nil.path == ""
    assert p_wal.WAL.search_for_end_height(str(tmp_path / "none"), 1) is None
    assert STEP_PREVOTE == 4
