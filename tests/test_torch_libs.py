"""The port's small libraries against the JAX package's:

  * ``crypto/armor.py``: armored text byte-equal for seeded data and
    headers, round trips, and the same ``ArmorError`` texts for a missing
    BEGIN line, a mismatched END line, a bad body and a CRC24 mismatch;
  * ``libs/service.py``: the same lifecycle and the same
    ``AlreadyStartedError`` / ``AlreadyStoppedError`` texts;
  * ``libs/protoio.py``: the same frames, and the same errors for torn,
    overlong and oversized length prefixes;
  * ``libs/health.py``: the loop-lag family renders as the JAX one, and
    the sampler observes a stalled loop;
  * ``libs/pprof.py``: every route over a real socket, with the JAX
    texts where the JAX server answers the same.

Equality is exact.
"""
import asyncio
import random

import pytest

from cometbft_tpu.crypto import armor as r_armor
from cometbft_tpu.libs import health as r_health
from cometbft_tpu.libs import metrics as r_metrics
from cometbft_tpu.libs import pprof as r_pprof
from cometbft_tpu.libs import protoio as r_protoio
from cometbft_tpu.libs import service as r_service
from cometbft_tpu_torch.crypto import armor
from cometbft_tpu_torch.libs import health
from cometbft_tpu_torch.libs import metrics
from cometbft_tpu_torch.libs import pprof
from cometbft_tpu_torch.libs import protoio
from cometbft_tpu_torch.libs import service
from cometbft_tpu_torch.libs.log import nop_logger
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- armor ---------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 2, 3, 47, 48, 49, 64, 1000])
def test_armor_text_equals_the_jax_one_and_round_trips(size):
    rng = random.Random(size)
    data = bytes(rng.randrange(256) for _ in range(size))
    headers = {"kdf": "bcrypt", "salt": data[:8].hex().upper(),
               "type": "ed25519"} if size % 2 else {}
    text = armor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
    assert text == r_armor.encode_armor("TENDERMINT PRIVATE KEY", headers,
                                        data)
    assert armor.decode_armor(text) == r_armor.decode_armor(text) == \
        ("TENDERMINT PRIVATE KEY", headers, data)
    assert armor._crc24(data) == r_armor._crc24(data)


def _bad_armors():
    good = armor.encode_armor("BLOCK", {"a": "b"}, b"payload bytes")
    lines = good.splitlines()
    return [
        "no armor here",
        good.replace("-----END BLOCK-----", "-----END OTHER-----"),
        good.replace(lines[3], lines[3][:-2] + "!!"),
        good.replace(lines[-2], "=AAAA"),
    ]


@pytest.mark.parametrize("i", range(4))
def test_armor_errors_equal_the_jax_ones(i):
    text = _bad_armors()[i]
    with pytest.raises(armor.ArmorError) as mine:
        armor.decode_armor(text)
    with pytest.raises(r_armor.ArmorError) as theirs:
        r_armor.decode_armor(text)
    assert str(mine.value) == str(theirs.value)


# -- service -------------------------------------------------------------------

def _lifecycle(mod):
    events = []

    class Svc(mod.Service):
        async def on_start(self):
            events.append("start")
            self.spawn(asyncio.sleep(3600), name="idle")

        async def on_stop(self):
            events.append("stop")

    class Failing(mod.Service):
        async def on_start(self):
            raise ValueError("cannot start")

    async def go():
        svc = Svc("svc")
        out = [svc.name, svc.is_running]
        await svc.start()
        out.append(svc.is_running)
        try:
            await svc.start()
        except mod.AlreadyStartedError as e:
            out.append(("started", str(e)))
        waiter = asyncio.ensure_future(svc.wait())
        await svc.stop()
        await svc.stop()                # idempotent
        await asyncio.wait_for(waiter, 1.0)
        out.append((svc.is_running, len(svc._tasks)))
        try:
            await Svc("svc").start()
            s2 = Svc("again")
            await s2.stop()
            await s2.start()
        except mod.AlreadyStoppedError as e:
            out.append(("stopped", str(e)))
        bad = Failing()
        try:
            await bad.start()
        except ValueError as e:
            out.append((str(e), bad._started, bad.name))
        return out, events
    return run(go())


def test_service_lifecycle_and_texts_equal_the_jax_ones():
    mine, theirs = _lifecycle(service), _lifecycle(r_service)
    assert mine == theirs
    assert mine[0] == ["svc", False, True, ("started", "svc"),
                       (False, 0), ("stopped", "again"),
                       ("cannot start", False, "Failing")]


def test_nop_logger_drops_everything(caplog):
    log = nop_logger()
    log.error("dropped", k=1)
    assert not caplog.records


# -- protoio -------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 127, 128, 300, 70_000])
def test_protoio_frames_equal_the_jax_ones(size):
    payload = bytes(i % 251 for i in range(size))
    frame = protoio.write_delimited(payload)
    assert frame == r_protoio.write_delimited(payload)

    async def read(mod):
        reader = asyncio.StreamReader()
        reader.feed_data(frame + frame)
        reader.feed_eof()
        return [await mod.read_delimited(reader, 1 << 20, ValueError)
                for _ in range(3)]
    assert run(read(protoio)) == run(read(r_protoio)) == \
        [payload, payload, None]


@pytest.mark.parametrize("data, text", [
    (b"\x80", "EOF inside length prefix"),
    (b"\xff" * 11, "length prefix too long"),
    (b"\x81\x80\x40", "message too large: 1048577"),
])
def test_protoio_errors_equal_the_jax_ones(data, text):
    class FrameError(Exception):
        pass

    for mod in (protoio, r_protoio):
        async def read():
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            return await mod.read_delimited(reader, 1 << 20, FrameError)
        with pytest.raises(FrameError, match=f"^{text}$"):
            run(read())


# -- health --------------------------------------------------------------------

def test_loop_lag_family_renders_as_the_jax_one():
    mine, theirs = metrics.Registry(), r_metrics.Registry()
    hm, hr = health.Metrics(mine), r_health.Metrics(theirs)
    for v in (0.0, 0.0004, 0.003, 0.02, 0.3, 4.0):
        hm.event_loop_lag_seconds.observe(v)
        hr.event_loop_lag_seconds.observe(v)
    assert mine.render() == theirs.render()
    assert hm.event_loop_lag_seconds.quantile(0.95) == \
        hr.event_loop_lag_seconds.quantile(0.95)


def test_loop_lag_sampler_sees_a_stalled_loop():
    import time
    m = health.Metrics(metrics.Registry())

    async def go():
        task = asyncio.ensure_future(
            health.LoopLagSampler(m, interval_s=0.01).run())
        await asyncio.sleep(0.05)
        time.sleep(0.06)                # a blocking call on the loop
        await asyncio.sleep(0.05)
        task.cancel()
    run(go())
    hist = m.event_loop_lag_seconds
    assert hist.count >= 3
    assert hist.quantile(1.0) >= 0.025
    assert health.LoopLagSampler(m, interval_s=0).interval_s == 0.001


# -- pprof ---------------------------------------------------------------------

async def _get(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0].decode(), body.decode()


async def _pprof_answers(mod, targets):
    srv = mod.PprofServer("127.0.0.1:0")
    await srv.start()
    port = int(srv.listen_addr.rsplit(":", 1)[1])
    try:
        return [await _get(port, t) for t in targets]
    finally:
        await srv.stop()


def test_pprof_routes():
    targets = ["/debug/pprof/", "/debug/pprof/tasks",
               "/debug/pprof/threads", "/debug/pprof/heap",
               "/debug/pprof/profile?seconds=0.05", "/debug/pprof/trace",
               "/nope"]
    got = dict(zip(targets, run(_pprof_answers(pprof, targets))))
    assert all(status == "HTTP/1.1 200 OK" for status, _ in
               [got[t] for t in targets[:-1]])
    assert got["/nope"] == ("HTTP/1.1 404 Not Found", "")
    assert got["/debug/pprof/"][1] == pprof._INDEX
    assert got["/debug/pprof/tasks"][1].startswith("asyncio tasks: ")
    assert "--- thread MainThread" in got["/debug/pprof/threads"][1]
    assert "function calls" in got["/debug/pprof/profile?seconds=0.05"][1]
    assert '"events"' in got["/debug/pprof/trace"][1]


def test_pprof_texts_equal_the_jax_ones():
    """The heap route without tracemalloc and the 404 answer as the JAX
    server's; the index lists the same routes."""
    targets = ["/debug/pprof/heap", "/missing"]
    mine = run(_pprof_answers(pprof, targets))
    theirs = run(_pprof_answers(r_pprof, targets))
    # past the first line, the gc counts
    assert [(s, b.partition("\n")[2]) for s, b in mine] == \
        [(s, b.partition("\n")[2]) for s, b in theirs]
    routes = {ln.split()[0] for ln in pprof._INDEX.splitlines()
              if ln.startswith("/")}
    assert routes == {ln.split()[0] for ln in r_pprof._INDEX.splitlines()
                      if ln.startswith("/")}
