"""Process driver for the port's fail-point crash-consistency sweep.

Runs a single-validator ``cometbft_tpu_torch.node.Node`` at HOME until
it has committed TARGET_HEIGHT, then exits 0 (1 if it never gets there
or the node fails).  With FAIL_TEST_INDEX set, the node hard-crashes
(exit 99) at that commit-path boundary instead
(cometbft_tpu_torch/libs/fail.py).

    python tests/torch_crash_driver.py HOME TARGET_HEIGHT

The node runs on ``$COMETBFT_TPU_TORCH_CRASH_DEVICE`` (unset: the card).
A single validator's commits hold one signature each, which the port
verifies on the host, so B1 does not launch here.  On a clean exit
the driver prints one JSON line: the seconds ``Node.start()`` took, the
seconds to the target, the height and this process's B1 launches and
lanes.  This module imports only the port.
"""
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEVICE_ENV = "COMETBFT_TPU_TORCH_CRASH_DEVICE"


def _count_lanes(ek) -> list:
    """Wrap B1's wrapper so each call adds its lanes to the returned
    one-item list."""
    lanes = [0]
    real = ek.verify_cols

    def verify_cols(a, r, s, k):
        lanes[0] += int(a.shape[1])
        return real(a, r, s, k)

    ek.verify_cols = verify_cols
    return lanes


async def main(home: str, target: int) -> int:
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.timestamp import Timestamp

    lanes = _count_lanes(ek)
    cfg = Config()
    cfg.base.home = home
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = ""
    cfg.consensus.timeout_commit_ns = 20_000_000
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    key_file = cfg.base.path(cfg.base.priv_validator_key_file)
    pv = FilePV.load_or_generate(
        key_file, cfg.base.path(cfg.base.priv_validator_state_file))
    NodeKey.load_or_gen(cfg.base.path(cfg.base.node_key_file))
    gen_file = cfg.base.path(cfg.base.genesis_file)
    if not os.path.exists(gen_file):
        doc = GenesisDoc(
            chain_id="crash-chain", genesis_time=Timestamp(1700000000, 0),
            validators=[GenesisValidator(address=b"",
                                         pub_key=pv.get_pub_key(),
                                         power=10)])
        doc.save_as(gen_file)

    t0 = time.monotonic()
    node = Node(cfg, device=os.environ.get(DEVICE_ENV) or None)
    await node.start()
    start_s = time.monotonic() - t0
    for _ in range(2000):
        node.raise_if_failed()
        if node.height >= target:
            await node.stop()
            print(json.dumps({
                "start_s": round(start_s, 3),
                "run_s": round(time.monotonic() - t0 - start_s, 3),
                "height": node.height, "b1_launches": ek.launches,
                "b1_lanes": lanes[0]}), flush=True)
            return 0
        await asyncio.sleep(0.02)
    await node.stop()
    return 1


if __name__ == "__main__":
    sys.exit(asyncio.run(main(sys.argv[1], int(sys.argv[2]))))
