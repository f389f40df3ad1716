"""Faults planted underneath a run, and the controls, for the tests.

A scrub fault is a function given the cell's in-process nodes after
set-up; an S3 fault is a file that each daemon runs before it serves
(``node.py --fault``).  None of them is ever used by a benchmark run.
"""

import asyncio
from pathlib import Path

HERE = Path(__file__).resolve().parent


def scrub_step_unchanged(nodes):
    """The scrub step returns without looking at its batch."""
    w = nodes[0].scrub_worker

    async def scrub_batch(batch, reads=None):
        return None
    w.scrub_batch = scrub_batch


def scrub_half_batch(nodes):
    """Half of each batch left out (rounded down): a one-block batch
    verifies nothing."""
    w = nodes[0].scrub_worker
    orig = w.scrub_batch

    async def scrub_batch(batch, reads=None):
        half = len(batch) // 2
        if half:
            await orig(batch[:half], None if reads is None else reads[:half])
    w.scrub_batch = scrub_batch


def scrub_verdicts_flipped(nodes):
    """Every verdict altered where the codec produces it."""
    feeder = nodes[0].block_manager.feeder
    orig = feeder.scrub_async

    async def scrub_async(blocks, hashes, want_parity):
        ok, parity = await orig(blocks, hashes, want_parity)
        return [not x for x in ok], parity
    feeder.scrub_async = scrub_async


def scrub_control_verify_nothing(nodes):
    """The control: a scrub whose codec accepts every block, breaking
    the configuration's integrity guarantee."""
    feeder = nodes[0].block_manager.feeder
    orig = feeder.scrub_async

    async def scrub_async(blocks, hashes, want_parity):
        ok, parity = await orig(blocks, hashes, want_parity)
        return [True] * len(ok), parity
    feeder.scrub_async = scrub_async


SCRUB_FAULTS = {
    "step_unchanged": scrub_step_unchanged,
    "half_batch": scrub_half_batch,
    "answer_altered": scrub_verdicts_flipped,
}

S3_FAULTS = {
    "step_unchanged": str(HERE / "s3_put_stores_nothing.py"),
    "answer_altered": str(HERE / "s3_get_altered.py"),
}

def s3_control(garage: dict) -> dict:
    """The S3 cells' control, as keys over the configuration's: where it
    states replicas, one copy per block (quorum 1); where it states an
    erasure code, no parity placed on other nodes."""
    codec = garage.get("codec", {})
    if codec.get("parity_distribute"):
        return {"codec": dict(codec, parity_distribute=False)}
    return {"replication_mode": "1"}
