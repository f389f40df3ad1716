"""The scrub cell: a node's own ScrubWorker over a store of seeded blocks,
measured over whole passes that all meet the same corruption.

Set-up starts the configuration's nodes in this process, writes the
mix's blocks to node 0 through the node's local write path (and good
copies of the blocks planted bad to node 1), references them as an
object table would, flushes the store to the disk (``os.sync``), and
sets the scrub to tranquility 0, as ``worker set scrub-tranquility 0``
does.  Then the passes run one after another (``run_passes``), each as
``repair scrub start`` asks for one: the planted copies are planted bad
on node 0's disk, the pass runs to its end, and the next pass waits
until node 0 has healed from node 1 every copy that this one set aside.
The first ``warmup_passes`` passes are set-up.  The window opens as the
next pass's copies are planted and closes once the first pass to end
after ``--seconds`` has its heals, so it holds whole passes, their heals
included, and every pass in it meets every planted copy.

The end-to-end metric is the card's time per GiB scrubbed: the union of
every kernel, copy and memset over the window (``torch.profiler``, the
CUDA activity alone in an untraced run), over the bytes of its passes.
The passes' own rate, ``scrub_gibs.window``, a per-layer metric, follows
the host's speed, which drifts between runs by more than any bound can
hold.

Each pass is judged as it ends and settles: every planted copy set aside
and healed with the right content within ``HEAL_WAIT_S``.  Once the
window has closed, node 0's store is judged against the reference:
every copy set aside healed from node 1, no good copy set aside, every
stored file hashing to its name.
"""

from __future__ import annotations

import asyncio
import os
import time
from pathlib import Path
from typing import List, Optional

from ..harness import data, host, profiling, spans
from ..harness.checks import Checks
from ..reference import blocks as ref_blocks
from ..reference import scrub as ref_scrub

FULL = 65536  # the scrub walks two-byte hash prefixes 0 .. 65535
POLL_S = 0.02
RESEND_S = 0.1
# a pass's heals are awaited this long at most: past one resync retry of
# a failed fetch (60 s) in the program
HEAL_WAIT_S = 90.0


class PassTracker:
    """The passes of a ScrubWorker, one at a time: ``start`` asks for
    one, ``poll`` follows it and says when it has ended, that is when
    the worker records its completion (``state.time_last_complete``
    changes).  Each pass keeps the prefix range it judged, read from the
    verified position, when it was asked for and seen to end, and how
    often the command was sent again.

    A command sent as the worker goes idle can lie unseen until its
    ``wait_for_work`` times out (10 s): the wait clears the wake-up that
    the command set.  Until the worker has the pass under way, the
    tracker sends the command again every ``RESEND_S``."""

    def __init__(self, worker):
        self.w = worker
        self.done_mark = worker.state.time_last_complete
        self.passes: List[dict] = []
        self.t_sent = 0.0

    def start(self) -> None:
        self.t_sent = time.perf_counter()
        self.passes.append({"range": [0, 0], "t_start": self.t_sent,
                            "t_end": None, "resent": 0, "under_way": False})
        self.w.send_command("start")

    def poll(self) -> bool:
        """True once the pass asked for last has ended."""
        w, st, p = self.w, self.w.state, self.passes[-1]
        if st.time_last_complete != self.done_mark:
            self.done_mark = st.time_last_complete
            p["range"][1] = FULL
            p["t_end"] = time.perf_counter()
            return True
        if w.iterator is not None:
            p["under_way"] = True
            p["range"][1] = max(p["range"][1], w._verified_pos)
        elif (not p["under_way"]
              and time.perf_counter() - self.t_sent >= RESEND_S):
            self.t_sent = time.perf_counter()
            p["resent"] += 1
            w.send_command("start")
        return False

    def ranges(self, first: int = 0):
        return [tuple(p["range"]) for p in self.passes[first:]
                if p["range"][1] > p["range"][0]]


class Plants:
    """The copies planted bad on node 0, the same ones before every pass.

    A planted block goes round: healed (a good copy under its name; each
    is one at the start), planted (one byte of it flipped, its inode
    noted), set aside (that inode under ``.corrupted``), healed again (a
    new file under its name that hashes to it, by the reference).
    ``plant`` and ``look`` touch the disk and run in a thread, never on
    the nodes' event loop, and only between passes: beside a pass the
    harness only reads the worker's state and the nodes' timelines."""

    def __init__(self, root: str, digests: List[bytes], planted: dict):
        self.items = []
        for i, frac in sorted(planted.items()):
            hx = digests[i].hex()
            self.items.append({
                "base": os.path.join(root, hx[:2], hx[2:4], hx),
                "frac": frac, "stage": "healed", "path": None, "ino": None})
        self.per_pass: List[dict] = []

    @staticmethod
    def _current(base: str):
        for p in (base, base + ".zst"):
            try:
                return p, os.stat(p)
            except FileNotFoundError:
                pass
        return None, None

    def plant(self) -> int:
        """Before a pass: every healed copy planted bad; returns the
        copies planted for the pass."""
        for it in self.items:
            if it["stage"] == "healed":
                it["path"], s = self._current(it["base"])
                it["ino"] = s.st_ino
                flip_byte(it["path"], it["frac"])
                it["stage"] = "planted"
        return self.count("planted")

    def look(self) -> None:
        """Moves each planted copy that the scrub has set aside to
        ``aside``, and each copy set aside that node 0 has replaced to
        ``healed`` (or ``bad``, where the new file does not hash to its
        name)."""
        for it in self.items:
            if it["stage"] == "planted":
                try:
                    s = os.stat(it["path"] + ".corrupted")
                except FileNotFoundError:
                    s = None
                if s is not None and s.st_ino == it["ino"]:
                    it["stage"] = "aside"
            if it["stage"] == "aside":
                path, s = self._current(it["base"])
                if s is not None and s.st_ino != it["ino"]:
                    it["path"], it["ino"] = path, s.st_ino
                    it["stage"] = ("healed" if ref_blocks.file_content_ok(path)
                                   else "bad")

    def count(self, stage: str) -> int:
        return sum(1 for it in self.items if it["stage"] == stage)

    async def settle(self, planted: int, wait_s: float, tick=None) -> dict:
        """After a pass: what it set aside and missed, then the heals,
        awaited for ``wait_s`` at most (``tick`` called at each look); a
        copy not healed by then is ``late`` and never planted again."""
        t0 = time.perf_counter()
        await asyncio.to_thread(self.look)
        missed = self.count("planted")
        look_s = time.perf_counter() - t0
        while self.count("aside") and time.perf_counter() - t0 < wait_s:
            await asyncio.sleep(POLL_S)
            if tick is not None:
                tick()
            t = time.perf_counter()
            await asyncio.to_thread(self.look)
            look_s = time.perf_counter() - t
        late = self.count("aside")
        for it in self.items:
            if it["stage"] == "aside":
                it["stage"] = "late"
        rec = {"planted": planted, "set_aside": planted - missed,
               "missed": missed, "healed": self.count("healed"),
               "late": late, "bad": self.count("bad"),
               "heal_wait_s": time.perf_counter() - t0,
               "last_look_s": look_s}
        self.per_pass.append(rec)
        return rec

    def unhealed(self) -> int:
        return self.count("late") + self.count("bad")


def bytes_in(ranges, prefixes, sizes) -> int:
    return sum(s for p, s in zip(prefixes, sizes)
               for lo, hi in ranges if lo <= p < hi)


def flip_byte(path: str, frac: float) -> None:
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        off = min(int(frac * f.tell()), f.tell() - 1)
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


async def bounded(coros, width: int = 16):
    sem = asyncio.Semaphore(width)

    async def one(c):
        async with sem:
            return await c
    return await asyncio.gather(*[one(c) for c in coros])


async def wait_until(cond, timeout: float, dt: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(dt)
    return True


async def run_passes(track: PassTracker, plants: Plants,
                     n: Optional[int] = None, until: Optional[float] = None,
                     drain=None) -> None:
    """Whole passes one after another, each meeting every planted copy:
    the copies planted, the pass asked for and followed to its end, its
    heals awaited.  Stops after ``n`` passes, or once the first pass to
    end at or after ``until`` (``perf_counter``) has settled."""
    for _ in range(n if n is not None else 1 << 30):
        t0 = time.perf_counter()
        planted = await asyncio.to_thread(plants.plant)
        plant_s = time.perf_counter() - t0
        track.start()
        while not track.poll():
            await asyncio.sleep(POLL_S)
            if drain is not None:
                drain.poll()
        rec = await plants.settle(planted, HEAL_WAIT_S,
                                  drain.poll if drain is not None else None)
        rec["plant_s"] = plant_s
        if until is not None and track.passes[-1]["t_end"] >= until:
            return


async def run(ctx) -> dict:
    from garage_tpu_torch.block.block import DataBlock
    from garage_tpu_torch.utils.data import Hash

    from ..harness import inproc

    t = ctx.traffic
    level = ctx.config["garage"].get("compression_level")
    nodes = await inproc.start(ctx.config, Path(ctx.tmp), ctx.device)
    try:
        m0, m1 = nodes[0].block_manager, nodes[1].block_manager
        # 1. the store, its digests by the reference, written through
        # node 0's local write path
        size = int(ctx.config["garage"]["block_size"])
        store = data.BlockStore(ctx.seed, int(ctx.config["store_bytes"]) // size,
                                size, t)
        digests = ref_blocks.digests(store.blocks)
        planted = set(store.planted)

        def block(i):
            raw = bytes(store.blocks[i])
            return (DataBlock.from_buffer(raw, level)
                    if i in store.compressible else DataBlock.plain(raw))

        await bounded([m0.write_block(Hash(digests[i]), block(i))
                       for i in range(len(store))])
        await bounded([m1.write_block(Hash(digests[i]), block(i))
                       for i in planted])
        m0.db.transaction(lambda tx: [m0.rc.block_incref(tx, Hash(d))
                                      for d in digests])
        m1.db.transaction(lambda tx: [m1.rc.block_incref(tx, Hash(digests[i]))
                                      for i in planted])
        root0 = str(Path(ctx.tmp) / "n0" / "data")
        worker = nodes[0].scrub_worker
        plants = Plants(root0, digests, store.planted)
        if ctx.fault is not None:
            ctx.fault(nodes)
        await wait_until(lambda: m0.resync.queue_len() == 0
                         and m1.resync.queue_len() == 0, 60)
        # the store on the disk before the first pass: else the host's
        # writeback of its 2 GiB runs on into the passes and slows their
        # reads for some tens of seconds
        await asyncio.to_thread(os.sync)

        # 2. warm-up: the first whole passes with their heals
        worker.set_tranquility(0)
        track = PassTracker(worker)
        await run_passes(track, plants, n=int(t["warmup_passes"]))

        # 3. the window: whole passes with their heals, until the first
        # pass to end after --seconds has settled
        feeder, obs = m0.feeder, m0.codec.obs
        # the card's time over the window in every run on the card: the
        # whole trace of a traced run, the CUDA activity alone otherwise
        prof = None
        if ctx.device == "cuda":
            out_path = os.path.join(ctx.tmp, "trace.json")
            prof = (profiling.Window(out_path) if ctx.trace
                    else profiling.CardTime(out_path))
            prof.start()
        # the program's spans over the window: the per-layer metrics of a
        # traced run, and the load governor's pauses in every run's notes
        drain = spans.Drain([g.block_manager.codec.obs.timeline
                             for g in nodes])
        drain.open()
        before = (feeder.stats(), dict(obs.bytes_total))
        heals0 = sum(m0.heal_counts.values())
        ctx.host["load1"] = host.load1()
        first = len(track.passes)
        t_open = time.perf_counter()
        setup_s = t_open - ctx.t_process
        await run_passes(track, plants, until=t_open + ctx.seconds, drain=drain)
        window_s = time.perf_counter() - t_open
        heals_in_window = sum(m0.heal_counts.values()) - heals0
        if prof:
            prof.stop()
        drain.poll()
        after = (feeder.stats(), dict(obs.bytes_total))
        memory = ctx.memory_peak()

        red, card_ms_per_gib = None, None
        prefixes = [ref_scrub.prefix(d) for d in digests]
        window_bytes = bytes_in(track.ranges(first), prefixes, store.sizes)
        if prof:
            red = (profiling.reduce([prof.out_path]) if ctx.trace
                   else profiling.card_time(prof.out_path))
            if red["device_events"] and window_bytes:
                card_ms_per_gib = 1e3 * red["busy_s"] / (window_bytes / 2**30)
        scrub_gibs = window_bytes / window_s / 2**30

        # 4. node 0 judged against the reference
        ranges = track.ranges()
        reached_bad = ref_scrub.covered([digests[i] for i in planted], ranges)
        present, quarantined, other = ref_blocks.walk_store(root0)
        bad_planted = {digests[i] for i in planted}
        unreached_bad = {d.hex() for d in bad_planted - reached_bad}
        files = [p for hx, ps in present.items() if hx not in unreached_bad
                 for p in ps]
        bad = ref_blocks.bad_files(files)
        healed_ok = {hx for hx in present} - {
            os.path.basename(p).partition(".")[0] for p in bad}
        counts = ref_scrub.judge(digests, bad_planted, ranges, present,
                                 quarantined, healed_ok)
        present1, _q1, _o1 = ref_blocks.walk_store(
            str(Path(ctx.tmp) / "n1" / "data"))
        bad1 = ref_blocks.bad_files(p for ps in present1.values() for p in ps)

        checks = Checks()
        checks.at_least("verdicts", counts["verdicts"], 1)
        checks.at_most("missed_corruptions", counts["missed_corruptions"], 0)
        checks.at_most("false_quarantines", counts["false_quarantines"], 0)
        checks.at_most("unhealed", counts["unhealed"], 0)
        checks.at_most("missing_blocks", counts["missing_blocks"], 0)
        checks.at_most("bad_files", len(bad) + len(bad1) + len(other), 0)
        # pass by pass: each planted copy set aside by every pass, and
        # healed from node 1 with the right content before the next
        checks.at_most("missed_in_a_pass",
                       sum(p["missed"] for p in plants.per_pass), 0)
        checks.at_most("unhealed_in_a_pass", plants.unhealed(), 0)

        passes, settled = track.passes[first:], plants.per_pass[first:]
        out = {
            "attempted": counts["verdicts"],
            "failed": counts["missed_corruptions"] + counts["false_quarantines"],
            "metrics": {"scrub_card_ms_per_gib": card_ms_per_gib,
                        "setup_s": setup_s},
            "checks": checks, "memory_peak_bytes": memory,
            "notes": {"scrub_gibs": scrub_gibs,
                      "card_ms_per_gib": card_ms_per_gib,
                      "card_busy_s": red["busy_s"] if red else None,
                      "passes": len(track.passes),
                      "window_passes": len(passes),
                      "window_s": window_s,
                      "pass_s": [p["t_end"] - p["t_start"] for p in passes],
                      "heal_wait_s": [p["heal_wait_s"] for p in settled],
                      "planted_per_pass": [p["planted"] for p in settled],
                      "set_aside_per_pass": [p["set_aside"] for p in settled],
                      "healed_per_pass": [p["healed"] for p in settled],
                      # the harness's own time between passes: planting,
                      # and the look that found the last heal
                      "harness_ms_per_pass": [
                          1e3 * (p["plant_s"] + p["last_look_s"])
                          for p in settled],
                      "heals_in_window": heals_in_window,
                      "start_resent": sum(p["resent"] for p in passes),
                      "planted_reached": counts["planted_reached"],
                      "window_blocks": window_bytes / 2**20,
                      "throttle_s": spans.throttle_seconds(
                          (drain.spans() or [[]])[0])},
            "obs": {"feeder": (before[0], after[0]),
                    "bytes_by_side": (before[1], after[1]),
                    "window_gibs": scrub_gibs},
        }
        if prof and ctx.trace:
            out["trace"] = red
            out["obs"]["trace"] = red
            out["obs"]["trace_bytes_by_side"] = out["obs"]["bytes_by_side"]
            sp = drain.result(prof.out_path, (prof.t0, prof.t1))
            if sp is not None:
                out["obs"]["spans"] = sp
                out["notes"]["spans"] = {k: sp[k] for k in (
                    "dropped", "events", "metrics", "throttle_s")}
                out["notes"]["idle_by_span"] = sp["idle_by_span"][:12]
        return out
    finally:
        await inproc.stop(nodes)
