"""S3 cells: the deployment's daemons, an open loop of signed requests to
node 0's S3 endpoint.

Set-up builds the program's kernels and native libraries once (in the
parent, before any daemon starts), starts one daemon per node, sets the
cluster up through the port's CLI, writes the mix's objects, runs one
scrub pass on every node (``repair scrub`` at tranquility 0), and warms
each operation up.  The scrub pass is what opens the hybrid codec's
device gate: only background batches probe the link, and for 120 s after
a probe the foreground's hashes, encodes and decodes may go to the card;
without it every foreground codec call of the window runs on the CPU.  The window sends the mix's requests at their due
times (``harness/openloop.py``); each latency runs from its due time.
After the window every read is judged against what the client's own
record of writes allows (``reference/reads.py``), every key is read
back once more, the daemons are stopped and every block file on every
node is hashed and counted against the replicas each acknowledged write
was promised.

The mix (``traffic/<name>.json``) sets: ``ops`` (each operation's share),
``keys`` (``zipfian`` with ``zipf_constant`` or ``uniform`` over the
configuration's ``recordcount`` objects, written in set-up; or ``new``,
a key of its own for every PUT), ``object_bytes``, ``rate_per_s``,
``preload_concurrency``, ``warmup_requests``, ``timeout_s``,
``kill_nodes`` (after set-up, SIGKILL that many daemons other than node
0, those holding the most block files, and leave the layout as it is)
and ``metrics`` (each end-to-end metric's name and the operation whose
95th percentile it is).  Where the configuration states an erasure code,
every codeword the nodes list is also held to the reference's parity.
"""

from __future__ import annotations

import asyncio
import hashlib
import math
import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..harness import data, openloop, profiling, promtext
from ..harness.checks import Checks
from ..reference import blocks as ref_blocks
from ..reference import codewords as ref_codewords
from ..reference import reads as ref_reads

BUCKET = "bench"


def zipf_ranks(g: np.random.Generator, n_items: int, n: int, theta: float) -> np.ndarray:
    """YCSB's Zipfian request distribution: rank i (from 1) with
    probability proportional to 1 / i^theta."""
    p = 1.0 / np.arange(1, n_items + 1) ** theta
    return g.choice(n_items, size=n, p=p / p.sum())


def plan(seed: int, t: dict, n_keys: int, seconds: float) -> dict:
    """Due times, operations, keys and payloads of one run: the same
    counts for every seed, in another order and with other bytes."""
    g = data.rng(seed, 2)
    dues = openloop.due_times(g, float(t["rate_per_s"]), seconds)
    n = len(dues)
    ops: List[str] = []
    for op, share in sorted(t["ops"].items()):
        ops += [op] * int(round(share * n))
    ops = (ops + [max(t["ops"], key=t["ops"].get)] * n)[:n]
    g.shuffle(ops)
    if t["keys"] == "new":
        n_keys = 0
    names = [f"obj/{i:06d}" for i in g.permutation(n_keys)]
    if t["keys"] == "zipfian":
        keys = [names[r] for r in zipf_ranks(g, n_keys, n, float(t["zipf_constant"]))]
    elif t["keys"] == "uniform":
        keys = [names[int(i)] for i in g.integers(0, n_keys, n)]
    else:
        keys = [f"new/{i:06d}" for i in range(n)]
    n_put = sum(op == "put" for op in ops)
    size = int(t["object_bytes"])
    n_warm = int(t["warmup_requests"])
    # payloads: the preloaded versions, the warm-up's and the window's
    pool = data.payloads(seed, 3, n_keys + n_warm + n_put, size)
    bodies = [bytes(pool[i * size:(i + 1) * size])
              for i in range(n_keys + n_warm + n_put)]
    return {"dues": dues, "ops": ops, "keys": keys, "names": sorted(names),
            "bodies": bodies, "n_keys": n_keys, "n_warm": n_warm}


class Client:
    """Signed requests against one bucket, recording every write in the
    reference's history, every read for judging and every status that
    was not 200."""

    def __init__(self, s3, history: ref_reads.History):
        self.s3, self.history = s3, history
        self.reads: List[tuple] = []
        self.statuses: Dict[str, int] = {}

    def _note(self, op: str, st: int) -> None:
        k = f"{op} {st}"
        self.statuses[k] = self.statuses.get(k, 0) + 1

    async def put(self, key: str, body: bytes, tries: int = 1) -> bool:
        h = hashlib.sha256(body)
        for attempt in range(tries):
            sent = time.perf_counter()
            acked = None
            try:
                st, _ = await self.s3.request("PUT", f"/{BUCKET}/{key}", body,
                                              payload_hash=h.hexdigest())
                if st == 200:
                    acked = time.perf_counter()
                else:
                    self._note("PUT", st)
            finally:
                self.history.add(ref_reads.Version(key, h.digest(), sent, acked))
            if acked is not None:
                return True
            await asyncio.sleep(0.5 * (attempt + 1))
        return False

    async def get(self, key: str) -> bool:
        sent = time.perf_counter()
        st, body = await self.s3.request("GET", f"/{BUCKET}/{key}")
        done = time.perf_counter()
        if st != 200:
            self._note("GET", st)
            return False
        self.reads.append((key, sent, done, hashlib.sha256(body).digest()))
        return True


async def bounded(coros, width: int, failures_ok: bool = False):
    """The coroutines, ``width`` at a time; with ``failures_ok`` a
    request that raises (a timeout) comes back as its exception."""
    sem = asyncio.Semaphore(width)

    async def one(c):
        async with sem:
            return await c
    return await asyncio.gather(*[one(c) for c in coros],
                                return_exceptions=failures_ok)


async def settle(d, quiet_s: float, timeout: float = 60.0) -> None:
    """Until no node's store has changed for ``quiet_s`` (write-time
    parity is encoded and placed after the PUT is acknowledged)."""
    def count():
        return [sum(len(f) for _r, _d, f in os.walk(x)) for x in d.data_dirs]
    last, since = count(), time.monotonic()
    deadline = since + timeout
    while time.monotonic() - since < quiet_s and time.monotonic() < deadline:
        await asyncio.sleep(0.5)
        now = count()
        if now != last:
            last, since = now, time.monotonic()


def judge_codewords(cfg, d, stores, bodies, history) -> dict:
    """The reference's account of every codeword the nodes list."""
    from ..harness import ecindex

    bs = int(cfg["garage"]["block_size"])
    k, m = cfg["guarantees"]["erasure_code"]
    content = {}
    for b in bodies:
        for blk in ref_blocks.split_blocks(b, bs):
            content[ref_blocks.blake2s256(blk)] = bytes(blk)
    by_digest = {hashlib.sha256(b).digest(): b for b in bodies}
    written = [ref_blocks.blake2s256(blk) for v in history.acked()
               for blk in ref_blocks.split_blocks(by_digest[v.digest], bs)]
    where: Dict[str, List[int]] = {}
    paths: Dict[str, str] = {}
    for i, (present, _c, _o) in enumerate(stores):
        for hx, ps in present.items():
            where.setdefault(hx, []).append(i)
            paths.setdefault(hx, ps[0])

    def read_piece(hx):
        with open(paths[hx], "rb") as f:
            return f.read()
    cws = ecindex.codewords([x.parent / "meta" for x in d.data_dirs])
    out = ref_codewords.judge(cws.values(), content, where, read_piece,
                              k, m, written)
    out.update(ref_codewords.judge_sidecars(
        ecindex.sidecars(o for _p, _c, others in stores for o in others),
        {**content, **out.pop("pieces")}, k, m))
    return out


async def run(ctx) -> dict:
    import aiohttp

    from ..harness import card
    from ..harness.daemons import Daemons

    t, cfg = ctx.traffic, ctx.config
    root = Path(ctx.tmp)
    ctl = root / "ctl" if ctx.trace else None
    if ctl is not None:
        ctl.mkdir()
    p = plan(ctx.seed, t, int(cfg["recordcount"]), ctx.seconds)
    d = Daemons(cfg, root, ctl, ctx.fault)
    try:
        d.start()
        await d.wait_listening()
        key_id, secret = await d.configure(BUCKET)
        conn = aiohttp.TCPConnector(limit=0)
        async with aiohttp.ClientSession(connector=conn) as session:
            from ..harness.s3client import S3Client

            s3 = S3Client(session, f"http://127.0.0.1:{d.s3[0]}", key_id,
                          secret, timeout=float(t["timeout_s"]))
            deadline = time.monotonic() + 120
            while (await s3.request("GET", "/"))[0] != 200:
                if time.monotonic() > deadline:
                    raise RuntimeError("node 0 never answered a signed ListBuckets")
                await asyncio.sleep(0.5)
            history = ref_reads.History()
            c = Client(s3, history)
            # 1. the objects, then a warm-up of every operation in the mix
            n_keys, n_warm = p["n_keys"], p["n_warm"]
            width = int(t["preload_concurrency"])
            ok = await bounded([c.put(k, b, tries=3) for k, b in
                                zip(p["names"], p["bodies"][:n_keys])], width)
            if not all(ok):
                raise RuntimeError(f"set-up wrote {sum(ok)} of {n_keys} objects")
            killed = []
            ec = "erasure_code" in cfg["guarantees"]
            await d.scrub_pass()
            if int(t.get("kill_nodes", 0)):
                await settle(d, 6.0)
                held = sorted(((sum(len(f) for _r, _d, f in os.walk(x)), i)
                               for i, x in enumerate(d.data_dirs) if i),
                              reverse=True)
                killed = sorted(i for _n, i in held[:int(t["kill_nodes"])])
                for i in killed:
                    d.kill(i)
            live = [i for i in range(d.n) if i not in killed]
            warm = []
            for j in range(n_warm):
                k = p["names"][j % n_keys] if n_keys else f"warm/{j:04d}"
                if "put" in t["ops"] and (j % 2 or "get" not in t["ops"]):
                    warm.append(c.put(k, p["bodies"][n_keys + j]))
                else:
                    warm.append(c.get(k))
            await bounded(warm, width, failures_ok=True)
            d.check_alive(live)

            # 2. the window
            before = [promtext.parse(d.metrics_text(i)) if i in live else {}
                      for i in range(d.n)]
            if ctl is not None:
                (ctl / "start").touch()
                await asyncio.sleep(0.5)
            nxt = iter(range(n_keys + n_warm, len(p["bodies"])))

            async def send(i: int, rec) -> bool:
                op, key = p["ops"][i], p["keys"][i]
                rec.detail["op"] = op
                if op == "put":
                    return await c.put(key, p["bodies"][next(nxt)])
                return await c.get(key)

            t0 = time.perf_counter() + 0.05
            setup_s = t0 - ctx.t_process
            memory = [card.memory_used_bytes() if ctx.device == "cuda" else 0]
            wall0 = time.time_ns() / 1e3
            recs = await openloop.run(p["dues"], send, t0)
            wall1 = time.time_ns() / 1e3
            memory.append(card.memory_used_bytes() if ctx.device == "cuda" else 0)
            if ctl is not None:
                (ctl / "stop").touch()
                deadline = time.monotonic() + 120
                while len(list(ctl.glob("done-*"))) < len(live):
                    if time.monotonic() > deadline:
                        raise RuntimeError("a node never wrote its trace")
                    await asyncio.sleep(0.1)
            after = [promtext.parse(d.metrics_text(i)) if i in live else {}
                     for i in range(d.n)]

            if ec:
                await settle(d, 6.0)
            # 3. every key written read back once more
            fc = Client(s3, history)
            written_keys = sorted(k for k, vs in history.by_key.items()
                                  if any(v.acked is not None for v in vs))
            await bounded([fc.get(k) for k in written_keys], width,
                          failures_ok=True)
            final_reads = fc.reads
        d.stop()

        # 4. judge
        wrong = [r for r in c.reads
                 if r[3] not in history.valid(r[0], r[1], r[2])]
        wrong_final = [r for r in final_reads
                       if r[3] not in history.valid(r[0], r[1], r[2])]
        stores = [ref_blocks.walk_store(str(x)) for x in d.data_dirs]
        files = [q for present, _c, _o in stores for ps in present.values()
                 for q in ps]
        bad = ref_blocks.bad_files(files)
        # local parity sidecars (``parity/<gid>.par``) are judged with
        # the codewords; anything else is a stray file
        other = sum(1 for _p, _c, o in stores for x in o
                    if not (ec and x.endswith(".par")))
        bs = int(cfg["garage"]["block_size"])
        copies: Dict[str, int] = {}
        for present, _c, _o in stores:
            for hx in present:
                copies[hx] = copies.get(hx, 0) + 1
        want = int(cfg["guarantees"]["write_quorum"])
        by_digest = {hashlib.sha256(b).digest(): b for b in p["bodies"]}
        under = 0
        for v in history.acked():
            body = by_digest[v.digest]
            if any(copies.get(ref_blocks.blake2s256(blk).hex(), 0) < want
                   for blk in ref_blocks.split_blocks(body, bs)):
                under += 1
        checks = Checks()
        n_ok_reads = sum(r.ok and r.detail.get("op") == "get" for r in recs)
        if killed:
            # reads that needed a block of a lost node: the decode path
            lost = {hx for i in killed for hx in stores[i][0]}
            degraded = sum(
                any(ref_blocks.blake2s256(blk).hex() in lost
                    for blk in ref_blocks.split_blocks(by_digest[r[3]], bs))
                for r in c.reads if r[3] in by_digest)
            checks.at_least("reads_of_lost_blocks", degraded, 1)
        checks.at_most("wrong_reads", len(wrong), 0)
        checks.at_most("wrong_final_reads", len(wrong_final), 0)
        checks.at_least("final_reads", len(final_reads), len(written_keys))
        checks.at_most("bad_block_files", len(bad) + other, 0)
        checks.at_most("writes_under_quorum", under, 0)
        checks.at_least("acked_writes", len(history.acked()), 1)
        if "get" in t["ops"]:
            checks.at_least("window_reads", n_ok_reads, 1)
        counts = {}
        if ec:
            counts = judge_codewords(cfg, d, stores, p["bodies"], history)
            for name in ("wrong_parity", "missing_pieces", "pieces_sharing_a_node",
                         "bad_geometry", "codewords_of_unknown_blocks",
                         "blocks_without_codeword", "wrong_sidecar_parity",
                         "sidecars_of_unknown_blocks", "bad_sidecar_geometry"):
                checks.at_most(name, counts[name], 0)

        # a failed request misses any limit: it counts as infinitely
        # late, and a tail of such requests reads as the client's timeout
        metrics = {"setup_s": setup_s}
        for name, op in t["metrics"].items():
            lat = [r.latency if r.ok else math.inf for r in recs
                   if r.detail.get("op") == op]
            metrics[name] = min(openloop.tail_ms(lat), 1e3 * float(t["timeout_s"]))
        failed = [r for r in recs if not r.ok]
        out = {
            "attempted": len(recs), "failed": len(failed),
            "metrics": metrics, "checks": checks,
            "memory_peak_bytes": max(memory),
            "notes": {
                "requests": {op: sum(r.detail.get("op") == op for r in recs)
                             for op in t["ops"]},
                "p50_ms": {op: openloop.tail_ms(
                    [r.latency if r.ok else math.inf for r in recs
                     if r.detail.get("op") == op], 0.5) for op in t["ops"]},
                "generator_lateness": openloop.lateness(recs),
                "last_done_after_close_s": max(
                    (r.done for r in recs), default=t0) - (t0 + ctx.seconds),
                "errors": sorted({r.detail.get("error", "status")
                                  for r in failed})[:5],
                "statuses": c.statuses,
                "killed": killed, "codewords": counts.get("codewords"),
                "sidecars": counts.get("sidecars"),
            },
            "obs": {"prom": [promtext.delta(b, a) for b, a in zip(before, after)]},
        }
        if ctl is not None:
            traces = sorted(str(q) for q in ctl.glob("trace-*.json")
                            if not q.name.endswith(".host.json"))
            red = profiling.reduce(traces, (wall0, wall1))
            out["trace"] = red
            out["obs"]["trace"] = red
        return out
    finally:
        d.stop(timeout=10)
