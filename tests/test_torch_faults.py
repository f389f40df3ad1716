"""The port's fault rig (garage_tpu_torch.net.latency_proxy and
testing.faults) against the reference's.

- LatencyProxy / FaultyLink: one scripted sequence of link states
  (clean, latency, one-way drops, blackhole, mid-transfer blackhole,
  refuse, a kill of live connections, retarget, clear) over an echo
  server; what the client and the server saw must be equal.
- FaultyDisk: the same seeded operations over each package's DiskIo give
  the same errors, bytes and injection counts.
- FaultInjector on small in-process SimClusters (3 storage nodes and a
  gateway, replication 3, the CPU codec, the `native` metadata engine;
  the port's built with device="cpu"): a corrupted block found by one
  scrub pass, quarantined and resynced, a dropped block found by the
  repair walk and refetched, and a crash and revive of a storage node
  from its native db with every acked object read back; the same counts
  in both packages.  A revive whose codec needs a card that is not
  there raises.
"""

import asyncio
import errno
import hashlib
import os
import random
import time

import aiohttp
import pytest

import garage_tpu.block.health as r_health
import garage_tpu.testing.faults as r_faults
import garage_tpu.testing.sim_cluster as r_sim
import garage_tpu_torch.block.health as p_health
import garage_tpu_torch.testing.faults as p_faults
import garage_tpu_torch.testing.sim_cluster as p_sim
from garage_tpu_torch.testing.s3_client import S3Client
from test_torch_sim import crash_all

pytestmark = pytest.mark.asyncio

SEED = 20261023
PKGS = {"ref": (r_faults, r_health, r_sim), "port": (p_faults, p_health,
                                                       p_sim)}


def test_shared_tunables_equal_reference():
    for name in ("FAST_CHAOS_RPC", "FAST_CHAOS_HEALTH", "WAN_3ZONE_RTT"):
        assert getattr(p_faults, name) == getattr(r_faults, name)


# --- links -------------------------------------------------------------------


async def _echo_server(prefix: bytes, seen: list):
    async def handle(reader, writer):
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                seen.append(data)
                writer.write(prefix + data)
                await writer.drain()
        except ConnectionError:
            pass
        finally:
            writer.close()

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1]


async def _exchange(port: int, payload: bytes, wait: float = 0.25):
    """Connect through the link, send, read what comes back within
    `wait` seconds: ('echo', bytes), ('eof',), ('silent',) or
    ('refused',)."""
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
    except OSError:
        return ("refused",)
    try:
        writer.write(payload)
        await writer.drain()
        got = b""
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline:
            try:
                chunk = await asyncio.wait_for(
                    reader.read(65536), deadline - time.monotonic())
            except asyncio.TimeoutError:
                break
            if not chunk:
                return ("eof", got) if got else ("eof",)
            got += chunk
        return ("echo", got) if got else ("silent",)
    except ConnectionError:
        return ("reset",)
    finally:
        writer.close()


async def link_session(pkg) -> list:
    faults = PKGS[pkg][0]
    seen_a, seen_b = [], []
    srv_a, port_a = await _echo_server(b"A:", seen_a)
    srv_b, port_b = await _echo_server(b"B:", seen_b)
    link = faults.FaultyLink("127.0.0.1", port_a, rng=random.Random(SEED))
    lport = await link.start()
    log = []

    async def step(name, payload=b"ping", wait=0.25):
        n = len(seen_a) + len(seen_b)
        t = time.monotonic()
        got = await _exchange(lport, payload, wait)
        log.append((name, got, [bytes(x) for x in (seen_a + seen_b)[n:]]))
        return time.monotonic() - t

    try:
        await step("clean")
        link.delay = 0.06
        took = await step("latency", wait=0.6)
        assert took >= 0.12, took  # 60 ms each way
        link.delay = 0.0
        link.drop = {"tx"}
        await step("drop tx")
        link.drop = {"rx"}
        await step("drop rx")
        link.clear()
        link.blackhole = True
        await step("blackhole")
        link.clear()
        link.blackhole_after_bytes = 6
        await step("dark after 6 bytes", b"abc")
        await step("dark after 6 bytes, more", b"defghij")
        link.clear()
        # a live connection, then refuse + kill: the client sees it end
        reader, writer = await asyncio.open_connection("127.0.0.1", lport)
        writer.write(b"live")
        await writer.drain()
        first = await asyncio.wait_for(reader.read(100), 2)
        link.refuse = True
        link.kill_connections()
        rest = await asyncio.wait_for(reader.read(100), 2)
        writer.close()
        log.append(("killed live connection", first, rest))
        await step("refuse")
        link.clear()
        link.retarget(port_b)
        await step("retargeted")
        await step("big", bytes(range(256)) * 300, wait=0.5)
    finally:
        await link.stop()
        srv_a.close()
        srv_b.close()
    return log


async def test_faulty_link_semantics_equal_reference():
    ref = await link_session("ref")
    port = await link_session("port")
    assert port == ref
    steps = {name: rest for name, *rest in port}
    assert steps["clean"][0] == ("echo", b"A:ping")
    assert steps["drop tx"] == [("silent",), []]
    assert steps["drop rx"] == [("silent",), [b"ping"]]
    assert steps["blackhole"] == [("silent",), []]
    assert steps["refuse"][0] in (("eof",), ("reset",))
    assert steps["killed live connection"] == [b"A:live", b""]
    assert steps["retargeted"][0] == ("echo", b"B:ping")


# --- disks -------------------------------------------------------------------


def disk_session(pkg, root) -> list:
    faults, health, _sim = PKGS[pkg]
    os.makedirs(root, exist_ok=True)
    disk = faults.FaultyDisk(health.DiskIo(), rng=random.Random(SEED),
                             path_prefix=os.path.join(root, "faulty"))
    os.makedirs(os.path.join(root, "faulty"), exist_ok=True)
    os.makedirs(os.path.join(root, "clean"), exist_ok=True)
    rng = random.Random(SEED + 1)
    log = []

    def op(name, fn, *a):
        try:
            out = fn(*a)
            if isinstance(out, bytes):
                out = hashlib.sha256(out).hexdigest()[:16]
            elif out is not None and not isinstance(out, (int, str)):
                free = out.f_bavail * out.f_frsize
                out = free if free == 12345 * 4096 else "real"
            log.append((name, "ok", out))
        except OSError as e:
            log.append((name, "OSError", errno.errorcode[e.errno]))
        except faults.SimulatedCrash:
            log.append((name, "crash"))

    paths = [os.path.join(root, d, f"f{i}") for d in ("faulty", "clean")
             for i in range(4)]
    for p in paths:
        op("seed write", disk.write_file, p, rng.randbytes(3000))
    disk.read_errno, disk.read_error_prob = errno.EIO, 0.5
    disk.bitrot_prob = 0.4
    for _ in range(24):
        p = rng.choice(paths)
        op(f"read {os.path.basename(os.path.dirname(p))}",
           rng.choice((disk.read_file, disk.read_file_direct)), p)
    disk.clear()
    disk.write_errno, disk.write_error_prob = errno.ENOSPC, 0.5
    disk.fsync_errno = errno.EIO
    for i in range(10):
        op("write", disk.write_file, rng.choice(paths), rng.randbytes(500),
           bool(i % 2))
    disk.clear()
    for stage in ("tmp", "rename", "fsync"):
        disk.crash_stage = stage
        tmp = os.path.join(root, "faulty", f"c-{stage}.tmp")
        op(f"crash {stage} write", disk.write_file, tmp, b"x" * 1000)
        op(f"crash {stage} rename", disk.replace, tmp,
           os.path.join(root, "faulty", f"c-{stage}"))
        op(f"crash {stage} fsync", disk.fsync_dir, os.path.join(root,
                                                                "faulty"))
        log.append((f"torn {stage}", os.path.exists(tmp)
                    and os.path.getsize(tmp)))
    disk.clear()
    disk.statvfs_free = 12345 * 4096
    op("statvfs faulty", disk.statvfs, os.path.join(root, "faulty"))
    op("statvfs clean", disk.statvfs, os.path.join(root, "clean"))
    log.append(("injected", dict(disk.injected)))
    return log


def test_faulty_disk_equals_reference(tmp_path):
    ref = disk_session("ref", str(tmp_path / "ref"))
    port = disk_session("port", str(tmp_path / "port"))
    assert port == ref
    kinds = {x[1] for x in port if x[0] != "injected" and len(x) > 1}
    assert {"ok", "OSError", "crash"} <= kinds
    assert ("statvfs faulty", "ok", 12345 * 4096) in port
    assert ("statvfs clean", "ok", "real") in port


# --- the injector on small clusters -------------------------------------------


def _cluster(pkg, root, **kw):
    sim = PKGS[pkg][2]
    args = dict(n_storage=3, n_zones=3, db="native")
    if pkg == "port":
        args["device"] = "cpu"
    return sim.SimCluster(root, **args, **kw)


def _bodies(n, salt):
    rng = random.Random(SEED + salt)
    return {f"o{i:02d}": rng.randbytes(rng.randrange(4000, 40000))
            for i in range(n)}


async def _put_all(s3, bodies, bucket="flt"):
    for name, body in bodies.items():
        st, _b, _h = await s3.req("PUT", f"/{bucket}/{name}", body)
        assert st == 200, (name, st)


async def _read_all(s3, bodies, bucket="flt"):
    bad = []
    for name, body in sorted(bodies.items()):
        st, got, _h = await s3.req("GET", f"/{bucket}/{name}")
        if st != 200 or got != body:
            bad.append((name, st))
    return bad


async def _wait(cond, secs=20.0):
    deadline = time.monotonic() + secs
    while not cond():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(0.05)
    return True


async def scrub_session(pkg, root) -> list:
    """corrupt_block → one scrub pass finds it; drop_block → the repair
    walk finds it; both come back from the peers."""
    c = _cluster(pkg, root)
    await c.start(faults=False)
    log = []
    try:
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, c.port, c.key_id, c.secret)
            assert (await s3.req("PUT", "/flt"))[0] == 200
            bodies = _bodies(6, 1)
            await _put_all(s3, bodies)
            inj = c.injector
            blocks = sorted(bytes(h) for h in inj.list_blocks(1))
            log.append(("blocks per node",
                        [len(inj.list_blocks(i)) for i in range(1, 4)]))
            victim, gone = blocks[0], blocks[-1]
            g = c.garages[1]
            assert inj.corrupt_block(1, victim)
            w = g.scrub_worker
            w.set_tranquility(0)
            done0 = w.state.time_last_complete
            w.send_command("start")
            log.append(("scrub finished", await _wait(
                lambda: not w.state.running
                and w.state.time_last_complete != done0, 60)))
            log.append(("corruptions", w.state.corruptions,
                        g.block_manager.quarantined))
            mgr = g.block_manager
            log.append(("healed", await _wait(
                lambda: mgr.is_block_present(victim))))
            assert inj.drop_block(2, gone)
            g2 = c.garages[2]
            g2.block_manager.resync.put_to_resync(gone, 0.0)
            log.append(("dropped refetched", await _wait(
                lambda: g2.block_manager.is_block_present(gone))))
            log.append(("read back", await _read_all(s3, bodies)))
            log.append(("files", sorted(bytes(h) for h in inj.list_blocks(1))
                        == blocks))
    finally:
        await c.stop()
    return log


async def test_corrupt_and_dropped_blocks_found_and_healed(tmp_path):
    ref = await scrub_session("ref", tmp_path / "ref")
    port = await scrub_session("port", tmp_path / "port")
    assert port == ref
    steps = {name: rest for name, *rest in port}
    assert steps["corruptions"] == [1, 1]
    assert steps["healed"] == [True] and steps["dropped refetched"] == [True]
    assert steps["read back"] == [[]] and steps["files"] == [True]


async def crash_session(pkg, root) -> list:
    c = _cluster(pkg, root)
    await c.start(faults=False)
    log = []
    try:
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, c.port, c.key_id, c.secret)
            assert (await s3.req("PUT", "/flt"))[0] == 200
            before, during = _bodies(4, 2), _bodies(3, 3)
            during = {f"d-{k}": v for k, v in during.items()}
            await _put_all(s3, before)
            inj = c.injector
            await inj.crash(3)
            log.append(("dead", sorted(inj.dead)))
            await _put_all(s3, during)  # quorum 2 of 3 while it is down
            g = await inj.revive(3)
            log.append(("revived engine", g.db.engine,
                        type(g.block_manager.codec).__name__))
            log.append(("same node", bytes(g.system.id)
                        == bytes(c.garages[3].system.id)))
            # the revived node's own metadata came back from its log
            n_obj = len(list(g.object_table.data.store.items(None, None)))
            log.append(("objects in its db", n_obj >= len(before)))
            log.append(("read back", await _read_all(s3, {**before,
                                                          **during})))
            # and it serves a block of an object acked before the crash
            h = inj.list_blocks(3)[0]
            got = await g.block_manager.rpc_get_block(h)
            log.append(("revived serves",
                        hashlib.blake2s(got).digest() == bytes(h)))
    finally:
        # the reference's graceful stop waits out the revived node's
        # parked workers for seconds
        await crash_all(c)
    return log


async def test_crash_and_revive_from_native_db(tmp_path):
    ref = await crash_session("ref", tmp_path / "ref")
    port = await crash_session("port", tmp_path / "port")
    assert port == ref
    steps = {name: rest for name, *rest in port}
    assert steps["revived engine"] == ["native", "CpuCodec"]
    assert steps["read back"] == [[]] and steps["revived serves"] == [True]


async def test_revive_with_a_cuda_codec_and_no_card_raises(tmp_path):
    """The injector builds a revived node on its device, the card by
    default: with a cuda codec and no card, revive raises instead of
    bringing the node back on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the revive would succeed")
    c = _cluster("port", tmp_path)
    await c.start(faults=False)
    try:
        inj = c.injector
        await inj.crash(2)
        inj.device = "cuda"
        inj.configs[2].codec.backend = "cuda"
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            await inj.revive(2)
        assert 2 in inj.dead
    finally:
        await c.stop()
