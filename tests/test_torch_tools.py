"""The port's operator and device tools (garage_tpu_torch/tools/) against
the reference's scripts/ and bench.py on the CPU.

- ``testing/cluster.mk_cluster`` against ``bench._mk_cluster``: three
  nodes each way (replication 3; the port's codecs built on the CPU), the
  same seeded objects PUT through ``testing/s3_client.S3Client`` and
  ``bench._S3``: equal ETags, equal listings, bit-exact reads.
- The transport, pool and link smokes with ``--synthetic`` (the
  reference's synthetic link on the CPU) against the reference's scripts'
  drives on the same seeds: digests and parity, warm-pass staged bytes,
  pool hit/miss totals, the sweep's cell set and ``sum_ok``.
- ``blake2s_tune``'s lane check at 8 lanes of 4 KiB through the plain
  version, against hashlib and the reference's XLA ``blake2s_batch``.
- ``device_capture``'s ``make_batches`` against ``bench.make_batches``
  byte for byte at a reduced BATCH/BLOCK (4 blocks of 4 KiB, not 256 of
  1 MiB), and its device-resident helper on ``CudaCodec(device="cpu")``
  at tiny shapes.
- Every tool that builds a device codec exits non-zero with no result
  without a GPU (this host has none); ``put_trace`` runs on its CPU codec.
"""

import asyncio
import hashlib
import json
import os
import re
import runpy
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from garage_tpu.ops import tpu_blake2s as r_tpu_blake2s
from garage_tpu.ops.codec import CodecParams as RParams
from garage_tpu.ops.cpu_codec import CpuCodec as RCpuCodec
from garage_tpu.ops.feeder import CodecFeeder as RFeeder
from garage_tpu.ops.hybrid_codec import HybridCodec as RHybrid
from garage_tpu.testing.synthetic_device import SyntheticLinkCodec as RSynth
from garage_tpu.utils.data import Hash as RHash
from garage_tpu_torch.ops.codec import CodecParams
from garage_tpu_torch.ops.cuda_codec import CudaCodec
from garage_tpu_torch.testing.cluster import mk_cluster
from garage_tpu_torch.testing.s3_client import S3Client
from garage_tpu_torch.tools import (blake2s_tune, device_capture,
                                    link_profile, pool_smoke,
                                    transport_smoke)

REPO = Path(__file__).resolve().parents[1]
SEED = 20261031
# every tool that builds a device codec, with the arguments that would
# run it on the card
CARD_TOOLS = {"transport_smoke": [], "pool_smoke": [], "link_profile": [],
              "blake2s_tune": [], "device_capture": [],
              "chaos": ["--quick", "--phases", "partition"],
              "loop_stalls": []}


def _blocks(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,), dtype=np.uint8).tobytes()
            for n in sizes]


# --- mk_cluster -----------------------------------------------------------


async def _serve(build, client, tmp, objects, **kw):
    """PUT `objects` through node 0 of a 3-node cluster that `build`
    makes; (ETags, the bucket's listing, the bodies read back)."""
    import aiohttp

    garages, server, port, kid, secret = await build(tmp, n=3, repl="3",
                                                     **kw)
    try:
        async with aiohttp.ClientSession() as session:
            s3 = client(session, port, kid, secret)
            st, _b, _h = await s3.req("PUT", "/tools")
            assert st == 200
            etags = {}
            for name, body in objects:
                st, _b, h = await s3.req("PUT", f"/tools/{name}", body)
                assert st == 200, (name, st)
                etags[name] = h["ETag"]
            st, body, _h = await s3.req("GET", "/tools",
                                        query=[("list-type", "2")])
            assert st == 200
            root = ET.fromstring(body)
            ns = root.tag.split("}")[0] + "}"
            listing = [(c.findtext(f"{ns}Key"), c.findtext(f"{ns}ETag"),
                        c.findtext(f"{ns}Size"))
                       for c in root.findall(f"{ns}Contents")]
            reads = {}
            for name, _body in objects:
                st, got, _h = await s3.req("GET", f"/tools/{name}")
                assert st == 200
                reads[name] = got
    finally:
        await server.stop()
        for g in garages:
            await g.shutdown()
    return etags, listing, reads


def test_mk_cluster_serves_the_objects_the_reference_serves(tmp_path):
    objects = list(zip([f"o{i}" for i in range(6)],
                       _blocks(SEED, (0, 1, 3071, 3072, 4113, 20000))))
    port = asyncio.run(_serve(mk_cluster, S3Client, tmp_path / "port",
                              objects, device="cpu"))
    ref = asyncio.run(_serve(bench._mk_cluster, bench._S3,
                             tmp_path / "ref", objects))
    assert port[0] == ref[0]
    assert port[1] == ref[1] and len(port[1]) == len(objects)
    assert port[2] == ref[2] == dict(objects)


# --- the three smokes, --synthetic ----------------------------------------


def _ref_transport_drive():
    """The reference script's drive (scripts/transport_smoke.py, its seed
    and blocks) up to its results: the digests and the scrub's parity."""
    params = RParams(rs_data=4, rs_parity=2, block_size=1 << 16)
    dev = RSynth(params, link_gibs=50.0, compute_real=True)
    hy = RHybrid(params, device_codec=dev)
    hy._probe_link()
    feeder = RFeeder(hy, slo_ms=1.0, max_batch_blocks=256)
    blocks = _blocks(transport_smoke.SEED, transport_smoke.SIZES)
    hashes = [RHash(hashlib.blake2s(b, digest_size=32).digest())
              for b in blocks]
    try:
        got = feeder.submit_hash(blocks, peers=1).result(timeout=60)
        ok, parity = feeder.submit_scrub(blocks, hashes,
                                         want_parity=True).result(timeout=60)
    finally:
        feeder.shutdown()
        hy.close()
    return [bytes(g).hex() for g in got], ok, parity


def test_transport_smoke_synthetic_matches_the_reference():
    port = transport_smoke.run(synthetic=True)
    digests, ok, parity = _ref_transport_drive()
    assert port["digests"] == digests
    assert port["ok"] == ok.tolist() and all(port["ok"])
    assert port["parity_shape"] == list(parity.shape)
    assert port["parity_sha256"] == hashlib.sha256(
        np.ascontiguousarray(parity).tobytes()).hexdigest()
    assert port["tpu_frac"] > 0 and port["copies_per_block"] <= 1.0
    assert port["bytes_level_submissions"] == 0
    assert port["slot_overlaps"] >= 1


def test_pool_smoke_synthetic_matches_the_reference(capsys):
    port = pool_smoke.run(synthetic=True)
    runpy.run_path(str(REPO / "scripts" / "pool_smoke.py"),
                   run_name="__main__")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    ref = dict(re.findall(r"(\w+)=([\d.]+)", line))
    assert line.startswith("pool smoke ok"), line
    assert port["warm_link_bytes"] == int(ref["warm_link_bytes"]) == 0
    assert f"{port['hit_ratio']:.2f}" == ref["hit_ratio"]
    assert port["final"]["resident_pages"] == int(ref["resident_pages"])
    assert port["final"]["adopted"] == int(ref["adopted"])
    blocks = _blocks(pool_smoke.SEED, pool_smoke.SIZES)
    total = sum(map(len, blocks))
    assert port["total_bytes"] == total
    assert port["cold"] == {"hit_bytes": 0, "miss_bytes": total}
    assert port["warm"] == {"hit_bytes": total, "miss_bytes": total}
    assert port["final"]["hit_bytes"] == 2 * total - len(blocks[0])
    assert port["final"]["miss_bytes"] == total + len(blocks[0])
    hashes = [RHash(hashlib.blake2s(b, digest_size=32).digest())
              for b in blocks]
    rok, rpar = RCpuCodec(RParams(rs_data=4, rs_parity=2)).scrub_encode_batch(
        blocks, hashes, True)
    assert rok.all()
    assert port["warm_parity_sha256"] == hashlib.sha256(
        np.ascontiguousarray(rpar).tobytes()).hexdigest()


def test_link_profile_synthetic_matches_the_reference(capsys, monkeypatch):
    port = link_profile.run(synthetic=True, table=False)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["link_profile.py", "--json"])
    runpy.run_path(str(REPO / "scripts" / "link_profile.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    ref = json.loads(out[:out.rindex("link profile ok")])

    def cells(block):
        return sorted((c["kind"], c["size_mib"], c["blocks"])
                      for c in block["cells"])

    assert cells(port["sweep"]) == cells(ref) and len(ref["cells"]) == 18
    assert all(c["sum_ok"] for c in port["sweep"]["cells"])
    assert port["sweep"]["sum_ok"] and ref["sum_ok"]
    assert port["sweep"]["summary"]["stage_copy"]["bytes"] > 0
    assert sorted(port["sweep"]["cells"][0]) == sorted(ref["cells"][0])


# --- without a GPU ---------------------------------------------------------


@pytest.fixture(scope="module")
def card_tool_runs():
    """Every card tool started at once with no CPU flag; their (rc,
    stdout, stderr)."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"garage_tpu_torch.tools.{name}", *args],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in CARD_TOOLS.items()}
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=120)
        out[name] = (p.returncode, so, se)
    return out


@pytest.mark.parametrize("name", sorted(CARD_TOOLS))
def test_a_card_tool_without_a_gpu_exits_nonzero_with_no_result(
        card_tool_runs, name):
    assert not torch.cuda.is_available()
    rc, so, se = card_tool_runs[name]
    assert rc != 0
    assert "{" not in so and "CHAOS" not in so, so
    assert "no CUDA device" in se, se[-2000:]


def test_loop_stalls_sampler_finds_a_blocked_loop():
    from garage_tpu_torch.tools.loop_stalls import Sampler, summarise

    def _block():
        time.sleep(0.6)

    async def body():
        await asyncio.sleep(0.1)
        _block()
        await asyncio.sleep(0.1)
        return 7

    sampler = Sampler()
    assert asyncio.run(sampler.run(body())) == 7
    assert len(sampler.episodes) == 1
    ep = sampler.episodes[0]
    assert 0.5 <= ep["max"] < 0.9 and ep["late"] is None
    assert ep["window"] == "traffic" and "_block" in ep["first"]["loop"]
    assert summarise([{"stalls": sampler.episodes}])["traffic"] == {
        "runs_with_stall": 1, "runs": 1, "max_s": [ep["max"], ep["max"]]}


def test_loop_stalls_windows_follow_the_drills_stack():
    from garage_tpu_torch.tools.loop_stalls import window_of

    chaos = "/r/garage_tpu_torch/tools/chaos.py"
    sim = "/r/garage_tpu_torch/testing/sim_cluster.py"
    drill = (chaos, "run_node_rebuild")
    assert window_of([drill, (sim, "start"),
                      ("/t/torch/cuda/__init__.py", "is_available")]) \
        == "startup"
    # an import run_node_rebuild makes, through a module's top level
    assert window_of([drill, (sim, "<module>"),
                      ("<frozen importlib>", "_find_spec")]) == "startup"
    assert window_of([drill, (sim, "make_bucket")]) == "traffic"
    assert window_of([drill, (sim, "node_rebuild_drill"),
                      ("/r/garage_tpu_torch/utils/background.py",
                       "_run_worker")]) == "traffic"
    assert window_of([drill, (sim, "stop")]) == "teardown"


def test_loop_stalls_await_chain_names_the_suspended_coroutines():
    from garage_tpu_torch.tools.loop_stalls import await_chain

    async def inner(ev):
        await ev.wait()

    async def outer(ev):
        await inner(ev)

    async def main():
        ev = asyncio.Event()
        coro = outer(ev)
        task = asyncio.ensure_future(coro)
        await asyncio.sleep(0)
        names = [n for _f, n in await_chain(coro)]
        ev.set()
        await task
        return names

    assert asyncio.run(main())[:2] == ["outer", "inner"]


def test_the_clock_sampler_waits_for_nvidia_smis_first_sample(
        tmp_path, monkeypatch):
    from garage_tpu_torch.tools import timing

    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/bash\nsleep 1\necho 1755\n"
                   "while true; do echo 1980; sleep 0.02; done\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    # a timed window of 0.3 s that starts before nvidia-smi's first line
    # would hold no sample; the sampler waits for that line first
    monkeypatch.setattr(timing, "queued_ms",
                        lambda fn, reps, flush=None: time.sleep(0.3) or 1.5)
    assert timing.time_kernel_clocked(torch, lambda: None) == (1.5, 1980.0)
    # a window with no sample of its own falls back to the first one
    monkeypatch.setattr(timing, "queued_ms",
                        lambda fn, reps, flush=None: 1.5)
    assert timing.time_kernel_clocked(torch, lambda: None) == (1.5, 1755.0)


def test_put_trace_runs_on_its_cpu_codec():
    r = subprocess.run([sys.executable, "-m",
                        "garage_tpu_torch.tools.put_trace"], cwd=str(REPO),
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.search(r"solo put p50 = [\d.]+ ms", r.stdout), r.stdout
    assert "per-stage mean over all puts" in r.stdout


# --- blake2s_tune ----------------------------------------------------------


def test_blake2s_tune_lane_check_equals_hashlib_and_the_reference():
    data, lengths = blake2s_tune.make_lanes(8, 4096, SEED, "cpu")
    assert data.device.type == "cpu" and tuple(data.shape) == (8, 4096)
    got = blake2s_tune.lane_digests(data, lengths)
    arr = data.numpy()
    assert got == [hashlib.blake2s(row.tobytes(), digest_size=32).digest()
                   for row in arr]
    ref = np.asarray(r_tpu_blake2s.blake2s_batch(arr, lengths.numpy()))
    assert got == r_tpu_blake2s.digests_to_bytes(ref)
    assert blake2s_tune.check_lanes(data, lengths, got) == {
        "lanes_checked": 8, "hashlib_lanes": [0, 7]}


def test_blake2s_tune_lane_check_fails_on_a_wrong_lane():
    data, lengths = blake2s_tune.make_lanes(8, 4096, SEED, "cpu")
    got = blake2s_tune.lane_digests(data, lengths)
    got[3] = bytes(32)
    with pytest.raises(SystemExit, match="1 of 8 lanes differ"):
        blake2s_tune.check_lanes(data, lengths, got)


# --- device_capture --------------------------------------------------------


def test_make_batches_equals_the_reference_at_a_reduced_size(monkeypatch):
    for mod in (bench, device_capture):
        monkeypatch.setattr(mod, "BATCH", 4)
        monkeypatch.setattr(mod, "BLOCK", 4096)
    port = device_capture.make_batches(np.random.default_rng(0))
    ref = bench.make_batches(np.random.default_rng(0))
    assert len(port) == len(ref) == device_capture.N_DISTINCT
    for (pb, ph), (rb, rh) in zip(port, ref):
        assert pb == rb and len(pb) == 4 and len(pb[0]) == 4096
        assert [bytes(h) for h in ph] == [bytes(h) for h in rh]


DOCUMENTED = {"fused_scrub_rungs", "fused_scrub_gibs", "fused_scrub_ms",
              "fused_scrub_lanes", "fused_scrub_block", "gf_shape",
              "gf_lost", "gf_apply_ms", "gf_apply_gibs", "gf_bitmatmul_ms",
              "gf_bitmatmul_gibs", "gf_decode_ms", "gf_decode_gibs"}


def test_device_resident_helper_at_tiny_shapes():
    codec = CudaCodec(CodecParams(rs_data=8, rs_parity=4), device="cpu")
    res = device_capture.bench_device_resident(codec, 16, block=2048,
                                               gf_blocks=16, reps=1)
    assert set(res) == DOCUMENTED
    assert [(r["lanes"], r["block"]) for r in res["fused_scrub_rungs"]] == [
        (128, 128), (16, 512), (16, 2048)]
    assert (res["fused_scrub_lanes"], res["fused_scrub_block"]) == (16, 2048)
    assert res["gf_shape"] == [2, 8, 2048] and res["gf_lost"] == [2, 5]
    assert all(res[k] > 0 for k in DOCUMENTED if k.endswith("_gibs"))


def test_device_resident_helper_holds_parity_to_the_numpy_oracle(
        monkeypatch):
    """The helper's checks bite: a fused scrub whose parity is off by one
    bit ends the capture."""
    codec = CudaCodec(CodecParams(rs_data=8, rs_parity=4), device="cpu")
    fused = codec.fused_scrub

    def flipped(*a):
        h, ok, bad, parity = fused(*a)
        parity = parity.clone()
        parity[0, 0, 0] ^= 1
        return h, ok, bad, parity

    monkeypatch.setattr(codec, "fused_scrub", flipped)
    with pytest.raises(SystemExit, match="parity != numpy"):
        device_capture.fused_rung(codec, 16, 1024, 1, 5)
    # the oracle the helper uses is the reference's GF(2^8) arithmetic
    from garage_tpu.ops import gf256 as r_gf256

    rng = np.random.default_rng(SEED)
    shards = rng.integers(0, 256, (3, 8, 300), dtype=np.uint8)
    mat = r_gf256.rs_parity_matrix(8, 4)
    assert np.array_equal(device_capture._oracle_parity(mat, shards),
                          r_gf256.gf_matmul_blocks(mat, shards))


def test_device_capture_writes_under_build_never_the_root_record():
    assert device_capture.OUT == REPO / "build" / "device_capture.json"
    assert os.path.basename(device_capture.OUT) != "DEVICE_CAPTURE.json"
