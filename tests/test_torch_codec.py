"""The codec slice of the port against the reference, end to end.

The same blocks, made with numpy from a seed, go through the reference's
``make_codec("tpu")`` behind its CodecFeeder (JAX on the CPU) and through
the port's ``make_codec("cuda", device="cpu")`` behind the port's
CodecFeeder (the kernels' plain versions): scrub with planted corruption,
PUT hashing, write-time encode and degraded-read decode, plus the
submit/collect surface the transport calls.  Integer work: the tolerance
is exact equality.  Also checks the port's import rule (no jax, nothing
of garage_tpu) and that it never falls back to the CPU on its own.
"""

import ast
import asyncio
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from garage_tpu.ops import make_codec as ref_make_codec
from garage_tpu.ops.feeder import CodecFeeder as RefFeeder
from garage_tpu.utils.data import Hash as RefHash
from garage_tpu_torch.ops import make_codec
from garage_tpu_torch.ops.feeder import CodecFeeder
from garage_tpu_torch.utils.data import Hash

REPO = Path(__file__).resolve().parent.parent
K, M = 4, 2


@pytest.fixture(scope="module")
def ref():
    return ref_make_codec("tpu", rs_data=K, rs_parity=M)


@pytest.fixture(scope="module")
def port():
    return make_codec("cuda", rs_data=K, rs_parity=M, device="cpu")


def _blocks(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def _digest(b):
    return hashlib.blake2s(b, digest_size=32).digest()


def _corrupt(blocks, idx):
    out = list(blocks)
    for i in idx:
        buf = bytearray(out[i] or b"\0")
        buf[len(buf) // 2] ^= 0x5A
        out[i] = bytes(buf)
    return out


async def _drive(feeder, blocks, hashes, put_blocks, enc_groups, decodes):
    scrub = await feeder.scrub_async(blocks, hashes)
    hashed = await asyncio.gather(*[feeder.hash_async([b], peers=len(put_blocks))
                                    for b in put_blocks])
    enc = await asyncio.gather(*[asyncio.wrap_future(feeder.submit_encode(g))
                                 for g in enc_groups])
    dec = await asyncio.gather(*[feeder.decode_async(s, p, r)
                                 for s, p, r in decodes])
    return scrub, hashed, enc, dec


def test_slice_through_both_feeders(ref, port):
    """Scrub (3 planted corruptions, ragged lengths), 6 concurrent PUT
    hashes, 3 encodes and 3 degraded-read decodes, bit-identical through
    both packages' feeders."""
    sizes = [3000, 1, 0, 2047, 3000, 64, 65, 2999, 1000, 3000]
    blocks = _blocks(sizes, seed=1)
    digests = [_digest(b) for b in blocks]
    scrubbed = _corrupt(blocks, [1, 4, 8])
    put_blocks = _blocks([777, 4096, 1, 0, 65, 3000], seed=2)
    enc_groups = [_blocks([500] * K, seed=3 + i) for i in range(3)]
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (3, K, 256), dtype=np.uint8)
    present = [0, 2, 4, 5]
    results = []
    for codec, feeder_cls, hcls in ((ref, RefFeeder, RefHash),
                                    (port, CodecFeeder, Hash)):
        full = np.concatenate([data, codec.rs_encode(data)], axis=1)
        decodes = [(full[c:c + 1, present], present, rows)
                   for c, rows in ((0, [1, 3]), (1, [1, 3]), (2, None))]
        feeder = feeder_cls(codec)
        try:
            results.append(asyncio.run(_drive(
                feeder, scrubbed, [hcls(d) for d in digests], put_blocks,
                enc_groups, decodes)))
        finally:
            feeder.shutdown()
    (r_scrub, r_hash, r_enc, r_dec), (p_scrub, p_hash, p_enc, p_dec) = results
    want_ok = np.ones(len(sizes), bool)
    want_ok[[1, 4, 8]] = False
    assert np.array_equal(r_scrub[0], want_ok)
    assert np.array_equal(p_scrub[0], want_ok)
    assert p_scrub[1].shape == r_scrub[1].shape == (3, M, 3000)
    assert np.array_equal(p_scrub[1], r_scrub[1])
    assert [bytes(h[0]) for h in p_hash] == [bytes(h[0]) for h in r_hash]
    assert [bytes(h[0]) for h in p_hash] == [_digest(b) for b in put_blocks]
    for a, b in zip(p_enc, r_enc):
        assert np.array_equal(a, b)
    for a, b in zip(p_dec, r_dec):
        assert np.array_equal(a, b)
    assert np.array_equal(p_dec[0][0], data[0, [1, 3]])
    assert np.array_equal(p_dec[2][0], data[2])


def test_codec_entry_points_match_reference(ref, port):
    rng = np.random.default_rng(11)
    blocks = _blocks([0, 1, 63, 64, 65, 128, 1000, 4096, 5000], seed=4)
    assert [bytes(h) for h in port.batch_hash(blocks)] == \
        [bytes(h) for h in ref.batch_hash(blocks)]
    hashes = [Hash(_digest(b)) for b in blocks]
    bad = _corrupt(blocks, [2, 7])
    assert np.array_equal(port.batch_verify(bad, hashes),
                          ref.batch_verify(bad, [RefHash(h) for h in hashes]))
    assert port.verify_one(blocks[3], hashes[3])
    assert not port.verify_one(bad[2], hashes[2])
    data = rng.integers(0, 256, (2, 3, K, 301), dtype=np.uint8)
    p_par = port.rs_encode(data)
    assert np.array_equal(p_par, ref.rs_encode(data))
    full = np.concatenate([data, p_par], axis=-2)
    present = [1, 3, 4, 5]
    shards = np.ascontiguousarray(full[..., present, :])
    for rows in (None, [0, 2]):
        got = port.rs_reconstruct(shards, present, rows)
        assert np.array_equal(got, ref.rs_reconstruct(shards, present, rows))
    assert np.array_equal(port.rs_reconstruct(shards, present), data)
    ok, par = port.scrub_encode_batch(bad, hashes)
    r_ok, r_par = ref.scrub_encode_batch(bad, [RefHash(h) for h in hashes])
    assert np.array_equal(ok, r_ok) and np.array_equal(par, r_par)
    assert port.scrub_encode_batch([], [])[0].shape == (0,)


def test_transport_surface_matches_reference(ref, port):
    """The submit/collect API the transport drives, on staged arrays."""
    for args in ((5, 3000, "scrub"), (9, 64, "hash"), (1, 0, "encode"),
                 (300, 1 << 20, "decode")):
        assert port.staging_geometry(*args) == ref.staging_geometry(*args)
    blocks = _blocks([3000, 17, 0, 2500, 3000], seed=5)
    hashes = [Hash(_digest(b)) for b in _corrupt(blocks, [3])]
    arr, lengths, expected = port._pad_group(blocks, hashes)
    r_arr, r_len, r_exp = ref._pad_group(blocks, [RefHash(h) for h in hashes])
    assert np.array_equal(arr, r_arr) and np.array_equal(lengths, r_len)
    assert np.array_equal(expected, r_exp)
    ok, par = port.scrub_collect(
        port.scrub_encode_submit(arr, lengths, expected), True)
    r_ok, r_par = ref.scrub_collect(
        ref.scrub_encode_submit(r_arr, r_len, r_exp), True)
    assert np.array_equal(ok, r_ok) and np.array_equal(par, r_par)
    assert ok.tolist() == [True, True, True, False, True, True, True, True]
    h = port.hash_collect(port.hash_submit(arr, lengths), 5)
    assert [bytes(x) for x in h] == [_digest(b) for b in blocks]
    groups = arr.reshape(-1, K, arr.shape[-1])
    assert np.array_equal(port.encode_collect(port.encode_submit(groups)),
                          ref.encode_collect(ref.encode_submit(groups)))
    full = np.concatenate([groups, par], axis=1)
    present = [0, 1, 4, 5]
    shards = np.ascontiguousarray(full[:, present, :2999])
    got = port.decode_collect(port.decode_submit(shards, present, [2, 3]))
    want = ref.decode_collect(ref.decode_submit(shards, present, [2, 3]))
    assert np.array_equal(got, want)
    assert np.array_equal(got, groups[:, [2, 3], :2999])
    probe = np.arange(4096, dtype=np.uint8)
    assert port.probe_collect(port.probe_submit(probe)) == int(probe.sum())


def test_fused_scrub_plain_matches_reference(ref, port):
    """The fused scrub's plain version (the yardstick the kernels are held
    against on the card) gives the reference's ok vector and parity, the
    hashlib digests and the corrupt count, on one staged batch."""
    from garage_tpu_torch.ops.cuda_codec import fused_scrub_plain

    blocks = _blocks([4096, 0, 1, 4000, 64, 65, 4096], seed=6)
    hashes = [Hash(_digest(b)) for b in _corrupt(blocks, [0, 5])]
    arr, lengths, expected = port._pad_group(blocks, hashes)
    h, ok, bad, par = fused_scrub_plain(
        torch.from_numpy(arr), torch.from_numpy(lengths),
        torch.from_numpy(expected.view(np.int32)), port._K_enc, K)
    r_ok, r_par = ref.scrub_collect(ref.scrub_encode_submit(
        *ref._pad_group(blocks, [RefHash(x) for x in hashes])), True)
    assert np.array_equal(ok.numpy(), r_ok)
    assert np.array_equal(par.numpy(), r_par)
    assert int(bad) == 2 and ok.numpy()[:7].tolist() == [
        False, True, True, True, True, False, True]
    got = h.numpy().view(np.uint32)[:7]
    assert [g.astype("<u4").tobytes() for g in got] == [_digest(b)
                                                        for b in blocks]


def test_link_profiler_stamps():
    port = make_codec("cuda", rs_data=K, rs_parity=M, device="cpu")
    arr = np.zeros((8, 64), np.uint8)
    lengths = np.zeros(8, np.int32)
    handle = port.hash_submit(arr, lengths)
    assert port.last_adopt_ns > 0
    first = port.last_submit_compiled
    port.hash_collect(handle, 8)
    assert port.last_ready_ns >= port.last_adopt_ns
    port.hash_collect(port.hash_submit(arr, lengths), 8)
    assert first and not port.last_submit_compiled
    stages = port.obs.stage_stats()
    assert {"h2d_transfer/tpu", "kernel_dispatch/tpu"} <= set(stages)


def test_load_reference_matrices(ref, port):
    """The reference's parity matrix and decode cache, fed through
    consts_from_numpy, give identical parity and decode output."""
    codec = make_codec("cuda", rs_data=K, rs_parity=M, device="cpu")
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (3, K, 400), dtype=np.uint8)
    full = np.concatenate([data, ref.rs_encode(data)], axis=1)
    present = [0, 3, 4, 5]
    shards = np.ascontiguousarray(full[:, present])
    want = ref.rs_reconstruct(shards, present, [1, 2])
    key = (tuple(present), (1, 2))
    cache = {key: tuple(np.asarray(v) for v in ref._decode_w_cache[key])}
    codec.load_reference_matrices(ref._enc_mat, cache)
    assert np.array_equal(codec.rs_encode(data), full[:, K:])
    assert np.array_equal(codec.rs_reconstruct(shards, present, [1, 2]), want)
    assert codec._decode_cache[key] is not None
    mat_only = make_codec("cuda", rs_data=K, rs_parity=M, device="cpu")
    mat_only.load_reference_matrices(None, {key: cache[key][1]})
    assert np.array_equal(mat_only.rs_reconstruct(shards, present, [1, 2]),
                          want)


def test_no_fallback_and_unported_backends(monkeypatch):
    """The device backends default to the card and raise without one;
    the CPU backend has no device; unknown backends raise, and so does a
    multi-GPU split over more GPUs than the host has; on the CPU device
    the split builds."""
    from garage_tpu_torch.ops.cpu_codec import CpuCodec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("cuda", "hybrid"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make_codec(backend)
    assert isinstance(make_codec("cpu"), CpuCodec)
    with pytest.raises(ValueError, match="unknown codec backend"):
        make_codec("tpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"shard_mesh=2 .*device_count\(\) is 1"):
        make_codec("cuda", shard_mesh=2)
    split = make_codec("cuda", device="cpu", shard_mesh=2)
    assert split.shards == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="blake2s only"):
        make_codec("cuda", device="cpu", hash_algo="sha256")


def test_sync_failure_records_and_switches_nothing(port):
    variant = port.last_submit_variant
    port.note_sync_failure(RuntimeError("boom"), variant)
    port.note_sync_success(variant)
    ev = port.obs.events_list()[-1]
    assert ev["kind"] == "sync_failure" and ev["reason"] == "RuntimeError"
    assert port.last_submit_variant == variant == "plain"
    blocks = _blocks([100, 200], seed=13)
    ok, _ = port.scrub_encode_batch(blocks, [Hash(_digest(b)) for b in blocks])
    assert ok.all()


_IMPORT_PROBE = """
import hashlib, importlib, json, pkgutil, sys
import garage_tpu_torch
from garage_tpu_torch.ops import make_codec
from garage_tpu_torch.ops.feeder import CodecFeeder
from garage_tpu_torch.utils.data import Hash
import asyncio
# every module of the package: api/, web/, admin/, server, cli ... (not
# __main__, which runs the CLI)
names = sorted(m.name for m in pkgutil.walk_packages(
    garage_tpu_torch.__path__, "garage_tpu_torch.")
    if m.name != "garage_tpu_torch.__main__")
for name in names:
    importlib.import_module(name)
blocks = [bytes([i]) * (100 + 37 * i) for i in range(6)]
hashes = [Hash(hashlib.blake2s(b, digest_size=32).digest()) for b in blocks]
for backend in ("cuda", "hybrid", "cpu"):
    codec = make_codec(backend, rs_data=4, rs_parity=2, device="cpu")
    feeder = CodecFeeder(codec)
    ok, parity = asyncio.run(feeder.scrub_async(blocks, hashes))
    feeder.shutdown()
assert codec.scrub_encode_batch(blocks, hashes)[0].all()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "garage_tpu"
             or m.startswith("garage_tpu."))
print(json.dumps({"ok": ok.tolist(), "parity": list(parity.shape),
                  "bad": bad, "modules": names}))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["ok"] == [True] * 6 and res["parity"] == [2, 2, 285]
    for name in ("api.s3.api_server", "api.k2v_server", "api.admin_server",
                 "web.web_server", "admin.handler", "server", "cli",
                 "ops.cuda_codec", "model.garage"):
        assert f"garage_tpu_torch.{name}" in res["modules"]


def _imports_of(path: Path) -> list:
    """Every module an `import` or `from` statement of the file names,
    at any depth (imports inside functions included); relative imports
    as written (leading dots)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append("." * node.level + (node.module or ""))
    return out


def test_no_port_source_imports_jax_or_the_reference():
    sources = sorted((REPO / "garage_tpu_torch").rglob("*.py"))
    assert len(sources) > 100
    bad = [(str(p.relative_to(REPO)), m) for p in sources
           for m in _imports_of(p)
           if m.split(".")[0] in ("jax", "jaxlib", "garage_tpu")]
    assert bad == []


_CLI_PROBE = """
import atexit, runpy, sys
atexit.register(lambda: print("TORCH_LOADED", "torch" in sys.modules,
                              file=sys.stderr))
sys.argv = ["garage_tpu_torch"] + sys.argv[1:]
runpy.run_module("garage_tpu_torch", run_name="__main__")
"""


@pytest.mark.parametrize("args", [
    ["--version"], ["node-id"], ["status"], ["bucket", "list"],
    ["codec", "info"]], ids=lambda a: " ".join(a))
def test_cli_admin_commands_import_no_torch(args, tmp_path):
    """`--version` and the admin commands (which talk RPC to a daemon;
    here none listens, so those fail to connect) never load torch."""
    (tmp_path / "meta").mkdir()
    cfg = tmp_path / "garage.toml"
    cfg.write_text(f'''
metadata_dir = "{tmp_path}/meta"
data_dir = "{tmp_path}/data"
rpc_bind_addr = "127.0.0.1:1"
rpc_secret = "cli-probe"
''')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _CLI_PROBE, "-c", str(cfg),
                          *args], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert "TORCH_LOADED False" in out.stderr, out.stderr[-2000:]
    if args in (["--version"], ["node-id"]):
        assert out.returncode == 0, out.stderr[-2000:]


def test_native_build_stays_out_of_the_packages():
    """The port's native libraries (the CPU codec's kernels, the logdb
    metadata engine and the layout optimizer's cycle canceller) build
    into build/native/ at the root of the checkout: nothing is written
    inside the package (and the port never runs the reference's
    in-place make)."""
    from garage_tpu_torch.ops import native

    pkg_native = REPO / "garage_tpu_torch" / "native"
    before = sorted(p.name for p in pkg_native.iterdir())
    assert native.BUILD_DIR == REPO / "build" / "native"
    for name in ("gf256", "blake2s_mb", "logdb", "flowcost"):
        lib = native.load_native(name)
        path = native._lib_path(name)
        assert (lib is None) or (path.exists() and path.parent == native.BUILD_DIR)
    assert sorted(p.name for p in pkg_native.iterdir()) == before == [
        "blake2s_mb.cpp", "flowcost.cpp", "gf256.cpp", "logdb.cpp",
        "tsan.supp"]


def test_codec_info_reports_launches_and_feeder_routes():
    """`codec info`'s port-only keys: the device side (where the kernels
    run, this process's launch counts) and the feeder's dispatches and
    bytes by kind and side, which keep block hashing apart from the
    Merkle trie's CPU-side metadata hashing."""
    codec = make_codec("cuda", rs_data=K, rs_parity=M, device="cpu")
    feeder = CodecFeeder(codec)
    blocks = _blocks([300, 500, 700], seed=21)
    hashes = [Hash(_digest(b)) for b in blocks]
    try:
        feeder.submit_hash(blocks).result(timeout=60)
        feeder.submit_mhash([b"node-a", b"node-bb"]).result(timeout=60)
        ok, _parity = feeder.submit_scrub(blocks, hashes).result(timeout=60)
    finally:
        feeder.shutdown()
    assert ok.all()
    routes = feeder.stats()["routes"]
    assert routes["hash"] == {"tpu": {"dispatches": 1, "bytes": 1500}}
    assert routes["mhash"] == {"cpu": {"dispatches": 1, "bytes": 13}}
    assert routes["scrub"] == {"tpu": {"dispatches": 1, "bytes": 1500}}
    info = codec.info()
    assert info["device"] == "cpu" and "cuda_memory" not in info
    # the plain versions on the CPU launch no kernel: nothing is counted
    assert set(info["launches"]) == {"blake2s", "gf_apply", "gf_apply_by",
                                     "fused_scrub"}
    assert info["bytes"] == {"cpu": 13, "tpu": 3000}
