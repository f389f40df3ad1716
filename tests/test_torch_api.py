"""The port's HTTP front doors (garage_tpu_torch.api, .web) against the
reference's, on the same inputs.

SigV4 (header signing, server-side verification, presigned URLs and the
aws-chunked streaming body) and the S3 router go through both packages'
functions directly.  The S3, K2V, admin and website servers run
in-process on loopback clusters of each package's `Garage` nodes: the
reference with its CPU codec, the port as `Garage(config, device="cpu")`
with `codec.backend = "cuda"`, so the CUDA kernels' plain versions hash
every block.  One scripted sequence per server is driven through a
client that imports neither package (tests/independent_s3_client.py),
and the two transcripts must be equal once timestamps and random ids are
normalised.  Inputs come from numpy with a fixed seed.

The plain BLAKE2s costs ~4 ms per 64-byte chunk of a dispatch's longest
block on the CPU, so the port's clusters use 1 KiB blocks.
"""

import asyncio
import datetime
import hashlib
import hmac
import importlib
import json
import os
import re
import shutil
import sys
import types
import urllib.parse

import aiohttp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from independent_s3_client import IndependentS3Client  # noqa: E402

pytestmark = pytest.mark.asyncio

SEED = 20261017
BLOCK = 1024


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")

    model = m("model")
    return types.SimpleNamespace(
        name=name, sig=m("api.signature"), router=m("api.s3.router"),
        common=m("api.common"), S3ApiServer=m("api.s3.api_server").S3ApiServer,
        K2VApiServer=m("api.k2v_server").K2VApiServer,
        AdminApiServer=m("api.admin_server").AdminApiServer,
        WebServer=m("web.web_server").WebServer, Garage=model.Garage,
        BucketKeyPerm=model.BucketKeyPerm, layout=m("rpc.layout"),
        k2v_rpc=m("model.k2v.rpc"), ver=m("model.s3.version_table"),
        config_from_dict=m("utils.config").config_from_dict)


REF, PORT = _pkg("garage_tpu"), _pkg("garage_tpu_torch")


def _rng(salt: int):
    return np.random.default_rng([SEED, salt])


# --- SigV4 -------------------------------------------------------------------

# characters a key or query value may carry: unreserved, reserved,
# space, percent and non-ASCII
_CHARS = list("abcXYZ0189-_.~ /+=&?%:@é中")


def _text(rng, lo, hi, chars=_CHARS) -> str:
    return "".join(rng.choice(chars, int(rng.integers(lo, hi))))


def sig_case(i: int) -> dict:
    rng = _rng(100 + i)
    ts = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc) + \
        datetime.timedelta(seconds=int(rng.integers(0, 300 * 86400)))
    return {
        "key_id": "GK" + rng.bytes(12).hex(),
        "secret": rng.bytes(32).hex(),
        "region": str(rng.choice(["garage", "us-east-1"])),
        "method": str(rng.choice(["GET", "PUT", "POST", "DELETE", "HEAD"])),
        "path": "/bkt-" + _text(rng, 1, 6, list("abc123")) + "/"
                + _text(rng, 0, 24),
        "query": [(_text(rng, 1, 8), _text(rng, 0, 10))
                  for _ in range(int(rng.integers(0, 4)))],
        "headers": {"host": "127.0.0.1:3900",
                    "content-type": "application/octet-stream",
                    "x-amz-meta-note": "  two   spaces " + _text(
                        rng, 0, 6, list("ab c"))},
        "body": rng.bytes(int(rng.integers(0, 2048))),
        "ts": ts.strftime("%Y%m%dT%H%M%SZ"),
    }


class _Key:
    """The part of a model Key the verifier reads."""

    def __init__(self, secret):
        self._p = types.SimpleNamespace(secret_key=secret)

    def params(self):
        return self._p


def _verified(v) -> tuple:
    return (v.content_sha256, v.signature, v.credential.scope,
            v.credential.key_id, v.timestamp)


async def _verify(P, c, headers, path, query, raw_path=None, raw_query=None):
    async def get_key(kid):
        return _Key(c["secret"]) if kid == c["key_id"] else None

    try:
        return "ok", _verified(await P.sig.check_signature(
            get_key, c["region"], c["method"], path, query, headers,
            raw_path=raw_path, raw_query=raw_query))
    except P.sig.AuthError as e:
        return "AuthError", str(e)


@pytest.mark.parametrize("i", range(8))
async def test_sigv4_header_signature_equals_reference(i):
    """The same request signed by both packages: equal canonical
    request, string to sign, signing key and headers; each package's
    verifier accepts the other's signature and refuses a tampered one
    with the same error."""
    c = sig_case(i)
    out = {}
    for P in (REF, PORT):
        s = P.sig
        payload = hashlib.sha256(c["body"]).hexdigest()
        hdrs = {**c["headers"], "x-amz-date": c["ts"],
                "x-amz-content-sha256": payload}
        signed = sorted(hdrs)
        canon = s.canonical_request(c["method"], c["path"], c["query"], hdrs,
                                    signed, payload)
        raw_path = s.uri_encode(c["path"], encode_slash=False)
        raw_qs = "&".join(f"{s.uri_encode(k)}={s.uri_encode(v)}"
                          for k, v in c["query"])
        canon_raw = s.canonical_request(
            c["method"], c["path"], c["query"], hdrs, signed, payload,
            raw_path=raw_path, raw_query=s.raw_query_pairs(raw_qs))
        scope = f"{c['ts'][:8]}/{c['region']}/s3/aws4_request"
        out[P.name] = {
            "canon": canon, "canon_raw": canon_raw,
            "sts": s.string_to_sign(c["ts"], scope, canon),
            "key": s.signing_key(c["secret"], c["ts"][:8], c["region"]),
            "signed": s.sign_request(
                c["key_id"], c["secret"], c["region"], c["method"],
                c["path"], c["query"], c["headers"], c["body"],
                timestamp=c["ts"]),
            "signed_raw": s.sign_request(
                c["key_id"], c["secret"], c["region"], c["method"], raw_path,
                c["query"], c["headers"], c["body"], timestamp=c["ts"],
                path_is_raw=True),
            "raw_pairs": s.raw_query_pairs(raw_qs),
        }
    assert out["garage_tpu"] == out["garage_tpu_torch"]
    # verification: the reference's headers through both verifiers
    ref = out["garage_tpu"]
    lower = {k.lower(): v for k, v in {**c["headers"],
                                        **ref["signed_raw"]}.items()}
    bad = dict(lower, authorization=lower["authorization"][:-4] + "0000")
    for hdrs in (lower, bad):
        got = [await _verify(P, c, hdrs, c["path"], c["query"],
                             raw_path=raw_path,
                             raw_query=P.sig.raw_query_pairs(raw_qs))
               for P in (REF, PORT)]
        assert got[0] == got[1]
        assert got[0][0] == ("ok" if hdrs is lower else "AuthError")


@pytest.mark.parametrize("i", range(3))
async def test_sigv4_presigned_url_equals_reference(i):
    """A presigned URL from the independent client: both verifiers
    accept it with the same result, and refuse it once tampered."""
    c = sig_case(20 + i)
    cli = IndependentS3Client("http://127.0.0.1:3900", c["key_id"],
                              c["secret"], region=c["region"])
    # the URL carries the logical path; the wire carries its encoding
    raw_qs = cli.presign(c["method"], c["path"]).rsplit("?", 1)[1]
    raw_path = urllib.parse.quote(c["path"], safe="-_.~/")
    query = urllib.parse.parse_qsl(raw_qs, keep_blank_values=True)
    hdrs = {"host": "127.0.0.1:3900"}
    for tamper in (False, True):
        qs = raw_qs.replace("X-Amz-Signature=", "X-Amz-Signature=0") \
            if tamper else raw_qs
        q = urllib.parse.parse_qsl(qs, keep_blank_values=True)
        got = [await _verify(P, c, hdrs, urllib.parse.unquote(raw_path), q,
                             raw_path=raw_path,
                             raw_query=P.sig.raw_query_pairs(qs))
               for P in (REF, PORT)]
        assert got[0] == got[1]
        assert got[0][0] == ("AuthError" if tamper else "ok")
        canon = [P.sig.canonical_request(
            c["method"], c["path"], query, hdrs,
            ["host"], P.sig.UNSIGNED_PAYLOAD, skip_sig_param=True,
            raw_path=raw_path, raw_query=P.sig.raw_query_pairs(qs))
            for P in (REF, PORT)]
        assert canon[0] == canon[1]


def _chunked(body: bytes, key: bytes, scope: str, ts: str, seed: str,
             chunk: int) -> bytes:
    """An aws-chunked body signed per the AWS streaming specification."""
    empty = hashlib.sha256(b"").hexdigest()
    prev, frames = seed, []
    for off in list(range(0, len(body), chunk)) + [len(body)]:
        data = body[off:off + chunk]
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", ts, scope, prev, empty,
                         hashlib.sha256(data).hexdigest()])
        prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        frames.append(f"{len(data):x};chunk-signature={prev}\r\n".encode()
                      + data + b"\r\n")
        if not data:
            break
    return b"".join(frames)


@pytest.mark.parametrize("tamper", [False, True], ids=["intact", "tampered"])
async def test_streaming_body_decodes_as_reference(tamper):
    rng = _rng(30)
    body = rng.bytes(70_001)
    secret, ts = rng.bytes(32).hex(), "20261017T101010Z"
    key = REF.sig.signing_key(secret, ts[:8], "garage")
    seed = rng.bytes(32).hex()
    wire = _chunked(body, key, f"{ts[:8]}/garage/s3/aws4_request", ts, seed,
                    8192)
    if tamper:
        wire = wire[:20_000] + bytes([wire[20_000] ^ 1]) + wire[20_001:]
    cuts = sorted(int(x) for x in rng.integers(0, len(wire), 40))

    async def pieces():
        last = 0
        for cut in cuts + [len(wire)]:
            yield wire[last:cut]
            last = cut

    out = []
    for P in (REF, PORT):
        cred = P.sig.Credential(f"GK1/{ts[:8]}/garage/s3/aws4_request")
        got = bytearray()
        try:
            async for part in P.sig.decode_streaming_body(
                    pieces(), secret, cred, seed, ts):
                got += part
            out.append(("ok", bytes(got)))
        except P.sig.StreamingPayloadError as e:
            out.append(("StreamingPayloadError", str(e), bytes(got)))
    assert out[0] == out[1]
    assert out[0][0] == ("StreamingPayloadError" if tamper else "ok")
    if not tamper:
        assert out[0][1] == body


# --- the S3 router -----------------------------------------------------------

ROUTES = [
    ("GET", None, None, [], {}),
    ("PUT", None, None, [], {}),
    ("OPTIONS", "b", "k", [], {}),
    ("GET", "b", None, [], {}),
    ("GET", "b", None, [("list-type", "2"), ("prefix", "a/")], {}),
    ("GET", "b", None, [("uploads", "")], {}),
    ("GET", "b", None, [("versions", "")], {}),
    ("PUT", "b", None, [("versions", "")], {}),
    ("HEAD", "b", None, [], {}),
    ("PUT", "b", None, [], {}),
    ("DELETE", "b", None, [], {}),
    ("POST", "b", None, [("delete", "")], {}),
    ("POST", "b", None, [], {}),
    ("GET", "b", None, [("website", "")], {}),
    ("PUT", "b", None, [("website", "")], {}),
    ("DELETE", "b", None, [("website", "")], {}),
    ("GET", "b", None, [("cors", "")], {}),
    ("PUT", "b", None, [("cors", "")], {}),
    ("DELETE", "b", None, [("cors", "")], {}),
    ("GET", "b", None, [("lifecycle", "")], {}),
    ("PUT", "b", None, [("lifecycle", "")], {}),
    ("GET", "b", None, [("versioning", "")], {}),
    ("PUT", "b", None, [("versioning", "")], {}),
    ("GET", "b", None, [("location", "")], {}),
    ("GET", "b", None, [("acl", "")], {}),
    ("GET", "b", None, [("policy", "")], {}),
    ("GET", "b", None, [("tagging", "")], {}),
    ("DELETE", "b", None, [("encryption", "")], {}),
    ("PATCH", "b", None, [], {}),
    ("GET", "b", "k", [], {}),
    ("GET", "b", "k/é x", [("uploadId", "u1")], {}),
    ("HEAD", "b", "k", [("partNumber", "2")], {}),
    ("PUT", "b", "k", [], {}),
    ("PUT", "b", "k", [], {"x-amz-copy-source": "/b/src"}),
    ("PUT", "b", "k", [("partNumber", "3"), ("uploadId", "u")], {}),
    ("PUT", "b", "k", [("partNumber", "3"), ("uploadId", "u")],
     {"x-amz-copy-source": "/b/src"}),
    ("POST", "b", "k", [("uploads", "")], {}),
    ("POST", "b", "k", [("uploadId", "u")], {}),
    ("POST", "b", "k", [("restore", "")], {}),
    ("POST", "b", "k", [("select", ""), ("select-type", "2")], {}),
    ("POST", "b", "k", [], {}),
    ("DELETE", "b", "k", [], {}),
    ("DELETE", "b", "k", [("uploadId", "u")], {}),
    ("GET", "b", "k", [("tagging", "")], {}),
    ("PUT", "b", "k", [("acl", "")], {}),
    ("DELETE", "b", "k", [("legal-hold", "")], {}),
]


def _route(P, method, bucket, key, query, headers):
    try:
        e = P.router.parse_endpoint(method, bucket, key, query, headers)
        return (e.name, e.authorization, e.bucket, e.key, e.query)
    except P.common.ApiError as e:
        return (type(e).__name__, e.status, getattr(e, "code", None), str(e))


@pytest.mark.parametrize("req", ROUTES,
                         ids=[f"{r[0]}-{r[1]}-{r[2]}-{r[3]}" for r in ROUTES])
def test_router_equals_reference(req):
    assert _route(REF, *req) == _route(PORT, *req)


# --- in-process clusters -----------------------------------------------------


async def make_cluster(P, root, n=3, keys_from=None, extra=None):
    """n `Garage` nodes of package P on loopback with an applied layout
    (tests/test_model.py make_garage_cluster): the reference with its CPU
    codec, the port with the cuda backend's plain versions.  `keys_from`
    copies another cluster's node keys, so both clusters have the same
    node ids."""
    garages = []
    for i in range(n):
        meta = root / P.name / f"n{i}" / "meta"
        os.makedirs(meta, exist_ok=True)
        if keys_from is not None:
            src = keys_from / f"n{i}" / "meta"
            for f in os.listdir(src):
                if f.startswith("node_key"):
                    shutil.copy(src / f, meta / f)
        cfg = P.config_from_dict({
            "metadata_dir": str(meta),
            "data_dir": str(root / P.name / f"n{i}" / "data"),
            "replication_mode": "3" if n == 3 else "none",
            "rpc_bind_addr": "127.0.0.1:0", "rpc_secret": "api-test",
            "db_engine": "memory", "bootstrap_peers": [],
            "block_size": BLOCK,
            "codec": {"backend": "cpu" if P is REF else "cuda"},
            **(extra or {})})
        garages.append(P.Garage(cfg) if P is REF
                       else P.Garage(cfg, device="cpu"))
    for g in garages:
        await g.system.netapp.listen("127.0.0.1:0")
    ports = [g.system.netapp._server.sockets[0].getsockname()[1]
             for g in garages]
    for i, a in enumerate(garages):
        for j in range(i + 1, n):
            await a.system.netapp.connect(f"127.0.0.1:{ports[j]}",
                                          expected_id=garages[j].system.id)
        a.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"
    lay = garages[0].system.layout
    for g in garages:
        lay.stage_role(bytes(g.system.id), P.layout.NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    for g in garages:
        g.system.layout = P.layout.ClusterLayout.decode(enc)
        g.system._rebuild_ring()
        g.spawn_workers()
    return garages


async def grant_key(P, g, buckets=()):
    helper = g.helper()
    key = await helper.create_key("api-test")
    key.params().allow_create_bucket.update(True)
    await g.key_table.insert(key)
    for name in buckets:
        b = await helper.create_bucket(name)
        await helper.set_bucket_key_permissions(
            b.id, key.key_id, P.BucketKeyPerm(True, True, True))
    return key.key_id, key.params().secret_key


async def shutdown(garages, *servers):
    for s in servers:
        await s.stop()
    for g in garages:
        await g.shutdown()


_VOLATILE = [
    (re.compile(rb"<(LastModified|Initiated|UploadId|RequestId|"
                rb"CreationDate)>[^<]*</\1>"), rb"<\1>-</\1>"),
]


def _norm(body: bytes) -> bytes:
    for pat, rep in _VOLATILE:
        body = pat.sub(rep, body)
    return body


def _upload_id(body: bytes) -> str:
    return re.search(rb"<UploadId>([^<]*)</UploadId>", body).group(1).decode()


async def s3_sequence(client, objs: dict, parts: list) -> list:
    """One S3 session: CreateBucket, PutObject of 0 B, 1 B and
    multi-block sizes, a multipart upload with parts sent out of order,
    CopyObject, ranged and conditional GETs, HeadObject, ListObjectsV2
    with prefix, delimiter and continuation, DeleteObjects.  Returns the
    transcript of (step, status, ETag, Content-Length, Content-Range,
    normalised body)."""
    log = []

    async def req(step, method, path, query=(), body=b"", headers=None):
        st, h, data = await client.request(method, path, query=query,
                                           body=body, headers=headers,
                                           retry_on=())
        h = {k.lower(): v for k, v in h.items()}
        log.append((step, st, h.get("etag"), h.get("content-length"),
                    h.get("content-range"), _norm(data)))
        return st, h, data

    await req("create", "PUT", "/bkt")
    for k, v in objs.items():
        await req(f"put {k}", "PUT", f"/bkt/{k}", body=v)
    big = "multi/big.bin"
    etag = log[-len(objs) + list(objs).index(big)][2]
    await req("head", "HEAD", f"/bkt/{big}")
    await req("range", "GET", f"/bkt/{big}",
              headers={"range": f"bytes={BLOCK - 10}-{2 * BLOCK + 9}"})
    await req("suffix range", "GET", f"/bkt/{big}",
              headers={"range": "bytes=-700"})
    await req("if-none-match", "GET", f"/bkt/{big}",
              headers={"if-none-match": etag})
    await req("if-match wrong", "GET", f"/bkt/{big}",
              headers={"if-match": '"00"'})
    _st, _h, data = await req("mpu create", "POST", "/bkt/mpu/obj",
                              query=[("uploads", "")])
    uid = _upload_id(data)
    etags = {}
    for j in (2, 0, 1):
        _st, h, _d = await req(
            f"mpu part {j + 1}", "PUT", "/bkt/mpu/obj", body=parts[j],
            query=[("partNumber", str(j + 1)), ("uploadId", uid)])
        etags[j] = h["etag"]
    done = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{j + 1}</PartNumber><ETag>{etags[j]}</ETag>"
        "</Part>" for j in range(len(parts)))
        + "</CompleteMultipartUpload>").encode()
    await req("mpu complete", "POST", "/bkt/mpu/obj",
              query=[("uploadId", uid)], body=done)
    await req("mpu get", "GET", "/bkt/mpu/obj")
    first = len(parts[0])
    await req("mpu range", "GET", "/bkt/mpu/obj",
              headers={"range": f"bytes={first - 5}-{first + 5}"})
    await req("copy", "PUT", "/bkt/copy/big.bin",
              headers={"x-amz-copy-source": f"/bkt/{big}"})
    await req("copy get", "GET", "/bkt/copy/big.bin")
    await req("list prefix", "GET", "/bkt",
              query=[("list-type", "2"), ("prefix", "dir/"),
                     ("delimiter", "/")])
    _st, _h, data = await req("list page 1", "GET", "/bkt",
                              query=[("list-type", "2"), ("max-keys", "3")])
    token = re.search(rb"<NextContinuationToken>([^<]*)<", data).group(1)
    await req("list page 2", "GET", "/bkt",
              query=[("list-type", "2"), ("max-keys", "3"),
                     ("continuation-token", token.decode())])
    dele = ("<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>"
                                 for k in ("one.txt", "dir/a/1.txt", "nope"))
            + "</Delete>").encode()
    await req("delete objects", "POST", "/bkt", query=[("delete", "")],
              body=dele)
    await req("get deleted", "GET", "/bkt/one.txt")
    await req("list after", "GET", "/bkt", query=[("list-type", "2")])
    return log


def version_blocks(g) -> list:
    """(object key, [(part, offset, block hash, size)]) of every live
    version in node `g`'s version table."""
    out = []
    for _k, raw in g.version_table.data.store.items(None, None):
        v = g.version_table.data.decode_entry(raw)
        if not v.is_tombstone() and v.blocks:
            out.append((v.key, [(p, o, bytes(h), n)
                                for (p, o), (h, n) in v.sorted_blocks()]))
    return sorted(out)


async def test_s3_session_equals_reference(tmp_path):
    rng = _rng(40)
    objs = {"empty": b"", "one.txt": b"x",
            "multi/big.bin": rng.bytes(3 * BLOCK + 500),
            "multi/odd.bin": rng.bytes(4000),
            "dir/a/1.txt": rng.bytes(10), "dir/b/2.txt": rng.bytes(20),
            "dir/top.txt": rng.bytes(30)}
    parts = [rng.bytes(1500), rng.bytes(2100), rng.bytes(700)]
    out = {}
    for P in (REF, PORT):
        garages = await make_cluster(P, tmp_path)
        key_id, secret = await grant_key(P, garages[0])
        srv = P.S3ApiServer(garages[0])
        await srv.start("127.0.0.1:0")
        client = IndependentS3Client(f"http://127.0.0.1:{srv.port}",
                                     key_id, secret)
        log = await s3_sequence(client, objs, parts)
        out[P.name] = (log, version_blocks(garages[0]))
        await shutdown(garages, srv)
    (ref_log, ref_blocks), (port_log, port_blocks) = (
        out["garage_tpu"], out["garage_tpu_torch"])
    assert [x[0] for x in port_log] == [x[0] for x in ref_log]
    for r, p in zip(ref_log, port_log):
        assert r == p, r[0]
    statuses = {x[0]: x[1] for x in port_log}
    assert statuses["range"] == 206 and statuses["if-none-match"] == 304
    assert statuses["if-match wrong"] == 412
    assert statuses["mpu complete"] == 200 and statuses["get deleted"] == 404
    got = {x[0]: x[5] for x in port_log}
    assert got["mpu get"] == b"".join(parts)
    assert got["copy get"] == objs["multi/big.bin"]
    # the same block hashes in both clusters' version tables: every block
    # of every multi-block object, the multipart parts and the copy
    assert port_blocks == ref_blocks
    keys = {k for k, _b in port_blocks}
    assert keys == {"multi/big.bin", "multi/odd.bin", "mpu/obj",
                    "copy/big.bin"}
    for k, blocks in port_blocks:
        for _p, _o, h, _n in blocks:
            assert len(h) == 32


# --- K2V ---------------------------------------------------------------------


async def k2v_session(client) -> list:
    log = []
    token_hdr = "X-Garage-Causality-Token"

    async def req(step, method, path, query=(), body=b"", headers=None):
        st, h, data = await client.request(method, path, query=query,
                                           body=body, headers=headers,
                                           retry_on=())
        h = {k.lower(): v for k, v in h.items()}
        log.append((step, st, h.get(token_hdr.lower()), _norm(data)))
        return st, h, data

    as_json = {"accept": "application/json"}
    await req("insert a", "PUT", "/kbkt/pk1/a", body=b"v1")
    _s, h, _d = await req("read a", "GET", "/kbkt/pk1/a", headers=as_json)
    await req("insert a sibling", "PUT", "/kbkt/pk1/a", body=b"v2")
    _s, h, _d = await req("read siblings", "GET", "/kbkt/pk1/a",
                          headers=as_json)
    await req("read raw conflict", "GET", "/kbkt/pk1/a",
              headers={"accept": "application/octet-stream"})
    await req("supersede", "PUT", "/kbkt/pk1/a", body=b"v3",
              headers={token_hdr: h[token_hdr.lower()]})
    await req("read one", "GET", "/kbkt/pk1/a",
              headers={"accept": "application/octet-stream"})
    batch = [{"pk": "pk2", "sk": s, "ct": None,
              "v": "dmFs" if s != "c" else None} for s in ("a", "b", "c")]
    await req("insert batch", "POST", "/kbkt", body=json.dumps(batch).encode())
    await req("read batch", "POST", "/kbkt", query=[("search", "")],
              body=json.dumps([{"partitionKey": "pk2"},
                               {"partitionKey": "pk1", "singleItem": True,
                                "start": "a"}]).encode())
    await req("delete", "DELETE", "/kbkt/pk1/a",
              headers={token_hdr: log[-3][2] or ""})
    await req("read deleted", "GET", "/kbkt/pk1/a", headers=as_json)
    return log


async def test_k2v_items_and_tokens_equal_reference(tmp_path, monkeypatch):
    """The same inserts through both packages' K2V servers on one node
    with the same node key and the same clock: equal items, values and
    causality tokens."""
    out, keys = {}, None
    for P in (REF, PORT):
        clock = iter(range(1_700_000_000_000, 1_700_000_001_000, 7))
        monkeypatch.setattr(P.k2v_rpc, "now_msec", lambda c=clock: next(c))
        garages = await make_cluster(P, tmp_path, n=1, keys_from=keys)
        keys = tmp_path / P.name
        key_id, secret = await grant_key(P, garages[0], buckets=["kbkt"])
        srv = P.K2VApiServer(garages[0])
        await srv.start("127.0.0.1:0")
        client = IndependentS3Client(f"http://127.0.0.1:{srv.port}",
                                     key_id, secret)
        out[P.name] = await k2v_session(client)
        await shutdown(garages, srv)
    ref, port = out["garage_tpu"], out["garage_tpu_torch"]
    for r, p in zip(ref, port):
        assert r == p, r[0]
    assert len(ref) == len(port)
    steps = {x[0]: x for x in port}
    assert steps["read siblings"][1] == 200
    assert len(json.loads(steps["read siblings"][3])) == 2
    assert steps["read one"][3] == b"v3"
    assert steps["read raw conflict"][1] == 409


# --- admin REST and /metrics -------------------------------------------------

TOKEN = "api-test-admin"


_ID = re.compile(r"^(GK[0-9a-f]{24}|[0-9a-f]{64})$")


def shape(x):
    """The JSON's structure: dict keys all the way down (a key that is a
    node, bucket or access key id stands as "<id>"), a list by its first
    element's shape."""
    if isinstance(x, dict):
        return {("<id>" if _ID.match(k) else k): shape(v)
                for k, v in x.items()}
    if isinstance(x, list):
        return [shape(x[0])] if x else []
    return type(x).__name__


async def admin_session(port: int) -> list:
    hdrs = {"Authorization": f"Bearer {TOKEN}"}
    out = []

    async def call(step, method, path, body=None, query=None):
        async with aiohttp.ClientSession() as s:
            async with s.request(
                    method, f"http://127.0.0.1:{port}{path}",
                    params=query or {}, headers=hdrs,
                    data=json.dumps(body) if body is not None else None) as r:
                txt = await r.text()
        res = json.loads(txt) if txt.startswith(("{", "[")) else txt
        out.append((step, r.status, shape(res) if path != "/metrics"
                    else sorted(line.split()[2] for line in txt.splitlines()
                                if line.startswith("# TYPE "))))
        return res

    await call("status", "GET", "/v1/status")
    await call("health", "GET", "/v1/health")
    await call("layout", "GET", "/v1/layout")
    key = await call("key create", "POST", "/v1/key", {"name": "k1"})
    await call("key info", "GET", "/v1/key", query={"id": key["accessKeyId"]})
    await call("key list", "GET", "/v1/key")
    b = await call("bucket create", "POST", "/v1/bucket",
                   {"globalAlias": "adm-bkt"})
    await call("bucket allow", "POST", "/v1/bucket/allow", {
        "bucketId": b["id"], "accessKeyId": key["accessKeyId"],
        "permissions": {"read": True, "write": True, "owner": False}})
    await call("bucket info", "GET", "/v1/bucket", query={"id": b["id"]})
    await call("bucket list", "GET", "/v1/bucket")
    await call("metrics", "GET", "/metrics")
    return out


async def test_admin_rest_and_metrics_shape_equal_reference(tmp_path):
    out = {}
    for P in (REF, PORT):
        garages = await make_cluster(P, tmp_path, n=1,
                                     extra={"admin": {"admin_token": TOKEN}})
        srv = P.AdminApiServer(garages[0])
        await srv.start("127.0.0.1:0")
        out[P.name] = await admin_session(srv.port)
        await shutdown(garages, srv)
    ref, port = out["garage_tpu"], out["garage_tpu_torch"]
    for r, p in zip(ref, port):
        assert r == p, r[0]
    assert len(ref) == len(port)
    assert all(st == 200 for _s, st, _x in port)
    families = dict((s, x) for s, _st, x in port)["metrics"]
    assert "codec_bytes_total" in families and len(families) > 50


# --- the website -------------------------------------------------------------


async def test_website_equals_reference(tmp_path):
    rng = _rng(50)
    files = {"index.html": b"<h1>root</h1>", "err.html": b"custom 404",
             "photos/index.html": b"album", "big.bin": rng.bytes(5000)}
    wx = (b"<WebsiteConfiguration><IndexDocument><Suffix>index.html"
          b"</Suffix></IndexDocument><ErrorDocument><Key>err.html</Key>"
          b"</ErrorDocument></WebsiteConfiguration>")
    out = {}
    for P in (REF, PORT):
        garages = await make_cluster(P, tmp_path)
        garages[0].config.web_root_domain = ".web.localhost"
        key_id, secret = await grant_key(P, garages[0])
        s3 = P.S3ApiServer(garages[0])
        await s3.start("127.0.0.1:0")
        web = P.WebServer(garages[0])
        await web.start("127.0.0.1:0")
        client = IndependentS3Client(f"http://127.0.0.1:{s3.port}",
                                     key_id, secret)
        assert (await client.request("PUT", "/site"))[0] == 200
        assert (await client.request("PUT", "/site", query=[("website", "")],
                                     body=wx))[0] == 200
        for k, v in files.items():
            assert (await client.request("PUT", f"/site/{k}", body=v))[0] == 200
        log = []
        async with aiohttp.ClientSession() as s:
            for path in ("/", "/photos/", "/photos", "/big.bin", "/nope.html"):
                async with s.get(f"http://127.0.0.1:{web.port}{path}",
                                 headers={"Host": "site.web.localhost"},
                                 allow_redirects=False) as r:
                    log.append((path, r.status, r.headers.get("Location"),
                                r.headers.get("Content-Type"),
                                r.headers.get("ETag"), await r.read()))
        out[P.name] = log
        await shutdown(garages, web, s3)
    assert out["garage_tpu"] == out["garage_tpu_torch"]
    got = {p: (st, body) for p, st, _l, _c, _e, body in out["garage_tpu_torch"]}
    assert got["/"] == (200, files["index.html"])
    assert got["/nope.html"] == (404, files["err.html"])
    assert got["/big.bin"] == (200, files["big.bin"])
