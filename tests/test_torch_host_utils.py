"""The port's host helpers against the reference's, on the same inputs:
the exposition lint (utils/promlint.py) on hand-made expositions and on
both packages' own /metrics, the metrics-docs lint (utils/metricsdoc.py),
off-thread hashing (utils/async_hash.py) against hashlib, and the K2V
client (k2v_client.py, library and `python -m` CLI) against in-process
K2V servers of both packages with the same node key and clock: the two
transcripts must be equal."""

import asyncio
import hashlib
import os
import sys

import numpy as np
import pytest

import garage_tpu.k2v_client as r_k2vc
import garage_tpu.utils.async_hash as r_ahash
import garage_tpu.utils.metricsdoc as r_mdoc
import garage_tpu.utils.promlint as r_lint
import garage_tpu_torch.k2v_client as p_k2vc
import garage_tpu_torch.utils.async_hash as p_ahash
import garage_tpu_torch.utils.metricsdoc as p_mdoc
import garage_tpu_torch.utils.promlint as p_lint

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_api import PORT, REF, grant_key, make_cluster, shutdown  # noqa: E402

pytestmark = pytest.mark.asyncio

SEED = 20261022
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# expositions each lint must judge the same way: two clean ones first,
# then one or more violations of every rule the lint has
EXPOSITIONS = [
    "# HELP a_total A.\n# TYPE a_total counter\na_total 1\n",
    "# TYPE s summary\ns{quantile=\"0.5\"} 1\ns_sum 2\ns_count 3\n",
    "# TYPE a counter\na 1",
    "# TYPE a counter\n# TYPE a counter\na 1\n",
    "# HELP a x\n# HELP a y\n# TYPE a gauge\na 1\n",
    "# TYPE a wat\na 1\n",
    "# TYPE 1bad gauge\n",
    "b 1\n",
    "# TYPE a gauge\na{b=\"1\",a=\"2\"} 1\n",
    "# TYPE a gauge\na{a=\"\\q\"} 1\n",
    "# TYPE a gauge\na{a=\"1\"} 1\na{a=\"1\"} 2\n",
    "# TYPE a gauge\na{1a=\"1\"} 1\n",
    "# TYPE a gauge\na notanumber\n",
    "# TYPE a gauge\na{a=\"1\" 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"0.5\"} 1\n"
    "h_bucket{le=\"+Inf\"} 3\nh_count 3\nh_sum 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\n"
    "h_count 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_count 2\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 3\n"
    "h_count 4\n",
    "# TYPE h histogram\nh_bucket{le=\"1\",a=\"x\"} 2\n",
    "# TYPE h histogram\nh_bucket{a=\"x\"} 2\n",
]


@pytest.mark.parametrize("i", range(len(EXPOSITIONS)))
def test_promlint_verdicts_equal_reference(i):
    text = EXPOSITIONS[i]
    got = p_lint.lint_exposition(text)
    assert got == r_lint.lint_exposition(text)
    assert (got == []) == (i < 2)


async def test_promlint_and_metricsdoc_on_each_packages_metrics(tmp_path):
    """Both lints over a live node's exposition of each package (the
    port's Garage with the cuda backend's plain versions, after a few
    requests): equal verdicts from both packages' lints, and clean."""
    with open(os.path.join(REPO, "docs", "OBSERVABILITY.md")) as f:
        doc = f.read()
    for P in (REF, PORT):
        garages = await make_cluster(P, tmp_path, n=1)
        key_id, secret = await grant_key(P, garages[0], buckets=["mbkt"])
        srv = P.S3ApiServer(garages[0])
        await srv.start("127.0.0.1:0")
        client = p_k2vc.K2VClient(f"http://127.0.0.1:{srv.port}", "mbkt",
                                  key_id, secret)
        st, _h, _b = await client._req("PUT", "/mbkt/obj", body=b"x" * 3000)
        assert st == 200
        body = garages[0].system.metrics.render()
        await shutdown(garages, srv)
        assert "api_request_duration_seconds" in body or "# TYPE" in body
        assert p_lint.lint_exposition(body) == r_lint.lint_exposition(body) \
            == []
        fams = p_mdoc.families_in_exposition(body)
        assert fams == r_mdoc.families_in_exposition(body) and len(fams) > 50
        assert (p_mdoc.undocumented_families(body, doc)
                == r_mdoc.undocumented_families(body, doc))
        # a family the doc does not name is reported by both
        extra = body + "# TYPE zz_not_documented gauge\nzz_not_documented 1\n"
        assert "zz_not_documented" in p_mdoc.undocumented_families(extra, doc)
        assert (p_mdoc.undocumented_families(extra, doc, allow=["x"])
                == r_mdoc.undocumented_families(extra, doc, allow=["x"]))
    assert p_mdoc.documented_families(doc) == r_mdoc.documented_families(doc)


@pytest.mark.parametrize("algo", ["blake2s", "blake2b", "sha256"])
async def test_async_hash_equals_hashlib(algo):
    rng = np.random.default_rng([SEED, len(algo)])
    lib = {"blake2s": hashlib.blake2s, "blake2b":
           lambda: hashlib.blake2b(digest_size=32),
           "sha256": hashlib.sha256}[algo]
    for n in (0, 1, 64, 4097, 300_000):
        data = rng.bytes(n)
        want = lib()
        want.update(data)
        got = await p_ahash.async_block_hash(data, algo)
        assert bytes(got) == want.digest() == bytes(
            await r_ahash.async_block_hash(data, algo))
    # streaming: chunks below and above the inline threshold, on the
    # worker thread and inline
    chunks = [rng.bytes(int(n)) for n in (10, 200_000, 3, 150_000, 0, 9)]
    digests = []
    for mod in (p_ahash, r_ahash):
        h = mod.AsyncHasher(hashlib.md5())
        try:
            for c in chunks:
                await h.update(c)
            digests.append(await h.hexdigest())
        finally:
            await h.aclose()
    assert digests[0] == digests[1] == hashlib.md5(b"".join(chunks)).hexdigest()


async def k2v_client_session(mod, endpoint, key_id, secret) -> list:
    """One scripted session through package `mod`'s K2VClient: every
    answer, value and causality token, in order."""
    c = mod.K2VClient(endpoint, "kbkt", key_id, secret)
    log = []
    await c.insert_item("pk1", "a", b"v1")
    first = await c.read_item("pk1", "a")
    log.append(("read", first.values, str(first.token)))
    await c.insert_item("pk1", "a", b"v2")  # no token: a sibling
    both = await c.read_item("pk1", "a")
    log.append(("siblings", sorted(both.values), str(both.token), both.value))
    await c.insert_item("pk1", "a", b"v3", token=both.token)
    one = await c.read_item("pk1", "a")
    log.append(("superseded", one.values, one.value, str(one.token)))
    await c.insert_batch([("pk2", s, f"val-{s}".encode(), None)
                          for s in ("a", "b", "c")] + [("pk2", "d", None, None)])
    log.append(("batch", await c.read_batch([
        {"partitionKey": "pk2"},
        {"partitionKey": "pk1", "singleItem": True, "start": "a"}])))
    log.append(("range", await c.read_range("pk2", start="b")))
    log.append(("index", await c.read_index()))
    log.append(("poll timeout", await c.poll_item("pk1", "a", one.token,
                                                  timeout=0.3)))
    log.append(("delete range", await c.delete_range("pk2", prefix="a")))
    await c.delete_item("pk1", "a", token=one.token)
    gone = await c.read_item("pk1", "a")
    log.append(("deleted", gone.values if gone else None))
    log.append(("missing", await c.read_item("nope", "x")))
    try:
        await mod.K2VClient(endpoint, "kbkt", key_id, "bad-secret").read_item(
            "pk1", "a")
        log.append(("bad secret", "accepted"))
    except mod.K2VError as e:
        log.append(("bad secret", e.status))
    return log


async def _cli(pkg, endpoint, key_id, secret, *args) -> tuple:
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", f"{pkg}.k2v_client", "--endpoint", endpoint,
        "--bucket", "kbkt", "--key-id", key_id, "--secret", secret, *args,
        cwd=REPO, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    out, err = await asyncio.wait_for(proc.communicate(), 120)
    return proc.returncode, out.decode(), err.decode()[-500:]


async def test_k2v_client_transcripts_equal_reference(tmp_path, monkeypatch):
    """The same K2V session through each package's client against its
    own package's server (one node, the same node key and clock), and
    each package's client against the port's server: one transcript.
    The `python -m ...k2v_client` CLI prints the same lines."""
    out, keys = {}, None
    for P, mods in ((REF, (r_k2vc,)), (PORT, (p_k2vc, r_k2vc))):
        for mod in mods:
            clock = iter(range(1_700_000_000_000, 1_700_000_009_000, 7))
            monkeypatch.setattr(P.k2v_rpc, "now_msec",
                                lambda c=clock: next(c))
            root = tmp_path / f"{P.name}-{mod.__name__}"
            garages = await make_cluster(P, root, n=1, keys_from=keys)
            keys = keys or root / P.name
            key_id, secret = await grant_key(P, garages[0], buckets=["kbkt"])
            srv = P.K2VApiServer(garages[0])
            await srv.start("127.0.0.1:0")
            ep = f"http://127.0.0.1:{srv.port}"
            out[(P.name, mod.__name__)] = await k2v_client_session(
                mod, ep, key_id, secret)
            if mod is mods[0]:
                cli = []
                for i, pkg in enumerate(("garage_tpu", "garage_tpu_torch")):
                    for args in (("insert", "cli", f"k{i}", "hello"),
                                 ("read-range", "cli"),
                                 ("read", "cli", f"k{i}")):
                        rc, o, e = await _cli(pkg, ep, key_id, secret, *args)
                        assert rc == 0, e
                        cli.append(o)
                out[(P.name, "cli")] = cli
            await shutdown(garages, srv)
    runs = [v for k, v in out.items() if k[1] != "cli"]
    assert len(runs) == 3 and runs[0] == runs[1] == runs[2]
    steps = dict((x[0], x[1:]) for x in runs[0])
    assert steps["superseded"][1] == b"v3"
    assert steps["siblings"][0] == [b"v1", b"v2"]
    assert steps["missing"] == (None,) and steps["bad secret"] == (403,)
    cli_ref, cli_port = out[("garage_tpu", "cli")], out[("garage_tpu_torch",
                                                          "cli")]
    assert cli_ref == cli_port
    assert cli_port[3] == "ok\n" and '"k1"' in cli_port[4]
    assert cli_port[5].endswith("hello\n")
