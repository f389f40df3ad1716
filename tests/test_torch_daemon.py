"""The port's daemon as users run it: `python -m garage_tpu_torch -c
garage.toml server` processes, configured through the port's CLI
(tests/test_integration.py's recipe for the reference).

Three daemons with `codec.backend = "cpu"` (the native C++ floor: this
host has no card) serve an S3 PUT and GET through different nodes; one
is stopped by SIGTERM and exits 0 while the others keep serving.  A
daemon asked for the card (`backend = "cuda"`) on a host without one
exits non-zero naming the missing device, and serves nothing from the
CPU in its place.  `--version` names the port's features, and the CLI's
admin commands start without torch.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from independent_s3_client import IndependentS3Client  # noqa: E402

pytestmark = pytest.mark.asyncio

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 20261018


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO))


def free_ports(n: int) -> list:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def write_config(d: pathlib.Path, rpc: int, s3: int, admin: int, peers,
                 backend: str) -> pathlib.Path:
    for sub in ("meta", "data"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    cfg = d / "garage.toml"
    cfg.write_text(f'''
metadata_dir = "{d}/meta"
data_dir = "{d}/data"
db_engine = "sqlite"
replication_mode = "{3 if len(peers) == 3 else 'none'}"
rpc_bind_addr = "127.0.0.1:{rpc}"
rpc_public_addr = "127.0.0.1:{rpc}"
rpc_secret = "port-daemon-test"
bootstrap_peers = [{", ".join(f'"127.0.0.1:{p}"' for p in peers)}]

[codec]
backend = "{backend}"

[s3_api]
s3_region = "garage"
api_bind_addr = "127.0.0.1:{s3}"

[admin]
api_bind_addr = "127.0.0.1:{admin}"
admin_token = "port-daemon-token"
''')
    return cfg


def cli(config, *args, check=True, timeout=60) -> subprocess.CompletedProcess:
    r = subprocess.run(
        [sys.executable, "-m", "garage_tpu_torch", "-c", str(config), *args],
        cwd=str(REPO), env=_env(), capture_output=True, text=True,
        timeout=timeout)
    if check:
        assert r.returncode == 0, f"cli {args}: {r.stdout}\n{r.stderr}"
    return r


def spawn(config, log_path) -> subprocess.Popen:
    with open(log_path, "wb") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "garage_tpu_torch", "-c", str(config),
             "server"], cwd=str(REPO), env=_env(), stdout=f,
            stderr=subprocess.STDOUT)


def wait_port(port: int, proc, log_path, timeout=60.0) -> None:
    deadline = time.monotonic() + timeout
    while True:
        assert proc.poll() is None, pathlib.Path(log_path).read_text()
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            assert time.monotonic() < deadline, f"port {port} never opened"
            time.sleep(0.1)


async def test_three_daemons_serve_s3_and_survive_a_sigterm(tmp_path):
    ports = free_ports(9)
    rpc, s3, admin = ports[:3], ports[3:6], ports[6:]
    cfgs = [write_config(tmp_path / f"node{i}", rpc[i], s3[i], admin[i], rpc,
                         "cpu") for i in range(3)]
    logs = [tmp_path / f"node{i}.log" for i in range(3)]
    procs = [spawn(c, log) for c, log in zip(cfgs, logs)]
    try:
        for i in range(3):
            wait_port(s3[i], procs[i], logs[i])
        ids = [cli(c, "node-id").stdout.strip().split("@")[0] for c in cfgs]
        for nid in ids:
            cli(cfgs[0], "layout", "assign", nid, "-z", "dc1", "-c", "1G")
        cli(cfgs[0], "layout", "apply", "--version", "1")
        made = cli(cfgs[0], "key", "create", "daemon-key").stdout
        key_id = next(x for x in made.splitlines() if "Key ID" in x).split()[-1]
        secret = next(x for x in made.splitlines() if "Secret" in x).split()[-1]
        cli(cfgs[0], "bucket", "create", "dbkt")
        cli(cfgs[0], "bucket", "allow", "dbkt", "--key", key_id, "--read",
            "--write", "--owner")
        c0 = IndependentS3Client(f"http://127.0.0.1:{s3[0]}", key_id, secret)
        c1 = IndependentS3Client(f"http://127.0.0.1:{s3[1]}", key_id, secret)
        data = np.random.default_rng(SEED).bytes(2 * 1024 * 1024 + 4321)
        st, _h, _b = await c0.request("PUT", "/dbkt/x.bin", body=data)
        assert st == 200
        st, _h, got = await c1.request("GET", "/dbkt/x.bin")
        assert st == 200 and got == data
        # SIGTERM one node: it drains and exits 0 inside the workers'
        # deadline; the other two keep serving the object
        procs[2].send_signal(signal.SIGTERM)
        assert procs[2].wait(timeout=20) == 0, logs[2].read_text()[-3000:]
        st, _h, got = await c0.request("GET", "/dbkt/x.bin")
        assert st == 200 and got == data
        stats = json.loads(cli(cfgs[0], "stats").stdout)
        assert "codec-cuda" in stats["features"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p, log in zip(procs, logs):
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0, 0]


def test_cuda_daemon_without_a_card_exits_and_serves_nothing(tmp_path):
    """No fallback: a daemon asked to build its codec on the card exits
    non-zero on a host without one, with an error that names the missing
    device; its S3 port never opens."""
    rpc, s3, admin = free_ports(3)
    cfg = write_config(tmp_path / "node", rpc, s3, admin, [rpc], "cuda")
    log = tmp_path / "node.log"
    proc = spawn(cfg, log)
    try:
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    assert rc != 0
    assert "needs a CUDA device and none is available" in text
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", s3), timeout=1).close()


def test_version_lists_the_ports_features():
    # argparse wraps the version line at the terminal's width
    r = subprocess.run([sys.executable, "-m", "garage_tpu_torch", "--version"],
                       cwd=str(REPO), env={**_env(), "COLUMNS": "500"},
                       capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0
    assert r.stdout.startswith("garage_tpu_torch 0.9.5 [features: ")
    assert "codec-cuda" in r.stdout and "codec-tpu" not in r.stdout
    import garage_tpu
    from garage_tpu_torch import FEATURES

    assert "codec-tpu" not in FEATURES
    # every feature of the reference, the TPU codec's as the CUDA one's
    assert FEATURES == [f.replace("codec-tpu", "codec-cuda")
                        for f in garage_tpu.FEATURES]
    for f in ("lmdb-equivalent-logdb", "consul-discovery",
              "kubernetes-discovery"):
        assert f in r.stdout
