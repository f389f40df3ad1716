"""The port's dev cluster on the CPU: tools/dev_cluster.sh's node configs,
tools/dev_configure.sh and the smoke tools against three real daemons.

Three ``python -m garage_tpu_torch -c nodeN.toml server`` processes run
on free ports (never the reference's 3900-3924, which another test file
may hold under xdist).  Their configs are the text of dev_cluster.sh's
heredoc, its ports mapped to free ones, with ``backend = "cpu"`` added
under ``[codec]`` (the script's own daemons run the config default,
hybrid, on the card).  dev_configure.sh lays the cluster out through the
port's CLI; tools/smoke.py then runs every flow (each bit-exact),
cpu_profile folds a PUT load, metadata_smoke loads and lists 5,000
objects, device_timeline exports the feeder's events (once after PUTs of
its own) and incident_dump writes a bundle, all reading their ports from the configs under
GARAGE_TPU_DEV_DIR; SIGTERM ends every daemon with exit code 0.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "garage_tpu_torch" / "tools"
SCRIPTS = ("dev_cluster.sh", "dev_configure.sh", "test_smoke.sh")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _node_config(i: int, base: Path, ports: list) -> str:
    """dev_cluster.sh's heredoc for node i, ports 39<node><k> mapped to
    ports[node * 5 + k], backend cpu added under [codec]."""
    text = (TOOLS / "dev_cluster.sh").read_text()
    tmpl = text.split("<<EOT\n", 1)[1].split("\nEOT\n", 1)[0]
    cfg = (tmpl.replace("$d", str(base / f"node{i}"))
           .replace("$SECRET", "dev-cluster-secret").replace("${i}", str(i)))
    cfg = re.sub(r"\b39([0-2])([0-4])\b",
                 lambda m: str(ports[int(m.group(1)) * 5 + int(m.group(2))]),
                 cfg)
    assert "[codec]\n" in cfg
    return cfg.replace("[codec]\n", '[codec]\nbackend = "cpu"\n') + "\n"


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    base = tmp_path_factory.mktemp("dev")
    ports = _free_ports(15)
    env = dict(os.environ, GARAGE_TPU_DEV_DIR=str(base),
               PYTHONPATH=str(REPO))
    procs = []
    for i in range(3):
        d = base / f"node{i}"
        (d / "meta").mkdir(parents=True)
        (d / "data").mkdir()
        (d / "garage.toml").write_text(_node_config(i, base, ports))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "garage_tpu_torch", "-c",
             str(d / "garage.toml"), "server"], cwd=str(REPO), env=env,
            stdout=open(d / "daemon.log", "wb"), stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + 60
        for i in range(3):
            while True:
                assert procs[i].poll() is None, \
                    (base / f"node{i}" / "daemon.log").read_text()[-3000:]
                assert time.monotonic() < deadline, f"node {i} not up"
                try:
                    socket.create_connection(
                        ("127.0.0.1", ports[i * 5]), 1).close()
                    break
                except OSError:
                    time.sleep(0.1)
        conf = subprocess.run(["bash", str(TOOLS / "dev_configure.sh")],
                              cwd=str(REPO), env=env, capture_output=True,
                              text=True, timeout=180)
        yield {"base": base, "ports": ports, "env": env, "procs": procs,
               "configure": conf}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _tool(cluster, name, *args):
    return subprocess.run(
        [sys.executable, "-m", f"garage_tpu_torch.tools.{name}", *args],
        cwd=str(REPO), env=cluster["env"], capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("script", SCRIPTS)
def test_shell_scripts_parse(script):
    r = subprocess.run(["bash", "-n", str(TOOLS / script)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_configs_are_the_scripts_with_the_cpu_codec(cluster):
    from garage_tpu_torch.tools.dev import DevCluster

    dev = DevCluster(cluster["base"])
    ports = cluster["ports"]
    assert dev.s3_ports == [ports[0], ports[5], ports[10]]
    assert dev.admin_ports == [ports[3], ports[8], ports[13]]
    assert dev.web_ports[0] == ports[2]
    assert dev.rpc_addrs == [f"127.0.0.1:{ports[1]}", f"127.0.0.1:{ports[6]}",
                             f"127.0.0.1:{ports[11]}"]
    assert dev.admin_token == "dev-admin-token"


def test_dev_configure_applies_the_layout(cluster):
    conf = cluster["configure"]
    assert conf.returncode == 0, conf.stdout[-2000:] + conf.stderr[-2000:]
    assert "Layout version: 1" in conf.stdout
    assert conf.stdout.count("dc1") >= 3


def test_smoke_passes_every_flow(cluster):
    r = _tool(cluster, "smoke")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and "SMOKE OK" in r.stdout
    assert set(res["steps_s"]) == {
        "configure", "put_get", "multipart", "list", "website", "delete",
        "metrics_lint", "feeder", "waterfall", "fleet_health"}


def test_device_timeline_exports_the_feeders_events(cluster, tmp_path):
    out = tmp_path / "t.json"
    r = _tool(cluster, "device_timeline", "-o", str(out))
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["events"] > 0 and res["by_cat"].get("feeder", 0) > 0
    assert json.loads(out.read_text())["traceEvents"]


def test_incident_dump_captures_and_lists(cluster):
    r = _tool(cluster, "incident_dump", "--reason", "dev-test")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "bundle written:" in r.stdout
    r = _tool(cluster, "incident_dump", "--list")
    assert r.returncode == 0 and "dev-test" in r.stdout


def test_cpu_profile_folds_the_put_load(cluster):
    r = _tool(cluster, "cpu_profile")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["samples"] > 0 and "event-loop" in res["roles"]
    assert res["overhead_ratio"] < 0.02


def test_metadata_smoke_loads_and_lists_5000_objects(cluster):
    r = _tool(cluster, "metadata_smoke")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["objects"] == 5000
    assert "METADATA SMOKE OK" in r.stdout


def test_device_timeline_drives_signed_puts(cluster, tmp_path):
    from garage_tpu_torch.tools.dev import DevCluster

    dev = DevCluster(cluster["base"])
    kid, sec = dev.create_key("timeline-key")
    dev.cli("bucket", "create", "timelinebkt")
    dev.cli("bucket", "allow", "timelinebkt", "--key", kid, "--read",
            "--write")
    env = dict(cluster["env"], GARAGE_TPU_KEY_ID=kid, GARAGE_TPU_SECRET=sec)
    out = tmp_path / "t.json"
    r = subprocess.run(
        [sys.executable, "-m", "garage_tpu_torch.tools.device_timeline",
         "--drive", "4", "-o", str(out)], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["events"] > 0


def test_sigterm_ends_every_daemon_with_exit_code_0(cluster):
    procs = cluster["procs"]
    for p in procs:
        p.send_signal(signal.SIGTERM)
    assert [p.wait(timeout=30) for p in procs] == [0, 0, 0]
