"""tools/chaos.py on the CPU against the reference's scripts/chaos.py.

Both run ``--quick --phases partition --secs 2`` (one hard partition
between the two replicas of an in-process 3-node cluster under PUT/GET
traffic), the port with ``--device cpu`` (the reference's CPU codec on
every node), at the same time in two processes: both report zero
client-visible errors and the same summary keys, phase by phase.  Then
tools/loop_stalls samples one node_rebuild drill on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from garage_tpu_torch.tools import chaos

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--quick", "--phases", "partition", "--secs", "2"]


def _summary(stdout: str) -> dict:
    line = [ln for ln in stdout.splitlines() if ln.startswith("CHAOS {")]
    assert len(line) == 1, stdout[-2000:]
    return json.loads(line[0][len("CHAOS "):])


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "garage_tpu_torch.tools.chaos",
             "--device", "cpu", *ARGS], cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "ref": subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / "chaos.py"), *ARGS],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=240)
        out[name] = (p.returncode, so, se)
    return out


@pytest.mark.parametrize("side", ["port", "ref"])
def test_partition_phase_has_zero_client_errors(runs, side):
    rc, so, se = runs[side]
    assert rc == 0, se[-3000:]
    s = _summary(so)
    assert s["ok"] and "CHAOS OK" in so
    st = s["phases"]["partition"]
    assert st["errors"] == 0 and st["puts"] > 0 and st["gets"] > 0


def test_the_summary_keys_are_the_references(runs):
    port, ref = (_summary(runs[side][1]) for side in ("port", "ref"))
    assert set(port) == set(ref)
    assert set(port["phases"]) == set(ref["phases"]) == {"partition"}
    assert set(port["phases"]["partition"]) == set(ref["phases"]["partition"])


def test_the_device_picks_every_nodes_codec():
    assert chaos.codec_backend("cuda") == "cuda"
    assert chaos.codec_backend("cpu") == "cpu"
    assert chaos.sim_codec("cuda") == {"codec": {
        "rs_data": 0, "rs_parity": 0, "backend": "cuda"}}
    assert set(chaos.PHASES + chaos.ZONE_PHASES + chaos.STORM_PHASES
               + chaos.OVERLOAD_PHASES + chaos.QOS_PHASES + chaos.WAN_PHASES
               + chaos.GATEWAY_PHASES + chaos.REBUILD_PHASES) == {
        "baseline", "latency", "fail_slow", "flaky", "oneway", "partition",
        "blackhole", "disk", "zone_blackhole", "compound", "rolling",
        "zone_drain", "repair_storm", "overload", "noisy_neighbor", "wan",
        "gateway_failover", "node_rebuild"}


def test_loop_stalls_samples_a_node_rebuild_drill_on_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "garage_tpu_torch.tools.loop_stalls",
         "--child", "--device", "cpu"], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["ok"] and res["errors"] == 0
    for e in res["stalls"]:
        assert e["window"] in ("startup", "traffic", "teardown")
        assert e["max"] > 0.35 and e["first"]["loop"]
