"""The port's cluster-aware admission against the reference's.

A gateway sheds a request (503 SlowDown, verdict ``remote_pressure``)
when a node of the bucket's placement gossiped a pressure at or above
``remote_pressure_shed``.  That reading cannot change before the hot
node's next status exchange, so the port's Retry-After covers the time
until it is due (``System.peer_status_due_in``, capped at
``retry_after_max``); the reference answers with the gateway's local
load hint alone, which an idle gateway puts at 1 s.  A remote shed
whose status is overdue answers as the reference does.
"""

import asyncio
import math
import time
from types import SimpleNamespace

import pytest

from garage_tpu.api.admission import AdmissionGate as RGate
from garage_tpu.api.common import admit_request as r_admit
from garage_tpu_torch.api.admission import AdmissionGate, RemotePressureProbe
from garage_tpu_torch.api.common import admit_request
from garage_tpu_torch.rpc.system import STATUS_EXCHANGE_INTERVAL, System
from garage_tpu_torch.utils.data import FixedBytes32


class _Request:
    headers = {"Authorization": "AWS4-HMAC-SHA256 Credential=GK1/x"}
    path = "/bucket/key"


def _shed(admit, gate, **kw):
    token, resp = asyncio.run(admit(gate, _Request(), bucket="bucket", **kw))
    assert token is None and resp.status == 503
    return int(resp.headers["Retry-After"])


@pytest.mark.parametrize("due", [0.0, 0.4, 7.2, 45.0])
def test_a_remote_pressure_shed_waits_for_the_hot_nodes_next_status(due):
    gate, ref = AdmissionGate(), RGate()
    hint = _shed(r_admit, ref, remote_pressure=1.9)
    assert hint == ref.retry_after_hint() == gate.retry_after_hint()
    got = _shed(admit_request, gate, remote_pressure=1.9, remote_due_s=due)
    assert got == max(hint, min(math.ceil(due), gate.tun.retry_after_max))


def test_below_the_shed_pressure_both_admit():
    for admit, gate, kw in ((r_admit, RGate(), {}),
                            (admit_request, AdmissionGate(),
                             {"remote_due_s": 9.0})):
        token, resp = asyncio.run(admit(gate, _Request(), bucket="bucket",
                                        remote_pressure=1.4, **kw))
        assert resp is None and token is not None
        token.release()


def test_peer_status_due_in_counts_down_from_the_last_status():
    nid = bytes(range(32))
    sys_ = SimpleNamespace(_status_at={
        FixedBytes32(nid): time.monotonic() - 3.0})
    due = System.peer_status_due_in(sys_, nid)
    assert STATUS_EXCHANGE_INTERVAL - 3.5 < due <= STATUS_EXCHANGE_INTERVAL - 3
    sys_._status_at[FixedBytes32(nid)] -= 2 * STATUS_EXCHANGE_INTERVAL
    assert System.peer_status_due_in(sys_, nid) == 0.0
    assert System.peer_status_due_in(sys_, bytes(32)) == 0.0


def test_the_probe_names_the_hot_node_and_its_due_time():
    me, cool, hot = (bytes([i]) * 32 for i in (1, 2, 3))
    sys_ = SimpleNamespace(
        id=me, replication_mode=SimpleNamespace(replication_factor=3),
        ring=SimpleNamespace(get_nodes=lambda bid, n: [me, cool, hot]),
        peer_pressure=lambda n: {cool: 0.4, hot: 1.8}[bytes(n)],
        peer_status_due_in=lambda n: {cool: 1.0, hot: 6.5}[bytes(n)])
    probe = RemotePressureProbe(sys_)
    assert probe.pressure("bucket") == (0.0, "", 0.0)
    probe.note_bucket("bucket", b"\x07" * 32)
    assert probe.pressure("bucket") == (1.8, hot.hex()[:16], 6.5)
