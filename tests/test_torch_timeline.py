"""The port's device timeline (``garage_tpu_torch/utils/timeline.py``)
as a trace on the wall clock: ``since()`` reads a window whole, the
anchor puts it beside a ``torch.profiler`` trace, and one scrub batch's
events on the ``scrub``, feeder and transport tracks share its id.

CPU only: the node runs the hybrid codec over the kernels' plain
versions, and the profiler traces CPU activity.
"""

import asyncio
import hashlib
import json
import time

import pytest

from garage_tpu_torch.ops import make_codec
from garage_tpu_torch.ops.feeder import CodecFeeder
from garage_tpu_torch.utils.data import Hash
from garage_tpu_torch.utils.timeline import Src, Timeline, submitting

from test_torch_block import PORT, _flip, _scrub_pass, close_nodes, make_nodes

TRANSPORT_SLOT = ("stage", "adopt", "submit", "compute", "collect",
                  "pool_adopt")


def _hybrid(min_link_gibs: float):
    return make_codec("hybrid", device="cpu", rs_data=8, rs_parity=4,
                      block_size=4096, pool_page_kib=1,
                      hybrid_min_link_gibs=min_link_gibs)


def _blocks(n: int, size: int = 700):
    out = [bytes([(7 * i + j) % 251 for j in range(size + 37 * i)])
           for i in range(n)]
    return out, [Hash(hashlib.blake2s(b, digest_size=32).digest())
                 for b in out]


def _by_track(tl: Timeline, events):
    names = tl.track_names()
    return [(names[e["tid"]], e) for e in events]


# --- the ring read as a stream -------------------------------------------


def test_since_reads_every_event_once_and_counts_what_the_ring_dropped():
    tl = Timeline(size=16)
    assert tl.since(0) == ([], 0, 0)
    got, cursor = [], 0
    for i in range(100):
        tl.event(f"e{i}", "t", 1000 * i, 1000 * i + 500, n=i)
        if i % 7 == 6:          # read more often than the ring wraps
            evs, cursor, lost = tl.since(cursor)
            assert lost == 0
            got += evs
    evs, cursor, lost = tl.since(cursor)
    got += evs
    assert [e["args"]["n"] for e in got] == list(range(100))
    assert cursor == 100 and tl.since(cursor) == ([], 100, 0)
    # a reader that falls behind: the ring keeps the last 16 of 40 new
    tl.counter("depth", 0, q=1)
    for i in range(39):
        tl.event("late", "t", i)
    evs, cursor2, lost = tl.since(cursor)
    assert (len(evs), cursor2, lost) == (16, 140, 24)
    assert evs[-1]["name"] == "late" and tl.dropped == 124
    # snapshot and the export are unchanged by reading
    assert tl.snapshot() == evs
    assert len([e for e in tl.chrome_trace()["traceEvents"]
                if e["ph"] != "M"]) == 16


def test_anchor_maps_monotonic_stamps_onto_the_wall_clock():
    tl = Timeline()
    a = tl.anchor()
    assert set(a) == {"wall_ns", "mono_ns", "bracket_ns"}
    assert 0 <= a["bracket_ns"] < 1_000_000
    for _ in range(3):
        m0 = time.monotonic_ns()
        w = time.time_ns()
        m1 = time.monotonic_ns()
        mapped = (m0 + m1) // 2 + a["wall_ns"] - a["mono_ns"]
        assert abs(mapped - w) <= (m1 - m0) + a["bracket_ns"] + 200_000
    tl.event("x", "t", time.monotonic_ns(), time.monotonic_ns())
    chrome = tl.chrome_trace()
    json.dumps(chrome)
    other = chrome["otherData"]
    assert set(other) == {"source", "captured_at", "dropped_events", "anchor"}
    wall_us = chrome["traceEvents"][-1]["ts"] + (
        other["anchor"]["wall_ns"] - other["anchor"]["mono_ns"]) / 1e3
    assert abs(wall_us - time.time_ns() / 1e3) < 1e6


def _profiled_session(path: str) -> list:
    """Six ``aten::mm`` calls, each inside a timeline span, under a CPU
    profiler opened as the benchmark opens its window.  Returns, per
    call, how far (us) the op lies outside its span once the trace is on
    the wall clock by the window's marker (``benchmark/harness/spans.py``
    ``trace_events``) and the span by the timeline's anchor."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import devtrace, spans

    tl = Timeline()
    x = torch.randn(192, 192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.MARK):
            mark_wall_us = time.time_ns() / 1e3
        anchor = tl.anchor()
        for i in range(6):
            time.sleep(0.003)
            t0 = time.monotonic_ns()
            torch.mm(x, x)
            tl.event("mm", "host", t0, time.monotonic_ns(), i=i)
    prof.export_chrome_trace(path)
    ops = sorted((e for e in spans.trace_events(path, mark_wall_us)
                  if e["name"] == "aten::mm"), key=lambda e: e["ts"])
    timed = tl.since(0)[0]
    assert len(ops) == len(timed) == 6
    off_us = (anchor["wall_ns"] - anchor["mono_ns"]) / 1e3
    return [max(0.0, sp["ts"] + off_us - op["ts"],
                op["ts"] + op["dur"] - (sp["ts"] + sp["dur"] + off_us))
            for op, sp in zip(ops, timed)]


def test_an_aten_op_lands_inside_its_timeline_span(tmp_path):
    """The benchmark's clock: each aten op run inside a timeline span
    lands inside that span within 0.1 ms.  A session in which the thread
    is preempted between the marker's clock reading and the marker's
    exit is misplaced whole by the length of the preemption, so one of
    three sessions must land every op within 0.1 ms and every session
    within 1 ms (a marker read at its start instead of its end is off by
    the first profiled range's entry, ~1 ms)."""
    worst = []
    for i in range(3):
        worst.append(max(_profiled_session(str(tmp_path / f"t{i}.json"))))
        assert worst[-1] <= 1000.0, worst
        if worst[-1] <= 100.0:
            break
    assert min(worst) <= 100.0, worst


# --- one scrub batch across the tracks -----------------------------------


@pytest.mark.asyncio
async def test_a_scrub_batch_carries_its_id_through_feeder_and_transport(
        tmp_path):
    (node,) = await make_nodes(PORT, tmp_path, [lambda: _hybrid(1e-6)],
                               mode="1")
    try:
        blocks, hashes = _blocks(6)
        for h, b in zip(hashes, blocks):
            await node.write_block(h, PORT.DataBlock.plain(b))
        bad = hashes[2]
        _flip(node.find_block(bad)[0], 5)
        tl = node.codec.obs.timeline
        cursor = tl.since(0)[1]
        w = PORT.ScrubWorker(node)
        w.set_tranquility(0)
        assert await _scrub_pass(w) == 1
        evs, _c, lost = tl.since(cursor)
    finally:
        await close_nodes([node])
    assert lost == 0
    tracked = _by_track(tl, evs)
    scrub = [e for track, e in tracked if track == "scrub"]
    assert {e["cat"] for e in scrub} == {"scrub"}
    for e in scrub:
        assert {"batch", "blocks", "bytes"} <= set(e["args"])
        assert all(type(e["args"][k]) is int
                   for k in ("batch", "blocks", "bytes"))
    by = {}
    for e in scrub:
        by.setdefault(e["args"]["batch"], []).append(e)
    batches = {b for b, es in by.items()
               if any(e["name"] == "scrub verify" for e in es)}
    # one prefix per block here, and all six fit one window of the
    # codec's batch_blocks: one dispatch carries every prefix
    assert len(batches) == 1
    for b in batches:
        names = [e["name"] for e in by[b]]
        assert names.count("scrub await_read") == 1
        assert names.count("scrub verify") == 1
        assert {"scrub list", "scrub read"} <= set(names)
        for name in ("scrub list", "scrub read", "scrub verify"):
            ev = next(e for e in by[b] if e["name"] == name)
            assert (ev["args"]["prefixes"], ev["args"]["blocks"]) == (6, 6)
        ver = next(e for e in by[b] if e["name"] == "scrub verify")
        aw = next(e for e in by[b] if e["name"] == "scrub await_read")
        # the resolver's stamp lies inside the verify; the read-ahead
        # finished before the await resumed
        dl = ver["args"]["delivered_ns"] // 1000
        assert ver["ts"] <= dl <= ver["ts"] + ver["dur"] + 1
        assert 0 < aw["args"]["ready_ns"] // 1000 <= aw["ts"] + aw["dur"] + 1
    quar = [e for e in scrub if e["name"] == "scrub quarantine"]
    assert len(quar) == 1 and quar[0]["args"]["batch"] in batches
    assert quar[0]["args"]["blocks"] == 1
    # the feeder handed each batch to the transport under its id, and
    # the transport's slot events of its real (not prefetch) dispatch
    # carry it too
    handed = [e for track, e in tracked
              if track == "feeder" and e["name"] == "handoff scrub"]
    assert sorted(i for e in handed for i in e["args"]["src"]) == sorted(
        batches)
    slot = [e for track, e in tracked if track.startswith("slot")]
    for b in batches:
        for stage in ("stage", "submit", "collect"):
            assert any(e["name"] == f"{stage} scrub"
                       and b in e["args"]["src"] for e in slot), (b, stage)
    assert {e["name"].split(" ")[0] for e in slot} <= set(TRANSPORT_SLOT)
    assert any(e["name"] == "pool_adopt scrub" for e in slot)
    # every id the feeder and transport carry is a batch of the track
    carried = {i for track, e in tracked if track != "scrub"
               for i in e.get("args", {}).get("src", [])}
    assert carried and carried <= set(by)


@pytest.mark.asyncio
async def test_the_inline_cpu_scrub_writes_its_dispatch_with_the_id():
    """A shut hybrid gate (a threshold no link reaches): the feeder's
    scrub runs inline on the CPU side and says so on the timeline."""
    codec = _hybrid(1e12)
    feeder = CodecFeeder(codec)
    try:
        blocks, hashes = _blocks(3)
        src = Src(41)
        with submitting(src):
            ok, _par = await feeder.scrub_async(blocks, hashes)
        assert list(ok) == [True] * 3
        assert src.delivered_ns > 0
        evs = _by_track(codec.obs.timeline, codec.obs.timeline.since(0)[0])
    finally:
        feeder.shutdown()
        codec.close()
    disp = [e for track, e in evs
            if track == "feeder" and e["name"] == "dispatch scrub"]
    assert len(disp) == 1
    a = disp[0]["args"]
    assert (a["side"], a["src"], a["blocks"]) == ("cpu", [41], 3)
    assert a["bytes"] == sum(map(len, blocks))
    assert disp[0]["ts"] * 1000 <= src.delivered_ns
    assert not [e for track, e in evs if track.startswith("slot")]


@pytest.mark.asyncio
async def test_request_spans_sit_on_the_timeline_through_its_anchor():
    """The waterfall's ``transport`` and ``device`` segments of a traced
    hash equal the timeline's enqueue → EDF pop and stage → collect end,
    once the wall-clock spans are mapped back through the anchor."""
    from garage_tpu_torch.utils.tracing import Tracer
    from garage_tpu_torch.utils.waterfall import segment_breakdown

    codec = _hybrid(1e-6)
    records = []
    tracer = Tracer("test")
    tracer.waterfall = type("Sink", (), {"note": staticmethod(records.append)})
    codec.obs.tracer = tracer
    codec.refresh_gate()
    assert codec.ragged_side() == "tpu"
    feeder = CodecFeeder(codec)
    try:
        blocks, hashes = _blocks(4)
        with tracer.new_trace("S3 PUT"):
            digs = await feeder.hash_async(blocks)
        assert [bytes(d) for d in digs] == [bytes(h) for h in hashes]
        tl = codec.obs.timeline
        evs = tl.since(0)[0]
        anchor = tl.chrome_trace()["otherData"]["anchor"]
    finally:
        feeder.shutdown()
        codec.close()
    off = anchor["wall_ns"] - anchor["mono_ns"]
    ev = {e["name"]: e for e in evs if e["ph"] in ("X", "i")}
    spans = {r["name"]: r for r in records}
    wait, dev = spans["Transport wait hash"], spans["Device hash"]
    tol = 2_000 + anchor["bracket_ns"]   # the events' us truncation
    assert abs(wait["start_ns"] - off - ev["enqueue hash"]["ts"] * 1000) < tol
    assert abs(wait["end_ns"] - off - ev["edf_pop hash"]["ts"] * 1000) < tol
    assert abs(dev["start_ns"] - off - ev["stage hash"]["ts"] * 1000) < tol
    end = ev["collect hash"]
    assert abs(dev["end_ns"] - off - (end["ts"] + end["dur"]) * 1000) < tol
    root = spans["S3 PUT"]
    seg = segment_breakdown(records, root)
    # the feeder span covers both, so each segment is exactly its span
    # less what a deeper span covers (none here)
    assert seg["transport"] == pytest.approx(
        (wait["end_ns"] - wait["start_ns"]) / 1e9, abs=1e-9)
    assert seg["device"] == pytest.approx(
        (dev["end_ns"] - dev["start_ns"]) / 1e9, abs=1e-9)


@pytest.mark.asyncio
async def test_the_governors_pause_of_the_scrub_is_a_span(tmp_path):
    """A worker the load governor duty-cycles sleeps between batches in
    the runner (utils/background.py): the pause is a ``scrub throttle``
    span naming the signal that pressed hardest."""
    from garage_tpu_torch.utils.background import BackgroundRunner

    class Governor:
        def bg_pause(self, worked_s):
            return 0.03

        def signals(self):
            return {"queue_wait": 1.3, "admission": 0.0, "disk": None}

    (node,) = await make_nodes(PORT, tmp_path, [lambda: _hybrid(1e-6)],
                               mode="1")
    runner = BackgroundRunner()
    try:
        blocks, hashes = _blocks(3)
        for h, b in zip(hashes, blocks):
            await node.write_block(h, PORT.DataBlock.plain(b))
        node.governor = runner.governor = Governor()
        w = PORT.ScrubWorker(node)
        w.set_tranquility(0)
        w.send_command("start")
        runner.spawn(w)
        for _ in range(600):
            await asyncio.sleep(0.05)
            if w.state.time_last_complete:
                break
        assert w.state.time_last_complete
    finally:
        t_stop_us = time.monotonic_ns() // 1000
        runner.stopping.set()    # cuts a pause under way short
        await asyncio.gather(*runner.tasks.values(), return_exceptions=True)
        await close_nodes([node])
    tl = node.codec.obs.timeline
    thr = [e for track, e in _by_track(tl, tl.since(0)[0])
           if track == "scrub" and e["name"] == "scrub throttle"]
    verified = {e["args"]["batch"]: e["args"]["prefixes"]
                for track, e in _by_track(tl, tl.since(0)[0])
                if e["name"] == "scrub verify"}
    whole = [e for e in thr if e["ts"] + 30_000 < t_stop_us]
    assert len(whole) >= 3
    assert all(e["dur"] >= 25_000 for e in whole)
    assert all(e["args"]["signal"] == "queue_wait" for e in thr)
    assert {e["args"]["batch"] for e in thr} >= set(verified)
    # a window settles one prefix per work(), and the governor pauses
    # after each: every verified window is followed by at least as many
    # pauses as it carried prefixes
    assert verified and all(
        sum(e["args"]["batch"] == b for e in whole) >= n
        for b, n in verified.items())
