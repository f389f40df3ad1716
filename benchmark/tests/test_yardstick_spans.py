"""``harness/spans.py``: the program's timeline spans on the device
trace's wall clock, each idle instant of the card given to one span,
and the four numbers read from them, on synthetic traces."""

import json

import pytest

from benchmark.harness import devtrace, spans

ANCHOR = {"wall_ns": 5_000_000_000, "mono_ns": 1_000_000_000, "bracket_ns": 80}
OFF_US = 4_000_000  # wall us = monotonic us + this


def ev(name, tid, ts_us, dur_us, **args):
    return {"name": name, "ph": "X", "tid": tid, "ts": ts_us, "dur": dur_us,
            "pid": 1, "cat": "x", "args": args}


TRACKS = {1: "scrub", 2: "feeder", 3: "slot0", 4: "slot1"}


def kernels(*ivals):
    return [{"ph": "X", "cat": "kernel", "name": "blake2s_kernel",
             "ts": a, "dur": b - a} for a, b in ivals]


def test_anchor_and_marker_put_both_on_one_wall_clock(tmp_path):
    # the profiler's clock runs 700 us behind the wall clock; its window
    # marker opened at trace 10,000 and the wall clock was read at its
    # end, 1,200 us later (the first range's entry cost)
    path = str(tmp_path / "trace.json")
    marker = {"ph": "X", "cat": "user_annotation", "name": devtrace.MARK,
              "ts": 10_000, "dur": 1_200}
    k = {"ph": "X", "cat": "kernel", "name": "k", "ts": 12_000, "dur": 50}
    with open(path, "w") as f:
        json.dump({"traceEvents": [marker, k]}, f)
    wall_read = 10_000 + 1_200 + 700
    out = spans.trace_events(path, wall_read)
    assert next(e for e in out if e["name"] == "k")["ts"] == 12_700
    # devtrace's own mapping (by the marker's start) is 1,200 us later
    assert next(e for e in devtrace.load(path, wall_read)
                if e["name"] == "k")["ts"] == 13_900
    # the timeline: monotonic us 1,000,100 is wall 5,000,100
    got = spans.to_wall([ev("stage scrub", 3, 1_000_100, 40, src=[7])],
                        ANCHOR, TRACKS)
    assert got == [{"name": "stage scrub", "track": "slot0",
                    "start": 5_000_100, "end": 5_000_140,
                    "args": {"src": [7]}}]


def test_derived_loop_delay_spans():
    evs = [
        # read ready 300 us into the await: 300 exposed, 200 on the loop
        ev("scrub await_read", 1, 1_000_000, 500, batch=3, blocks=1,
           bytes=9, ready_ns=1_000_300_000),
        # verdict delivered at 2,000 of 2,500: 500 on the loop
        ev("scrub verify", 1, 1_000_600, 2_500, batch=3, blocks=1, bytes=9,
           delivered_ns=1_002_600_000),
        # a read ready before its await began: nothing exposed, and the
        # whole await (50 us) was the loop's
        ev("scrub await_read", 1, 1_004_000, 50, batch=4, blocks=1,
           bytes=9, ready_ns=1_003_000_000),
        ev("scrub verify", 1, 1_004_100, 100, batch=4, blocks=1, bytes=9,
           delivered_ns=0),   # not stamped: no derived span
        ev("scrub list", 1, 1_004_050, 10, batch=5, blocks=1, bytes=0),
    ]
    got = spans.to_wall(evs, ANCHOR, TRACKS)
    derived = [(s["name"], s["args"]["batch"], s["start"] - OFF_US,
                s["end"] - OFF_US) for s in got if s["name"].startswith("loop")]
    assert derived == [(spans.READ_DELAY, 3, 1_000_300, 1_000_500),
                       (spans.VERIFY_DELAY, 3, 1_002_600, 1_003_100),
                       (spans.READ_DELAY, 4, 1_004_000, 1_004_050)]
    m = spans.scrub_metrics(got, 0.0, 1.0)
    assert m["scrub.read_exposed_ms"] == pytest.approx((0.3 + 0.0) / 2)
    # batch 3: 0.2 + 0.5 ms; batch 4: 0.05 ms; batch 5 has neither
    assert m["scrub.loop_delay_ms"] == pytest.approx((0.7 + 0.05) / 2)


def test_host_time_per_dispatch_counts_every_submit():
    s = [ev("stage scrub", 3, 0, 300), ev("adopt scrub", 3, 300, 100),
         ev("submit scrub", 3, 400, 100), ev("compute scrub", 3, 500, 9000),
         ev("collect scrub", 3, 9500, 500),
         ev("pool_adopt scrub", 3, 9600, 300),   # inside collect: not twice
         ev("stage scrub", 4, 100, 100, prefetch=True),
         ev("submit scrub", 4, 200, 100),
         ev("stage hash", 4, 400, 999), ev("submit hash", 4, 1400, 1),
         ev("handoff scrub", 2, 0, 5)]
    got = spans.to_wall(s, ANCHOR, TRACKS)
    assert spans.slot_seconds(got)["stage scrub"] == pytest.approx(400e-6)
    m = spans.scrub_metrics(got, 0.0, 0.0)
    assert m["transport.host_ms_per_dispatch"] == pytest.approx(
        (300 + 100 + 100 + 500 + 100 + 100) / 1e3 / 2)
    assert m["device_idle.scrub.unnamed"] is None     # no idle: no share
    assert spans.scrub_metrics([], 0.0, 1.0)["scrub.read_exposed_ms"] is None


def test_idle_instants_go_to_the_latest_open_span_node_0_first():
    w = (0.0, 1000.0)
    events = kernels((100, 200), (600, 700), (650, 800))
    idle = spans.idle_intervals(events, w)
    assert idle == [(0.0, 100), (200, 600), (800, 1000.0)]

    def s(name, a, b, track="scrub"):
        return {"name": name, "track": track, "start": a, "end": b,
                "args": {}}
    node0 = [s("scrub verify", 150, 500),
             s("stage scrub", 250, 300, "slot0"),        # nested: wins
             s(spans.VERIFY_DELAY, 450, 500),            # derived: wins
             s("scrub await_read", 520, 560)]
    node1 = [s("heal", 0, 700), s("put", 880, 950)]
    node2 = [s("scrub list", 850, 1000)]
    gaps = []
    got = spans.attribute(idle, [node0, node1, node2], gaps)
    assert gaps == [(800, 850)]
    assert spans.neighbours((800, 850), node0) == [
        "scrub await_read", ""]
    us = {k: round(v * 1e6, 6) for k, v in got.items()}
    assert us == {
        "n1:heal": 100 + 20 + 40,       # [0,100], [500,520], [560,600]
        "scrub verify": 50 + 150,       # [200,250], [300,450]
        "stage scrub": 50,
        spans.VERIFY_DELAY: 50,
        "scrub await_read": 40,
        "unnamed": 50,                  # [800,850]
        "n2:scrub list": 30 + 50,       # [850,880], [950,1000]
        "n1:put": 70,                   # node 1 ahead of node 2
    }
    assert sum(got.values()) == pytest.approx(
        sum(b - a for a, b in idle) * 1e-6)


def test_summarize_clips_to_the_window_and_reports_unnamed():
    w = (1000.0, 2000.0)
    events = kernels((900, 1100), (1500, 1600))
    node0 = [{"name": "scrub verify", "track": "scrub", "start": 800,
              "end": 1300, "args": {"batch": 1}},
             {"name": "scrub verify", "track": "scrub", "start": 1700,
              "end": 2500, "args": {"batch": 2}}]
    out = spans.summarize(events, [node0, []], w)
    assert out["idle_s"] == pytest.approx(800e-6)
    by = dict(out["idle_by_span"])
    assert by["scrub verify"] == pytest.approx(200e-6 + 300e-6)
    assert by["unnamed"] == pytest.approx(300e-6)       # [1300, 1500)
    assert out["metrics"]["device_idle.scrub.unnamed"] == pytest.approx(37.5)
    assert out["idle_by_span"][0][0] == "scrub verify"
    assert out["unnamed_gaps"] == []
    assert out["slot_s"] == {}
    assert out["throttle_s"] == {}
    pauses = [{"name": "scrub throttle", "track": "scrub", "start": a,
               "end": a + 400, "args": {"batch": 1, "signal": sig}}
              for a, sig in ((100, "queue_wait"), (600, "queue_wait"),
                             (900, "disk"))]
    assert spans.throttle_seconds(pauses) == pytest.approx(
        {"queue_wait": 800e-6, "disk": 400e-6})
    wide = spans.summarize(kernels((1000, 1010)), [node0, []],
                           (1000.0, 1_000_000.0))
    assert wide["unnamed_gaps"] == [
        [pytest.approx(2500e-6 - 1000e-6), pytest.approx((1e6 - 2500) * 1e-6),
         "scrub verify", ""]]


def test_drain_reads_only_the_window_and_counts_what_it_lost():
    from garage_tpu_torch.utils.timeline import Timeline

    tl = Timeline(size=8)

    def emit(lo, hi):
        for i in range(lo, hi):
            tl.event("scrub list", "scrub", 1_000_000_000 + 10_000 * i,
                     1_000_000_000 + 10_000 * i + 5_000, batch=i)
    emit(0, 3)
    d = spans.Drain([tl])
    d.open()                 # what came before the window is not read
    for i in range(3, 20, 4):
        emit(i, i + 4)
        d.poll()
    (got,) = d.spans()
    assert [s["args"]["batch"] for s in got] == list(range(3, 23))
    assert d.dropped == 0
    emit(23, 40)             # 17 events into a ring of 8: 9 lost
    d.poll()
    (got,) = d.spans()
    assert [s["args"]["batch"] for s in got][20:] == list(range(32, 40))
    assert d.dropped == 9
    wall = [s["start"] for s in got]
    a = d.anchors[0]
    assert wall[0] == pytest.approx(
        1_000_030_000 / 1e3 + (a["wall_ns"] - a["mono_ns"]) / 1e3)


def test_drain_of_a_program_without_a_readable_timeline_gives_nothing():
    class Ring:          # a timeline with no since() or anchor()
        def snapshot(self):
            return []
    d = spans.Drain([Ring(), Ring()])
    d.open()
    d.poll()
    assert d.result("no-trace.json", (0.0, 1.0)) is None
