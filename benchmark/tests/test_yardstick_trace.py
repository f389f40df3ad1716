"""The reduction of profiler traces: wall-clock alignment by the
window's marker, busy time as a union over processes, idle gaps named
from the host samples."""

import json

import pytest

from benchmark.harness import devtrace, profiling


def write_trace(path, mark_ts, kernels, wall_open, samples, window):
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.MARK,
           "ts": mark_ts, "dur": 1.0}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
           for n, t, d in kernels]
    ev.append({"ph": "i", "cat": "overhead", "name": "x", "ts": 0})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": 123, "traceEvents": ev}, f)
    with open(path + ".host.json", "w") as f:
        json.dump({"window": window, "samples": samples}, f)


def test_two_processes_on_one_card(tmp_path):
    # process A's trace clock is 500 us behind the wall clock, B's 9,000
    # ahead; both open their window at wall 1,000,000 us
    a, b = str(tmp_path / "trace-1.json"), str(tmp_path / "trace-2.json")
    write_trace(a, 999_500, [("blake2s_kernel(x)", 999_600, 100_000)],
                1_000_000, [[1_300_000, "ops/feeder.py:_loop"]],
                [1_000_000, 2_000_000])
    write_trace(b, 1_009_000, [("gf_apply_kernel", 1_059_100, 50_000),
                               ("blake2s_kernel(y)", 1_409_000, 200_000)],
                1_000_000, [[1_700_000, "api/s3/put.py:save_stream"],
                            [1_750_000, "api/s3/put.py:save_stream"]],
                [1_000_000, 2_000_000])
    red = profiling.reduce([a, b], (1_000_000, 2_000_000))
    # A: [1.0001, 1.1001] s; B: [1.0501, 1.1001] and [1.4, 1.6] s
    assert red["busy_s"] == pytest.approx(0.1 + 0.2)
    assert red["window_s"] == pytest.approx(1.0)
    assert red["k1_s"] == pytest.approx(0.3)
    assert red["device_events"] == 3
    gaps = red["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([0.4, 0.2999, 0.0001])
    assert gaps[0][0] == "api/s3/put.py:save_stream"   # (1.6, 2.0)
    assert gaps[1][0] == "ops/feeder.py:_loop"          # (1.1001, 1.4)
    assert red["device_ops"][0] == ["blake2s_kernel(y)", pytest.approx(0.2)]


def test_events_outside_the_window_are_clipped(tmp_path):
    p = str(tmp_path / "trace-1.json")
    write_trace(p, 0, [("k", -50, 100), ("k", 900, 200)], 0, [], [0, 1000])
    red = profiling.reduce([p])
    assert red["busy_s"] == pytest.approx(150e-6)
    assert red["idle_gaps"][0] == ["no thread in the program's code",
                                   pytest.approx(850e-6)]


def test_card_time_of_an_untraced_window_is_the_union_of_its_device_events(
        tmp_path):
    p = str(tmp_path / "trace.json")
    ev = [{"ph": "X", "cat": "kernel", "name": "blake2s_kernel", "ts": 100,
           "dur": 300},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 350,
           "dur": 100},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 1000,
           "dur": 50},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 90, "dur": 5000},
          {"ph": "i", "cat": "kernel", "name": "no duration", "ts": 0}]
    with open(p, "w") as f:
        json.dump({"traceEvents": ev}, f)
    red = profiling.card_time(p)
    # [100, 450] and [1000, 1050] us; the runtime call is the host's
    assert red["busy_s"] == pytest.approx(400e-6)
    assert red["device_events"] == 3
