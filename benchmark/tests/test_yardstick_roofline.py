"""K1's work and the card's peaks, for fixed shapes."""

import importlib

import pytest

from benchmark.harness import roofline


def test_blake2s_compression_is_1120_ops():
    # RFC 7693: 10 rounds x 8 G, G = 6 additions + 4 XORs + 4 rotations
    assert roofline.B2S_OPS_PER_CHUNK == 1120


@pytest.mark.parametrize("lengths, chunks", [
    ([0], 1), ([1], 1), ([64], 1), ([65], 2), ([700001], 10938),
    ([1048576], 16384), ([1048576] * 256, 16384 * 256),
])
def test_blake2s_work(lengths, chunks):
    ops, nbytes = roofline.blake2s_work(lengths)
    assert ops == chunks * 1120
    assert nbytes == sum(lengths) + 32 * len(lengths)


def test_int32_issue_rate_and_bound():
    assert roofline.INT32_OPS_PER_S == pytest.approx(64 * 132 * 1.98e9)
    ops, nbytes = roofline.blake2s_work([1048576])
    # one 1 MiB block is bound by issue: 18.35 M ops at 16.73 T ops/s
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        ops / (64 * 132 * 1.98e9))
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.share_percent(ops, nbytes, 2 * roofline.least_seconds(
        ops, nbytes)) == pytest.approx(50.0)
    assert roofline.share_percent(ops, nbytes, 0) is None


def test_k1_reader_counts_the_device_side_bytes():
    from benchmark.harness.spec import load_reader, BENCH_DIR

    r = load_reader(BENCH_DIR / "metrics" / "k1_roofline.py")
    mib = 2**20
    obs = {"trace": {"k1_s": 0.028},
           "trace_bytes_by_side": ({"tpu": 0, "cpu": 0}, {"tpu": mib, "cpu": 5})}
    ops = 16384 * 1120
    want = 100 * max(ops / roofline.INT32_OPS_PER_S, mib / 3.35e12) / 0.028
    assert r.read(obs) == pytest.approx(want)
    assert r.read({"trace": {"k1_s": 0.0},
                   "trace_bytes_by_side": obs["trace_bytes_by_side"]}) is None
