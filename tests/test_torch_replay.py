"""The port's trace replayer (garage_tpu_torch.testing.replay) against the
reference's: the same configuration gives the same operation trace,
signature, Zipf table and object bodies, for several seeds and every
size preset, and a Replayer driven through the same scripted gateway
(a fake pool that keeps objects in a dict and sheds every 7th request
with a 503) sends the same requests and counts the same outcomes."""

import asyncio
import dataclasses
import hashlib

import pytest

import garage_tpu.testing.replay as r_replay
import garage_tpu_torch.testing.replay as p_replay

pytestmark = pytest.mark.asyncio

SEEDS = (19, 20260807, 7, 123456)


def _cfgs():
    for preset in sorted(p_replay.SIZE_PRESETS):
        for seed in SEEDS:
            yield preset, seed


def test_presets_equal_reference():
    assert p_replay.SIZE_PRESETS == r_replay.SIZE_PRESETS
    assert (dataclasses.asdict(p_replay.ReplayConfig())
            == dataclasses.asdict(r_replay.ReplayConfig()))


@pytest.mark.parametrize("preset,seed", list(_cfgs()))
def test_trace_and_signature_equal_reference(preset, seed):
    kw = dict(seed=seed, n_keys=64 + seed % 97, size_preset=preset,
              base_ops_per_s=12.0 + seed % 13, duration_s=12.0,
              read_fraction=0.5, delete_fraction=0.05)
    p_ops = p_replay.generate_ops(p_replay.ReplayConfig(**kw))
    r_ops = r_replay.generate_ops(r_replay.ReplayConfig(**kw))
    assert p_ops == r_ops and len(p_ops) > 20
    sig = p_replay.trace_signature(p_ops)
    assert sig == r_replay.trace_signature(r_ops)
    # the same seed again: the same trace (the determinism check)
    assert sig == p_replay.trace_signature(
        p_replay.generate_ops(p_replay.ReplayConfig(**kw)))
    assert (p_replay.zipf_cdf(kw["n_keys"], 1.1)
            == r_replay.zipf_cdf(kw["n_keys"], 1.1))
    for kind, key, size, _at in p_ops[:40]:
        if kind == "put":
            assert (p_replay.body_for(p_replay.ReplayConfig(**kw), key, 3,
                                      size)
                    == r_replay.body_for(r_replay.ReplayConfig(**kw), key, 3,
                                         size))
    # the signature changes with the trace
    other = dict(kw, seed=seed + 1)
    assert sig != p_replay.trace_signature(
        p_replay.generate_ops(p_replay.ReplayConfig(**other)))


class ScriptedPool:
    """A gateway stand-in: objects in a dict, every 7th request shed
    with a 503, every request logged (method, path, body digest)."""

    def __init__(self):
        self.objects = {}
        self.log = []

    async def request(self, method, path, body=b""):
        self.log.append((method, path, hashlib.sha256(body).hexdigest()))
        if len(self.log) % 7 == 0:
            return 503, b"", {}
        if method == "PUT":
            self.objects[path] = bytes(body)
            return 200, b"", {}
        if method == "GET":
            if path in self.objects:
                return 200, self.objects[path], {}
            return 404, b"", {}
        self.objects.pop(path, None)
        return 204, b"", {}


async def test_replayer_requests_and_outcomes_equal_reference():
    out = []
    for mod in (r_replay, p_replay):
        cfg = mod.ReplayConfig(seed=19, n_keys=16, base_ops_per_s=60.0,
                               duration_s=1.0, size_preset="small",
                               delete_fraction=0.1)
        pool = ScriptedPool()
        rp = mod.Replayer(cfg, pool)
        fired = []

        async def on_op(i, at, fired=fired):
            fired.append(i)

        stats = await asyncio.wait_for(rp.run(on_op=on_op), 30)
        bad = await rp.verify_all()
        summary = {k: v for k, v in stats.summary().items()
                   if k not in ("behind_s", "p50_ms", "p99_ms")}
        out.append((pool.log, summary, bad, fired,
                    sorted(rp.acked), sorted(rp.deleted)))
    assert out[1] == out[0]
    log, summary, bad, fired, acked, _deleted = out[1]
    assert fired == list(range(len(fired))) and len(fired) > 20
    assert summary["sheds"] > 0 and summary["puts"] > 0 and acked
