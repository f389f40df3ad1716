"""The benchmark's harness and headline (garage_tpu_torch/tools/bench.py)
against bench.py's on the CPU.

Both packages get the same small constants (4 KiB blocks, 16-block
batches, a 4-batch window): the plain BLAKE2s costs ~4 ms per 64-byte chunk
of a block here.  The port's steps run with ``device="cpu"`` (the kernels'
plain versions); the reference's on its CPU codec, its hybrid's TPU attach
left out (it would start a JAX device on this host).

- ``make_batches``, ``bench_reference_serial``, ``bench_cpu`` and
  ``bench_repair``: equal batches, and the repair's recovered rows equal
  byte for byte to the reference's and to the lost data.
- ``bench_hybrid`` (with a ``--device-phase`` process on the CPU),
  ``bench_synth_crossover`` and ``bench_sustained``: verdicts ok, the
  reference's keys (less the dropped, under the renamed names).
- ``main``: the reference's keys less the written drop/rename list; a
  failed phase is ``<phase>_error`` and a non-zero exit after the JSON
  line; the checkpoint goes under the port's build/, never to the root's
  ``BENCH_PARTIAL.json``.
- ``run_phase_subprocess`` records a phase that exits non-zero (here: no
  GPU); the guard reads ``BENCH_TORCH_r*.json`` and ignores
  ``BENCH_r*.json``; the bench modules import no JAX and nothing of the
  reference (in a subprocess), and pin no cluster to the CPU codec.
"""

import builtins
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench as ref
from garage_tpu.ops import hybrid_codec as r_hybrid
from garage_tpu_torch.ops.cuda_codec import CudaCodec
from garage_tpu_torch.tools import bench, device_capture

REPO = Path(__file__).resolve().parents[1]
TINY = {"BLOCK": 4096, "BATCH": 16, "N_BATCHES": 4}
SUSTAINED = {"SUSTAINED_GIB": 1, "SUSTAINED_FILE_BLOCKS": 64}


def _no_drop_caches(real_open):
    """`open` that refuses /proc/sys/vm/drop_caches (the reference's
    sustained pass writes it; this host is shared)."""
    def fake(path, *a, **kw):
        if str(path).startswith("/proc/sys/vm"):
            raise PermissionError(path)
        return real_open(path, *a, **kw)
    return fake


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    for mod in (ref, bench, device_capture):
        for name, v in TINY.items():
            monkeypatch.setattr(mod, name, v)
    for mod in (ref, bench):
        for name, v in SUSTAINED.items():
            monkeypatch.setattr(mod, name, v)
    monkeypatch.setattr(bench, "SUSTAINED_DIR", str(tmp_path / "port_sus"))
    monkeypatch.setattr(ref, "SUSTAINED_DIR", str(tmp_path / "ref_sus"))
    monkeypatch.setattr(bench, "_drop_page_cache", lambda: False)
    monkeypatch.setattr(ref, "open", _no_drop_caches(builtins.open),
                        raising=False)
    # the reference hybrid's background TPU attach stays off: its CPU
    # floor runs, as with no device
    monkeypatch.setattr(r_hybrid.HybridCodec, "_build_device_thread",
                        lambda self: None)
    batches = bench.make_batches(np.random.default_rng(0))
    return batches


def test_batches_baseline_cpu_floor_and_repair_match_the_reference(
        tiny, monkeypatch):
    batches = tiny
    rbatches = ref.make_batches(np.random.default_rng(0))
    assert [(b, [bytes(h) for h in hs]) for b, hs in batches] == \
        [(b, [bytes(h) for h in hs]) for b, hs in rbatches]
    assert bench.bench_reference_serial(batches) > 0
    assert ref.bench_reference_serial(rbatches) > 0
    assert bench.bench_cpu(batches) > 0 and ref.bench_cpu(rbatches) > 0

    rows = {}

    def capture(key, fn):
        def wrapped(self, *a, **kw):
            out = fn(self, *a, **kw)
            rows[key] = np.array(out)
            return out
        return wrapped

    from garage_tpu.ops.cpu_codec import CpuCodec as RCpuCodec
    monkeypatch.setattr(CudaCodec, "rs_reconstruct",
                        capture("port", CudaCodec.rs_reconstruct))
    monkeypatch.setattr(RCpuCodec, "rs_reconstruct",
                        capture("ref", RCpuCodec.rs_reconstruct))
    assert bench.bench_repair(batches, "cpu") > 0
    assert ref.bench_repair(rbatches) > 0
    data = np.stack([np.frombuffer(b, np.uint8) for b in batches[0][0]])
    lost = data.reshape(-1, 8, 4096)[:, [2, 5], :]
    assert rows["port"].shape == lost.shape
    assert np.array_equal(rows["port"], rows["ref"])
    assert np.array_equal(rows["port"], lost)


def _device_keys() -> set:
    """The reference's device-resident keys under the port's names."""
    return {bench.RENAMED_KEYS.get(k, k) for k in ref._DEVICE_ZERO}


def test_hybrid_window_and_device_phase_cover_the_references_keys(tiny):
    batches = tiny
    rate, frac, dev, codec = bench.bench_hybrid(batches, "cpu")
    try:
        assert rate > 0 and 0.0 <= frac <= 1.0
        assert _device_keys() | {"device_block_kib"} <= set(dev)
        assert dev["device_scrub_variant"] == "cuda"
        assert dev["device_lanes"] == codec.device_batch_blocks
        # every rung's digests were checked against hashlib before timing
        assert [r["lanes"] for r in dev["device_fused_rungs"]][-1] == \
            dev["device_lanes"]
        attr = bench.codec_attribution(codec)
        assert set(attr) == {"stages", "link_stages", "bytes_by_side",
                             "tpu_frac_cumulative", "gate_events"}
    finally:
        codec.close()
    rrate, rfrac, rdev, rcodec = ref.bench_hybrid(
        ref.make_batches(np.random.default_rng(0)), False)
    assert rrate > 0 and rdev == ref._DEVICE_ZERO
    assert set(ref.codec_attribution(rcodec)) == set(attr)


def test_synth_crossover_and_sustained_pass_match_the_references_keys(
        tiny):
    from garage_tpu.ops.codec import CodecParams as RParams
    from garage_tpu_torch.ops import make_codec

    batches = tiny
    port = bench.bench_synth_crossover(batches)
    reference = ref.bench_synth_crossover(
        ref.make_batches(np.random.default_rng(0)))
    assert set(port) == set(reference)
    assert 0.0 <= port["synth_tpu_frac"] <= 1.0

    codec = make_codec("hybrid", device="cpu", rs_data=8, rs_parity=4,
                       batch_blocks=16)
    try:
        port = bench.bench_sustained(codec)
    finally:
        codec.close()
    rcodec = r_hybrid.HybridCodec(RParams(rs_data=8, rs_parity=4,
                                          batch_blocks=16),
                                  build_device=False)
    reference = ref.bench_sustained(rcodec)
    assert set(port) == set(reference) | {"sustained_page_cache_dropped"}
    assert port["sustained_gib_scanned"] == \
        reference["sustained_gib_scanned"]
    assert port["sustained_gibs"] > 0 and port["disk_gibs"] > 0
    assert not Path(bench.SUSTAINED_DIR).exists()


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_main_records_a_failed_phase_and_exits_nonzero(tiny, monkeypatch,
                                                       tmp_path, capsys):
    root_partial = REPO / "BENCH_PARTIAL.json"
    before = root_partial.read_bytes()
    (tmp_path / "BENCH_r99.json").write_text(json.dumps({"value": 1e9}))
    monkeypatch.setattr(bench, "DEVICE", "cpu")
    monkeypatch.setattr(bench, "PARTIAL", tmp_path / "build" / "P.json")
    monkeypatch.setattr(bench, "RECORDS_DIR", tmp_path)
    flags = []

    def fake_phase(flag, timeout=600):
        flags.append(flag)
        if flag == "--put-phase":
            return {"put_phase_error": {"rc": 1, "stderr": "failed"}}
        return {}

    monkeypatch.setattr(bench, "run_phase_subprocess", fake_phase)
    rc = bench.main([])
    port = _last_json(capsys.readouterr().out)
    assert rc == 1
    assert set(flags) == set(bench._PHASES)
    assert port["errors"] == ["put_phase_error"]
    assert port["headline_best_prior_src"] is None
    assert port["value"] > 0 and "partial" not in port
    assert json.loads((tmp_path / "build" / "P.json").read_text()) == port
    assert root_partial.read_bytes() == before

    # the reference's main on the same steps, its attach loop and phases
    # stubbed, its records and checkpoint in a temporary directory
    class Attach:
        up = False

        def start(self):
            return self

        def stop(self):
            pass

        def snapshot(self):
            return {k: None for k in bench.DROPPED_KEYS}

    monkeypatch.setattr(ref, "AttachLoop", Attach)
    rflags = []
    monkeypatch.setattr(ref, "run_phase_subprocess",
                        lambda flag, **_k: rflags.append(flag) or {})
    monkeypatch.setattr(ref, "__file__", str(tmp_path / "ref" / "bench.py"))
    monkeypatch.setattr(ref, "JAX_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    (tmp_path / "ref").mkdir()
    ref.main()
    reference = _last_json(capsys.readouterr().out)
    want = {bench.RENAMED_KEYS.get(k, k) for k in reference
            if k not in bench.DROPPED_KEYS}
    assert want <= set(port), sorted(want - set(port))
    # the phases run in the reference's order
    assert flags == rflags
    assert root_partial.read_bytes() == before


def test_run_phase_subprocess_records_a_phase_that_fails():
    """Without a GPU the phase process exits non-zero: an error record,
    never an empty result."""
    out = bench.run_phase_subprocess("--rs-put-phase", timeout=120)
    err = out["rs_put_phase_error"]
    assert err["rc"] not in (0, None)
    assert "no CUDA device" in err["stderr"]
    assert set(out) == {"rs_put_phase_error", "rs_put_phase_wall_s"}


def test_the_guard_reads_only_the_ports_records(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "RECORDS_DIR", tmp_path)
    (tmp_path / "BENCH_r99.json").write_text(json.dumps({"value": 100.0}))
    out = {"value": 1.0}
    assert bench._headline_guard(out) == 0
    assert out["headline_best_prior_src"] is None
    assert out["headline_best_prior_gibs"] == 0.0
    line = json.dumps({"value": 2.0, "cpu_functions": {"f": 0.1}})
    (tmp_path / "BENCH_TORCH_r01.json").write_text(json.dumps(
        {"n": 1, "cmd": "python -m garage_tpu_torch.tools.bench", "rc": 0,
         "tail": f"# a log line\n{line}\n"}))
    out = {"value": 1.0, "hybrid_phase_cpu_profile": {
        "top": [{"leaf": "f", "count": 9}, {"leaf": "g", "count": 1}]}}
    assert bench._headline_guard(out) == 1
    assert out["headline_best_prior_src"] == "BENCH_TORCH_r01.json"
    assert out["headline_best_prior_gibs"] == 2.0
    assert out["cpu_func_regressions"][0]["func"] == "f"
    out = {"value": 1.9}
    assert bench._headline_guard(out) == 0


def test_the_bench_modules_import_no_jax_and_nothing_of_the_reference():
    code = ("import sys\n"
            "import garage_tpu_torch.tools.bench, "
            "garage_tpu_torch.tools.bench_api, "
            "garage_tpu_torch.tools.bench_repair, "
            "garage_tpu_torch.tools.bench_scale\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'garage_tpu', 'bench')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
    for name in ("bench", "bench_api", "bench_repair", "bench_scale"):
        src = (REPO / "garage_tpu_torch" / "tools" / f"{name}.py").read_text()
        assert '"backend": "cpu"' not in src
        assert "import jax" not in src and "garage_tpu." not in src


def test_every_phase_flag_and_key_rename_is_the_references():
    assert list(bench._PHASES) == list(ref._PHASES)
    for flag in bench._PHASES:
        assert bench._phase_cpu_key(flag) == ref._phase_cpu_key(flag)
    assert set(bench.RENAMED_KEYS) <= set(ref._DEVICE_ZERO)
    for key in (*bench.DROPPED_KEYS, *bench.RENAMED_KEYS,
                *bench.RENAMED_KEYS.values()):
        assert f"``{key}``" in bench.__doc__
    from garage_tpu_torch.tools.bench_api import CARD_CODEC
    assert CARD_CODEC == {"backend": "cuda"}


def test_the_device_phase_holds_the_references_keys(monkeypatch, capsys):
    """``--device-phase`` in this process on the plain versions at a tiny
    block: the reference's device keys under the port's names, and its
    rungs checked against hashlib."""
    monkeypatch.setenv("BENCH_DEVICE_SPEC", json.dumps(
        {"device": "cpu", "block": 2048, "device_batch_blocks": 128,
         "reps": 1}))
    assert bench.main(["--device-phase"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert _device_keys() <= set(out)
    assert out["device_lanes"] == 128 and out["device_block_kib"] == 2
    assert all(r["gibs"] > 0 for r in out["device_fused_rungs"])


def test_the_committed_record_is_the_guards_prior():
    """BENCH_TORCH_r01.json, the first full run on the card, is what the
    next run's guard compares its headline with."""
    record = json.loads((REPO / "BENCH_TORCH_r01.json").read_text())
    assert record["card"].startswith("NVIDIA H100")
    assert record["device"].startswith("NVIDIA H100")
    assert bench._best_prior_headline() == (record["value"],
                                            "BENCH_TORCH_r01.json")
    assert {bench.RENAMED_KEYS.get(k, k) for k in ref._DEVICE_ZERO} <= \
        set(record)
