"""The sanitizer builds of the port's native libraries (ops/native.py).

``GARAGE_NATIVE_SUFFIX=.asan`` / ``.tsan`` selects an AddressSanitizer /
ThreadSanitizer build of each of gf256, blake2s_mb, logdb and flowcost,
with the flags of the reference's ``garage_tpu/native/Makefile`` asan and
tsan targets, into ``build/native/lib<name>-<hash>.<san>.so``.  A child
interpreter with the sanitizer's runtime preloaded loads every variant and
runs a logdb round trip (open, put, get, iterate, close), a GF(2^8) matmul
that must equal the reference's native kernel and a multi-buffer BLAKE2s
that must equal hashlib; the sanitizer ends the child non-zero on any
report.  A variant that cannot be built raises and never gives way to the
plain library or a Python fallback.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from garage_tpu.ops import gf256 as r_gf256
from garage_tpu.ops import native as r_native
from garage_tpu_torch.ops import native

REPO = Path(__file__).resolve().parents[1]
SEED = 20261030
SANS = (".asan", ".tsan")
LIBS = ("gf256", "blake2s_mb", "logdb", "flowcost")
GF_SHAPE = (6, 8, 4096)
BLAKE_LENGTHS = (0, 1, 63, 64, 65, 4096, 70001)

CHILD = r"""
import hashlib, json, os, sys, tempfile
import numpy as np
from garage_tpu_torch.db import open_db
from garage_tpu_torch.ops import gf256, native

seed, gf_shape, lengths, gf_out = json.loads(sys.argv[1])
rng = np.random.default_rng(seed)
shards = rng.integers(0, 256, gf_shape, dtype=np.uint8)
blocks = [rng.bytes(n) for n in lengths]
gf = native.get_native_gf_matmul_blocks()
np.save(gf_out, gf(gf256.rs_parity_matrix(8, 4), shards))
b2 = native.get_native_blake2s_multi()
flow = native.get_native_flow_cancel() is not None
with tempfile.TemporaryDirectory() as d:
    db = open_db("native", path=os.path.join(d, "x.logdb"))
    tree = db.open_tree("t")
    for i in range(64):
        tree.insert(b"k%03d" % i, b"v%d" % i)
    got = tree.get(b"k007")
    rows = [(bytes(k), bytes(v)) for k, v in tree.items()]
    db.close()
    reopened = open_db("native", path=os.path.join(d, "x.logdb"))
    again = reopened.open_tree("t").get(b"k063")
    reopened.close()
print(json.dumps({
    "libs": {n: os.path.basename(native._lib_path(n, native.variant()))
             for n in ("gf256", "blake2s_mb", "logdb", "flowcost")},
    "loaded": sorted(n for (n, s), lib in native._libs.items()
                     if s == native.variant() and lib is not None),
    "blake2s": [d.hex() for d in b2(blocks)],
    "db": {"get": got.decode(), "rows": len(rows),
           "first": rows[0][0].decode(), "last": rows[-1][0].decode(),
           "reopened": again.decode()},
    "flow": flow,
}))
"""


def _runtime(suffix: str) -> dict:
    lib = {".asan": "libasan.so", ".tsan": "libtsan.so"}[suffix]
    path = subprocess.run(["gcc", f"-print-file-name={lib}"],
                          capture_output=True, text=True).stdout.strip()
    env = {**os.environ, "GARAGE_NATIVE_SUFFIX": suffix, "LD_PRELOAD": path,
           "PYTHONPATH": str(REPO)}
    if suffix == ".asan":
        env["ASAN_OPTIONS"] = "detect_leaks=0"
    else:
        supp = REPO / "garage_tpu_torch" / "native" / "tsan.supp"
        env["TSAN_OPTIONS"] = f"suppressions={supp}"
    return env


@pytest.fixture(scope="module", params=SANS)
def child(request, tmp_path_factory):
    """One child interpreter under the sanitizer: its JSON report and the
    GF parity it computed."""
    suffix = request.param
    gf_out = tmp_path_factory.mktemp("san") / "gf.npy"
    arg = json.dumps([SEED, GF_SHAPE, BLAKE_LENGTHS, str(gf_out)])
    r = subprocess.run([sys.executable, "-c", CHILD, arg], cwd=str(REPO),
                       env=_runtime(suffix), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, (r.returncode, r.stderr[-4000:])
    return suffix, json.loads(r.stdout.strip().splitlines()[-1]), \
        np.load(gf_out)


def test_every_library_loads_its_sanitized_build(child):
    suffix, rep, _ = child
    assert rep["loaded"] == sorted(LIBS)
    for name, fname in rep["libs"].items():
        assert re.fullmatch(rf"lib[a-z0-9]+-[0-9a-f]{{12}}\{suffix}\.so",
                            fname), fname
        assert (native.BUILD_DIR / fname).exists()
    assert rep["flow"]


def test_logdb_round_trip_under_the_sanitizer(child):
    _suffix, rep, _ = child
    assert rep["db"] == {"get": "v7", "rows": 64, "first": "k000",
                         "last": "k063", "reopened": "v63"}


def test_gf_matmul_under_the_sanitizer_equals_the_reference(child):
    _suffix, _rep, got = child
    rng = np.random.default_rng(SEED)
    shards = rng.integers(0, 256, GF_SHAPE, dtype=np.uint8)
    ref = r_native.get_native_gf_matmul_blocks()
    assert ref is not None, "the reference's native GF kernel did not build"
    want = ref(r_gf256.rs_parity_matrix(8, 4), shards)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_blake2s_under_the_sanitizer_equals_hashlib(child):
    import hashlib

    _suffix, rep, _ = child
    rng = np.random.default_rng(SEED)
    rng.integers(0, 256, GF_SHAPE, dtype=np.uint8)
    blocks = [rng.bytes(n) for n in BLAKE_LENGTHS]
    assert rep["blake2s"] == [hashlib.blake2s(b, digest_size=32).hexdigest()
                              for b in blocks]


def _makefile_flags() -> dict:
    """{(suffix, lib): flags} from the reference Makefile's asan/tsan
    recipes, $(SAN_*) expanded."""
    text = (REPO / "garage_tpu" / "native" / "Makefile").read_text()
    san = dict(re.findall(r"^SAN_(ASAN|TSAN) := (.*)$", text, re.M))
    out = {}
    for line in text.splitlines():
        m = re.match(r"\s+\$\(CXX\) \$\(SAN_(ASAN|TSAN)\) (.*) -o "
                     r"lib\w+\.\w+\.so (\w+)\.cpp$", line)
        if m:
            suffix = "." + m.group(1).lower()
            out[(suffix, m.group(3))] = (san[m.group(1)].split()
                                         + m.group(2).split())
    return out


@pytest.mark.parametrize("suffix", SANS)
def test_variant_flags_are_the_makefiles(suffix):
    want = _makefile_flags()
    for name in ("gf256", "blake2s_mb", "logdb"):
        assert native.flags(name, suffix) == want[(suffix, name)], name
    # the port-only flowcost library takes logdb's recipe
    assert native.flags("flowcost", suffix) == want[(suffix, "logdb")]
    # and the plain build is what it was
    assert native.flags("gf256") == native._FLAGS["gf256"]
    assert native._lib_path("gf256", suffix).name.endswith(f"{suffix}.so")
    assert native._lib_path("gf256", suffix) != native._lib_path("gf256")


@pytest.mark.parametrize("suffix", SANS)
def test_a_variant_that_cannot_build_raises(suffix, tmp_path, monkeypatch):
    """No plain library and no numpy/hashlib fallback stands in for a
    sanitizer build that the compiler refuses."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_errors", {})
    monkeypatch.setattr(native, "_resolved", {})
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setenv(native.SUFFIX_ENV, suffix)
    for name in LIBS:
        with pytest.raises(RuntimeError, match=re.escape(suffix)):
            native.load_native(name)
    with pytest.raises(RuntimeError, match="variant"):
        native.get_native_gf_matmul_blocks()
    with pytest.raises(RuntimeError, match="variant"):
        native.get_native_blake2s_multi()
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_an_unknown_suffix_raises(monkeypatch):
    monkeypatch.setenv(native.SUFFIX_ENV, ".msan")
    with pytest.raises(ValueError, match="GARAGE_NATIVE_SUFFIX"):
        native.load_native("gf256")
