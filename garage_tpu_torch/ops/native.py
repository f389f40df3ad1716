"""ctypes loaders for the port's native C++ libraries.

Four libraries, sources in ``garage_tpu_torch/native/``:
  - gf256.cpp      → libgf256.so      (AVX2/GFNI GF(2^8) matmul)
  - blake2s_mb.cpp → libblake2smb.so  (multi-buffer BLAKE2s-256;
    16-lane AVX-512 / 8-lane AVX2, runtime-dispatched inside the kernel)
  - logdb.cpp      → liblogdb.so      (the `native` metadata engine,
    bound by ``db/native_adapter.py``)
  - flowcost.cpp   → libflowcost.so   (the layout optimizer's
    negative-cycle cancellation, bound by ``rpc/graph_algo.py``)

The first two are the CPU floor of the hybrid codec, not device
kernels.  Each library is compiled with the host C++ compiler at first
use (never at import) into ``build/native/`` at the root of the
checkout: the file name carries a hash of the source, flags and host,
the compiler writes a temporary file and a finished build is renamed
into place, so concurrent processes (test workers) never load or
clobber a half-written library, and nothing is ever written inside a
package directory.  A failed build is remembered for the life of the
process.  The codec's
callers fall back to numpy (GF) / hashlib (BLAKE2s) when a kernel is
unavailable, e.g. on a host without a C++ compiler, and the layout
optimizer to its Python loop; the metadata engine has no fallback
(``require_native`` raises).

Sanitizer builds: ``GARAGE_NATIVE_SUFFIX=.asan`` (or ``.tsan``) selects
an AddressSanitizer (ThreadSanitizer) build of every library,
``lib<name>-<hash>.asan.so``, with the reference Makefile's flags
(``-fsanitize=address|thread -fno-omit-frame-pointer -g -O1``).  A
variant that cannot be built or loaded raises, from ``load_native`` too:
no plain library and no Python fallback ever stands in for it.  Python
loads a sanitized library only with the sanitizer's runtime preloaded::

    GARAGE_NATIVE_SUFFIX=.asan ASAN_OPTIONS=detect_leaks=0 \
        LD_PRELOAD=$(gcc -print-file-name=libasan.so) python ...
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("garage_tpu_torch.ops.native")

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the one build recipe of native/: the GF kernel is tuned for the build
# host (and parallel over codewords); the BLAKE2s kernel carries its own
# target("avx2") attributes and checks the CPU at run time
_FLAGS = {
    "gf256": ["-O3", "-march=native", "-fPIC", "-Wall", "-fopenmp",
              "-shared"],
    "blake2s_mb": ["-O3", "-fPIC", "-Wall", "-shared"],
    "logdb": ["-O3", "-march=native", "-fPIC", "-Wall", "-shared"],
    "flowcost": ["-O3", "-march=native", "-fPIC", "-Wall", "-shared"],
}
_LIB_NAMES = {"gf256": "libgf256", "blake2s_mb": "libblake2smb",
              "logdb": "liblogdb", "flowcost": "libflowcost"}
# the sanitizer variants (garage_tpu/native/Makefile's asan and tsan
# targets): the sanitizer's flags, then the library's own, where only the
# GF kernel keeps -march=native and OpenMP
SUFFIX_ENV = "GARAGE_NATIVE_SUFFIX"
_SANITIZERS = {
    ".asan": ["-fsanitize=address", "-fno-omit-frame-pointer", "-g", "-O1"],
    ".tsan": ["-fsanitize=thread", "-fno-omit-frame-pointer", "-g", "-O1"],
}
_SAN_FLAGS = {
    "gf256": ["-march=native", "-fPIC", "-Wall", "-fopenmp", "-shared"],
    "blake2s_mb": ["-fPIC", "-Wall", "-shared"],
    "logdb": ["-fPIC", "-Wall", "-shared"],
    "flowcost": ["-fPIC", "-Wall", "-shared"],
}

_BUILD_LOCK = threading.Lock()
# by (name, suffix): the library, or None when it could not be built
_libs: Dict[tuple, Optional[ctypes.CDLL]] = {}
_errors: Dict[tuple, str] = {}  # why a library could not be built or loaded


def variant() -> str:
    """The build variant GARAGE_NATIVE_SUFFIX selects: "" (plain),
    ".asan" or ".tsan"; ValueError for any other value."""
    suffix = os.environ.get(SUFFIX_ENV, "")
    if suffix and suffix not in _SANITIZERS:
        raise ValueError(f"{SUFFIX_ENV}={suffix!r}: expected one of "
                         f"{sorted(_SANITIZERS)} or nothing")
    return suffix


def flags(name: str, suffix: str = "") -> List[str]:
    """The compiler flags of native/<name>.cpp in variant `suffix`."""
    if not suffix:
        return _FLAGS[name]
    return _SANITIZERS[suffix] + _SAN_FLAGS[name]


def _lib_path(name: str, suffix: str = "") -> Path:
    """Where variant `suffix` of native/<name>.cpp is built: the name
    carries a hash of the source, the flags and the host."""
    src = (NATIVE_SRC / f"{name}.cpp").read_bytes()
    key = src + " ".join(flags(name, suffix)).encode() + platform.node().encode()
    tag = hashlib.sha256(key).hexdigest()[:12]
    return BUILD_DIR / f"{_LIB_NAMES[name]}-{tag}{suffix}.so"


def _build(name: str, suffix: str, out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *flags(name, suffix), "-o", str(tmp),
                        str(NATIVE_SRC / f"{name}.cpp")],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library for native/<name>.cpp in the variant
    GARAGE_NATIVE_SUFFIX selects, built first if needed.  None when the
    plain library cannot be built or loaded here; a sanitizer variant
    that cannot be raises RuntimeError."""
    suffix = variant()
    key = (name, suffix)
    with _BUILD_LOCK:
        if key not in _libs:
            lib = None
            try:
                out = _lib_path(name, suffix)
                if not out.exists():
                    _build(name, suffix, out)
                lib = ctypes.CDLL(str(out))
            except subprocess.CalledProcessError as e:
                _errors[key] = (f"{e.cmd[0]} exited {e.returncode}: "
                                f"{e.stderr.decode(errors='replace')[-400:]}")
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _errors[key] = str(e)
            if lib is None:
                logger.debug("native %s%s unavailable: %s", name, suffix,
                             _errors[key])
            _libs[key] = lib
        if _libs[key] is None and suffix:
            raise RuntimeError(f"cannot build or load the {suffix} variant "
                               f"of {_LIB_NAMES[name]} into {BUILD_DIR}: "
                               f"{_errors.get(key)}")
        return _libs[key]


def require_native(name: str) -> ctypes.CDLL:
    """load_native for a caller with no fallback: raises RuntimeError,
    with the compiler's or loader's reason, when the library cannot be
    built or loaded here."""
    lib = load_native(name)
    if lib is None:
        raise RuntimeError(f"cannot build or load {_LIB_NAMES[name]} into "
                           f"{BUILD_DIR}: {_errors.get((name, ''))}")
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# --- GF(2^8) matmul ---

_resolved: Dict[str, Optional[Callable]] = {}


def get_native_gf_matmul_blocks() -> Optional[Callable]:
    """fn(mat (r, k), shards (..., k, s)) → (..., r, s) uint8 through the
    native GF kernel, or None (numpy fallback); builds on first call."""
    if "gf_blocks" in _resolved:
        return _resolved["gf_blocks"]
    fn = None
    lib = load_native("gf256")
    if lib is not None:
        lib.gf_matmul_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.gf_matmul_blocks.restype = None

        def fn(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
            r, k = mat.shape
            shards = np.ascontiguousarray(shards, dtype=np.uint8)
            if shards.shape[-2] != k:
                raise ValueError(f"shards {shards.shape} do not have k={k} rows")
            lead = shards.shape[:-2]
            batch = int(np.prod(lead)) if lead else 1
            s = shards.shape[-1]
            out = np.zeros(lead + (r, s), dtype=np.uint8)
            mat_c = np.ascontiguousarray(mat, dtype=np.uint8)
            lib.gf_matmul_blocks(_u8p(mat_c), _u8p(shards), _u8p(out),
                                 batch, r, k, s)
            return out
    _resolved["gf_blocks"] = fn
    return fn


def get_native_gf_matmul_ptrs() -> Optional[Callable]:
    """fn(mat (r,k) uint8, buffers: Sequence[bytes], s) → (B, r, s) uint8,
    where consecutive groups of k buffers form one codeword, each
    zero-extended to width s.  len(buffers) must be a multiple of k.
    Only available when the GFNI kernel backs it (on AVX2-only hosts,
    packing + gf_matmul_blocks is faster than the scalar gather)."""
    if "gf_ptrs" in _resolved:
        return _resolved["gf_ptrs"]
    fn = None
    lib = load_native("gf256")
    if lib is not None and lib.gf_ptrs_fast():
        lib.gf_matmul_ptrs.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.gf_matmul_ptrs.restype = None

        def fn(mat: np.ndarray, buffers: Sequence[bytes], s: int) -> np.ndarray:
            r, k = mat.shape
            n = len(buffers)
            if n % k:
                raise ValueError(f"{n} buffers are not whole codewords of {k}")
            ptrs = (ctypes.c_char_p * n)(*buffers)
            lens = (ctypes.c_uint64 * n)(*[len(b) for b in buffers])
            out = np.zeros((n // k, r, s), dtype=np.uint8)
            mat_c = np.ascontiguousarray(mat, dtype=np.uint8)
            lib.gf_matmul_ptrs(_u8p(mat_c), ptrs, lens, _u8p(out),
                               n // k, r, k, s)
            return out
    _resolved["gf_ptrs"] = fn
    return fn


# --- multi-buffer BLAKE2s-256 ---


def _blake2s_lib() -> Optional[ctypes.CDLL]:
    lib = load_native("blake2s_mb")
    if lib is None or not lib.blake2s_mb_supported():
        return None  # no compiler, or a pre-AVX2 host
    lib.blake2s256_multi.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.blake2s256_multi.restype = None
    return lib


def _run_multi(lib, ptrs, lens, order) -> List[bytes]:
    n = len(order)
    out = (ctypes.c_uint8 * (32 * n))()
    lib.blake2s256_multi(ptrs, lens, ctypes.cast(out, ctypes.c_void_p), n)
    raw = bytes(out)
    digests: List[bytes] = [b""] * n
    for pos, i in enumerate(order):
        digests[i] = raw[pos * 32:(pos + 1) * 32]
    return digests


def get_native_blake2s_multi() -> Optional[Callable[[Sequence[bytes]], List[bytes]]]:
    """Batch BLAKE2s-256 over the multi-buffer SIMD kernel, or None
    (hashlib fallback).  Returns a callable blocks → [32-byte digests].

    The wrapper sorts the batch by length before dispatch: lanes in one
    SIMD group advance in lock-step, so grouping similar lengths minimises
    the work wasted on lanes that finish early.  Output order matches the
    input order."""
    if "b2_multi" in _resolved:
        return _resolved["b2_multi"]
    fn = None
    lib = _blake2s_lib()
    if lib is not None:
        def fn(blocks: Sequence[bytes]) -> List[bytes]:
            n = len(blocks)
            if n == 0:
                return []
            order = sorted(range(n), key=lambda i: len(blocks[i]))
            ptrs = (ctypes.c_char_p * n)(*[blocks[i] for i in order])
            lens = (ctypes.c_uint64 * n)(*[len(blocks[i]) for i in order])
            return _run_multi(lib, ptrs, lens, order)
    _resolved["b2_multi"] = fn
    return fn


def get_native_blake2s_rows() -> Optional[Callable]:
    """Strided in-place variant of the multi-buffer kernel: hash the
    first `n` rows of a C-contiguous uint8 matrix WITHOUT materializing
    per-row bytes copies — the lane pointers index straight into the
    (lane-aligned-stride) staging buffer where the rows already lie.

    Returns fn(arr_2d, lengths, n) -> [32-byte digests], or None when
    the kernel is unavailable (callers fall back to hashlib over row
    views, which are zero-copy too, just not multi-buffer)."""
    if "b2_rows" in _resolved:
        return _resolved["b2_rows"]
    fn = None
    lib = _blake2s_lib()
    if lib is not None:
        def fn(arr, lengths, n: int) -> List[bytes]:
            if n == 0:
                return []
            if arr.dtype.itemsize != 1 or not arr.flags["C_CONTIGUOUS"]:
                raise ValueError("rows must be a C-contiguous uint8 matrix")
            stride = arr.strides[0]
            base = arr.ctypes.data
            order = sorted(range(n), key=lambda i: int(lengths[i]))
            ptrs = (ctypes.c_char_p * n)()
            lens = (ctypes.c_uint64 * n)()
            for pos, i in enumerate(order):
                ptrs[pos] = ctypes.cast(base + i * stride, ctypes.c_char_p)
                lens[pos] = int(lengths[i])
            return _run_multi(lib, ptrs, lens, order)
    _resolved["b2_rows"] = fn
    return fn


# --- the layout optimizer's negative-cycle cancellation ---


def get_native_flow_cancel() -> Optional[Callable]:
    """fn(n, first, dst, cap, flow, cost, rev, max_rounds) -> rounds over
    int64 CSR arrays (flow updated in place; see native/flowcost.cpp), or
    None (the Python loop); builds on first call."""
    if "flow_cancel" in _resolved:
        return _resolved["flow_cancel"]
    fn = None
    lib = load_native("flowcost")
    if lib is not None:
        p64 = ctypes.POINTER(ctypes.c_int64)
        lib.flow_cancel_negative_cycles.argtypes = [
            ctypes.c_int64, p64, p64, p64, p64, p64, p64, ctypes.c_int64]
        lib.flow_cancel_negative_cycles.restype = ctypes.c_int64

        def fn(n, first, dst, cap, flow, cost, rev, max_rounds):
            arrs = [np.ascontiguousarray(a, dtype=np.int64)
                    for a in (first, dst, cap, cost, rev)]
            if flow.dtype != np.int64 or not flow.flags["C_CONTIGUOUS"]:
                raise ValueError("flow must be a C-contiguous int64 array")
            m = int(arrs[0][-1])
            if len(arrs[0]) != n + 1 or any(len(a) != m for a in (
                    arrs[1], arrs[2], arrs[3], arrs[4], flow)):
                raise ValueError("graph arrays do not match n and the edges")
            if m and not (0 <= arrs[1].min() and arrs[1].max() < n
                          and 0 <= arrs[4].min() and arrs[4].max() < m):
                raise ValueError("edge endpoints out of range")
            first_, dst_, cap_, cost_, rev_ = (a.ctypes.data_as(p64)
                                               for a in arrs)
            return int(lib.flow_cancel_negative_cycles(
                n, first_, dst_, cap_, flow.ctypes.data_as(p64), cost_, rev_,
                max_rounds))
    _resolved["flow_cancel"] = fn
    return fn
