"""The host a run measures on, read from ``/proc`` and the store's own
directory: the CPU, the logical CPUs this process may use, the store's
filesystem and whether O_DIRECT reads work there, and the load.

Nothing here changes the machine: it reads, and it writes one page
into the store's directory to try an O_DIRECT read.
"""

from __future__ import annotations

import mmap
import os
import platform
from typing import Optional, Tuple

PAGE = 4096


CPU_KEYS = ("model name", "Model", "cpu model", "Hardware")


def cpu_model(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The first of ``CPU_KEYS`` that ``/proc/cpuinfo`` names (a sandbox
    may write ``unknown`` there), else its vendor, family and model
    numbers, else the machine's architecture."""
    found = {}
    try:
        with open(cpuinfo) as f:
            for line in f:
                key, _, value = line.partition(":")
                found.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    named = next((found[k] for k in CPU_KEYS
                  if found.get(k) not in (None, "", "unknown")), None)
    if named:
        return named
    if found.get("cpu family") and found.get("model"):
        return (f"{found.get('vendor_id', 'cpu')} family "
                f"{found['cpu family']} model {found['model']}")
    return platform.machine()


def _unescape(field: str) -> str:
    """A path as ``/proc/mounts`` writes it (space, tab, newline and
    backslash in octal)."""
    for code, ch in (("\\040", " "), ("\\011", "\t"), ("\\012", "\n"),
                     ("\\134", "\\")):
        field = field.replace(code, ch)
    return field


def mount_of(path: str, mounts: str = "/proc/mounts") -> Tuple[str, str]:
    """(filesystem type, mount point) of the mount that holds ``path``:
    the longest mount point above it, the last mounted where two are
    alike."""
    real = os.path.realpath(path)
    best: Tuple[str, str] = ("", "")
    try:
        with open(mounts) as f:
            lines = f.read().splitlines()
    except OSError:
        return best
    for line in lines:
        fields = line.split()
        if len(fields) < 3:
            continue
        point = _unescape(fields[1])
        inside = real == point or real.startswith(point.rstrip("/") + "/")
        if inside and len(point) >= len(best[1]):
            best = (fields[2], point)
    return best


def o_direct_reads(directory: str) -> bool:
    """Does a page-aligned O_DIRECT read of a file in ``directory``
    work?  The probe file is removed again."""
    flag = getattr(os, "O_DIRECT", 0)
    if not flag:
        return False
    path = os.path.join(directory, ".o_direct_probe")
    try:
        with open(path, "wb") as f:
            f.write(b"\0" * PAGE)
            f.flush()
            os.fsync(f.fileno())
        fd = os.open(path, os.O_RDONLY | flag)
        try:
            buf = mmap.mmap(-1, PAGE)
            try:
                return os.preadv(fd, [buf], 0) == PAGE
            finally:
                buf.close()
        finally:
            os.close(fd)
    except OSError:
        return False
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def load1() -> Optional[float]:
    try:
        return os.getloadavg()[0]
    except OSError:
        return None


def record(store_dir: str) -> dict:
    """The host record of a run whose store lives in ``store_dir``;
    ``load1`` is read again when the window opens."""
    fs, point = mount_of(store_dir)
    return {"cpu": cpu_model(), "cpus": len(os.sched_getaffinity(0)),
            "store_fs": fs, "store_mount": point,
            "o_direct": o_direct_reads(store_dir), "load1": load1()}
