"""The card a run measures on, and the builds it needs first."""

from __future__ import annotations

import subprocess
import sys


class NoCard(SystemExit):
    pass


def require(chips: int) -> dict:
    """The card's name, count and power limit; exits non-zero, printing
    no result, when CUDA is missing or has fewer cards than the cell
    asks for.  Creates no CUDA context."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures on an NVIDIA GPU",
              file=sys.stderr)
        raise NoCard(3)
    n = torch.cuda.device_count()
    if n < chips:
        print(f"the cell asks for {chips} cards and {n} are here",
              file=sys.stderr)
        raise NoCard(3)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_w": power_limit()}


def nvidia_smi(*query: str) -> list:
    try:
        r = subprocess.run(["nvidia-smi", *query], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


def power_limit():
    lines = nvidia_smi("--query-gpu=power.limit", "--format=csv,noheader,nounits")
    try:
        return float(lines[0])
    except (IndexError, ValueError):
        return None


def memory_used_bytes() -> int:
    """Device memory in use on card 0, every process's contexts and
    allocations together (nvidia-smi reads MiB)."""
    lines = nvidia_smi("--query-gpu=memory.used", "--format=csv,noheader,nounits")
    try:
        return int(float(lines[0])) * 2**20
    except (IndexError, ValueError):
        return 0


def build_program() -> float:
    """Build the program's CUDA kernels (``build/kernels/``) and native
    libraries (``build/native/``) in this process, before any node
    starts, so that no two processes build at once.  Returns seconds."""
    import time

    from garage_tpu_torch.ops import _build, native

    t0 = time.perf_counter()
    _build.build_all()
    for name in ("gf256", "blake2s_mb", "logdb", "flowcost"):
        native.require_native(name)
    return time.perf_counter() - t0
