"""What the operator tools share: the device codec they drive, the
kernel launch counts they report, their one JSON result line.

A tool runs on the card (``cuda:0``) unless its caller asks for the CPU
(``--synthetic``, ``--device cpu``); without a GPU it exits non-zero and
prints no result."""

from __future__ import annotations

import json
import subprocess
import sys


def check(cond: bool, msg: str) -> None:
    """A failed check ends the tool non-zero, with `msg` on stderr and no
    result line."""
    if not cond:
        sys.exit(f"{sys.argv[0]}: FAILED: {msg}")


def require_card():
    """torch, with a CUDA device present; else exit non-zero with the
    reason on stderr and no result."""
    import torch

    if not torch.cuda.is_available():
        sys.exit(f"{sys.argv[0]}: no CUDA device (torch.cuda.is_available() "
                 "is False); this tool runs on the card")
    return torch


def device_codec(params, synthetic: bool, **synthetic_kw):
    """The device codec a smoke drives: the reference's synthetic link
    (``testing/synthetic_device.SyntheticLinkCodec(params,
    **synthetic_kw)``) on the CPU when `synthetic`, else a CudaCodec on
    cuda:0 with its kernels built and loaded."""
    if synthetic:
        from ..testing.synthetic_device import SyntheticLinkCodec

        return SyntheticLinkCodec(params, **synthetic_kw)
    require_card()
    from ..ops.cuda_codec import CudaCodec

    dev = CudaCodec(params, device="cuda:0")
    dev.warm_scrub(1, params.block_size)
    return dev


def reset_launches() -> None:
    """Zero this process's kernel launch counts (K1, K2/K3, K4)."""
    from ..ops import cuda_blake2s, cuda_codec, cuda_gf

    cuda_blake2s.reset_launches()
    cuda_gf.reset_launches()
    cuda_codec.reset_launches()


def launch_counts() -> dict:
    """This process's kernel launches since the last reset: blake2s
    (K1), gf_apply (K2/K3, with its bodies), fused_scrub (K4)."""
    from ..ops.cuda_codec import launch_counts as counts

    return counts()


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def emit(result: dict) -> None:
    """The tool's result: one JSON line on stdout."""
    print(json.dumps(result, default=float), flush=True)
