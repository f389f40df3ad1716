"""Link microprofiler sweep: sizes x batch shapes x kinds over the link.

    python -m garage_tpu_torch.tools.link_profile [--synthetic] [--table]

The port's ``scripts/link_profile.py``.  A DeviceTransport over a
CudaCodec on cuda:0 (``--synthetic``: the reference's synthetic in-process
link on the CPU, with its modeled 2 ms first-dispatch compile) probes the
link and runs the controlled sweep (``ops/link_profiler.run_sweep``:
0.25, 1 and 4 MiB blocks x 1 and 16 blocks x hash, encode and decode),
and the reference's invariants must hold:

  - every cell carries kind/size/blocks/wall/stages/dominant;
  - the exact-sum invariant holds LIVE in every cell (the per-stage
    breakdown equals the profiler-measured wall, bounded by the
    caller-observed outer wall: ``sum_ok``);
  - stage names stay inside the published taxonomy and every cell names
    a dominant stage;
  - the probe verdict carries a per-stage breakdown and prices its
    staging-buffer refill as stage_copy bytes.

On the card the kernels are built and loaded before the probe, and the
first dispatch of each (kind, shape) lands in the ``compile`` stage, so
neither nvcc nor the library load is read as ``dispatch``.  Prints the
attribution table with ``--table``, and one JSON line: the sweep block
(cells, summary, sum_ok), the probe's stages and, on the card, the kernel
launches.  Without a GPU (and without ``--synthetic``) it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse

from ..ops.codec import CodecParams
from ..ops.cpu_codec import CpuCodec
from ..ops.link_profiler import STAGES, format_sweep, run_sweep
from ..ops.transport import DeviceTransport
from .common import (check, device_codec, emit, launch_counts,
                     reset_launches)

K, M = 4, 2
CELL_KEYS = ("kind", "size_mib", "blocks", "nbytes", "wall_s", "outer_s",
             "gibs", "stages", "dominant", "sum_ok")


def run(synthetic: bool, table: bool) -> dict:
    params = CodecParams(rs_data=K, rs_parity=M, block_size=1 << 16)
    dev = device_codec(params, synthetic, link_gibs=50.0, compute_real=True,
                       compile_s=0.002)
    reset_launches()
    tr = DeviceTransport(dev, params, fallback=CpuCodec(params))
    try:
        link = tr.probe_link(1 << 20)
        check(bool(tr.last_probe_stages), "probe carried no stage breakdown")
        check(set(tr.last_probe_stages) <= set(STAGES),
              f"probe stages {tr.last_probe_stages}")
        probe_stages = dict(tr.last_probe_stages)

        block = run_sweep(tr, sizes_mib=(0.25, 1, 4), shapes=(1, 16),
                          kinds=("hash", "encode", "decode"), rounds=1)

        # well-formedness of the machine-readable block
        check(bool(block["cells"]), "sweep produced no cells")
        for c in block["cells"]:
            for key in CELL_KEYS:
                check(key in c, f"cell missing {key}: {c}")
            check(set(c["stages"]) <= set(STAGES), f"stages of {c}")
            check(c["dominant"] in STAGES, f"dominant of {c}")
            check(c["sum_ok"], f"exact-sum invariant violated: {c}")
        check(block["sum_ok"], "sweep sum_ok is False")
        # the probe's staging refill is visible as stage_copy bytes
        check(block["summary"]["stage_copy"]["bytes"] > 0,
              "no stage_copy bytes in the sweep summary")
    finally:
        tr.shutdown()
    if table:
        print(format_sweep(block))
    out = {"tool": "link_profile", "synthetic": synthetic, "link_gibs": link,
           "probe_stages": probe_stages, "sweep": block}
    if not synthetic:
        import torch

        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        out["device"] = torch.cuda.get_device_name(0)
    print(f"link profile ok ({len(block['cells'])} cells, "
          f"sum_ok={block['sum_ok']}, "
          f"overhead={block['overhead_seconds']}s)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="drive the reference's synthetic link on the CPU "
                         "instead of the card")
    ap.add_argument("--table", action="store_true",
                    help="also print the human attribution table")
    args = ap.parse_args(argv)
    emit(run(args.synthetic, args.table))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
