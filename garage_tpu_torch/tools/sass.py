"""SASS census of a built kernel: its instructions by opcode and by the SM
pipe that runs them, from ``cuobjdump -sass`` of the kernel's library.

``chip_smoke.py`` and ``tools/gf_tune.py`` turn a census and a measured
time into the lanes a kernel issued per SM per clock, and a census into
the least time its instructions need (``timing.ops_ms``).
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import Dict, Optional

# SASS opcodes by the SM pipe that runs them (integer ALU, FMA, memory)
ALU_OPS = {"LOP3", "PRMT", "SHF", "IADD3", "LEA", "ISETP", "SEL", "PLOP3",
           "MOV", "SGXT", "IABS", "IMNMX", "FLO", "POPC", "BREV", "S2R",
           "CS2R", "S2UR"}
FMA_OPS = {"IMAD", "FMUL", "FADD", "FFMA"}
MEM_OPS = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ULDC"}

_OP_RE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_census(lib_path, symbol_part: str) -> Optional[Dict[str, int]]:
    """Instruction counts by opcode of one kernel's SASS in a built
    library (cuobjdump -sass), the kernel picked by a part of its mangled
    name; None when cuobjdump is missing or finds no such kernel.  Each
    instruction of the code is counted once: a loop's body once."""
    from ..ops import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        return None
    counts, inside = {}, False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = symbol_part in line
            continue
        if not inside:
            continue
        m = _OP_RE.search(line)
        if m:
            op = m.group(1).split(".")[0]
            if op != "NOP":
                counts[op] = counts.get(op, 0) + 1
    return counts or None


def census_classes(counts: Dict[str, int]) -> Dict[str, int]:
    """Instructions per thread by pipe class from a sass_census."""
    cls = {"alu": 0, "fma": 0, "mem": 0, "uniform": 0, "other": 0}
    for op, n in counts.items():
        # U* run once per warp on the uniform datapath, not on the lanes
        key = ("uniform" if op.startswith("U") else "alu" if op in ALU_OPS
               else "fma" if op in FMA_OPS else "mem" if op in MEM_OPS
               else "other")
        cls[key] += n
    cls["total"] = sum(counts.values())
    return cls
