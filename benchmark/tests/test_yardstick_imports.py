"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: an ``ast`` walk of every module,
comparing top-level import names whole."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "garage_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
    return names


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_walk_sees_every_module():
    found = {p.relative_to(BENCH).as_posix() for p in modules()}
    assert {"run.py", "node.py", "drivers/scrub.py", "drivers/s3.py",
            "reference/blocks.py"} <= found


def test_no_module_imports_jax_or_the_jax_package():
    for p in modules():
        bad = top_level_imports(p) & NEVER
        assert not bad, f"{p} imports {bad}"


def test_the_names_compare_whole():
    src = "import garage_tpu_torch.ops\nfrom garage_tpu_torch import x\n"
    tmp = BENCH / "tests" / "__pycache__"
    tmp.mkdir(exist_ok=True)
    f = tmp / "probe_imports.py"
    f.write_text(src + "import garage_tpu.ops\n")
    try:
        assert top_level_imports(f) == {"garage_tpu_torch", "garage_tpu"}
    finally:
        f.unlink()


def test_the_reference_imports_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        names = top_level_imports(p)
        assert "garage_tpu_torch" not in names, p
        assert names <= {"__future__", "hashlib", "os", "zlib", "math",
                         "concurrent", "dataclasses", "typing", "numpy",
                         "zstandard"}, (p, names)
        text = p.read_text()
        assert "from .." not in text and "import benchmark" not in text, p
