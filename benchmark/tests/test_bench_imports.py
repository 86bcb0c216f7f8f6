"""Nothing the benchmark runs loads JAX or the JAX package
(``decompress_tpu``), compared by whole top-level module names, so
``decompress_tpu_torch`` passes; the reference loads nothing of the
program."""

import ast
import json
import pathlib
import subprocess
import sys

from benchmark import harness

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _top_level_imports(path) & set(harness.FORBIDDEN)
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_the_torch_port_passes_the_whole_name_compare():
    assert harness.forbidden_loaded(["decompress_tpu_torch", "decompress_tpu_torch.gz",
                                     "jaxtyping", "flaxen.x", "numpy"]) == []
    assert harness.forbidden_loaded(["decompress_tpu.gz", "jax._src.core", "jaxlib",
                                     "flax"]) == ["decompress_tpu", "flax", "jax", "jaxlib"]


def _loaded_after(code: str) -> set:
    """Top-level names of ``sys.modules`` after ``code`` runs in a fresh
    interpreter from the checkout's root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither():
    code = ("import io, sys, time\nsys.path.insert(0, '.')\n"
            "from benchmark import harness, spec\n"
            "cell = spec.load_cell('gz6-calgary-8m-x1')\n"
            "cell['traffic'] = dict(cell['traffic'], input_bytes=20000)\n"
            "assert harness.run(cell, 1, 0.5, False, t_start=time.perf_counter(), "
            "device='cpu', out=io.StringIO(), err=io.StringIO()) == 0\n")
    loaded = _loaded_after(code)
    assert "decompress_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import sys\nsys.path.insert(0, '.')\nimport benchmark.reference\n")
    assert "benchmark" in loaded
    assert not loaded & {"decompress_tpu_torch", *harness.FORBIDDEN}
    assert "decompress_tpu_torch" not in _top_level_imports(BENCH / "reference.py")
