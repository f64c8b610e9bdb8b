"""The PyTorch port stands alone: no file of `wildgaussians_torch/` and not
`chip_smoke.py` imports JAX or the JAX package, and none imports `triton` at
module level (the CPU machines that import every module have no triton).

Every `tests/test_torch_*.py` file holds one test: pytest-xdist's
`--dist loadfile` sends files with more tests first, so one-test port files
are sent after the suite's multi-test files and leave their schedule as it
was without the port. The root `conftest.py` sends the suite's two long
one-test files (`test_skew.py`, `test_send_cap.py`) ahead of all of them
(ROADMAP.md, Queue 3)."""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "wildgaussians_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "wildgaussians_tpu", "bench")


def _imports(tree):
    """(top-level module name, runs at import time) for every import: an
    import runs at import time unless it sits inside a function body."""
    in_function = {id(inner) for node in ast.walk(tree)
                   if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
                   for inner in ast.walk(node)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], id(node) not in in_function
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], id(node) not in in_function


def test_no_jax_and_no_toplevel_triton():
    assert len(FILES) > 10 and all(f.exists() for f in FILES)
    # the probes' subpackage is part of the port and held to the same rules
    assert {"probe_cfin.py", "probe_sortdesign.py"} <= {
        f.name for f in FILES if f.parent.name == "profiles"}
    for path in FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name, at_top in _imports(tree):
            assert name not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"
            assert not (name == "triton" and at_top), \
                f"{path.relative_to(ROOT)} imports triton at module level"
    # one test per port test file, unparametrised (see the module docstring)
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        tests = [n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name.startswith("test")]
        assert len(tests) == 1, f"{path.name} holds {len(tests)} tests"
        assert not any("parametrize" in ast.unparse(d) for d in tests[0].decorator_list), \
            f"{path.name} is parametrised"
