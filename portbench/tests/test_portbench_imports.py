"""No module under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""
import ast
import os

import pytest

import run

FORBIDDEN = {"jax", "jaxlib", "flax", "wildgaussians_tpu"}


def top_level_imports(path):
    with open(path, encoding="utf8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    for dirpath, _dirs, files in os.walk(os.path.join(run.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("forbidden,sub", [(FORBIDDEN, ""),
                                           (FORBIDDEN | {"wildgaussians_torch"}, "reference")])
def test_imports(forbidden, sub):
    found = {p: top_level_imports(p) & forbidden for p in sources(sub)}
    assert not {p: n for p, n in found.items() if n}
    assert "wildgaussians_torch" not in FORBIDDEN and "wildgaussians_torch" != "wildgaussians_tpu"
