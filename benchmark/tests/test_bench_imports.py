"""No file of the benchmark imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the program."""

import ast
import os

import pytest

from benchmark.harness import FORBIDDEN, HERE

PROGRAM = "nerfail_tpu_torch"


def _sources():
    for base, dirs, files in os.walk(HERE):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_level_imports(path: str):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            yield node.args[0].value.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_forbidden_import(path):
    names = set(top_level_imports(path))
    assert not names & set(FORBIDDEN), path
    if os.path.relpath(path, HERE).startswith("reference" + os.sep):
        assert PROGRAM not in names, path


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import nerfail_tpu_torch.render\nfrom jax import numpy\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n")
    assert set(top_level_imports(str(f))) == {
        "nerfail_tpu_torch", "jax", "importlib", "flax"}
    assert "nerfail_tpu_torch" not in FORBIDDEN
