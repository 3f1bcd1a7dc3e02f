"""No module of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the program either: top-level names are
compared whole, so darwin_tpu_torch is not darwin_tpu."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    found = top_level_imports(path) & {"jax", "jaxlib", "flax",
                                       "darwin_tpu"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted(modules("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_stands_alone(path):
    found = top_level_imports(path) & {"jax", "jaxlib", "flax",
                                       "darwin_tpu", "darwin_tpu_torch"}
    assert not found, f"{path} imports {found}"


def test_guard_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import darwin_tpu_torch.ops\nfrom jax.numpy import x\n"
                 "import darwin_tpu\n")
    assert top_level_imports(str(p)) == {"darwin_tpu_torch", "jax",
                                         "darwin_tpu"}
