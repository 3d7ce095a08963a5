"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names
compared whole (``fmov_pose_torch`` begins with ``fmov_pose_t`` as the
JAX package does)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "fmov_pose_tpu"}


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "fmov_pose_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "numpy", "benchmark"}


def test_rule_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import fmov_pose_torch.train\nfrom jaxtyping import x\n")
    assert top_level_imports(p) == {"fmov_pose_torch", "jaxtyping"}
    assert not top_level_imports(p) & FORBIDDEN
    p.write_text("from fmov_pose_tpu.ops import fused_sdf\n")
    assert top_level_imports(p) & FORBIDDEN == {"fmov_pose_tpu"}
