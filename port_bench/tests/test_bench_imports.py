"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program it judges. Module names are
compared by their top-level name, whole: the program's name begins with
the JAX package's."""
from __future__ import annotations

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "multimodal_sam_adapter_tpu"}
PROGRAM = "multimodal_sam_adapter_torch"


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_module_imports_the_jax_side():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        found = set(imported_top_levels(f)) & JAX_SIDE
        assert not found, f"{f.relative_to(ROOT)} imports {found}"


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert PROGRAM not in set(imported_top_levels(f)), f


def test_top_level_names_compare_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import multimodal_sam_adapter_torch.ops\n"
                 "from multimodal_sam_adapter_tpu import x\n")
    names = set(imported_top_levels(f))
    assert names & JAX_SIDE == {"multimodal_sam_adapter_tpu"}
    assert PROGRAM in names
