"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and the plain
references import nothing of the program."""
import ast
import subprocess
import sys

from conftest import ROOT

HERE = ROOT / "gnnbench"
PROGRAM = {"dgl_hack_tpu_torch", "dgl_hack_tpu", "jax", "jaxlib", "flax"}

SCRIPT = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from gnnbench import harness, plugins
from conftest import CELLS, tiny_cell
import run
for name in CELLS:
    harness.run_cell(tiny_cell(name), 5, 0.1, name.startswith("gat"), "cpu")
found = run.forbidden_modules()
assert "dgl_hack_tpu_torch" in sys.modules
print("FOUND", found)
"""


def test_a_run_loads_no_jax():
    code = SCRIPT.format(root=str(ROOT), tests=str(HERE / "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=HERE)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(HERE))
    import run
    monkeypatch.setitem(sys.modules, "dgl_hack_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dgl_hack_tpu.ops", sys)
    assert run.forbidden_modules() == ["dgl_hack_tpu"]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    refs = [HERE / "reference.py", HERE / "compare.py",
            *sorted((HERE / "configs").glob("*.py")),
            *sorted((HERE / "graphs").glob("*.py")),
            *sorted((HERE / "counts").glob("*.py"))]
    for path in refs:
        assert not _imports(path) & PROGRAM, path


def test_harness_files_import_no_jax():
    for path in HERE.rglob("*.py"):
        if "tests" not in path.parts:
            assert not _imports(path) & {"jax", "jaxlib", "flax",
                                         "dgl_hack_tpu"}, path
