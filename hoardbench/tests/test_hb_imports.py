"""No module of JAX or of the JAX package in a run, compared by whole
top-level names, and nothing of the program in the reference."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import sys
sys.path[:0] = [{root!r}, {tests!r}, {src!r}]
from _tiny import tiny_cell
from hoardbench import bench
out = bench.run_cell(tiny_cell({w!r}), 3, 0.2, False, t_start=0.0, device="cpu")
tops = {{m.split(".")[0] for m in sys.modules}}
assert "repro_torch" in tops, "the run imported the program"
print("FOUND", bench.forbidden_modules(), sorted(tops & {{"jax", "jaxlib", "flax", "repro"}}))
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)


def test_a_run_loads_no_jax_module():
    for w in ("phi4-mini-3.8b.train.2x1024", "deepseek-v2-lite-16b.L4.train.4x4096"):
        p = _run(RUN.format(root=str(ROOT), tests=str(ROOT / "hoardbench" / "tests"),
                            src=str(ROOT / "src"), w=w))
        assert p.returncode == 0, p.stderr[-3000:]
        assert p.stdout.strip().splitlines()[-1] == "FOUND [] []"


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import hoardbench.reference.model, hoardbench.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    p = _run(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_reference_imports_only_torch_and_itself():
    for path in sorted((ROOT / "hoardbench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = ["." if node.level else node.module.split(".")[0]]
            else:
                continue
            assert set(names) <= {"torch", "math", "__future__", "."}, (path.name, names)


def test_the_whole_name_is_compared():
    from hoardbench import bench

    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro" not in bench.forbidden_modules() or "repro" in {
        m.split(".")[0] for m in sys.modules}
