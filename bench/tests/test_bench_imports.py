"""Nothing the benchmark runs imports ``jax`` or the JAX package
``repro`` (compared by whole top-level names: ``repro_torch`` is the
port), and the references import nothing of the port."""
import ast
import subprocess
import sys

from bench.env import BENCH, ROOT, forbidden_modules


def test_forbidden_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reprox": 1,
            "repro": 1, "repro.core": 1, "jax.numpy": 1, "jaxlib": 1,
            "flax": 1, "numpy": 1}
    assert forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                       "repro", "repro.core"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_names_jax_or_repro():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                             "repro"), (path, mod)


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] != "repro_torch", (path, mod)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}, {tests!r}]\n"
        "from bench_tiny import POOL, SERVE, pool_cell, run, serve_cell\n"
        "run(POOL, *pool_cell(), seconds=0.2)\n"
        "run(SERVE, *serve_cell(), seconds=0.1)\n"
        "from bench.env import forbidden_modules\n"
        "print(forbidden_modules())\n").format(
            root=str(ROOT), src=str(ROOT / "src"),
            tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
