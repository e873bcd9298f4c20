"""The benchmark loads neither JAX nor the JAX package, and its references load
nothing of the program. Names are compared whole, by their top-level part:
``zktpu_torch`` begins with ``zktpu`` and is not it."""

import ast
import os
import subprocess
import sys

from zkbench.harness import runner

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "zktpu"}


def _sources():
    for dirpath, dirnames, filenames in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_top_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    sources = list(_sources())
    assert any(p.endswith("run.py") for p in sources)
    for path in sources:
        assert not (_imported_top_names(path) & FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = _imported_top_names(os.path.join(ref, f))
            assert not names & (FORBIDDEN | {"zktpu_torch", "zkbench"}), f


def test_forbidden_names_are_compared_whole():
    assert runner.forbidden_loaded(["zktpu_torch", "zktpu_torch.gkr", "numpy"]) == []
    assert runner.forbidden_loaded(["zktpu.gkr", "jax._src", "jaxlib"]) == ["jax", "jaxlib", "zktpu"]


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    modules = []
    for path in _sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if "." in os.path.basename(path)[:-3] or rel.startswith("zkbench.tests"):
            continue  # metric files are loaded by path, tests by pytest
        modules.append(rel.removesuffix(".__init__"))
    assert "zkbench.run" in modules and "zkbench.generators.gkr_prove" in modules
    code = ("import sys\n"
            + "".join(f"sys.modules[{n!r}] = None\n" for n in sorted(FORBIDDEN))
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in modules)
            + "from zkbench.harness import catalog\n"
            + "for m in catalog.load_benchmark()['per_layer']:\n"
            + "    catalog.metric_reader(m['name'])\n"
            + "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
