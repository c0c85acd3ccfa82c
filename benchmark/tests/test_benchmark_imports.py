"""No module of the benchmark loads JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from harness import manifest, runtime


def test_whole_name_comparison():
    mods = {"nerf_workspaces_explorer_tpu_torch.ops": 1, "numpy": 1, "jaxtyping": 1, "flaxen": 1}
    assert runtime.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "nerf_workspaces_explorer_tpu.models": 1})
    assert runtime.forbidden_modules(mods) == ["jax", "nerf_workspaces_explorer_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub):
    base = os.path.join(manifest.BENCH_DIR, sub)
    return [os.path.join(base, f) for f in sorted(os.listdir(base)) if f.endswith(".py")]


def test_no_source_imports_jax():
    files = [os.path.join(manifest.BENCH_DIR, "run.py")]
    for sub in ("harness", "reference", "generators", "metrics"):
        files += _sources(sub)
    for f in files:
        assert not set(_imports(f)) & set(runtime.FORBIDDEN), f


def test_reference_imports_nothing_of_the_program():
    for f in _sources("reference"):
        assert "nerf_workspaces_explorer_tpu_torch" not in set(_imports(f)), f


def test_a_run_loads_no_jax():
    """Everything run.py and a cell's modules import, in a fresh process."""
    code = (
        "import sys; sys.path[:0] = [{b!r}, {r!r}];"
        "import runpy; from harness import manifest, frames, runtime, control;"
        "man = manifest.manifest();"
        "[manifest.generator(manifest.load_traffic(w['traffic'])['kind']) for w in man['workloads']];"
        "[manifest.metric_reader(m['name']) for m in man['end_to_end'] + man['per_layer']];"
        "import nerf_workspaces_explorer_tpu_torch.app.workspace, nerf_workspaces_explorer_tpu_torch.infer.renderer;"
        "import nerf_workspaces_explorer_tpu_torch.train.distill;"
        "print(runtime.forbidden_modules())"
    ).format(b=manifest.BENCH_DIR, r=manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
