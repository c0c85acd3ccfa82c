"""Import rules of the PyTorch port: no JAX, nothing of the JAX package, no
image library (cv2, PIL, imageio: the card's machine has none), no silent
CPU fallback."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nerf_workspaces_explorer_tpu_torch")


FORBIDDEN = ("jax", "jaxlib", "nerf_workspaces_explorer_tpu", "cv2", "PIL", "imageio")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_imports_without_jax():
    code = (
        "import sys, importlib, importlib.util\n"
        "for name in ('jax', 'nerf_workspaces_explorer_tpu', 'cv2', 'PIL', 'imageio'):\n"
        "    sys.modules[name] = None\n"
        # app.gui_qt needs PyQt5; without it, the duck-typed stand-in.
        "if importlib.util.find_spec('PyQt5') is None:\n"
        f"    sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "    from fake_toolkits import install_fake_pyqt5\n"
        "    install_fake_pyqt5()\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path",
    [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "profile_torch_frame.py"),
     os.path.join(ROOT, "scripts", "profile_torch_train_step.py"),
     os.path.join(ROOT, "scripts", "profile_torch_placement_eps.py"),
     os.path.join(ROOT, "scripts", "profile_torch_fine_ablation.py"),
     os.path.join(ROOT, "scripts", "probe_int4_torch.py"),
     os.path.join(ROOT, "scripts", "record_render_bits.py"),
     os.path.join(ROOT, "scripts", "time_torch_int4.py"),
     os.path.join(ROOT, "scripts", "validate_quality_torch.py"),
     os.path.join(ROOT, "scripts", "long_horizon_study_torch.py"),
     os.path.join(ROOT, "scripts", "collect_long_run_report_torch.py")]
    + sorted(
        os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")
    ),
    ids=lambda p: os.path.relpath(p, ROOT),
)
def test_no_jax_package_imports(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, (path, name)


def test_renderer_without_device_raises_without_cuda():
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeRFRenderer("tokyo", os.path.join(ROOT, "assets", "bench", "synth_hier.npz"))


def test_unported_options_raise():
    """Options the port refuses raise: a chunk override of the fused path, a
    mesh that is not a `DataMesh`, and a mesh with a fused precision (the
    JAX renderer renders those unsharded); so do unknown precisions and a
    turbo preset without a checkpoint. nan_debug and the strip path are
    ported: they build, and the strip path asks for weights first."""
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer
    from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh

    with pytest.raises(ValueError, match="precision"):
        NeRFRenderer("tokyo", precision="int4", device="cpu")
    with pytest.raises(ValueError, match="preset"):
        NeRFRenderer("tokyo", preset="turbo", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        NeRFRenderer("tokyo", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mesh: precision 'fast' renders unsharded"):
        NeRFRenderer("tokyo", precision="fast", mesh=data_mesh(devices=["cpu"] * 2), device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        NeRFRenderer("tokyo", precision="int8", chunk=4096, device="cpu")
    r = NeRFRenderer("tokyo", nan_debug=True, device="cpu")
    with pytest.raises(RuntimeError, match="initialize_models"):
        r.render_pose_uint8_pipelined(None)


def test_missing_checkpoint_raises():
    from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer

    r = NeRFRenderer("tokyo", "/nonexistent/model.ckpt", device="cpu")
    with pytest.raises(RuntimeError, match="cannot be found"):
        r.initialize_models()


def test_kernels_refuse_other_devices():
    """A kernel wrapper takes the plain version only for a CPU tensor; any
    other device gets the kernel or an error."""
    from nerf_workspaces_explorer_tpu_torch.ops.importance_merge import importance_merge

    z = torch.linspace(0.1, 1.0, 8)[:, None].repeat(1, 4).to("meta")
    with pytest.raises(ValueError, match="no importance kernel"):
        importance_merge(torch.zeros_like(z), z, 4)
    with pytest.raises(ValueError, match="n_importance >= 2"):
        importance_merge(torch.zeros(8, 4), torch.zeros(8, 4), 1)
