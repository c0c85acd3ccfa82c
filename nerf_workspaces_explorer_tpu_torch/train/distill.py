"""Distillation: a trained checkpoint compressed into the narrow student the
turbo preset serves, and the readers of its sidecar.

Counterpart of `nerf_workspaces_explorer_tpu/train/distill.py`. Given a
teacher checkpoint (the scene itself; no dataset needed):

  1. render the teacher at poses covering the reachable view space
     (`render_teacher_views`; `office_distill_poses` for an office),
  2. train a proposal (2x64) + fine (depth x width) student on those
     renders with the port's `Trainer(use_proposal=True)`
     (`distill_student`), and score it against held-out teacher views
     rendered the way the turbo preset serves (`render_student_views`),
  3. write the student as a `.turbo.npz` sidecar beside the teacher
     (`save_turbo_checkpoint`), whose metadata names the student's
     architecture and the serving settings it was gated at (importance
     samples, proposal frequencies, placement stride);
     `NeRFRenderer(preset="turbo")` of either package serves it.

On `cuda` the views render through the fused serving path
(`ops/fused_render.py::render_rays_fused`: K1/K2/K3 for the teacher, K1/K6/K3
on the `grid_hw` lattice for the student) and the student trains through the
fused field (K4/K5, one library for the student's shape and one for the
proposal net's); on the CPU everything is plain PyTorch. The device decides,
as everywhere in the port: the caller's `device`, else the device of the
parameters' tensors, else the card.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.core.config import (
    ExperimentConfig,
    FrameworkConfig,
    LoggingConfig,
    ModelConfig,
    RenderingConfig,
)
from nerf_workspaces_explorer_tpu_torch.data.replica import SceneData
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import (
    load_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from nerf_workspaces_explorer_tpu_torch.infer.renderer import resolve_device
from nerf_workspaces_explorer_tpu_torch.models.encoding import embedding_output_dim
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLPSpec, tree_leaves
from nerf_workspaces_explorer_tpu_torch.ops.fused_render import prepare_kernel_params, render_rays_fused
from nerf_workspaces_explorer_tpu_torch.ops.quantize import spec_from_net_params
from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
from nerf_workspaces_explorer_tpu_torch.render.pipeline import RenderSettings, render_rays_chunked

TURBO_SUFFIX = ".turbo.npz"

# The default student: 6x192 at a 10-frequency encoding with a 50k-step
# budget, the recipe measured to hold interior scenes (the offices are
# interiors); the 4x128@8f student is faster and holds the orbit scene but
# not interiors, an opt-in to gate per scene.
DEFAULT_STUDENT = {"depth": 6, "width": 192, "num_freqs_3d": 10}
SPEED_STUDENT = {"depth": 4, "width": 128, "num_freqs_3d": 8}
DEFAULT_DISTILL_STEPS = 50_000


def turbo_sidecar_path(ckpt_path: str) -> str:
    """`model.ckpt` / `model.npz` -> `model.turbo.npz` (same directory)."""
    stem, _ = os.path.splitext(ckpt_path)
    return stem + TURBO_SUFFIX


def student_spec_from_meta(meta: Dict[str, Any]) -> Tuple[NerfMLPSpec, Dict[str, Any]]:
    """The student's NerfMLPSpec and its metadata entry."""
    student = meta["student"]
    spec = NerfMLPSpec(
        depth=int(student["depth"]),
        width=int(student["width"]),
        input_ch=embedding_output_dim(int(student["num_freqs_3d"])),
        input_ch_views=embedding_output_dim(int(student.get("num_freqs_2d", 4))),
        use_view_dirs=True,
    )
    return spec, student


def _views_device(params: Dict[str, Any], device: Optional[str | torch.device]) -> torch.device:
    """The caller's device, else that of the tree's tensors, else the card."""
    if device is None:
        leaf = tree_leaves(params)[0]
        if isinstance(leaf, torch.Tensor):
            device = leaf.device
    return resolve_device(device)


@torch.no_grad()
def _render_views(
    params, spec, settings: RenderSettings, poses, height: int, width: int, *, near: float, far: float,
    hfov_degrees: float, device, chunk: int, grid: bool,
) -> np.ndarray:
    """Each pose's frame -> float32 [N, H, W, 3] in [0, 1]: the fused
    serving path on `cuda` (on the `grid_hw` lattice with `grid`), the
    chunked plain pipeline on the CPU."""
    device = _views_device(params, device)
    first = "proposal" if settings.use_proposal else "coarse"
    tree = params_from_numpy({k: params[k] for k in (first, "fine")}, device)
    fx = width / 2.0 / np.tan(np.radians(hfov_degrees / 2.0))
    cx, cy = (width - 1.0) / 2.0, (height - 1.0) / 2.0
    s = settings.for_eval()._replace(field_impl="plain")
    kparams = None
    if device.type == "cuda":
        kparams = {k: prepare_kernel_params(p, spec_from_net_params(p)) for k, p in tree.items()}
    frames = []
    for pose in np.asarray(poses, dtype=np.float32):
        c2w = torch.as_tensor(pose, device=device)
        rays = create_rays(c2w, height, width, fx, fx, cx, cy, near, far).reshape(height * width)
        if kparams is not None:
            rgb = render_rays_fused(kparams, rays, s, grid_hw=(height, width) if grid else None)
        else:
            rgb = render_rays_chunked(tree, rays, s, spec=spec, chunk=min(chunk, height * width))["rgb_fine"]
        frames.append(rgb.reshape(height, width, 3).to(torch.float32).cpu().numpy())
    return np.clip(np.stack(frames).astype(np.float32), 0.0, 1.0)


def render_teacher_views(
    teacher_params: Dict[str, Any],
    teacher_spec: NerfMLPSpec,
    teacher_settings: RenderSettings,
    poses: np.ndarray,
    height: int,
    width: int,
    *,
    near: float,
    far: float,
    hfov_degrees: float = 90.0,
    device: Optional[str | torch.device] = None,
    chunk: int = 8192,
) -> np.ndarray:
    """The teacher at each pose -> float32 [N, H, W, 3] in [0, 1]: on `cuda`
    the fused bf16 path the server runs (K1/K2/K3; the targets are what
    serving produces), on the CPU the chunked fp32 pipeline (JAX
    `render_teacher_views`)."""
    return _render_views(teacher_params, teacher_spec, teacher_settings, poses, height, width, near=near, far=far,
                         hfov_degrees=hfov_degrees, device=device, chunk=chunk, grid=False)


def render_student_views(
    params: Dict[str, Any],
    spec: NerfMLPSpec,
    settings: RenderSettings,
    poses: np.ndarray,
    height: int,
    width: int,
    *,
    near: float,
    far: float,
    hfov_degrees: float = 90.0,
    device: Optional[str | torch.device] = None,
    chunk: int = 8192,
) -> np.ndarray:
    """A student's full frames through the serving placement (on `cuda`
    K1/K6/K3 on the frame's `grid_hw` lattice) -> float32 [N, H, W, 3] in
    [0, 1] (JAX `render_student_views`)."""
    return _render_views(params, spec, settings, poses, height, width, near=near, far=far,
                         hfov_degrees=hfov_degrees, device=device, chunk=chunk, grid=True)


def student_config(
    height: int,
    width: int,
    *,
    near: float,
    far: float,
    depth: int = DEFAULT_STUDENT["depth"],
    net_width: int = DEFAULT_STUDENT["width"],
    num_freqs_3d: int = DEFAULT_STUDENT["num_freqs_3d"],
    n_samples: int = 64,
    n_importance: int = 128,
) -> FrameworkConfig:
    """The student trainer's FrameworkConfig (no console print, TensorBoard,
    checkpoint or eval render on a cadence)."""
    return FrameworkConfig(
        experiment=ExperimentConfig(image_width=width, image_height=height),
        model=ModelConfig(net_depth=depth, net_width=net_width, net_depth_fine=depth, net_width_fine=net_width),
        rendering=RenderingConfig(depth_range=(near, far), num_freqs_3d=num_freqs_3d, n_samples=n_samples,
                                  n_importance=n_importance),
        logging=LoggingConfig(step_log_print=0, step_log_tensorboard=2**31 - 1, step_save_ckpt=0,
                              step_render_test=0, step_render_train=0),
    )


def distill_student(
    teacher_params: Dict[str, Any],
    teacher_spec: NerfMLPSpec,
    teacher_settings: RenderSettings,
    poses: np.ndarray,
    *,
    height: int,
    width: int,
    near: float,
    far: float,
    steps: int = DEFAULT_DISTILL_STEPS,
    depth: int = DEFAULT_STUDENT["depth"],
    net_width: int = DEFAULT_STUDENT["width"],
    num_freqs_3d: int = DEFAULT_STUDENT["num_freqs_3d"],
    n_holdout: int = 2,
    seed: int = 0,
    field_impl: str = "auto",
    log_every: int = 500,
    name: str = "distill",
    teacher_rgb: Optional[np.ndarray] = None,
    n_samples: Optional[int] = None,
    n_importance_train: Optional[int] = None,
    save_dir: Optional[str] = None,
    device: Optional[str | torch.device] = None,
    on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
) -> Tuple[Dict[str, Any], FrameworkConfig, Dict[str, Any]]:
    """Distill (teacher params, spec, settings) into a proposal-mode student
    of depth x net_width at num_freqs_3d: the last `n_holdout` poses are
    held out, the student trains `steps` steps on the teacher's renders of
    the others. Returns (student params, student config, report): the
    report's `psnr_vs_teacher` (mean) and `psnr_vs_teacher_min` are the
    student's PSNR against the teacher on the held-out views, rendered as
    the turbo preset serves (JAX `distill_student`).

    `teacher_rgb` ([len(poses), H, W, 3], from `render_teacher_views`)
    skips the teacher's renders; `n_samples` / `n_importance_train` set the
    student's uniform proposal samples and training importance samples
    (default: the teacher's). `field_impl` is the Trainer's ("auto": the
    K4/K5 kernels on `cuda`); `save_dir` the Trainer's directory (default:
    its own numbered run directory); `device` the Trainer's (default: the
    card); `on_step(i, metrics)` runs after each step."""
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    poses = np.asarray(poses, dtype=np.float32)
    if poses.shape[0] < n_holdout + 2:
        raise ValueError(f"need at least {n_holdout + 2} poses, got {poses.shape[0]}")
    device = resolve_device(device)
    if teacher_rgb is not None:
        rgb = np.asarray(teacher_rgb, dtype=np.float32)
        if rgb.shape != (poses.shape[0], height, width, 3):
            raise ValueError(f"teacher_rgb shape {rgb.shape} != {(poses.shape[0], height, width, 3)}")
    else:
        rgb = render_teacher_views(teacher_params, teacher_spec, teacher_settings, poses, height, width,
                                   near=near, far=far, device=device)
    depth_maps = np.zeros(rgb.shape[:3], dtype=np.float32)
    n_train = poses.shape[0] - n_holdout
    train_data = SceneData(rgb[:n_train], depth_maps[:n_train], poses[:n_train])
    test_data = SceneData(rgb[n_train:], depth_maps[n_train:], poses[n_train:])

    cfg = student_config(
        height, width, near=near, far=far, depth=depth, net_width=net_width, num_freqs_3d=num_freqs_3d,
        n_samples=n_samples if n_samples is not None else teacher_settings.n_samples,
        n_importance=n_importance_train if n_importance_train is not None else teacher_settings.n_importance,
    )
    trainer = Trainer(name, cfg, train_data=train_data, test_data=test_data, save_dir=save_dir,
                      enable_tensorboard=False, use_proposal=True, seed=seed, field_impl=field_impl,
                      device=device)
    trainer.setup()
    for i in range(steps):
        metrics = trainer.step(i)
        if on_step is not None:
            on_step(i, metrics)
        if log_every and i % log_every == 0:
            print(f"[{name}] step {i}: loss {float(metrics['total_loss']):.5f} "
                  f"psnr_fine {float(metrics['psnr_fine']):.2f}", flush=True)

    # Student against teacher on the held-out views, rendered as the turbo
    # preset serves: proposal placement, importance-only fine pass.
    student_settings = trainer._settings.for_eval()._replace(merge_coarse=False)
    student_rgb = render_student_views(trainer.params, trainer._spec, student_settings, poses[n_train:], height,
                                       width, near=near, far=far, device=device)
    mses = np.mean((student_rgb - rgb[n_train:]) ** 2, axis=(1, 2, 3))
    psnrs = -10.0 * np.log10(np.maximum(mses, 1e-12))
    report = {
        "psnr_vs_teacher": float(np.mean(psnrs)),
        "psnr_vs_teacher_min": float(np.min(psnrs)),
        "n_views": int(poses.shape[0]),
        "n_holdout": int(n_holdout),
        "steps": int(steps),
    }
    return trainer.params, cfg, report


def save_turbo_checkpoint(
    path: str,
    student_params: Dict[str, Any],
    student_cfg: FrameworkConfig,
    *,
    n_importance_serving: int = 48,
    proposal_subsample_serving: int = 4,
    report: Optional[Dict[str, Any]] = None,
    teacher: str = "",
    step: int = 0,
) -> None:
    """Write the `.turbo.npz` sidecar `NeRFRenderer(preset="turbo")` loads,
    its metadata the JAX package's key for key: the student's architecture
    and the serving settings it was gated at (importance samples, placement
    stride); a report is stamped with the serving settings it was measured
    at (`measured_at`)."""
    meta: Dict[str, Any] = {
        "turbo": True,
        "teacher": os.path.basename(teacher),
        "student": {
            "depth": student_cfg.model.net_depth_fine,
            "width": student_cfg.model.net_width_fine,
            "num_freqs_3d": student_cfg.rendering.num_freqs_3d,
            "num_freqs_2d": student_cfg.rendering.num_freqs_2d,
            "n_samples": student_cfg.rendering.n_samples,
            "n_importance": n_importance_serving,
            "proposal_num_freqs": 6,
            "proposal_subsample": int(proposal_subsample_serving),
        },
    }
    if report:
        meta["distill_report"] = dict(
            report,
            measured_at={
                "n_importance": int(n_importance_serving),
                "proposal_subsample": int(proposal_subsample_serving),
            },
        )
    save_checkpoint(path, student_params, step=step, metadata=meta)


def load_turbo_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A sidecar -> (params tree of numpy arrays, metadata). Raises if the
    file is not a turbo checkpoint."""
    params, _, meta = load_checkpoint(path)
    if not meta.get("turbo"):
        raise ValueError(f"{path} is not a turbo (distilled-student) checkpoint")
    return params, meta


def read_turbo_metadata(path: str) -> Dict[str, Any]:
    """The sidecar's metadata alone (the renderer's settings come from it
    before any weights load)."""
    with np.load(path) as arrays:
        meta = json.loads(bytes(arrays["__meta__"].tobytes()).decode())
    if not meta.get("turbo"):
        raise ValueError(f"{path} is not a turbo (distilled-student) checkpoint")
    return meta


def office_distill_poses(
    office_name: str,
    *,
    grid: int = 4,
    yaw_step_degrees: float = 45.0,
    margin: float = 0.15,
) -> np.ndarray:
    """Poses covering an office's reachable view space: the floor plan's
    relative-coordinate square on a `grid` x `grid` lattice inset by
    `margin`, crossed with yaws every `yaw_step_degrees`, each mapped
    through the office's calibration as a click is, in a fixed shuffled
    order (JAX `office_distill_poses`)."""
    from nerf_workspaces_explorer_tpu_torch.app.workspace import make_workspaces
    from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates

    key = office_name if office_name.startswith("office_") else f"office_{office_name}"
    # Only the calibration is used: the workspaces' renderers load nothing,
    # and on the CPU none needs the card.
    ws = {w.office_name: w for w in make_workspaces(device="cpu")}[key]
    poses: List[np.ndarray] = []
    lin = np.linspace(margin, 1.0 - margin, grid)
    for rel_x in lin:
        for rel_y in lin:
            for yaw in np.arange(0.0, 360.0, yaw_step_degrees):
                init, delta = ws.transform_relative_coordinates(float(rel_x), float(rel_y), float(yaw), 0.0)
                poses.append(poses_from_coordinates(init, [delta])[0])
    out = np.stack(poses).astype(np.float32)
    return out[np.random.default_rng(0).permutation(out.shape[0])]
