"""Full-frame NeRF inference: camera pose -> rendered image.

Counterpart of `nerf_workspaces_explorer_tpu/infer/renderer.py` (reference
NeRFReplicaInferenceHandler, nerf/inference/nerf_replica_inference_handler.py:
23-277): config and checkpoint loading, `render_coordinates(init, coord)` ->
uint8 [H, W, 3], batches, a pipelined stream, a strip-pipelined frame, a
cheap preview frame and the reference's NaN/Inf scan (`nan_debug`).

The precision picks the path:
  - "parity": fp32 weights through the plain pipeline
    (`render.pipeline.render_rays_chunked`);
  - "fast": bf16 weights through the fused path
    (`ops.fused_render.render_rays_fused`);
  - "int8-trunk" / "int8": the fused path with the trunk, or the trunk and
    the heads, quantized to int8 by a static calibration at load
    (`ops.quantize`).
The device picks the implementation: on `cuda` the fused path launches the
density-pass, placement and fine-pass kernels once each per frame; on `cpu`
it runs their plain versions (the JAX package refuses int8 without its TPU
kernel; the port's plain version is the same kernel's arithmetic).

`mesh` (a `parallel.DataMesh`) shards the parity path's rays over its
devices (`parallel.shard_render`, JAX renderer.py:156-165); frames come
back on the mesh's first device. A fused precision with a mesh raises: the
JAX renderer renders those unsharded, its fused path taking precedence
over the mesh (:129-152).

The preset picks the placement (JAX renderer.py:235-319):
  - "reference": 64 coarse + 128 importance samples merged, as the
    reference;
  - "fast": the fine net sees the importance samples only
    (`merge_coarse=False`); with a proposal checkpoint (`use_proposal`) and
    a fused precision the density pass runs on a stride-4 ray lattice.
    Gated on the free-floating orbit scene but not on interiors (-2.38 dB
    against merged placement on the room walkthrough at 128 samples,
    reports/quality_gate_room_fast_partial.md): for the offices serve
    "reference" or a gated "turbo" student;
  - "turbo": the distilled student in the checkpoint's `.turbo.npz`
    sidecar, with the spec and serving settings its metadata names;
  - "mipnerf360": mip-NeRF 360 (`models/mipnerf360.py`) from a seeded
    `.json` checkpoint (`infer.checkpoint.load_seeded_checkpoint`), served
    at bf16 products (precision "fast") by `ops.mipnerf360`: its kernels on
    the card, their plain versions on the CPU; every frame eager.
"""

from __future__ import annotations

import os
import warnings
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from nerf_workspaces_explorer_tpu_torch.camera.poses import poses_from_coordinates
from nerf_workspaces_explorer_tpu_torch.core.config import FrameworkConfig, load_config
from nerf_workspaces_explorer_tpu_torch.core.types import COORD
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import (
    load_checkpoint,
    load_seeded_checkpoint,
    load_torch_checkpoint,
    params_from_numpy,
)
from nerf_workspaces_explorer_tpu_torch.models.encoding import embedding_output_dim
from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import Mip360Spec
from nerf_workspaces_explorer_tpu_torch.models.mipnerf360 import init_params as init_mip360_params
from nerf_workspaces_explorer_tpu_torch.models.mlp import NerfMLP, NerfMLPSpec, init_nerf_params
from nerf_workspaces_explorer_tpu_torch.obs import profiler
from nerf_workspaces_explorer_tpu_torch.obs.debug import scan_outputs_finite
from nerf_workspaces_explorer_tpu_torch.obs.profiler import span
from nerf_workspaces_explorer_tpu_torch.ops.fused_render import (
    STEP_POINTS,
    prepare_kernel_params,
    render_rays_fused,
    render_rays_single_pass,
    weight_stream,
)
from nerf_workspaces_explorer_tpu_torch.ops.mipnerf360 import Mip360Model, ray_radii, render_rays_mip360
from nerf_workspaces_explorer_tpu_torch.ops.quantize import (
    calibrate_model_quant,
    spec_from_net_params,
)
from nerf_workspaces_explorer_tpu_torch.parallel.mesh import DataMesh
from nerf_workspaces_explorer_tpu_torch.parallel.sharding import shard_render
from nerf_workspaces_explorer_tpu_torch.rays.raygen import create_rays
from nerf_workspaces_explorer_tpu_torch.render.pipeline import (
    RenderSettings,
    render_rays_chunked,
)
from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec

PRECISIONS = ("parity", "fast", "int8", "int8-trunk")
PRESETS = ("reference", "fast", "turbo", "mipnerf360")


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """`cuda` unless the caller names a device; never a silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the renderer runs on the GPU unless it is "
            "given device='cpu'"
        )
    return device


def settings_from_config(cfg: FrameworkConfig) -> RenderSettings:
    return RenderSettings(
        n_samples=cfg.rendering.n_samples,
        n_importance=cfg.rendering.n_importance,
        perturb=cfg.rendering.perturb,
        raw_noise_std=cfg.rendering.raw_noise_std,
        white_background=cfg.rendering.white_background,
        num_freqs_3d=cfg.rendering.num_freqs_3d,
        num_freqs_2d=cfg.rendering.num_freqs_2d,
        use_view_dirs=cfg.rendering.use_view_dirs,
    )


def spec_from_config(cfg: FrameworkConfig) -> NerfMLPSpec:
    return NerfMLPSpec(
        depth=cfg.model.net_depth,
        width=cfg.model.net_width,
        input_ch=embedding_output_dim(cfg.rendering.num_freqs_3d),
        input_ch_views=(
            embedding_output_dim(cfg.rendering.num_freqs_2d)
            if cfg.rendering.use_view_dirs
            else 0
        ),
        use_view_dirs=cfg.rendering.use_view_dirs,
    )


def _to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """Reference to8b_np (model_utils.py:10): floor(255 * clip(rgb, 0, 1))."""
    return torch.floor(255.0 * torch.clamp(rgb, 0.0, 1.0)).to(torch.uint8)


def _host_frame(rgb: torch.Tensor) -> np.ndarray:
    """A float frame on the renderer's device -> uint8 numpy frame, in the
    span `renderer.to_host`. The copy to the host waits for the device to
    finish the frame, so on the card the span holds that wait."""
    with span("renderer.to_host"):
        return _to_uint8(rgb).cpu().numpy()


class FrameGraph:
    """A renderer's single-pose frame as one CUDA graph, replayed per frame.

    `frame(pose, live_groups)` is the renderer's eager frame function: a
    pose [1, 4, 4] on the card -> float32 [1, H, W, 3] (ray generation, the
    fused path, the reshape), `live_groups` a counter per pass. The
    constructor captures it whole, the uint8 conversion after it, on a side
    stream and in a private memory pool, without running it: the caller
    rendered one frame eagerly first, which built the kernels' libraries,
    packed the weight streams and warmed the allocator. A failed capture
    raises; nothing falls back to eager frames. The graph holds pointers to
    the weights it captured, so the renderer drops it with them.

    `replay` copies the pose into the graph's static input through pinned
    staging slots (an event keeps a slot until its copy has read it) and
    replays; it returns a fresh tensor, never overwritten by a later
    replay. The passes add their evaluated 4-sample steps to the graph's
    `GraphCounters`, counted as `render.density_samples` and
    `render.fine_samples` over traced replays; a traced replay also counts
    itself in `render.graph_replays`. The kernels' `LAUNCHES` count calls
    of their wrappers, as for `train.step.StepGraph`: the capture's calls
    count, a replay calls none (a profiler trace counts the kernels it
    runs, `obs.profiler.device_kernel_counts`).
    """

    SLOTS = 4  # pinned pose slots: replays a caller may queue ahead

    def __init__(self, frame: Callable, device: torch.device) -> None:
        self._pose = torch.zeros((1, 4, 4), dtype=torch.float32, device=device)
        self.device = self._pose.device
        staging = torch.empty((self.SLOTS, 1, 4, 4), dtype=torch.float32, pin_memory=True)
        self._staging, self._staging_np = list(staging), staging.numpy()
        self._copied = [torch.cuda.Event() for _ in range(self.SLOTS)]
        self._slot = 0
        self._samples = profiler.GraphCounters(("render.density_samples", "render.fine_samples"), self.device,
                                               STEP_POINTS)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.device(self.device), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(self.device)):
            rgb = frame(self._pose, (self._samples.values[0:1], self._samples.values[1:2]))[0]
            self._outputs = (rgb, _to_uint8(rgb))

    def replay(self, c2w: np.ndarray, uint8: bool) -> torch.Tensor:
        """The frame of the 4x4 pose `c2w`, uint8 or float32 [H, W, 3] on the
        card, queued. Spans: `renderer.rays` (the pose's copy in), then
        `fused.fine` holding `renderer.replay`: the replay queues the fine
        pass, so `fused.fine` ends where an eager frame's does for the
        readers of the host time until the fine pass is queued."""
        with span("renderer.rays"):
            slot = self._slot
            self._slot = (slot + 1) % self.SLOTS
            self._copied[slot].synchronize()
            self._staging_np[slot, 0] = c2w
            self._pose.copy_(self._staging[slot], non_blocking=True)
            self._copied[slot].record(torch.cuda.current_stream(self.device))
        with span("fused.fine"), span("renderer.replay"):
            self._samples.replay(self.graph.replay)
        if profiler.tracing():
            profiler.count("render.graph_replays", 1)
        return self._outputs[1 if uint8 else 0].clone()


class NeRFRenderer:
    """Pose -> frame renderer for one workspace's trained NeRF.

    On the card's fused path a single full frame of a 4x4 pose
    (`render_pose`, `render_pose_uint8`, `render_coordinates` without
    `nan_debug`, `warmup`, `render_poses_uint8_stream`) is a replay of the
    renderer's `FrameGraph`: its first such frame runs eagerly and then
    captures the graph, every later one copies the pose in and replays.
    Every other call (strips, batches, `full` outputs, the preview, the
    parity path, a mesh, the CPU) renders eagerly. Returned tensors are
    never overwritten by a later frame. `set_params` (and so
    `initialize_models`) drops the graph with the weights it captured.
    """

    def __init__(
        self,
        office_name: str,
        ckpt_path: Optional[str] = None,
        *,
        config: Optional[FrameworkConfig] = None,
        precision: str = "parity",
        chunk: Optional[int] = None,
        use_proposal: bool = False,
        early_stop_eps: float = 1e-3,
        sort_rays: bool = False,
        preset: str = "reference",
        n_importance: Optional[int] = None,
        proposal_subsample: Optional[int] = None,
        device: Optional[str | torch.device] = None,
        mesh: Any = None,
        nan_debug: bool = False,
    ) -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} ({'|'.join(PRECISIONS)})")
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r} ({'|'.join(PRESETS)})")
        fused = precision != "parity"
        if preset == "mipnerf360" and (precision != "fast" or mesh is not None):
            raise ValueError("preset='mipnerf360' serves precision='fast' (bf16 products) on one device")
        if mesh is not None:
            if not isinstance(mesh, DataMesh):
                raise ValueError(f"mesh must be a parallel.DataMesh (data_mesh()), got {type(mesh).__name__}")
            if fused:
                raise ValueError(
                    f"mesh: precision {precision!r} renders unsharded (the JAX renderer's fused path "
                    f"ignores its mesh); the mesh shards precision='parity'"
                )
            if device is None:
                device = mesh.devices[0]
            elif torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device {mesh.devices[0]}")
        self._mesh = mesh
        if chunk is not None and fused:
            raise ValueError(
                "chunk sets the plain pipeline's ray tile; the fused path takes the whole "
                "frame in one launch per kernel and has no chunk override"
            )
        self._device = resolve_device(device)
        self._ckpt_path = ckpt_path
        # Scan every rendered output for NaN/Inf, as the reference does
        # (…inference_handler.py:273-276); opt-in, as it renders the full
        # float outputs and reads them on the device.
        self._nan_debug = nan_debug
        self._config = config if config is not None else load_config(office_name=office_name)
        self._precision = precision
        self._chunk = chunk if chunk is not None else self._config.inference.chunk
        # Fused-path early ray termination: samples past transmittance < eps
        # are skipped; the rgb error this commits is bounded by eps (1e-3 is
        # under half a uint8 step).
        self._early_stop_eps = early_stop_eps
        # Fine pass in saturation order (fused path): exact up to eps.
        self._sort_rays = sort_rays
        self._spec = spec_from_config(self._config)
        settings = settings_from_config(self._config).for_eval()
        if use_proposal:
            settings = settings._replace(use_proposal=True)
        if preset == "fast":
            # Importance-only fine pass; with a proposal net on the fused
            # path, placement on the stride-4 lattice (gated at -0.02 dB,
            # reports/quality_gate_subsample4_20k.md). See the module note
            # on interiors.
            settings = settings._replace(merge_coarse=False)
            if use_proposal and fused:
                settings = settings._replace(proposal_subsample=4)
        self._turbo_path = None
        if preset == "turbo":
            from nerf_workspaces_explorer_tpu_torch.train.distill import (
                read_turbo_metadata,
                student_spec_from_meta,
                turbo_sidecar_path,
            )

            if ckpt_path is None:
                raise ValueError("preset='turbo' requires a checkpoint path")
            self._turbo_path = turbo_sidecar_path(ckpt_path)
            if not os.path.exists(self._turbo_path):
                raise RuntimeError(
                    f"turbo sidecar {self._turbo_path} not found - distill one first: "
                    f"python -m nerf_workspaces_explorer_tpu_torch.cli.distill --office {office_name}"
                )
            # The student's architecture and serving settings come from the
            # sidecar, before any weights load.
            self._spec, student = student_spec_from_meta(read_turbo_metadata(self._turbo_path))
            settings = settings._replace(
                use_proposal=True,
                merge_coarse=False,
                n_samples=int(student.get("n_samples", 64)),
                n_importance=int(student["n_importance"]),
                num_freqs_3d=int(student["num_freqs_3d"]),
                num_freqs_2d=int(student.get("num_freqs_2d", 4)),
                proposal_num_freqs=int(student.get("proposal_num_freqs", 6)),
                proposal_subsample=int(student.get("proposal_subsample", 1)),
            )
        if n_importance is not None:
            settings = settings._replace(n_importance=n_importance)
        if proposal_subsample is not None:
            if int(proposal_subsample) > 1 and not fused:
                warnings.warn(
                    "proposal_subsample > 1 only affects the fused path; the parity "
                    "pipeline renders with exact per-ray placement",
                    stacklevel=2,
                )
            settings = settings._replace(proposal_subsample=int(proposal_subsample))
        self._settings = settings
        self._params: Optional[Dict[str, Any]] = None  # the loaded tree, fp32 tensors
        self._models: Optional[Dict[str, NerfMLP]] = None  # parity
        self._kparams: Optional[Dict[str, Any]] = None  # fused precisions
        self._quant = None
        self._frame_graph: Optional[FrameGraph] = None
        self._m360: Optional[Mip360Model] = None  # preset "mipnerf360"
        self._m360_preset = preset == "mipnerf360"

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def config(self) -> FrameworkConfig:
        return self._config

    @property
    def settings(self) -> RenderSettings:
        return self._settings

    @property
    def params(self) -> Optional[Dict[str, Any]]:
        return self._params

    @property
    def quant(self):
        """Per-net int8 calibration ({net: TrunkQuant}) or None."""
        return self._quant

    @property
    def kernel_params(self) -> Optional[Dict[str, Any]]:
        """Per-net fused-kernel parameters (fused precisions) or None."""
        return self._kparams

    def initialize_models(
        self,
        *,
        allow_random_init: bool = False,
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        """Load checkpoint weights (torch `.ckpt`, native `.npz`, or the turbo
        sidecar), as reference initialize_models (…inference_handler.py:
        88-148), including its RuntimeError on a missing checkpoint, unless
        `allow_random_init`: then fresh weights from `generator` (default: a
        CPU generator seeded with `seed`; JAX's PRNG streams cannot be
        reproduced)."""
        if self._m360_preset:
            if self._ckpt_path is not None and os.path.exists(self._ckpt_path):
                tree, spec, _ = load_seeded_checkpoint(self._ckpt_path)
            elif allow_random_init:
                spec = Mip360Spec()
                tree = init_mip360_params(seed, spec)
            else:
                raise RuntimeError(f"Checkpoint path: {self._ckpt_path} for model cannot be found!")
            self._m360 = Mip360Model(tree, spec, self._device)
            self._params = self._m360.params
            return
        if self._turbo_path is not None:
            from nerf_workspaces_explorer_tpu_torch.train.distill import load_turbo_checkpoint

            tree, _ = load_turbo_checkpoint(self._turbo_path)
        elif self._ckpt_path is not None and os.path.exists(self._ckpt_path):
            if self._ckpt_path.endswith(".ckpt"):
                coarse, fine, _ = load_torch_checkpoint(self._ckpt_path)
                tree = {"coarse": coarse, "fine": fine}
            else:
                # Native checkpoints carry their net keys verbatim: coarse and
                # fine, or proposal and fine.
                tree, _, _ = load_checkpoint(self._ckpt_path)
        elif allow_random_init:
            gen = generator if generator is not None else torch.Generator().manual_seed(seed)
            first = "proposal" if self._settings.use_proposal else "coarse"
            first_spec = (
                proposal_spec(self._settings.proposal_num_freqs) if self._settings.use_proposal else self._spec
            )
            tree = {first: init_nerf_params(gen, first_spec), "fine": init_nerf_params(gen, self._spec)}
        else:
            raise RuntimeError(
                f"Checkpoint path: {self._ckpt_path} for model cannot be found!"
            )
        self.set_params(tree)

    def set_params(self, params: Dict[str, Any]) -> None:
        """Install a parameter tree (tensors or arrays; e.g. live from a
        trainer): recalibrate int8, rebuild the kernel parameters and drop
        the frame graph (the next single frame runs eagerly and captures
        anew)."""
        if self._m360_preset:
            self._m360 = Mip360Model(params, self._m360.spec if self._m360 else Mip360Spec(), self._device)
            self._params = self._m360.params
            return
        first = "proposal" if self._settings.use_proposal else "coarse"
        if first not in params or "fine" not in params:
            have = "/".join(sorted(k for k in params if isinstance(params[k], dict)))
            hint = " (a proposal checkpoint needs use_proposal=True)" if "proposal" in params else ""
            raise ValueError(f"the renderer needs {first} and fine nets, got {have}{hint}")
        tree = params_from_numpy({k: params[k] for k in (first, "fine")}, self._device)
        self._params = tree
        specs = {k: spec_from_net_params(p) for k, p in tree.items()}
        self._models = self._kparams = self._quant = self._frame_graph = None
        if self._precision == "parity":
            self._models = {k: NerfMLP(p, specs[k]) for k, p in tree.items()}
            return
        quant = {}
        if self._precision in ("int8", "int8-trunk"):
            # Static calibration, once per set of weights; "int8-trunk" keeps
            # the heads bf16.
            quant = self._quant = calibrate_model_quant(
                tree, self._spec, heads=self._precision == "int8"
            )
        elif self._precision == "fast":
            # bf16 weights, biases included, as the JAX package casts them.
            tree = params_from_numpy(tree, self._device, torch.bfloat16)
        self._kparams = {
            k: prepare_kernel_params(p, specs[k], quant=quant.get(k)) for k, p in tree.items()
        }
        if self._device.type == "cuda":
            # The kernels' weight streams, packed once per set of weights.
            for kp in self._kparams.values():
                weight_stream(kp)

    def _require_models(self) -> None:
        if self._kparams is None and self._models is None and self._m360 is None:
            raise RuntimeError("initialize_models() must be called before rendering")

    def _rays(self, c2ws: Sequence[np.ndarray], height: Optional[int] = None, cy: Optional[float] = None):
        """Rays of one or more poses, frames stacked row-major: [n * H * W].
        With `height` and `cy`, the rows [cfg.cy - cy, + height) of each
        frame: the full frame's pinhole grid with cy shifted (JAX
        renderer.py:121, `cy_override`)."""
        with span("renderer.rays"):
            c2w = torch.as_tensor(np.asarray(c2ws, dtype=np.float32), device=self._device)
            return self._pose_rays(c2w, height, cy)

    def _pose_rays(self, c2w: torch.Tensor, height: Optional[int] = None, cy: Optional[float] = None):
        """`_rays` of poses [n, 4, 4] already on the renderer's device."""
        cfg = self._config
        h = cfg.experiment.image_height if height is None else height
        w = cfg.experiment.image_width
        near, far = cfg.rendering.depth_range
        cy = cfg.cy if cy is None else cy
        return create_rays(c2w, h, w, cfg.fx, cfg.fy, cfg.cx, cy, near, far).reshape(c2w.shape[0] * h * w)

    @torch.no_grad()
    def _render_batch(
        self, c2ws: Sequence[np.ndarray], height: Optional[int] = None, cy: Optional[float] = None,
        full: bool = False,
    ):
        """float32 [n, H, W, 3] on the renderer's device (`height` rows with
        `cy` shifted for a strip, as `_rays`). With `full`, the reference's
        output dict instead: rgb/disp/acc/depth of the fine pass, [n, H, W,
        ...] (the parity path's coarse maps too when it has no fine pass).
        The span `renderer.frame`."""
        self._require_models()
        with span("renderer.frame"):
            return self._render_rays(self._rays(c2ws, height, cy), len(c2ws), height, full)

    def _render_rays(self, rays, n: int, height: Optional[int] = None, full: bool = False, live_groups=None):
        """`_render_batch` of the rays of n poses; `live_groups` the fused
        passes' sample counters (`render_rays_fused`)."""
        h = self._config.experiment.image_height if height is None else height
        w = self._config.experiment.image_width
        if self._m360 is not None:
            dirs = rays.dirs.reshape(n * h, w, 3)
            rgb = render_rays_mip360(self._m360, rays.origins, rays.dirs, rays.viewdirs,
                                     ray_radii(dirs).reshape(-1))
            out = {"rgb_fine": rgb}
        elif self._kparams is not None:
            # The ray axis is n frames of h rows: an (n * h, w) grid, so the
            # placement lattice's blocks never straddle two frames.
            fused = render_rays_fused(
                self._kparams, rays, self._settings, early_stop_eps=self._early_stop_eps,
                sort_rays=self._sort_rays, grid_hw=(n * h, w), full=full, live_groups=live_groups,
            )
            out = {"rgb_fine": fused.rgb, "disp_fine": fused.disp, "acc_fine": fused.acc,
                   "depth_fine": fused.depth} if full else {"rgb_fine": fused}
        elif self._mesh is not None:
            out = shard_render(self._params, rays, self._settings, self._mesh, spec=self._spec,
                               chunk=self._chunk)
        else:
            out = render_rays_chunked(self._models, rays, self._settings, chunk=self._chunk)
        if not full:
            rgb = out.get("rgb_fine", out.get("rgb_coarse"))
            return rgb.to(torch.float32).reshape(n, h, w, 3)
        return {k: v.to(torch.float32).reshape(n, h, w, *v.shape[1:]) for k, v in out.items()}

    def _pose_frame(self, c2w: torch.Tensor, live_groups) -> torch.Tensor:
        """The frame function a `FrameGraph` captures: poses [1, 4, 4] on
        the card -> float32 [1, H, W, 3], as `_render_batch` renders them."""
        return self._render_rays(self._pose_rays(c2w), 1, live_groups=live_groups)

    def _replays_frame(self, c2w: np.ndarray) -> bool:
        """Whether a single full frame of `c2w` is a replay of the frame
        graph: on the card's fused path, for a 4x4 pose."""
        return self._kparams is not None and self._device.type == "cuda" and np.shape(c2w) == (4, 4)

    def _single_frame(self, c2w: np.ndarray, uint8: bool, host: bool = False):
        """One pose's full frame, float32 or uint8 [H, W, 3] on the device,
        or with `host` the uint8 numpy frame (the conversion and the copy in
        the span `renderer.to_host`): a replay of the frame graph where
        `_replays_frame` (the first such frame eager, then the capture),
        else eager. While tracing, the program counters `render.graph_replays`
        and `render.eager_frames` count such frames."""
        graphed = self._replays_frame(c2w)
        if graphed and self._frame_graph is not None:
            with span("renderer.frame"):
                frame = self._frame_graph.replay(c2w, uint8 or host)
            if not host:
                return frame
            with span("renderer.to_host"):
                return frame.cpu().numpy()
        rgb = self._render_batch([c2w])[0]
        if profiler.tracing():
            profiler.count("render.eager_frames", 1)
        if graphed:
            self._frame_graph = FrameGraph(self._pose_frame, self._device)
        if host:
            return _host_frame(rgb)
        if not uint8:
            return rgb
        with span("renderer.to_host"):
            return _to_uint8(rgb)

    def render_pose(self, c2w: np.ndarray) -> torch.Tensor:
        """Render one camera pose -> float32 [H, W, 3] on the renderer's
        device (a frame graph replay on the card's fused path, as
        `render_pose_uint8`)."""
        return self._single_frame(c2w, uint8=False)

    def render_pose_uint8(self, c2w: np.ndarray) -> torch.Tensor:
        """Render one camera pose straight to uint8 [H, W, 3] on the device.
        On the card's fused path, with a 4x4 pose, the renderer's first such
        frame runs eagerly and captures the frame graph, and every later one
        is a replay of it (the conversion inside the graph); elsewhere the
        frame is eager, the conversion in the span `renderer.to_host`. The
        tensor returned is the caller's: no later frame overwrites it.
        `set_params` drops the graph."""
        return self._single_frame(c2w, uint8=True)

    def _pick_n_strips(self) -> int:
        """Largest strip count in 6..2 whose strips divide the image height
        and keep the placement stride's lattice whole (strip heights a
        multiple of `proposal_subsample`, so no block straddles two strips);
        1 when none fits (JAX renderer.py:539-549)."""
        h = self._config.experiment.image_height
        stride = max(1, int(self._settings.proposal_subsample or 1))
        return next((n for n in (6, 5, 4, 3, 2) if h % n == 0 and (h // n) % stride == 0), 1)

    def render_pose_uint8_pipelined(self, c2w: np.ndarray, n_strips: Optional[int] = None) -> np.ndarray:
        """Blocking uint8 [H, W, 3] numpy frame rendered as row strips, each
        strip's device-to-host copy overlapping the next strips' compute (the
        single-frame counterpart of `render_poses_uint8_stream`; JAX
        renderer.py:585-630). Each strip is the full frame's pinhole grid
        with cy shifted, rendered on its own (on the card: its own density
        pass, placement and fine pass); the copies run on a second CUDA
        stream into pinned host memory. Per-ray arithmetic is the blocking
        frame's, so frames are byte-identical to `render_pose_uint8` on the
        parity path and at early-stop eps 0; above 0 the 32-ray stop blocks
        fall otherwise and the frames agree to eps."""
        self._require_models()
        h, w = self._config.experiment.image_height, self._config.experiment.image_width
        n_strips = self._pick_n_strips() if n_strips is None else int(n_strips)
        stride = max(1, int(self._settings.proposal_subsample or 1))
        if n_strips < 1 or h % n_strips or (h // n_strips) % stride:
            raise ValueError(f"n_strips={n_strips} must divide height {h} into stride-{stride}-aligned strips")
        if n_strips == 1:
            return self.render_pose_uint8(c2w).cpu().numpy()
        strip_h, cy = h // n_strips, self._config.cy
        strips = (
            (r0, _to_uint8(self._render_batch([c2w], strip_h, cy - r0)[0])) for r0 in range(0, h, strip_h)
        )
        if self._device.type != "cuda":
            return np.concatenate([s.numpy() for _, s in strips], axis=0)
        frame = torch.empty((h, w, 3), dtype=torch.uint8, pin_memory=True)
        compute = torch.cuda.current_stream(self._device)
        copy = torch.cuda.Stream(self._device)
        for r0, strip in strips:
            copy.wait_stream(compute)  # this strip's kernels, not the later ones
            with torch.cuda.stream(copy):
                frame[r0 : r0 + strip_h].copy_(strip, non_blocking=True)
            strip.record_stream(copy)
        copy.synchronize()
        return frame.numpy()

    def render_coordinates(self, init_coordinates: COORD, coordinates: COORD) -> np.ndarray:
        """COORD pair -> uint8 [H, W, 3] numpy frame (reference
        render_coordinates, …inference_handler.py:166-185). With `nan_debug`
        it renders the full outputs (rgb, disp, acc, depth), scans each for
        NaN/Inf as the reference does and quantizes the rgb."""
        pose = poses_from_coordinates(init_coordinates, [coordinates])[0]
        if self._nan_debug:
            out = {k: v[0] for k, v in self._render_batch([pose], full=True).items()}
            scan_outputs_finite(out)
            return _host_frame(out.get("rgb_fine", out.get("rgb_coarse")))
        return self._single_frame(pose, uint8=True, host=True)

    def render_poses(self, c2ws: Sequence[np.ndarray]) -> np.ndarray:
        """A batch of poses -> float32 [N, H, W, 3] (the tour path): the rays
        of up to ~1M pixels' worth of frames go through one launch of each
        kernel."""
        c2ws = [np.asarray(p, dtype=np.float32) for p in c2ws]
        frames_per_group = max(1, 1_000_000 // self._config.n_pix)
        out = [
            self._render_batch(c2ws[i : i + frames_per_group]).cpu().numpy()
            for i in range(0, len(c2ws), frames_per_group)
        ]
        return np.concatenate(out, axis=0)

    def render_poses_uint8_stream(
        self, c2ws: Sequence[np.ndarray], lookahead: int = 2
    ) -> Iterator[np.ndarray]:
        """Yield uint8 [H, W, 3] frames for a pose sequence, pipelined: up to
        `lookahead` later frames are enqueued on the device (PyTorch's CUDA
        calls return before the work ends) before frame k is copied to the
        host, so the copy overlaps their compute. Frames are bit-identical
        to per-pose `render_pose_uint8` calls."""
        self._require_models()
        pending: "deque[torch.Tensor]" = deque()
        for pose in c2ws:
            pending.append(self.render_pose_uint8(pose))
            if len(pending) > lookahead:
                yield pending.popleft().cpu().numpy()
        while pending:
            yield pending.popleft().cpu().numpy()

    def render_coordinates_preview(
        self, init_coordinates: COORD, coordinates: COORD, n_samples: int = 64
    ) -> np.ndarray:
        """Cheap progressive-rendering frame: COORD pair -> uint8 [H, W, 3]
        (JAX renderer.py:696-791). With a coarse+fine checkpoint, one pass of
        the coarse net at `n_samples` uniform depths (the distribution it
        trains on). With a proposal checkpoint, whose fine net never sees
        uniform depths, the proposal pass at `n_samples` and an
        importance-only fine pass at n_samples / 2."""
        pose = poses_from_coordinates(init_coordinates, [coordinates])[0]
        return self.render_pose_preview_uint8(pose, n_samples).cpu().numpy()

    @torch.no_grad()
    def render_pose_preview_uint8(self, c2w: np.ndarray, n_samples: int = 64) -> torch.Tensor:
        """The preview frame of one pose, uint8 [H, W, 3] on the device."""
        self._require_models()
        if self._m360 is not None:  # no cheaper pass: the full frame
            return _to_uint8(self._render_batch([c2w])[0])
        cfg = self._config
        h, w = cfg.experiment.image_height, cfg.experiment.image_width
        rays = self._rays([c2w])
        s = self._settings.for_eval()
        if s.use_proposal:
            prop = s._replace(n_samples=n_samples, n_importance=max(2, n_samples // 2), merge_coarse=False)
            if self._kparams is not None:
                rgb = render_rays_fused(self._kparams, rays, prop, early_stop_eps=self._early_stop_eps)
            else:
                rgb = render_rays_chunked(self._models, rays, prop, chunk=self._chunk)["rgb_fine"]
        elif self._kparams is not None:
            rgb = render_rays_single_pass(
                self._kparams["coarse"], rays, s, n_samples=n_samples, early_stop_eps=self._early_stop_eps
            )
        else:
            single = s._replace(n_importance=0, n_samples=n_samples)
            rgb = render_rays_chunked(
                {"coarse": self._models["coarse"]}, rays, single, chunk=self._chunk
            )["rgb_coarse"]
        return _to_uint8(rgb.reshape(h, w, 3))

    def warmup(self, preview_n_samples: Sequence[int] = (64,)) -> None:
        """Render the preview(s) and one full frame at the identity pose, so
        the first click pays no kernel build or first-launch cost."""
        self._require_models()
        pose = np.eye(4, dtype=np.float32)
        for n in preview_n_samples:
            self.render_pose_preview_uint8(pose, n).cpu()
        self.render_pose_uint8(pose).cpu()
