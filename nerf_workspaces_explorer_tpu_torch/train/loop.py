"""Training orchestration: data on the device, the step loop, logging, eval
renders, checkpoint and resume.

Counterpart of `nerf_workspaces_explorer_tpu/train/loop.py` (reference
NeRFReplicaTrainingHandler, nerf/training/nerf_replica_training_handler.py:
24-618, and the loop of nerf/train.py:30-56). Cadences and metric names are
the reference's: console print every `step_log_print`, TensorBoard scalars
and sigma histograms every `step_log_tensorboard`, train/test eval renders
(PNG, batch PSNR/MSE; the JAX trainer's mp4 needs imageio, which the port
does not use) every `step_render_{train,test}`, checkpoints every
`step_save_ckpt`.

On `cuda` the field is the fused K4/K5 kernels (`field_impl="auto"`) and
eval renders go through the fused serving path (K1-K3 on the current
weights); on the CPU both are plain PyTorch. Each step's random draws come
from the Trainer's generator seeded from (seed, step), so a run resumed
from a checkpoint takes the same steps as one that never stopped.

`use_proposal` trains a 2x64 proposal net in the coarse net's place by the
interlevel loss, `merge_coarse=False` the fine net on the importance-only
placement of the fast serving preset (JAX `Trainer(use_proposal=,
merge_coarse=)`); eval renders and checkpoints follow the nets the state
holds. `rendering.test_viz_factor` f > 1 renders the eval views at 1/f of
the training resolution against ground truth downscaled as JAX's
`jax.image.resize(..., "bilinear")` does (antialiased).

`steps_per_call` K > 1 (JAX `Trainer(steps_per_call=)`, `lax.scan` there):
`fit` advances K steps a call wherever K fit up to the next cadence
boundary, on `cuda` as a replay of a CUDA graph of K steps
(`train/step.py::StepGraph`), on the CPU as K eager steps; the trajectory
is the single steps'.

`mesh` (a `parallel.DataMesh`; JAX `Trainer(mesh=)`) trains data-parallel:
each step's rays split into one shard a device, each shard drawn from a
generator seeded from (seed, step, shard) and its image index from (seed,
step), the shards' gradients summed on the mesh's first device (as JAX's
step applies them), which holds the state (`train/step.py::
DataParallelBody`); the rays, colours and parameters are copied once to
each other device. `steps_per_call` K then takes K data-parallel steps a
call (JAX's `lax.scan` inside `shard_map`): on `cuda` a replay of the
`StepGraph` of that body (one graph of K steps where the mesh repeats one
card, a graph a card and step across cards), on the CPU K eager steps of
the same body. Eval renders and checkpoints use the first device's state,
so checkpoints keep their format.

`step` and `step_many` return once their work is queued: their phase of
`StepTimer` (`Perf/train_step_ms`) is timed by CUDA events on `cuda`, and
only the cadence's prints, TensorBoard writes, renders and checkpoints
wait for the device, at their steps. While
a `torch.profiler` session records, a call is the span `train.step` or
`train.step_many`, holding `train.draws` and `train.eager`,
`train.capture` or `train.replay`; eval renders are `train.render_train`
and `train.render_test`.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerf_workspaces_explorer_tpu_torch.core.config import FrameworkConfig, load_config
from nerf_workspaces_explorer_tpu_torch.data.replica import ReplicaDataset, SceneData
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import (
    load_training_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from nerf_workspaces_explorer_tpu_torch.infer.renderer import (
    resolve_device,
    settings_from_config,
    spec_from_config,
)
from nerf_workspaces_explorer_tpu_torch.models.mlp import tree_leaves
from nerf_workspaces_explorer_tpu_torch.obs.profiler import StepTimer, span
from nerf_workspaces_explorer_tpu_torch.obs.tb import TensorboardWriter
from nerf_workspaces_explorer_tpu_torch.ops.fused_render import (
    prepare_kernel_params,
    render_rays_fused,
)
from nerf_workspaces_explorer_tpu_torch.rays.raygen import RayBundle, create_rays
from nerf_workspaces_explorer_tpu_torch.render.pipeline import FIELD_IMPLS, render_rays_chunked
from nerf_workspaces_explorer_tpu_torch.render.proposal import proposal_spec
from nerf_workspaces_explorer_tpu_torch.train.step import (
    DataParallelBody,
    ExponentialDecay,
    StepDraws,
    StepGraph,
    TrainState,
    apply_step,
    check_mesh_rays,
    draw_shards,
    draw_step,
    init_train_state,
    load_optimizer_leaves,
    mesh_replicas,
    optimizer_leaves,
    take_step,
    take_steps,
)
from nerf_workspaces_explorer_tpu_torch.utils.metrics import to8b
from nerf_workspaces_explorer_tpu_torch.utils.png import write_png
from nerf_workspaces_explorer_tpu_torch.utils.viz import depth2rgb

EXPERIMENTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "experiments")
# Rays per eval-render group (bounds the fine pass's [192, R] buffers).
EVAL_GROUP_RAYS = 1_000_000


def _next_run_dir(base: str) -> str:
    """Numbered run directories: max(existing numbers) + 1, created
    exclusively (JAX `_next_run_dir`)."""
    run = 1
    if os.path.exists(base):
        run = max((int(d) for d in os.listdir(base) if d.isdigit()), default=0) + 1
    while True:
        path = os.path.join(base, str(run))
        try:
            os.makedirs(path, exist_ok=False)
            return path
        except FileExistsError:
            run += 1


def resize_images(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """[N, H, W, C] float images -> [N, height, width, C], bilinear with
    the triangle filter widened when downsampling (antialiased): the
    arithmetic of `jax.image.resize(..., method="bilinear")`, which the JAX
    trainer scales its eval ground truth with (JAX train/loop.py:199-213)."""
    if images.shape[1:3] == (height, width):
        return images
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).numpy()


def step_seed(seed: int, step: int, *shard: int) -> int:
    """The generator seed of step `step` of a run seeded `seed` (of one of
    its shards, given the shard's index)."""
    return int(np.random.SeedSequence([seed, step, *shard]).generate_state(1)[0])


class Trainer:
    """End-to-end NeRF training for one workspace."""

    def __init__(
        self,
        office_name: str,
        config: Optional[FrameworkConfig] = None,
        *,
        train_data: Optional[SceneData] = None,
        test_data: Optional[SceneData] = None,
        experiments_dir: str = EXPERIMENTS_DIR,
        seed: int = 0,
        save_dir: Optional[str] = None,
        enable_tensorboard: bool = True,
        field_impl: str = "auto",
        use_proposal: bool = False,
        merge_coarse: bool = True,
        steps_per_call: int = 1,
        eval_max_views: int = 0,
        device: Optional[str | torch.device] = None,
        mesh: Any = None,
    ) -> None:
        if mesh is not None:
            if device is None:
                device = mesh.devices[0]
            elif torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device {mesh.devices[0]}")
        self._mesh = mesh
        self._device = resolve_device(device)
        self._office_name = office_name
        self._config = config if config is not None else load_config(office_name=office_name)
        self._seed = seed
        if field_impl == "auto":
            field_impl = "fused" if self._device.type == "cuda" else "plain"
        if field_impl not in FIELD_IMPLS:
            raise ValueError(f"unknown field_impl {field_impl!r} (auto|{'|'.join(FIELD_IMPLS)})")
        self._field_impl = field_impl
        # steps_per_call > 1: fit() advances K steps a call between cadence
        # boundaries (a CUDA-graph replay on cuda, StepGraph).
        self._steps_per_call = max(1, int(steps_per_call))
        self._graph: Optional[StepGraph] = None
        self._eval_max_views = max(0, int(eval_max_views))
        self.timer = StepTimer(self._device)
        self._save_dir = save_dir or _next_run_dir(os.path.join(experiments_dir, office_name))

        cfg = self._config
        self._spec = spec_from_config(cfg)
        # The proposal net in the coarse net's place; the fine net trained on
        # the importance-only placement it sees under the fast preset.
        self._settings = settings_from_config(cfg)._replace(
            train=True, field_impl=field_impl, use_proposal=use_proposal, merge_coarse=merge_coarse)
        self._schedule = ExponentialDecay(
            cfg.training.learning_rate, cfg.training.learning_rate_decay_rate,
            cfg.training.learning_rate_decay_steps,
        )
        self._tb = (
            TensorboardWriter(self._save_dir, cfg.to_dict()) if enable_tensorboard else None
        )
        if train_data is None or test_data is None:
            dataset = ReplicaDataset(
                office_name, image_height=cfg.experiment.image_height, image_width=cfg.experiment.image_width
            )
            train_data, test_data = dataset.train, dataset.test
        self._train_data, self._test_data = train_data, test_data
        self._img_h, self._img_w = int(train_data.rgb.shape[1]), int(train_data.rgb.shape[2])
        self._state: Optional[TrainState] = None
        self._gen = torch.Generator(device=self._device)
        self._shards: Optional[Dict[str, Any]] = None  # the mesh's per-device copies

    @property
    def config(self) -> FrameworkConfig:
        return self._config

    @property
    def field_impl(self) -> str:
        return self._field_impl

    @property
    def mesh(self) -> Any:
        return self._mesh

    @property
    def steps_per_call(self) -> int:
        return self._steps_per_call

    @property
    def graph_captured(self) -> bool:
        """Whether `step_many` holds a captured CUDA graph of its K steps."""
        return self._graph is not None and self._graph.captured

    @property
    def save_dir(self) -> str:
        return self._save_dir

    @property
    def state(self) -> TrainState:
        if self._state is None:
            raise RuntimeError("initialize_models() has not run")
        return self._state

    @property
    def params(self) -> Dict[str, Any]:
        return self.state.params

    # Setup (reference prepare_data / initialize_models / initialize_rays,
    # …training_handler.py:118-263).

    def prepare_data(self) -> None:
        """Training colors to the device; the eval views' ground truth at
        1 / test_viz_factor of the resolution; ground truth to TensorBoard."""
        f = self._config.rendering.test_viz_factor
        self._img_h_scaled, self._img_w_scaled = self._img_h // f, self._img_w // f
        n_train, n_test = len(self._train_data), len(self._test_data)
        self._train_rgbs = torch.as_tensor(
            self._train_data.rgb.reshape(n_train, -1, 3), dtype=torch.float32, device=self._device
        )

        def eval_ids(n: int) -> Optional[np.ndarray]:
            if 0 < self._eval_max_views < n:
                return np.linspace(0, n - 1, self._eval_max_views).astype(int)
            return None

        self._train_eval_ids, self._test_eval_ids = eval_ids(n_train), eval_ids(n_test)
        pick = lambda a, ids: a if ids is None else a[ids]  # noqa: E731
        scale = lambda a: resize_images(a, self._img_h_scaled, self._img_w_scaled)  # noqa: E731
        self._train_rgbs_eval = scale(pick(self._train_data.rgb, self._train_eval_ids))
        self._test_rgbs_eval = scale(pick(self._test_data.rgb, self._test_eval_ids))
        if self._tb is not None:
            self._tb.write_image("Train/rgb_ground_truth", self._train_data.rgb, 0)
            self._tb.write_image("Test/rgb_ground_truth", self._test_data.rgb, 0)
            near, far = self._config.rendering.depth_range
            depth_viz = np.stack([depth2rgb(d, near, far) for d in self._train_data.depth])
            self._tb.write_image("Train/depth_ground_truth", depth_viz / 255.0, 0)

    def _net_specs(self) -> Dict[str, Any]:
        """{net name: spec} of the state's nets: "coarse" or "proposal", "fine"."""
        if self._settings.use_proposal:
            return {"proposal": proposal_spec(self._settings.proposal_num_freqs), "fine": self._spec}
        return {"coarse": self._spec, "fine": self._spec}

    def initialize_models(self) -> None:
        if self._mesh is not None:
            check_mesh_rays(self._config.rendering.n_rays, self._mesh)
        prop = self._net_specs().get("proposal")
        self._state = init_train_state(self._spec, self._schedule, self._device, seed=self._seed,
                                       proposal_spec=prop)
        self._graph = None
        self._shards = None

    def initialize_rays(self) -> None:
        """Per-image ray bundles on the device (reference :243-263): the
        training views at full resolution, the eval views scaled."""
        near, far = self._config.rendering.depth_range

        def rays_for(poses: np.ndarray, h: int, w: int) -> RayBundle:
            fx = w / 2.0 / np.tan(np.radians(self._config.hfov_degrees / 2.0))
            c2w = torch.as_tensor(np.asarray(poses, np.float32), device=self._device)
            return create_rays(c2w, h, w, fx, fx, (w - 1.0) / 2.0, (h - 1.0) / 2.0, near, far)

        pick = lambda a, ids: a if ids is None else a[ids]  # noqa: E731
        scaled = (self._img_h_scaled, self._img_w_scaled)
        self.rays_train = rays_for(self._train_data.camera_pose, self._img_h, self._img_w)
        self.rays_vis = rays_for(pick(self._train_data.camera_pose, self._train_eval_ids), *scaled)
        self.rays_test = rays_for(pick(self._test_data.camera_pose, self._test_eval_ids), *scaled)

    def setup(self) -> None:
        self.prepare_data()
        self.initialize_models()
        self.initialize_rays()

    # The step loop (reference step(), …training_handler.py:265-339).

    def _draws(self, global_step: int) -> StepDraws:
        """Step `global_step`'s draws, from the generator seeded for it."""
        n_img, hw = self._train_rgbs.shape[0], self._train_rgbs.shape[1]
        self._gen.manual_seed(step_seed(self._seed, global_step))
        return draw_step(self._gen, n_img, hw, self._config.rendering.n_rays, self._settings,
                         self._device)

    def _mesh_shards(self) -> Dict[str, Any]:
        """Per distinct device of the mesh: the parameters (the state's own
        on the first), the training rays and colours, a generator."""
        if self._shards is None:
            devices = self._mesh.distinct_devices
            self._shards = dict(
                params=mesh_replicas(self.state, self._mesh),
                rays={d: RayBundle(*(f.to(d) for f in self.rays_train)) for d in devices},
                rgbs={d: self._train_rgbs.to(d) for d in devices},
                gens={d: torch.Generator(device=d) for d in devices},
            )
        return self._shards

    def _shard_draws(self, global_step: int) -> List[StepDraws]:
        """Step `global_step`'s draws over the mesh, seeded from (seed,
        step) for the image and (seed, step, shard) for each shard."""
        sh = self._mesh_shards()
        n_img, hw = self._train_rgbs.shape[0], self._train_rgbs.shape[1]
        seeds = [step_seed(self._seed, global_step, i) for i in range(self._mesh.size)]
        return draw_shards(sh["gens"], seeds, step_seed(self._seed, global_step), n_img, hw,
                           self._config.rendering.n_rays, self._settings, self._mesh)

    def _step_path(self, global_step: int, k: int) -> Tuple[Any, list]:
        """The step body and the draws of steps global_step .. global_step +
        k - 1: on one device `apply_step` (this module's, looked up now)
        bound to the state and the training data, and `_draws`; over the
        mesh a `DataParallelBody` and `_shard_draws`."""
        if self._mesh is not None:
            sh = self._mesh_shards()
            body = DataParallelBody(self.state, sh["params"], sh["rays"], sh["rgbs"], self._settings, self._spec,
                                    self._mesh)
            draw = self._shard_draws
        else:
            body = functools.partial(apply_step, self.state, self.rays_train, self._train_rgbs,
                                     settings=self._settings, spec=self._spec)
            draw = self._draws
        with span("train.draws"):
            return body, [draw(global_step + i) for i in range(k)]

    def step(self, global_step: int) -> Dict[str, Any]:
        """One optimization step plus cadenced logging, eval and checkpoints."""
        with self.timer.phase("train_step", "train.step"):
            body, draws = self._step_path(global_step, 1)
            with span("train.eager"):
                self._state, metrics = take_step(self.state, body, draws[0], self._schedule)
        self._cadence(global_step, metrics)
        return metrics

    def _cadence(self, global_step: int, metrics: Dict[str, Any]) -> None:
        """The logging, eval and checkpoint actions due at `global_step`,
        given that step's metrics."""
        cfg = self._config
        log = cfg.logging
        if log.step_log_print > 0 and global_step % log.step_log_print == 0:
            s = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
            print(
                f"[TRAIN] Iter: {global_step} Loss: {s['total_loss']:.6f}, "
                f"rgb_coarse: {s['rgb_loss_coarse']:.6f}, rgb_fine: {s['rgb_loss_fine']:.6f}, "
                f"PSNR_coarse: {s['psnr_coarse']:.3f}, PSNR_fine: {s['psnr_fine']:.3f}"
            )
        if self._tb is not None and global_step % log.step_log_tensorboard == 0:
            names = ("rgb_loss_coarse", "rgb_loss_fine", "total_loss")
            self._tb.write_scalars(global_step, [metrics[k] for k in names],
                                   [f"Train/Loss/{k}" for k in names])
            self._tb.write_scalars(global_step, [metrics["psnr_coarse"], metrics["psnr_fine"]],
                                   ["Train/Metric/psnr_coarse", "Train/Metric/psnr_fine"])
            self._tb.write_histogram(global_step, metrics["trans_coarse"], "trans_coarse")
            self._tb.write_histogram(global_step, metrics["trans_fine"], "trans_fine")
            for phase, mean_s in self.timer.summary().items():
                self._tb.write_scalars(global_step, [mean_s * 1000.0], [f"Perf/{phase}_ms"])
        if log.step_render_train > 0 and global_step % log.step_render_train == 0 and global_step > 0:
            self.render_train_images(global_step)
        if log.step_render_test > 0 and global_step % log.step_render_test == 0 and global_step > 0:
            self.render_test_images(global_step)
        if log.step_save_ckpt > 0 and global_step % log.step_save_ckpt == 0:
            self.save_models_checkpoint(global_step)

    def step_many(self, global_step: int) -> Dict[str, Any]:
        """Steps global_step .. global_step + K - 1 (K = `steps_per_call`) in
        one call, with no cadence action (the JAX package's scanned
        dispatch), single-device or over the mesh: on `cuda` a replay of a
        `StepGraph` of K steps (captured at its first call), on the CPU K
        eager steps of the same step body. Returns the last step's metrics,
        plus every step's total loss as `total_loss_steps` [K]."""
        with self.timer.phase("train_step", "train.step_many"):
            body, draws = self._step_path(global_step, self._steps_per_call)
            if self._device.type == "cuda":
                if self._graph is None:
                    self._graph = StepGraph(self._steps_per_call)
                self._state, metrics = self._graph(self.state, body, draws, self._schedule)
            else:
                with span("train.eager"):
                    self._state, metrics = take_steps(self.state, body, draws, self._schedule)
        return metrics

    def _cadence_intervals(self) -> list:
        """The logging, eval and checkpoint intervals whose actions can fire."""
        log = self._config.logging
        return [
            v
            for v, active in (
                (log.step_log_print, True),
                (log.step_log_tensorboard, self._tb is not None),
                (log.step_render_train, True),
                (log.step_render_test, True),
                (log.step_save_ckpt, True),
            )
            if v > 0 and active
        ]

    def fit(self, n_iterations: Optional[int] = None, *, start_step: int = 0) -> None:
        """Run the main loop (reference nerf/train.py:48-56).

        With `steps_per_call` K > 1, the steps advance K a call
        (`step_many`) wherever K of them fit before the next cadence
        boundary (a step at which a logging, eval or checkpoint action is
        due), the boundary included: the boundary's actions then run after
        the call on its last step's metrics, so every action fires at its
        exact step and a cadence of K (the train CLI raises the print's to
        K) leaves whole K-step calls. The rest go one step a call. The
        trajectory is the same either way. (JAX `Trainer.fit` ends each
        K-step run before a boundary, so a cadence of K leaves it none.)"""
        total = n_iterations if n_iterations is not None else self._config.training.n_iterations
        k = self._steps_per_call
        if k <= 1:
            for i in range(start_step, total):
                self.step(i)
            return
        intervals = self._cadence_intervals()
        if intervals and min(intervals) < k:
            print(
                f"[Trainer] steps_per_call={k} is limited by the "
                f"{min(intervals)}-step logging cadence; raise the logging "
                f"intervals (the train CLI's --steps-per-call stretches the "
                f"print cadence automatically) to get full K-step calls"
            )
        i = start_step
        while i < total:
            # The next boundary at or after step i (or the last step).
            last = min(min((-(-i // v) * v for v in intervals), default=total - 1), total - 1)
            while last - i + 1 >= k:
                metrics = self.step_many(i)
                i += k
                self._cadence(i - 1, metrics)
            while i <= last:
                self.step(i)
                i += 1

    # Eval renders (reference :411-508).

    @torch.no_grad()
    def _render_rays(self, flat_rays: RayBundle) -> torch.Tensor:
        """rgb [R, 3] of a flat bundle: the fused serving path (K1-K3) on the
        current weights on `cuda`, the plain fp32 pipeline on the CPU."""
        eval_settings = self._settings.for_eval()._replace(field_impl="plain")
        params = self.params
        if self._device.type == "cuda":
            kparams = {k: prepare_kernel_params(params[k], spec) for k, spec in self._net_specs().items()}
            return render_rays_fused(kparams, flat_rays, eval_settings)
        chunk = min(self._config.model.chunk, flat_rays.origins.shape[0])
        out = render_rays_chunked(params, flat_rays, eval_settings, spec=self._spec, chunk=chunk)
        return out["rgb_fine"]

    def _render_image_set(self, rays: RayBundle, save_dir: Optional[str]) -> np.ndarray:
        """Every image of a ray set -> [N, H, W, 3] at the eval resolution, in
        groups of whole images."""
        h, w = self._img_h_scaled, self._img_w_scaled
        n_img, n_pix = rays.origins.shape[0], h * w
        per_group = min(n_img, max(1, EVAL_GROUP_RAYS // n_pix))
        images = []
        for start in range(0, n_img, per_group):
            group = RayBundle(*(f[start : start + per_group] for f in rays))
            n_group = group.origins.shape[0]
            rgb = self._render_rays(group.reshape(n_group * n_pix))
            images.append(rgb.reshape(n_group, h, w, 3).cpu().numpy())
        images = np.concatenate(images, axis=0)
        if save_dir is not None:
            for i, rgb in enumerate(images):
                write_png(os.path.join(save_dir, f"rgb_{i:03d}.png"), to8b(rgb))
        return images

    def _eval_split(self, tag: str, rays: RayBundle, gt: np.ndarray, global_step: int,
                    subdir: str) -> float:
        save_dir = os.path.join(self._save_dir, subdir, f"step_{global_step:06d}")
        os.makedirs(save_dir, exist_ok=True)
        with self.timer.phase(f"render_{tag.lower()}", f"train.render_{tag.lower()}"):
            rgbs = self._render_image_set(rays, save_dir)
        mse = float(np.mean((rgbs - gt) ** 2))
        psnr = float(-10.0 * np.log(mse) / np.log(10.0))
        if self._tb is not None:
            self._tb.write_scalars(global_step, [psnr, mse],
                                   [f"{tag}/Metric/batch_PSNR", f"{tag}/Metric/batch_MSE"])
            self._tb.write_image(f"{tag}/rgb", rgbs, global_step)
        return psnr

    def render_train_images(self, global_step: int) -> float:
        return self._eval_split("Train", self.rays_vis, self._train_rgbs_eval, global_step,
                                "train_render")

    def render_test_images(self, global_step: int) -> float:
        return self._eval_split("Test", self.rays_test, self._test_rgbs_eval, global_step,
                                "test_render")

    # Checkpoint and resume (reference :394-409; resume is the JAX package's).

    def save_models_checkpoint(self, global_step: int) -> str:
        """`checkpoints/<global_step>.npz`: params, the Adam state in the JAX
        package's `opt||i` layout, and the number of updates taken (so a
        resumed run continues at the next step)."""
        path = os.path.join(self._save_dir, "checkpoints", f"{global_step:06d}.npz")
        save_checkpoint(path, self.params, step=self.state.step,
                        opt_leaves=optimizer_leaves(self.state),
                        metadata={"office": self._office_name})
        print(f"Saved checkpoints at {path}")
        return path

    def resume_from_checkpoint(self, path: str) -> int:
        """Restore params, Adam state and step; returns the step to run next.
        Reads either package's checkpoints; one without optimizer leaves
        restarts Adam from zero moments at its step."""
        if self._state is None:
            self.initialize_models()
        params, step, opt_leaves, _ = load_training_checkpoint(path)
        nets = tuple(self._net_specs())
        if any(k not in params for k in nets):
            hint = " (a proposal checkpoint needs use_proposal=True)" if "proposal" in params else ""
            raise ValueError(f"the checkpoint holds {'/'.join(sorted(params))}, the trainer needs "
                             f"{'/'.join(nets)}{hint}")
        loaded = params_from_numpy({k: params[k] for k in nets}, self._device)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self.params), tree_leaves(loaded)):
                if dst.shape != src.shape:
                    raise ValueError(f"checkpoint leaf {tuple(src.shape)} != {tuple(dst.shape)}")
                dst.copy_(src)
        state = self.state
        if opt_leaves:
            state = load_optimizer_leaves(state, opt_leaves)
        self._state = state._replace(step=step)
        self._graph = None  # a captured graph holds the optimizer state's old tensors
        self._shards = None  # the other devices' copies of the old parameters
        return step

    def export_results(self, out_dir: Optional[str] = None) -> list:
        """The reference's nine SVG training curves from this run's scalars."""
        from nerf_workspaces_explorer_tpu_torch.obs.export import (
            export_training_curves,
            scalars_from_tensorboard_logs,
        )

        out_dir = out_dir or os.path.join(self._save_dir, "results")
        writer = getattr(self._tb, "summary_writer", None) if self._tb else None
        if writer is not None:
            self._tb.flush()  # event files, or the scalar sink's history file
        if writer is not None and getattr(writer, "scalars", None):
            scalars = writer.scalars  # the scalar sink's in-memory history
        elif writer is not None:
            try:
                scalars = scalars_from_tensorboard_logs(os.path.join(self._save_dir, "tensorboard_logs"))
            except ImportError:
                scalars = {}
        else:
            scalars = {}
        return export_training_curves(scalars, out_dir)
