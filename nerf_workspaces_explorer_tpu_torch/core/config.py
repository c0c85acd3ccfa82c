"""Immutable, typed configuration.

Parity target: reference nerf/configs/config_parser.py:22-61 (singleton
ConfigParser with `eval()`-ed string params) and the per-office YAML schema
(reference nerf/configs/office_tokyo_config.yaml:1-41 — all four office files
are identical). The reference's two hazards are deliberately not reproduced:
the process-wide Singleton is replaced by plain frozen dataclasses, and
arithmetic strings such as ``"1024*32"`` are parsed by a whitelisted-token
evaluator instead of ``eval``.

Every field is a hashable Python scalar, so a config object can key a cache
of per-configuration state (kernel parameters, ray grids).
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import yaml

_ARITH_RE = re.compile(r"^[0-9+\-*/() .]+$")


def parse_int_expr(value: Any) -> int:
    """Parse an int or a simple arithmetic string like ``"1024*32"``.

    The reference eval()s these strings (e.g. reference
    nerf/training/nerf_replica_training_handler.py:54-59); we accept the same
    YAML syntax but only allow digit/operator tokens.
    """
    if isinstance(value, bool):
        raise TypeError(f"expected int expression, got bool: {value!r}")
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        if not value.is_integer():
            raise ValueError(f"expected integral value, got {value!r}")
        return int(value)
    if isinstance(value, str):
        expr = value.split("#", 1)[0].strip()
        if not _ARITH_RE.match(expr):
            raise ValueError(f"unsafe arithmetic expression: {value!r}")
        result = eval(compile(expr, "<config-arith>", "eval"), {"__builtins__": {}}, {})
        if not float(result).is_integer():
            raise ValueError(f"expression {value!r} is not integral")
        return int(result)
    raise TypeError(f"cannot parse int from {value!r}")


@dataclass(frozen=True)
class ExperimentConfig:
    """`experiment:` section (reference office_tokyo_config.yaml:1-4)."""

    image_width: int = 320
    image_height: int = 240
    endpoint_feat: bool = False


@dataclass(frozen=True)
class TrainingConfig:
    """`training:` section (reference office_tokyo_config.yaml:6-10)."""

    n_iterations: int = 200_000
    learning_rate: float = 5e-4
    learning_rate_decay_rate: float = 0.1
    learning_rate_decay_steps: float = 50_000.0


@dataclass(frozen=True)
class ModelConfig:
    """`model:` section (reference office_tokyo_config.yaml:12-18)."""

    net_depth: int = 8
    net_width: int = 256
    net_depth_fine: int = 8
    net_width_fine: int = 256
    chunk: int = 1024 * 32
    net_chunk: int = 1024 * 32


@dataclass(frozen=True)
class RenderingConfig:
    """`rendering:` section (reference office_tokyo_config.yaml:20-31)."""

    n_rays: int = 32 * 32
    n_samples: int = 64
    n_importance: int = 128
    perturb: float = 1.0
    use_view_dirs: bool = True
    num_freqs_3d: int = 10
    num_freqs_2d: int = 4
    raw_noise_std: float = 1.0
    test_viz_factor: int = 1
    depth_range: Tuple[float, float] = (0.1, 10.0)
    white_background: bool = False


@dataclass(frozen=True)
class LoggingConfig:
    """`logging:` section (reference office_tokyo_config.yaml:33-38)."""

    step_log_print: int = 1
    step_log_tensorboard: int = 500
    step_save_ckpt: int = 20_000
    step_render_test: int = 5_000
    step_render_train: int = 5_000


@dataclass(frozen=True)
class InferenceConfig:
    """`inference:` section (reference office_tokyo_config.yaml:40-41)."""

    chunk: int = 1024 * 8


@dataclass(frozen=True)
class FrameworkConfig:
    """Full config: one object per office, no global state."""

    experiment: ExperimentConfig = ExperimentConfig()
    training: TrainingConfig = TrainingConfig()
    model: ModelConfig = ModelConfig()
    rendering: RenderingConfig = RenderingConfig()
    logging: LoggingConfig = LoggingConfig()
    inference: InferenceConfig = InferenceConfig()

    # Camera intrinsics derive from image size and a fixed 90 deg hfov
    # (reference nerf/inference/nerf_replica_inference_handler.py:67-74).
    hfov_degrees: float = 90.0

    @property
    def fx(self) -> float:
        return self.experiment.image_width / 2.0 / math.tan(
            math.radians(self.hfov_degrees / 2.0)
        )

    @property
    def fy(self) -> float:
        return self.fx

    @property
    def cx(self) -> float:
        return (self.experiment.image_width - 1.0) / 2.0

    @property
    def cy(self) -> float:
        return (self.experiment.image_height - 1.0) / 2.0

    @property
    def n_pix(self) -> int:
        return self.experiment.image_height * self.experiment.image_width

    def scaled_hw(self) -> Tuple[int, int]:
        """Downscaled eval-render resolution (reference
        nerf/training/nerf_replica_training_handler.py:103-110)."""
        f = self.rendering.test_viz_factor
        return (self.experiment.image_height // f, self.experiment.image_width // f)

    def scaled_intrinsics(self) -> Tuple[float, float, float, float]:
        h, w = self.scaled_hw()
        fx = w / 2.0 / math.tan(math.radians(self.hfov_degrees / 2.0))
        return (fx, fx, (w - 1.0) / 2.0, (h - 1.0) / 2.0)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_INT_EXPR_FIELDS = {
    ("model", "chunk"),
    ("model", "net_chunk"),
    ("model", "net_depth"),
    ("model", "net_width"),
    ("model", "net_depth_fine"),
    ("model", "net_width_fine"),
    ("rendering", "n_rays"),
    ("inference", "chunk"),
}

_SECTIONS = {
    "experiment": ExperimentConfig,
    "training": TrainingConfig,
    "model": ModelConfig,
    "rendering": RenderingConfig,
    "logging": LoggingConfig,
    "inference": InferenceConfig,
}


def _coerce(section: str, field: dataclasses.Field, raw: Any) -> Any:
    if (section, field.name) in _INT_EXPR_FIELDS:
        return parse_int_expr(raw)
    if field.type in ("int", int):
        return parse_int_expr(raw)
    if field.type in ("float", float):
        return float(raw)
    if field.type in ("bool", bool):
        return bool(raw)
    if field.name == "depth_range":
        near, far = raw
        return (float(near), float(far))
    return raw


def config_from_dict(raw: Mapping[str, Any]) -> FrameworkConfig:
    """Build a FrameworkConfig from a reference-schema YAML dict."""
    sections: Dict[str, Any] = {}
    for section_name, section_cls in _SECTIONS.items():
        raw_section = raw.get(section_name, {}) or {}
        kwargs = {}
        for field in dataclasses.fields(section_cls):
            if field.name in raw_section:
                kwargs[field.name] = _coerce(section_name, field, raw_section[field.name])
        sections[section_name] = section_cls(**kwargs)
    return FrameworkConfig(**sections)


def load_config(path: Optional[str] = None, office_name: Optional[str] = None) -> FrameworkConfig:
    """Load a config YAML (reference schema) for a path or an office name.

    With `office_name`, looks under this repo's `configs/office_<name>_config.yaml`.
    """
    if path is None:
        if office_name is None:
            return FrameworkConfig()
        office = office_name.replace("office_", "")
        root = os.path.join(os.path.dirname(__file__), "..", "..", "configs")
        path = os.path.normpath(os.path.join(root, f"office_{office}_config.yaml"))
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    return config_from_dict(raw)
