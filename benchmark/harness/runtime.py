"""What a run checks about its process and its card."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List

import torch

from harness import trace as trace_mod

# Top-level module names that no process of the benchmark may hold: JAX and
# its libraries, and the JAX package the port was made from. Compared whole:
# the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_workspaces_explorer_tpu")


class ForbiddenModules(RuntimeError):
    def __init__(self, names: List[str]) -> None:
        super().__init__(f"the process holds forbidden modules: {', '.join(names)}")


def forbidden_modules(modules=None) -> List[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    """Raise unless CUDA is there with at least `chips` cards."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the benchmark measures the card and does not run on the CPU")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} cards, the machine has {torch.cuda.device_count()}")


def cache_dirs(bench_dir: str) -> Dict[str, str]:
    """Fixed build and kernel caches inside the checkout, for any library
    that the program or PyTorch builds at run time (the port's own kernels
    build into its fixed `build/torch_kernels/`)."""
    base = os.path.join(bench_dir, ".cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}


def card_power_limit() -> str:
    """`nvidia-smi`'s power limit of the first card, or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(correct: bool, attempted: int, failed: int, readers: Dict[str, object], ctx: dict,
                device_line: dict, tr, extra: dict, checks: dict) -> dict:
    """The result line: the readers' metrics (a reader with nothing to read
    is left out), the device, a traced run's busy and window seconds and
    breakdown, `extra` fields, and `checks` last."""
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": reader.UNIT}
    out = dict(correct=bool(correct), attempted=attempted, failed=failed, metrics=metrics, device=device_line)
    if tr is not None:
        out["device"] = dict(device_line, busy_s=trace_mod.busy_s(tr), window_s=trace_mod.window_s(tr))
        out["breakdown"] = dict(device_ops=trace_mod.top_device_ops(tr), idle_gaps=trace_mod.idle_gaps(tr))
    out.update(extra)
    out["checks"] = checks
    return out


def device_info(chips: int, device: torch.device) -> dict:
    if device.type != "cuda":  # the CPU tests' runs
        return dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips)),
    }
