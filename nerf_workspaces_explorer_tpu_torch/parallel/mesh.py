"""The device mesh: a flat data axis over CUDA cards.

Counterpart of `nerf_workspaces_explorer_tpu/parallel/mesh.py`. NeRF's ray
work is embarrassingly parallel, so the unit of scaling is one data axis:
sharded rays at inference (`parallel/sharding.py`) and a gradient mean over
shards in training (`train/step.py::data_parallel_step`). A `DataMesh` is
the list of devices the shards run on, in shard order. An explicit device
list may repeat a device: `data_mesh(devices=["cpu"] * 8)` is the port's
stand-in for XLA's virtual CPU devices (the CPU tests), and `[cuda:0] * k`
runs k shards on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh: `devices` in shard order, `axis_names` ("data",)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def device_count() -> int:
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def data_mesh(
    n_devices: Optional[int] = None,
    *,
    axis_name: str = "data",
    devices: Optional[Sequence] = None,
) -> DataMesh:
    """1-D mesh over the first `n_devices` of `devices` (default: every CUDA
    card); more than there are raises."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(device_count())]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(tuple(devices), (axis_name,))
