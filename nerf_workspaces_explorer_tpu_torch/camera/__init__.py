from nerf_workspaces_explorer_tpu_torch.camera.intrinsics import PinholeIntrinsics
from nerf_workspaces_explorer_tpu_torch.camera.poses import (
    camera_to_world_matrix,
    poses_from_coordinates,
    rodrigues,
)

__all__ = [
    "PinholeIntrinsics",
    "camera_to_world_matrix",
    "poses_from_coordinates",
    "rodrigues",
]
