from nerf_workspaces_explorer_tpu_torch.parallel.mesh import DataMesh, data_mesh, device_count
from nerf_workspaces_explorer_tpu_torch.parallel.sharding import shard_render

__all__ = ["DataMesh", "data_mesh", "device_count", "shard_render"]
