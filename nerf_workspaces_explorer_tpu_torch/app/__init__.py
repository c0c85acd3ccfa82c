from nerf_workspaces_explorer_tpu_torch.app.workspace import (
    WORKSPACE_CLASSES,
    OfficeBelgradeWorkspace,
    OfficeGeneveWorkspace,
    OfficeNewYorkWorkspace,
    OfficeTokyoWorkspace,
    Workspace,
    make_workspaces,
)

__all__ = [
    "WORKSPACE_CLASSES",
    "OfficeBelgradeWorkspace",
    "OfficeGeneveWorkspace",
    "OfficeNewYorkWorkspace",
    "OfficeTokyoWorkspace",
    "Workspace",
    "make_workspaces",
]
