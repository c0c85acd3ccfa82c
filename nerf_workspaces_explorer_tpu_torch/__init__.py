"""nerf_workspaces_explorer_tpu_torch — the PyTorch/CUDA port of the NeRF
Workspaces Explorer, for one NVIDIA H100 (Hopper, sm_90a).

The explorer app is `python -m nerf_workspaces_explorer_tpu_torch`
(`app.gui_qt` or `app.gui_tk`). Its product path is a floor-plan click ->
`app.workspace.Workspace.render_image` ->
`infer.renderer.NeRFRenderer.render_coordinates` -> uint8 [240, 320, 3]
frame. At `precision="fast"` that path runs three hand-written CUDA kernels
(`csrc/fused_render.cu` twice: the density-only coarse pass and the full
fine pass; `csrc/importance_merge.cu` for the sample placement between
them). `precision="parity"` is the fp32 plain-PyTorch pipeline
(`render.pipeline.render_rays_chunked`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; on a CPU
tensor each kernel wrapper runs its plain PyTorch version instead.

Training (`train.loop.Trainer`, `cli.train`) reads an office's Replica
sequence (`data.replica`) or an analytic scene (`data.synthetic`).

The package imports torch, numpy and yaml only, and a GUI toolkit (PyQt5 or
tkinter) where the app runs; PNGs go through its own codec, `utils.png`.
"""

__version__ = "0.1.0"
