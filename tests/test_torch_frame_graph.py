"""The renderer's frame graph on the CPU: which calls would replay it (a
single full frame of a 4x4 pose on the card's fused path) and that every
other call, and every call on the CPU, renders today's eager frame without
capturing; the engaged path's wiring through a stand-in graph; the
`render.eager_frames` counter; and the benchmark's two readers of the
graph's share of the frames. The graph itself needs the card
(`tests/test_torch_gpu.py -k frame_graph`)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu_torch.core.config import load_config
from nerf_workspaces_explorer_tpu_torch.core.types import COORD
from nerf_workspaces_explorer_tpu_torch.infer import renderer as renderer_mod
from nerf_workspaces_explorer_tpu_torch.infer.checkpoint import load_checkpoint
from nerf_workspaces_explorer_tpu_torch.infer.renderer import NeRFRenderer, _to_uint8
from nerf_workspaces_explorer_tpu_torch.obs import profiler
from nerf_workspaces_explorer_tpu_torch.parallel import data_mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "bench", "synth_hier.npz")
BENCH = os.path.join(ROOT, "benchmark")
H, W = 8, 16
INIT, COORDS = COORD(x=1.0, y=-0.5, z=0.5, pitch=-90.0), COORD(yaw=-30.0)


def _pose(yaw: float) -> np.ndarray:
    c, s = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    pose[:3, 3] = [1.0, -0.5, 0.5]
    return pose


POSES = [_pose(0.0), _pose(40.0)]


def _renderer(kind: str) -> NeRFRenderer:
    cfg = load_config(office_name="tokyo")
    cfg = dataclasses.replace(cfg, experiment=dataclasses.replace(cfg.experiment, image_width=W, image_height=H))
    if kind == "mesh":
        r = NeRFRenderer("tokyo", CKPT, config=cfg, precision="parity", chunk=H * W,
                         mesh=data_mesh(devices=["cpu"] * 2), device=None)
    elif kind == "parity":
        r = NeRFRenderer("tokyo", CKPT, config=cfg, precision="parity", chunk=H * W, device="cpu")
    else:
        r = NeRFRenderer("tokyo", CKPT, config=cfg, precision=kind, device="cpu")
    r.initialize_models()
    return r


@pytest.fixture(scope="module")
def renderers():
    return {kind: _renderer(kind) for kind in ("fast", "int8", "parity", "mesh")}


@pytest.fixture(autouse=True)
def fresh_counters():
    profiler.reset_counters()
    yield
    profiler.reset_counters()


def _eager_uint8(r, pose, height=None, cy=None):
    return _to_uint8(r._render_batch([pose], height, cy)[0])


def _strips(r, pose):
    half = H // 2
    return torch.cat([_eager_uint8(r, pose, half, r.config.cy - r0) for r0 in (0, half)]).numpy()


def _full_frame(r, pose, monkeypatch):
    monkeypatch.setattr(r, "_nan_debug", True)
    return r.render_coordinates(INIT, COORDS)


CALLS = {
    "render_pose": (lambda r, mp: r.render_pose(POSES[0]), lambda r: r._render_batch([POSES[0]])[0]),
    "render_pose_uint8": (lambda r, mp: r.render_pose_uint8(POSES[1]), lambda r: _eager_uint8(r, POSES[1])),
    "render_coordinates": (
        lambda r, mp: r.render_coordinates(INIT, COORDS),
        lambda r: _eager_uint8(r, renderer_mod.poses_from_coordinates(INIT, [COORDS])[0]).numpy()),
    "stream": (lambda r, mp: np.stack(list(r.render_poses_uint8_stream(POSES, lookahead=1))),
               lambda r: np.stack([_eager_uint8(r, p).numpy() for p in POSES])),
    "strips": (lambda r, mp: r.render_pose_uint8_pipelined(POSES[1], n_strips=2), lambda r: _strips(r, POSES[1])),
    "batch": (lambda r, mp: r.render_poses(POSES), lambda r: r._render_batch(POSES).numpy()),
    "full": (lambda r, mp: _full_frame(r, POSES[0], mp),
             lambda r: _to_uint8(r._render_batch([renderer_mod.poses_from_coordinates(INIT, [COORDS])[0]],
                                                 full=True)["rgb_fine"][0]).numpy()),
}


def _refuse_graphs(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a frame graph was captured")

    monkeypatch.setattr(renderer_mod, "FrameGraph", refuse)


@pytest.mark.parametrize("call", sorted(CALLS))
@pytest.mark.parametrize("kind", ["fast", "parity", "mesh"])
def test_no_graph_off_the_card(renderers, kind, call, monkeypatch, capsys):
    """On the CPU, on the parity path and over a mesh, no call captures a
    frame graph, and each renders today's eager frame: single frames,
    the stream, strips, batches and `nan_debug`'s full outputs."""
    r = renderers[kind]
    _refuse_graphs(monkeypatch)
    run, eager = CALLS[call]
    got = run(r, monkeypatch)
    want = eager(r)
    assert r._frame_graph is None
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,device,pose_shape,engages", [
    ("fast", "cuda", (4, 4), True),
    ("int8", "cuda", (4, 4), True),
    ("fast", "cuda", (3, 4), False),
    ("fast", "cpu", (4, 4), False),
    ("parity", "cuda", (4, 4), False),
    ("mesh", "cuda", (4, 4), False),
])
def test_which_frames_the_graph_takes(renderers, kind, device, pose_shape, engages, monkeypatch):
    """The rule reads only what a call can observe: the fused path (kernel
    parameters), a CUDA device and a 4x4 pose."""
    r = renderers[kind]
    monkeypatch.setattr(r, "_device", torch.device(device))
    assert r._replays_frame(np.eye(4, dtype=np.float32)[: pose_shape[0]]) is engages


class _StandInGraph:
    """A `FrameGraph` that runs its frame function eagerly on the CPU."""

    made = []

    def __init__(self, frame, device):
        self.frame, self.device = frame, device
        _StandInGraph.made.append(self)

    def replay(self, c2w, uint8):
        rgb = self.frame(torch.as_tensor(np.asarray(c2w, dtype=np.float32))[None], None)[0]
        return _to_uint8(rgb) if uint8 else rgb


@pytest.mark.parametrize("kind", ["fast", "int8"])
def test_engaged_frames_replay_the_eager_frame_function(kind, monkeypatch):
    """Where the rule engages, the first single frame renders eagerly and
    then makes the graph of `_pose_frame`, which renders what
    `_render_batch` renders; later single frames replay it, the strip and
    the batch do not, and `set_params` drops it."""
    r = _renderer(kind)
    monkeypatch.setattr(renderer_mod, "FrameGraph", _StandInGraph)
    monkeypatch.setattr(r, "_replays_frame", lambda c2w: np.shape(c2w) == (4, 4))
    _StandInGraph.made = []
    first = r.render_pose_uint8(POSES[0])
    assert len(_StandInGraph.made) == 1 and r._frame_graph is _StandInGraph.made[0]
    assert torch.equal(first, _eager_uint8(r, POSES[0]))
    for pose in POSES:
        assert torch.equal(r.render_pose_uint8(pose), _eager_uint8(r, pose))
        assert torch.equal(r.render_pose(pose), r._render_batch([pose])[0])
    np.testing.assert_array_equal(r.render_coordinates(INIT, COORDS), CALLS["render_coordinates"][1](r))
    r.render_pose_uint8_pipelined(POSES[1], n_strips=2)
    r.render_poses(POSES)
    assert len(_StandInGraph.made) == 1
    r.set_params(load_checkpoint(CKPT)[0])
    assert r._frame_graph is None
    r.render_pose_uint8(POSES[1])
    assert len(_StandInGraph.made) == 2


def test_traced_frames_on_the_cpu_count_as_eager(renderers, capsys):
    """While a profiler records, a single frame on the CPU counts in
    `render.eager_frames` and nothing counts `render.graph_replays`; a strip
    frame and a batch count in neither."""
    r = renderers["fast"]
    with torch.profiler.profile():
        r.render_pose_uint8(POSES[0])
        r.render_pose(POSES[1])
        r.render_coordinates(INIT, COORDS)
        r.render_pose_uint8_pipelined(POSES[1], n_strips=2)
        r.render_poses(POSES)
    counts = profiler.read_counters()
    assert counts["render.eager_frames"] == 3
    assert "render.graph_replays" not in counts


def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    from harness import manifest

    return manifest.metric_reader(name)


@pytest.mark.parametrize("name", ["graph_frame_share.walk", "graph_frame_share.click"])
@pytest.mark.parametrize("counts,share", [
    (None, None),
    ({}, None),
    ({"render.fine_samples": 7}, None),
    ({"render.graph_replays": 48}, 100.0),
    ({"render.graph_replays": 11, "render.eager_frames": 1}, 100.0 * 11 / 12),
    ({"render.eager_frames": 12}, 0.0),
])
def test_graph_frame_share_readers(name, counts, share, monkeypatch):
    """The benchmark's readers of the frame graph's share: replays over
    replays and eager frames, in percent; None where the program has
    neither counter (the parent's program) or none at all."""
    reader = _reader(name, monkeypatch)
    from harness import spans

    monkeypatch.setattr(spans, "program_counters", lambda: counts)
    assert reader.UNIT == "%"
    got = reader.read({"trace": object(), "counts": []})
    assert got == pytest.approx(share) if share is not None else got is None
