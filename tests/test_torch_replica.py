"""The port's Replica loader (`data/replica.py`) against the JAX package's,
which reads with cv2 here (its reference path), and the Trainer and train
CLI fed by it on the CPU.

Exact: split ids, poses, rgb and depth at the files' size, names, accessors,
`__str__`. With a resize (up and down): atol 1e-6, the float32 rounding of
cv2's float64 INTER_LINEAR against the port's."""

import os
import shutil

import imageio
import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu.data import replica as jreplica
from nerf_workspaces_explorer_tpu_torch.data import replica
from nerf_workspaces_explorer_tpu_torch.data.synthetic import render_room_ground_truth, room_scene, walkthrough_poses
from nerf_workspaces_explorer_tpu_torch.utils import png

torch.set_num_threads(2)

RESIZE_ATOL = 1e-6


def _write_layout(root, office="office_test", n_frames=13, h=8, w=10, filters=None, writer="imageio"):
    """The layout of tests/test_data.py's fixture (reference
    nerf/datasets/replica_dataset.py:25-52): 13 random frames of 8x10, so
    the last test id (10 + 2) is in range; written by imageio, or by the
    port's encoder with the given row filters."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, size=(n_frames, h, w, 3), dtype=np.uint8)
    depth = rng.uniform(100, 5000, size=(n_frames, h, w)).astype(np.uint16)
    poses = np.stack([np.eye(4) for _ in range(n_frames)])
    poses[:, 0, 3] = np.arange(n_frames) * 0.1
    scene_dir = os.path.join(root, office, "Sequence_1")
    if writer == "imageio":
        os.makedirs(os.path.join(scene_dir, "rgb"))
        os.makedirs(os.path.join(scene_dir, "depth"))
        for i in range(n_frames):
            imageio.imwrite(os.path.join(scene_dir, "rgb", f"rgb_{i}.png"), rgb[i])
            imageio.imwrite(os.path.join(scene_dir, "depth", f"depth_{i}.png"), depth[i])
        np.savetxt(os.path.join(scene_dir, "traj_w_c.txt"), poses.reshape(n_frames, -1), delimiter=" ")
    else:
        replica.write_sequence(scene_dir, rgb, depth, poses, filters)
    return rgb, depth, poses


@pytest.fixture
def fake_replica(tmp_path):
    rgb, depth, poses = _write_layout(str(tmp_path))
    return str(tmp_path), rgb, depth, poses


@pytest.fixture
def avg_paeth_replica(tmp_path):
    """Frames written by the port's encoder with Avg and Paeth rows (and the
    other three between them), which cv2 never writes."""
    filters = [(np.arange(8) + i) % 5 if i % 3 else [png.AVG, png.PAETH] * 4 for i in range(13)]
    rgb, depth, poses = _write_layout(str(tmp_path), filters=filters, writer="port")
    return str(tmp_path), rgb, depth, poses


def _assert_same(mine, ref, atol=0.0):
    for split in ("train", "test"):
        a, b = getattr(mine, split), getattr(ref, split)
        for key in ("rgb", "depth", "camera_pose"):
            x, y = getattr(a, key), getattr(b, key)
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, (split, key)
            if atol == 0.0 or key == "camera_pose":
                np.testing.assert_array_equal(x, y, err_msg=f"{split} {key}")
            else:
                np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=f"{split} {key}")


@pytest.mark.parametrize("fixture", ["fake_replica", "avg_paeth_replica"])
def test_splits_and_pixels_equal_jax_exactly(request, fixture):
    root, rgb, depth, poses = request.getfixturevalue(fixture)
    mine = replica.ReplicaDataset("office_test", datasets_path=root)
    ref = jreplica.ReplicaDataset("office_test", datasets_path=root)
    _assert_same(mine, ref)
    assert mine._train_ids == ref._train_ids == [0, 5, 10]
    assert mine._test_ids == ref._test_ids == [2, 7, 12]
    # And the arrays that were written, before any resize.
    np.testing.assert_array_equal(mine.train.rgb, (rgb[[0, 5, 10]] / 255.0).astype(np.float32))
    np.testing.assert_array_equal(mine.test.depth, (depth[[2, 7, 12]] / 1000.0).astype(np.float32))
    np.testing.assert_array_equal(mine.test.camera_pose, poses[[2, 7, 12]].astype(np.float32))


@pytest.mark.parametrize("hw", [(4, 6), (17, 23), (8, 23), (5, 10), (3, 1)], ids=["down", "up", "wide", "short", "tiny"])
@pytest.mark.parametrize("fixture", ["fake_replica", "avg_paeth_replica"])
def test_resize_matches_jax_cv2_path(request, fixture, hw):
    root, *_ = request.getfixturevalue(fixture)
    h, w = hw
    mine = replica.ReplicaDataset("office_test", datasets_path=root, image_height=h, image_width=w)
    ref = jreplica.ReplicaDataset("office_test", datasets_path=root, image_height=h, image_width=w)
    assert mine.train.rgb.shape == (3, h, w, 3) and mine.train.depth.shape == (3, h, w)
    _assert_same(mine, ref, atol=RESIZE_ATOL)


def test_resize_bilinear_is_cv2_inter_linear_in_float64():
    import cv2

    rng = np.random.default_rng(1)
    for shape in [(480, 640, 3), (480, 640), (7, 9, 3)]:
        image = rng.uniform(0, 1, shape)
        for w, h in [(320, 240), (1280, 960), (5, 3), (11, 13)]:
            mine = replica.resize_bilinear(image, w, h)
            ref = cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)
            assert mine.dtype == np.float64
            np.testing.assert_allclose(mine, ref, atol=RESIZE_ATOL, rtol=0)


def test_accessors_str_and_naming(fake_replica):
    root, *_ = fake_replica
    mine = replica.ReplicaDataset("office_test", datasets_path=root)
    ref = jreplica.ReplicaDataset("office_test", datasets_path=root)
    assert mine.train_dataset_len == ref.train_dataset_len == 3
    assert mine.test_dataset_len == ref.test_dataset_len == 3
    assert set(mine.train_dataset) == set(ref.train_dataset) == {"rgb", "depth", "camera_pose"}
    for key in ("rgb", "depth", "camera_pose"):
        np.testing.assert_array_equal(mine.test_dataset[key], ref.test_dataset[key])
    assert str(mine) == str(ref)
    assert replica.OFFICE_TO_REPLICA_SCENE == jreplica.OFFICE_TO_REPLICA_SCENE
    assert replica.REPLICA_SCENE_TO_OFFICE == jreplica.REPLICA_SCENE_TO_OFFICE
    assert os.path.normpath(replica.DATASETS_PATH) == os.path.normpath(jreplica.DATASETS_PATH)

    # Raw Replica naming on disk, the framework's name asked for; and back.
    shutil.copytree(os.path.join(root, "office_test"), os.path.join(root, "office0"))
    shutil.copytree(os.path.join(root, "office_test"), os.path.join(root, "office_new_york"))
    for name in ("office_tokyo", "office0", "office1", "office_new_york", "office_test"):
        assert replica.resolve_scene_dir(name, root) == jreplica.resolve_scene_dir(name, root)
    assert len(replica.ReplicaDataset("office_tokyo", datasets_path=root).train) == 3
    assert len(replica.ReplicaDataset("office1", datasets_path=root).test) == 3
    # Framework naming wins where both exist.
    shutil.copytree(os.path.join(root, "office_test"), os.path.join(root, "office_belgrade"))
    shutil.copytree(os.path.join(root, "office_test"), os.path.join(root, "office4"))
    assert replica.resolve_scene_dir("office_belgrade", root).endswith(os.path.join("office_belgrade", "Sequence_1"))


def test_errors(fake_replica, tmp_path, monkeypatch):
    root, *_ = fake_replica
    with pytest.raises(FileNotFoundError, match="office_geneve.*office2"):
        replica.ReplicaDataset("office_geneve", datasets_path=root)
    monkeypatch.setattr(replica, "DATASETS_PATH", root)
    assert replica.resolve_scene_dir("office_test").startswith(root)
    with pytest.raises(ValueError, match="unrecognized frame filename"):
        replica._frame_index("rgb.png")
    assert replica._frame_index("/a/rgb_12.png") == jreplica._frame_index("/a/rgb_12.png") == 12
    # Frames sort by their number, not as strings (rgb_10 after rgb_9).
    ds = replica.ReplicaDataset("office_test")
    assert [os.path.basename(p) for p in ds._rgb_images[9:11]] == ["rgb_9.png", "rgb_10.png"]
    # A depth frame that is not single-channel, and a 16-bit colour frame.
    scene = os.path.join(root, "office_test", "Sequence_1")
    png.write_png(os.path.join(scene, "depth", "depth_0.png"), np.zeros((8, 10, 3), np.uint8))
    with pytest.raises(ValueError, match="single-channel"):
        replica.ReplicaDataset("office_test")
    png.write_png(os.path.join(scene, "rgb", "rgb_0.png"), np.zeros((8, 10), np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        replica.ReplicaDataset("office_test")


def test_write_sequence_reads_back(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (6, 5, 7, 3), dtype=np.uint8)
    depth = rng.integers(0, 65536, (6, 5, 7), dtype=np.uint16)
    poses = rng.normal(size=(6, 4, 4)).astype(np.float32)
    scene = str(tmp_path / "office_x" / "Sequence_1")
    replica.write_sequence(scene, rgb, depth, poses, filters=[i % 5 for i in range(6)])
    for i in range(6):
        np.testing.assert_array_equal(png.read_png(os.path.join(scene, "rgb", f"rgb_{i}.png")), rgb[i])
        np.testing.assert_array_equal(png.read_png(os.path.join(scene, "depth", f"depth_{i}.png")), depth[i])
    ds = replica.ReplicaDataset("office_x", datasets_path=str(tmp_path), train_stride=2, test_offset=1)
    np.testing.assert_array_equal(ds.train.camera_pose, poses[[0, 2, 4]])
    np.testing.assert_array_equal(ds.test.camera_pose, poses[[1, 3, 5]])


# --------------------------------------------------------------------- #
# The Trainer and the CLI on a Replica-layout room walkthrough.
# --------------------------------------------------------------------- #

ROOM_YAML = """
experiment: {image_width: 16, image_height: 12}
training: {learning_rate: 0.005}
model: {net_depth: 4, net_width: 64, chunk: 4096}
rendering: {n_rays: 256, n_samples: 16, n_importance: 16, num_freqs_3d: 6, num_freqs_2d: 2,
            raw_noise_std: 1.0, depth_range: [0.1, 8.0]}
logging: {step_log_print: 1, step_log_tensorboard: 20, step_save_ckpt: 0,
          step_render_test: 0, step_render_train: 0}
"""


@pytest.fixture(scope="module")
def room_replica(tmp_path_factory):
    """The room walkthrough's ground truth as a Replica sequence at 32x24
    (the config asks for 16x12: the loader resizes), frames in the room's
    rendered order, every row filter in use."""
    root = str(tmp_path_factory.mktemp("replica"))
    n = 18  # train ids 0..15, test ids 2..17
    poses = walkthrough_poses(n)
    rgb, depth = render_room_ground_truth(room_scene(), poses, 24, 32, n_samples=64)
    rgb8 = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    depth_mm = np.clip(np.round(depth * 1000), 0, 65535).astype(np.uint16)
    replica.write_sequence(os.path.join(root, "office0", "Sequence_1"), rgb8, depth_mm, poses,
                           filters=[i % 5 for i in range(n)])
    return root


def _losses(out):
    return [float(line.split("Loss: ")[1].split(",")[0]) for line in out.splitlines() if line.startswith("[TRAIN]")]


def test_trainer_without_data_trains_on_the_replica_sequence(room_replica, tmp_path, monkeypatch):
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(replica, "DATASETS_PATH", room_replica)
    cfg_path = tmp_path / "room.yaml"
    cfg_path.write_text(ROOM_YAML)
    cfg = load_config(str(cfg_path), office_name="office_tokyo")
    trainer = Trainer("office_tokyo", cfg, save_dir=str(tmp_path / "run"), enable_tensorboard=False,
                      device="cpu")
    ds = replica.ReplicaDataset("office_tokyo", image_height=12, image_width=16)
    np.testing.assert_array_equal(trainer._train_data.rgb, ds.train.rgb)
    np.testing.assert_array_equal(trainer._test_data.camera_pose, ds.test.camera_pose)
    assert trainer._train_data.rgb.shape == (4, 12, 16, 3)
    trainer.setup()
    losses = [float(trainer.step(i)["total_loss"]) for i in range(40)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_train_cli_without_synthetic_trains_on_the_replica_sequence(room_replica, tmp_path, monkeypatch, capsys):
    from nerf_workspaces_explorer_tpu_torch.cli.train import main

    monkeypatch.setattr(replica, "DATASETS_PATH", room_replica)
    cfg = tmp_path / "room.yaml"
    cfg.write_text(ROOM_YAML)
    main(["--office", "tokyo", "--iterations", "40", "--device", "cpu", "--config", str(cfg),
          "--save-dir", str(tmp_path / "run")])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
