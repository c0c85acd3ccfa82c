"""The port's scalar history without TensorBoard (`obs/tb.py`'s sink, read
back by `obs/export.py`), the long-horizon study
(`scripts/long_horizon_study_torch.py`) and the run collector
(`scripts/collect_long_run_report_torch.py`), on the CPU at a tiny size."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from nerf_workspaces_explorer_tpu_torch.obs import tb
from nerf_workspaces_explorer_tpu_torch.obs.export import (
    PUBLISHED_CHARTS,
    export_training_curves,
    scalars_from_tensorboard_logs,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A config for runs of seconds: 2x32 nets, 64 rays of 8 + 8 samples, scalars
# every 2 steps and eval renders at step 4.
TINY_CONFIG = """\
experiment: {image_width: 16, image_height: 12}
training: {n_iterations: 8, learning_rate: 5e-3, learning_rate_decay_rate: 0.1, learning_rate_decay_steps: 50000}
model: {net_depth: 2, net_width: 32, net_depth_fine: 2, net_width_fine: 32, chunk: 4096, net_chunk: 65536}
rendering: {n_rays: 64, n_samples: 8, n_importance: 8, perturb: 1, use_view_dirs: True, num_freqs_3d: 10,
            num_freqs_2d: 4, raw_noise_std: 1, test_viz_factor: 1, depth_range: [0.1, 6.0],
            white_background: False}
logging: {step_log_print: 0, step_log_tensorboard: 2, step_save_ckpt: 0, step_render_test: 4,
          step_render_train: 4}
inference: {chunk: 4096}
"""


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name[:-3]}", os.path.join(ROOT, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _history():
    rng = np.random.default_rng(0)
    return {tag: [(s, float(v)) for s, v in zip(range(0, 40, 10), rng.normal(size=4))]
            for tag in PUBLISHED_CHARTS.values()}


def test_null_sink_history_reads_back_equal(tmp_path):
    """The sink's history file, written on flush and on close, reads back
    equal (steps and float values exactly) to its in-memory history."""
    log_dir = str(tmp_path / "tensorboard_logs")
    writer = tb._NullSummaryWriter(log_dir)
    assert scalars_from_tensorboard_logs(log_dir) == {}
    for tag, series in _history().items():
        for step, value in series[:2]:
            writer.add_scalar(tag, np.float32(value), step)
    writer.flush()
    assert scalars_from_tensorboard_logs(log_dir) == writer.scalars
    for tag, series in _history().items():
        for step, value in series[2:]:
            writer.add_scalar(tag, value, step)
    writer.close()
    got = scalars_from_tensorboard_logs(log_dir)
    assert got == writer.scalars and all(len(v) == 4 for v in got.values())
    assert os.listdir(log_dir) == [tb.SCALARS_FILE]
    tb._NullSummaryWriter().flush()  # no directory: memory only


def test_trainer_without_tensorboard_leaves_its_scalars(tmp_path, monkeypatch):
    """With no SummaryWriter backend, a Trainer's export still draws the
    curves from memory and leaves the history on disk for later readers."""
    from nerf_workspaces_explorer_tpu_torch.core.config import load_config
    from nerf_workspaces_explorer_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_workspaces_explorer_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(tb, "_make_summary_writer", lambda log_dir: tb._NullSummaryWriter(log_dir))
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_CONFIG)
    train, test, _ = make_synthetic_scene(n_train=4, n_test=1, height=12, width=16, device="cpu")
    trainer = Trainer("office_tokyo", load_config(str(path)), train_data=train, test_data=test,
                      save_dir=str(tmp_path / "run"), device="cpu")
    trainer.setup()
    trainer.fit(5)
    written = trainer.export_results()
    assert len(written) == len(PUBLISHED_CHARTS)
    history = trainer._tb.summary_writer.scalars
    assert history["Test/Metric/batch_PSNR"][-1][0] == 4
    assert scalars_from_tensorboard_logs(str(tmp_path / "run" / "tensorboard_logs")) == history


def _run_dir(path, sink: str):
    """A finished run's directory: the nine curves and the scalar history,
    as the scalar sink's file or as TensorBoard event files."""
    history = _history()
    export_training_curves(history, str(path / "results"))
    log_dir = str(path / "tensorboard_logs")
    if sink == "null":
        writer = tb._NullSummaryWriter(log_dir)
    else:
        pytest.importorskip("tensorboard")
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(log_dir=log_dir)
    for tag, series in history.items():
        for step, value in series:
            writer.add_scalar(tag, value, step)
    writer.close()
    return history


def test_collect_report_reads_either_history(tmp_path):
    """The collector's report from a run of the scalar sink and from one of
    event files: the same curves and, to the printed digits, the same table."""
    collect = _load("collect_long_run_report_torch.py")
    reports = {}
    for sink in ("null", "events"):
        history = _run_dir(tmp_path / sink, sink)
        out = tmp_path / f"reports_{sink}"
        assert collect.main([str(tmp_path / sink), "--label", "tiny", "--reports", str(out),
                             "--notes", "a tiny run"]) == 0
        assert sorted(os.listdir(out / "curves_tiny")) == sorted(f"{c}.svg" for c in PUBLISHED_CHARTS)
        reports[sink] = (out / "long_horizon_tiny.md").read_text()
        got = scalars_from_tensorboard_logs(str(tmp_path / sink / "tensorboard_logs"))
        for tag, series in history.items():  # event files keep float32
            assert [s for s, _ in got[tag]] == [s for s, _ in series]
            np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in series], rtol=1e-6)
    assert reports["null"] == reports["events"]
    text = reports["null"]
    assert text.startswith("# Long-horizon run: tiny\n\na tiny run\n")
    test_psnr = _history()["Test/Metric/batch_PSNR"]
    assert f"| test batch PSNR | {test_psnr[-1][1]:.2f} |" in text
    assert f"{test_psnr[-1][0]:>8d}  {test_psnr[-1][1]:.2f}" in text


def test_long_horizon_study_on_cpu(tmp_path, monkeypatch, capsys):
    """The three modes end to end through the train CLI, on a machine
    without `tensorboard` (a stand-in package that fails to import, as on
    the card's machine): every run copies its nine curves, the table holds
    each run's last scalars, and a drift gate of -1 dB fails the study."""
    shim = tmp_path / "shim" / "tensorboard"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text("raise ImportError('tensorboard is not installed')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path / "shim"))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    config = tmp_path / "tiny.yaml"
    config.write_text(TINY_CONFIG)
    study = _load("long_horizon_study_torch.py")
    reports, base = tmp_path / "reports", tmp_path / "base"
    code = study.main(["--steps", "8", "--size", "16", "--config", str(config), "--device", "cpu",
                       "--base", str(base), "--reports", str(reports), "--max-bf16-drift-db", "-1"])
    out = capsys.readouterr().out
    assert code == 1 and "LONG-HORIZON GATE FAILED" in out
    text = (reports / "long_horizon_torch_0k.md").read_text()
    assert "bf16-gradient drift (fused - plain test PSNR)" in text and "(|gate| -1.0)" in text
    rows = {}
    for mode in ("plain", "fused", "proposal"):
        assert os.path.exists(base / mode / "tensorboard_logs" / tb.SCALARS_FILE)
        assert not [f for f in os.listdir(base / mode / "tensorboard_logs") if f.startswith("events")]
        assert len(os.listdir(reports / "curves_torch_0k" / mode)) == len(PUBLISHED_CHARTS)
        scalars = scalars_from_tensorboard_logs(str(base / mode / "tensorboard_logs"))
        test_psnr = scalars["Test/Metric/batch_PSNR"]
        assert [s for s, _ in test_psnr] == [4]
        rows[mode] = (f"| {mode} | {scalars['Train/Loss/total_loss'][-1][1]:.5f} "
                      f"| {scalars['Train/Metric/psnr_fine'][-1][1]:.2f} | {test_psnr[-1][1]:.2f} |")
        assert rows[mode] in text
        assert os.path.exists(base / mode / "checkpoints" / "000008.npz")  # --save-final
    # The fused field's bf16 products move the eight steps' outcome only a little.
    assert abs(float(rows["fused"].split("|")[4]) - float(rows["plain"].split("|")[4])) < 0.5
    assert study.main(["--steps", "8", "--size", "16", "--config", str(config), "--device", "cpu",
                       "--base", str(base), "--reports", str(reports), "--modes", "plain"]) == 0
