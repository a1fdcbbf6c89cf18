"""The port's training CLI as a user runs it, after ``tests/test_cli.py``:
``python -m outgridvit_tpu_torch.train`` in a subprocess on the CPU
(``--device cpu`` or ``runtime.device: cpu``): exit codes, the JAX CLI's
log-line formats, checkpoints, the history pickle and a resume; the CIFAR
pickle fixture end to end; the refusal of a CUDA device without a card;
``--mesh`` and a 2-process ``--dist-*`` run."""

import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]

# the log-line shapes of scripts/train.py (tests/test_cli.py)
TRAIN_LINE = re.compile(
    r"\[Train\] loss (\d+\.\d+) \| top1 (\d+\.\d+)% \| top3 (\d+\.\d+)% "
    r"\| top5 (\d+\.\d+)%")
VAL_LINE = re.compile(r"\[Val\]\s+loss (\d+\.\d+) \| top1 (\d+\.\d+)%")
STEP_LINE = re.compile(r"\[train step \d+/\d+\] loss \d+\.\d+ .* "
                       r"(\d+\.\d) img/s \| lr ")


def _run(args, expect=0, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # a tiny model; spare the other workers
    proc = subprocess.run(
        [sys.executable, "-m", "outgridvit_tpu_torch.train", *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)
    ok = proc.returncode == 0 if expect == 0 else proc.returncode != 0
    assert ok, (f"exit {proc.returncode}\n--- stdout ---\n"
                f"{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    return proc


def test_cli_synthetic_smoke_history_and_resume(tmp_path):
    hist = tmp_path / "h.pkl"
    out = _run(["--config", str(ROOT / "configs" / "smoke_synthetic.yaml"),
                "--output-dir", str(tmp_path),
                "--history-out", str(hist)]).stdout
    m = TRAIN_LINE.search(out)
    assert m, out[-2000:]
    assert 0.0 <= float(m.group(2)) <= 100.0
    assert STEP_LINE.search(out), out[-2000:]
    assert "=== Epoch 1/1 ===" in out and "device=cpux1" in out
    ckpt = tmp_path / "last_smoke.ckpt"
    assert ckpt.exists() and ckpt.read_bytes()[:4] == b"OGVT"
    with open(hist, "rb") as f:
        history = pickle.load(f)
    assert len(history["train_loss"]) == 1 and len(history) == 18

    out2 = _run(["--config", str(ROOT / "configs" / "smoke_synthetic.yaml"),
                 "--output-dir", str(tmp_path), "--resume", str(ckpt),
                 "--epochs", "2"]).stdout
    assert re.search(r"Resumed from .*last_smoke\.ckpt at epoch 1", out2)
    assert "=== Epoch 2/2 ===" in out2 and "=== Epoch 1/2 ===" not in out2
    assert TRAIN_LINE.search(out2), out2[-2000:]


def _write_cifar_fixture(data_dir: Path, n_train=256, n_test=64, classes=10,
                         seed=0):
    base = data_dir / "cifar-100-python"
    base.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        payload = {b"data": rng.integers(0, 255, (n, 3072), dtype=np.uint8),
                   b"fine_labels": (np.arange(n) % classes).tolist()}
        with open(base / split, "wb") as f:
            pickle.dump(payload, f)


@pytest.fixture
def cifar_cli_config(tmp_path):
    data_dir = tmp_path / "data"
    _write_cifar_fixture(data_dir)
    cfg = {
        "model": {
            "type": "model_a", "num_classes": 10, "in_ch": 3,
            "stem_dim": 16, "dpr_max": 0.1,
            "stages": [
                {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
                 "outlook_heads": 2},
                {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 2,
                 "outlook_heads": 2},
            ],
        },
        "training": {
            "epochs": 1, "lr": 5e-4, "weight_decay": 0.05,
            "use_amp": False, "autocast_dtype": "fp32",
            "label_smoothing": 0.1, "mixup_alpha": 0.2,
            "cutmix_alpha": 1.0, "mix_prob": 0.5, "print_every": 4,
            "save_path": "best.ckpt", "last_path": "last.ckpt",
            "early_stop": False,
        },
        "data": {
            "dataset": "cifar100", "data_dir": str(data_dir),
            "batch_size": 32, "img_size": 32, "val_split": 0.25,
            "num_workers": 2,
        },
        "runtime": {"device": "cpu", "seed": 7,
                    "output_dir": str(tmp_path / "out")},
    }
    path = tmp_path / "cifar_fixture.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, tmp_path / "out"


@pytest.mark.parametrize("flags", [[], ["--device-augment", "on",
                                        "--steps-per-dispatch", "2"]],
                         ids=["host_augment", "device_augment_k2"])
def test_cli_cifar_pickles_and_resume(cifar_cli_config, flags):
    """CIFAR pickles -> loader -> augmentation (host, or in the step) ->
    val split -> train -> checkpoints, then a resume from last.ckpt."""
    cfg_path, out_dir = cifar_cli_config
    out = _run(["--config", str(cfg_path), *flags]).stdout
    assert TRAIN_LINE.search(out) and VAL_LINE.search(out), out[-2000:]
    assert (out_dir / "last.ckpt").exists()
    assert (out_dir / "best.ckpt").exists()  # val split -> best tracking
    assert ("device_augment=on" in out) == bool(flags)
    out2 = _run(["--config", str(cfg_path), *flags,
                 "--resume", str(out_dir / "last.ckpt"),
                 "--epochs", "2"]).stdout
    assert re.search(r"Resumed from .*last\.ckpt at epoch 1", out2), \
        out2[-2000:]
    assert "=== Epoch 2/2 ===" in out2 and "=== Epoch 1/2 ===" not in out2
    assert VAL_LINE.search(out2)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_cli_cuda_without_a_card_exits_nonzero(tmp_path):
    proc = _run(["--config", str(ROOT / "configs" / "smoke_synthetic.yaml"),
                 "--device", "cuda", "--output-dir", str(tmp_path)],
                expect=1)
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert "=== Epoch" not in proc.stdout
    assert not (tmp_path / "last_smoke.ckpt").exists()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flag", [["--mesh", "1,1"],
                                  ["--dist-num-processes", "2"]])
def test_cli_refuses_parallel_flags(tmp_path, flag):
    """The parallel flags, refused until data × model parallelism was
    ported, now train: ``--mesh 1,1`` in one process, and a 2-process
    ``--dist-*`` run (gloo on the CPU, mesh (2, 1) by default) in which
    rank 0 alone logs and writes its one checkpoint."""
    args = ["--config", str(ROOT / "configs" / "smoke_synthetic.yaml"),
            "--output-dir", str(tmp_path), *flag]
    if "--mesh" in flag:
        out = _run(args).stdout
        assert "mesh={'data': 1, 'model': 1}" in out
        assert TRAIN_LINE.search(out), out[-2000:]
        assert (tmp_path / "last_smoke.ckpt").exists()
        return
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "outgridvit_tpu_torch.train", *args,
         "--dist-coordinator", f"localhost:{port}", "--dist-process-id",
         str(r)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}\n{err[-3000:]}"
    assert "mesh={'data': 2, 'model': 1}" in outs[0][0]
    assert "batch_size=16 (2 data ranks x 8 local)" in outs[0][0]
    assert TRAIN_LINE.search(outs[0][0]), outs[0][0][-2000:]
    assert "[Train]" not in outs[1][0] and "Training complete" not in \
        outs[1][0]
    # the smoke config has no val split: one "last" checkpoint, rank 0's
    assert sorted(p.name for p in tmp_path.iterdir()) == ["last_smoke.ckpt"]


def test_cli_main_in_process(tmp_path, capsys):
    from outgridvit_tpu_torch.train import main

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the subprocesses: spare the other workers
    try:
        assert main(["--config",
                     str(ROOT / "configs" / "smoke_synthetic.yaml"),
                     "--output-dir", str(tmp_path), "--epochs", "1",
                     "--seed", "3"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert TRAIN_LINE.search(out) and (tmp_path / "last_smoke.ckpt").exists()
