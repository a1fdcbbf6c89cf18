"""Port parity, data × model parallelism: ``train_model`` and the steps of
``outgridvit_tpu_torch`` on meshes of 2 and 4 gloo ranks (spawned CPU
processes, ``tests/torch_parallel_worker.py``) against one rank.

The twin of ``tests/test_distributed.py`` and ``tests/test_sharding.py``:
the full recipe (uint8 in with the device augmentation, mixup / cutmix,
drop-path, a val split) for 2 epochs on mesh (2, 1), (1, 2), (4, 1) and
(2, 2) matches the single rank's run in this process (losses at
``rtol=2e-4``, as the JAX tests hold them; the parameter checksum at
``rtol=2e-4``; val top-1 at 1e-6); only rank 0 logs and writes the
checkpoint; the tensor-parallel leaves hold their block and their moments
with them; a 2-rank resume is bitwise the uninterrupted 2-rank run; the
eval superstep epoch on the mesh equals the per-batch one; the mesh
predictor returns the single one's labels and probabilities; dropout under
2 ranks draws the single rank's masks; the (2, 2) superstep at K = 2 is
bitwise two single steps.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
sys.path.insert(0, str(WORKER.parent))

import torch_parallel_worker as W  # noqa: E402

RTOL = 2e-4  # tests/test_distributed.py's bar on histories and checksums


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(world: int, outdir: Path, scenario: str):
    """Spawn a gloo world of the worker; ``(stdouts, results by rank)``."""
    port = _free_port()
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    for k in ("OUTGRIDVIT_COORDINATOR", "OUTGRIDVIT_NUM_PROCESSES",
              "OUTGRIDVIT_PROCESS_ID", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(port),
         str(outdir), scenario], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs, [torch.load(outdir / f"{scenario}_r{r}.pt",
                             weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single rank's run, in this process (no process group)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.summary(*W.run_train_model(tmp_path_factory.mktemp("one")))
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, tmp_path_factory.mktemp("w2"), "world2")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(4, tmp_path_factory.mktemp("w4"), "world4")


def _assert_run_matches(run, ref):
    assert run["step"] == ref["step"] == 8  # 2 epochs x 4 global batches
    h, r = run["history"], ref["history"]
    for k in ("train_loss", "val_loss", "train_grad_norm"):
        np.testing.assert_allclose(h[k], r[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(h["val_top1"], r["val_top1"], atol=1e-6)
    np.testing.assert_allclose(run["checksum"], ref["checksum"], rtol=RTOL)
    assert set(run["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        assert run["state"][k].shape == v.shape, k


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_two_rank_train_model_matches_one_rank(world2, single, mesh):
    """Mesh (2, 1) (data) and (1, 2) (model) against one rank; every rank
    ends with the same whole state."""
    _, res = world2
    _assert_run_matches(res[0][mesh], single)
    for k, v in res[0][mesh]["state"].items():
        assert torch.equal(res[1][mesh]["state"][k], v), k


@pytest.mark.parametrize("mesh", ["dp", "dptp"])
def test_four_rank_train_model_matches_one_rank(world4, single, mesh):
    """Mesh (4, 1) and (2, 2) against one rank; rank 0 logs alone."""
    outs, res = world4
    _assert_run_matches(res[0][mesh], single)
    assert "=== Run config ===" in outs[0] and "[Train]" in outs[0]
    assert "mesh={'data': 2, 'model': 2}" in outs[0]
    for out in outs[1:]:
        assert "[Train]" not in out and "=== Run config ===" not in out


def test_only_rank_zero_logs_and_writes(world2):
    outs, res = world2
    assert "=== Run config ===" in outs[0] and "[Train]" in outs[0]
    assert "batch_size=16 (2 data ranks x 8 local)" in outs[0]
    assert "[Train]" not in outs[1] and "=== Run config ===" not in outs[1]
    assert res[0]["dp_ckpt"] == ["best.ckpt", "last.ckpt"]
    assert res[1]["dp_ckpt"] == []


def test_tensor_parallel_leaves_hold_their_block(world2):
    """On (1, 2) the sharded leaves (the MLPs' fc1 / fc2, qkv, the
    attention projections, the MBConv's expand / project, the classifier)
    hold half their rows on the port's dim, the AdamW moments with them;
    the whole state gathers back to the single rank's shapes."""
    _, res = world2
    blocks = res[0]["tp_blocks"]
    assert {"classifier.weight", "classifier.bias",
            "stages.0.0.mlp.fc1.weight", "stages.0.0.mlp.fc2.weight",
            "stages.0.0.grid_attn.mhsa.qkv.weight",
            "stages.0.0.grid_attn.mhsa.proj.weight",
            "stages.0.0.mbconv.expand.0.weight",
            "stages.0.0.mbconv.project.0.weight"} <= set(blocks)
    for name, (shape, mu, nu, dim) in blocks.items():
        whole = res[0]["tp_whole"][name]
        assert mu == nu == shape, name
        assert shape[dim] * 2 == whole[dim], name
        assert all(a == b for i, (a, b) in enumerate(zip(shape, whole))
                   if i != dim), name
    # Dense kernels [out, in]: fc1 splits its out rows, fc2 its in columns
    assert blocks["stages.0.0.mlp.fc1.weight"][3] == 0
    assert blocks["stages.0.0.mlp.fc2.weight"][3] == 1
    assert "stages.0.0.mlp.fc1" in res[0]["tp_gathered"]
    assert res[0]["tp_blocks"] == res[1]["tp_blocks"]


def test_two_rank_resume_matches_uninterrupted(world2):
    """Epoch 1 on (2, 1), the run stopped at epoch 2, then a fresh run
    resumed from rank 0's checkpoint: bitwise the uninterrupted run."""
    _, res = world2
    for r in res:
        got, full = r["resumed"], r["dp"]
        assert got["step"] == full["step"] == 8
        assert got["history"]["train_loss"] == full["history"][
            "train_loss"][1:]
        assert got["history"]["val_loss"] == full["history"]["val_loss"][1:]
        for k, v in full["state"].items():
            assert torch.equal(got["state"][k], v), k


def test_eval_superstep_epoch_on_mesh_equals_per_batch(world2):
    _, res = world2
    for r in res:
        assert r["eval_super"] == r["eval_batch"]
    assert res[0]["eval_batch"] == res[1]["eval_batch"]


def test_mesh_predictor_returns_the_single_predictor(world2):
    _, res = world2
    for r in res:
        (lab1, prob1), (lab2, prob2) = r["predict_single"], r["predict_mesh"]
        np.testing.assert_array_equal(lab2, lab1)
        np.testing.assert_allclose(prob2, prob1, rtol=0, atol=1e-6)
        assert lab2.shape == (12,) and prob2.shape == (12, 10)
        assert "must divide over the data axis" in r["predict_refused"]


def test_dropout_under_two_ranks_draws_the_single_rank_masks(world2):
    """Two steps with every dropout rate on and mixing, on (2, 1), against
    the single device's steps on the whole batch: each step's metrics, the
    BN statistics and the AdamW moments within 1e-5, the parameters within
    the trajectory bar of ``test_torch_train.py`` (2e-3: Adam's first steps
    move a parameter by about lr wherever its gradient is near zero). A
    mask of other rows moves the loss by far more."""
    _, res = world2
    for r in res:
        (m1, s1), (m2, s2) = r["drop_single"], r["drop_mesh"]
        for a, b in zip(m1, m2):
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5,
                                           err_msg=k)
        for k, v in s1.items():
            atol = 2e-3 if k.startswith("model.") and "running" not in k \
                else 1e-5
            np.testing.assert_allclose(s2[k].numpy(), v.numpy(), rtol=0,
                                       atol=atol, err_msg=k)


def test_dptp_superstep_is_bitwise_two_single_steps(world4):
    _, res = world4
    for r in res:
        a, b = r["superstep"]["steps"], r["superstep"]["super"]
        for k, v in a.items():
            assert torch.equal(b[k], v), k
