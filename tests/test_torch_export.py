"""The ``ogvt::`` custom ops (``ops/library.py``) and the export surface of
``serving.py`` on the CPU.

- Each op: ``torch.library.opcheck``; its fake output's shape, dtype and
  strides against the plain version's; a one-op module exported, saved and
  loaded, with the op in the graph and the plain version's output bit for
  bit. The wrappers take the op only while traced, also from inside the
  ``autograd.Function.forward`` under ``no_grad`` that the models call.
- Whole tiny models (Model A; Model B with ``fused_outlook`` and depthwise
  mode "t") with the kernel route switched on (on the CPU a wrapper runs its
  plain version eagerly; exported, it is an op node): the program holds one
  op node per launch, and the loaded program's logits are the live model's
  bit for bit.
- ``build_predictor(checkpoint=...)``, the export round trip of the plain
  path against the live predictor (labels equal, probabilities within 1e-6)
  and against the JAX package's predictor with the same weights (1e-5,
  ``tests/test_torch_model.py``'s bar), and the refusals: both weight
  sources at once, a bogus file, a JAX ``OGVT1`` artifact, a checkpoint, a
  card artifact where there is no card; the ``export_model`` CLI with
  ``--selfcheck``.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outgridvit_tpu.models import build_model as jax_build_model
from outgridvit_tpu.serving import build_predictor as jax_build_predictor
from outgridvit_tpu.serving import export_predictor as jax_export_predictor
from outgridvit_tpu_torch import serving
from outgridvit_tpu_torch.models import build_model
from outgridvit_tpu_torch.ops import attn_branch as ab
from outgridvit_tpu_torch.ops import dwconv as dw
from outgridvit_tpu_torch.ops import grid_attention as ga
from outgridvit_tpu_torch.ops import kernel_build, library
from outgridvit_tpu_torch.ops import mlp_branch as mb
from outgridvit_tpu_torch.ops import outlook_agg as oa
from outgridvit_tpu_torch.ops import outlook_softmax as osm
from outgridvit_tpu_torch.training.checkpoints import save_checkpoint
from outgridvit_tpu_torch.training.optim import AdamW
from outgridvit_tpu_torch.training.train_state import TrainState

ROOT = Path(__file__).resolve().parents[1]
TINY = {
    "type": "model_a", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 4},
    ],
}
TINY_B = {
    "type": "model_b", "num_classes": 10, "in_ch": 3, "stem_dim": 8,
    "outlooker_front_depth": 1, "use_pallas": "fused_outlook",
    "stages": [
        {"dim": 16, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
        {"dim": 32, "depth": 1, "num_heads": 2, "grid_size": 4,
         "outlook_heads": 2},
    ],
}
IMG = 16


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _op_case(name, dtype=torch.float32, seed=0):
    """(wrapper, plain version, args) of an op at a small shape."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    C = 16
    ln = ((1 + r(C, scale=0.1)).float(), r(C, scale=0.1).float())
    a = torch.softmax(r(2, 5, 6, 2, 9).float(), -1).reshape(
        2, 5, 6, 18).to(dtype)
    cases = {
        "grid_mhsa": (ga.grid_mhsa, ga.grid_mhsa_reference,
                      (r(6, 4, 3 * C), 2, "t")),
        "grid_mhsa_packed": (ga.grid_mhsa_packed,
                             ga.grid_mhsa_packed_reference,
                             (r(6, 9, 3 * C), 2)),
        "attn_branch": (ab.attn_branch, ab.attn_branch_reference,
                        (r(4, 16, C), *ln, r(C, 3 * C, scale=0.25),
                         r(3 * C), r(C, C, scale=0.25), r(C), 2, 1e-5,
                         True)),
        "attn_branch_nhwc": (ab.attn_branch_nhwc,
                             ab.attn_branch_nhwc_reference,
                             (r(2, 8, 8, C), *ln, r(C, 3 * C, scale=0.25),
                              r(3 * C), r(C, C, scale=0.25), r(C), 2, 2,
                              1e-5, True)),
        "mlp_branch": (mb.mlp_branch, mb.mlp_branch_reference,
                       (r(2, 4, 4, C), *ln, r(C, 2 * C, scale=0.25),
                        r(2 * C), r(2 * C, C, scale=0.2), r(C), "gelu",
                        1e-5, True, "t")),
        "outlook_agg_proj": (oa.outlook_agg_proj,
                             oa.outlook_agg_proj_reference,
                             (r(2, 5, 6, C), a, r(C, C, scale=0.25), r(C))),
        "outlook_branch": (oa.outlook_branch, oa.outlook_branch_reference,
                           (r(2, 5, 6, C), a, r(C, C, scale=0.25), r(C),
                            r(C, C, scale=0.25), r(C))),
        "outlook_softmax_agg": (osm.outlook_softmax_agg,
                                osm.outlook_softmax_agg_reference,
                                (r(2, 5, 6, C), r(2, 5, 6, 18), 2, 3)),
        "dwconv3x3": (dw.dwconv3x3, dw.dwconv3x3_reference,
                      (r(2, 5, 6, C), r(9, C, scale=0.3))),
    }
    return cases[name]


def _plain_args(name, args):
    """The plain version's arguments: the variant is the wrapper's alone."""
    return args[:-1] if name in ("grid_mhsa", "mlp_branch") else args


class OneOp(torch.nn.Module):
    """Calls ``fn(*tensors, *consts)``: the tensors are the exported
    program's inputs."""

    def __init__(self, fn, consts):
        super().__init__()
        self.fn, self.consts = fn, consts

    def forward(self, *tensors):
        return self.fn(*tensors, *self.consts)


def _split(args):
    n = len([a for a in args if isinstance(a, torch.Tensor)])
    assert all(isinstance(a, torch.Tensor) for a in args[:n])
    return args[:n], args[n:]


def _round_trip(program):
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    return torch.export.load(buf)


def _op_nodes(graph):
    return [str(n.target) for n in graph.nodes if n.op == "call_function"
            and str(n.target).startswith("ogvt.")]


def test_library_has_one_op_per_forward_wrapper():
    assert sorted(library.OPS) == sorted([
        "grid_mhsa", "grid_mhsa_packed", "attn_branch", "attn_branch_nhwc",
        "mlp_branch", "outlook_agg_proj", "outlook_branch",
        "outlook_softmax_agg", "dwconv3x3"])
    for name in library.OPS:
        assert hasattr(torch.ops.ogvt, name)


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_opcheck(name):
    _, _, args = _op_case(name)
    torch.library.opcheck(library.OPS[name], args)


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_fake_output_matches_the_plain_version(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    for dtype in (torch.float32, torch.bfloat16):
        _, plain, args = _op_case(name, dtype)
        want = plain(*_plain_args(name, args))
        with FakeTensorMode() as mode:
            fake = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args)
            got = getattr(torch.ops.ogvt, name)(*fake)
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        assert got.stride() == want.contiguous().stride()


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_one_op_export_round_trip_is_bitwise_the_plain_version(name):
    wrapper, plain, args = _op_case(name)
    tensors, consts = _split(args)
    with torch.no_grad():
        program = torch.export.export(OneOp(wrapper, consts), tensors)
    loaded = _round_trip(program)
    assert _op_nodes(loaded.graph) == [f"ogvt.{name}.default"]
    got = loaded.module()(*tensors)
    assert torch.equal(got, plain(*_plain_args(name, args)))
    assert torch.equal(got, wrapper(*args))


def test_wrappers_route_to_the_ops_only_while_traced(monkeypatch):
    """Eager calls never ask for an op (a traced_op that raises is never
    reached); traced, the op also comes from inside an autograd.Function
    forward under no_grad, as the models call the cores."""
    def refuse(name):
        raise AssertionError(f"eager call reached ogvt::{name}")

    monkeypatch.setattr(kernel_build, "traced_op", refuse)
    for name in library.OPS:
        wrapper, _, args = _op_case(name)
        wrapper(*args)
    monkeypatch.undo()

    qkv = _op_case("grid_mhsa")[2][0]

    class Core(torch.nn.Module):
        def forward(self, qkv):
            return ga.grid_mhsa_autograd(qkv, 2, True, "t") * 2

    with torch.no_grad():
        program = torch.export.export(Core(), (qkv,))
    assert _op_nodes(program.graph) == ["ogvt.grid_mhsa.default"]
    assert torch.equal(program.module()(qkv),
                       ga.grid_mhsa_reference(qkv, 2) * 2)


def _kernel_route(model):
    """Switch a CPU model's modules onto the kernel wrappers: eagerly they
    run their plain versions, traced they are ops."""
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = True
    return model


@pytest.mark.parametrize("cfg,dwconv,ops", [
    (TINY, "xla", {"ogvt.grid_mhsa.default": 2,
                   "ogvt.mlp_branch.default": 4}),
    (TINY_B, "t", {"ogvt.grid_mhsa.default": 2,
                   "ogvt.mlp_branch.default": 3,
                   "ogvt.outlook_softmax_agg.default": 1,
                   "ogvt.dwconv3x3.default": 2}),
], ids=["model_a", "model_b_fused_outlook_dw_t"])
def test_whole_model_export_holds_one_op_per_launch(cfg, dwconv, ops):
    model = _kernel_route(build_model(cfg, device="cpu", seed=1,
                                      dwconv=dwconv))
    x = torch.randn(3, IMG, IMG, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
        program = torch.export.export(model, (x,))
    loaded = _round_trip(program)
    nodes = _op_nodes(loaded.graph)
    assert {n: nodes.count(n) for n in set(nodes)} == ops
    with torch.no_grad():
        assert torch.equal(loaded.module()(x), want)


# ---- predictors ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tiny():
    jmodel = jax_build_model(TINY, use_pallas=False)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, dict(init)))
    return variables


def _requests(n=7, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3),
                                                np.uint8)


def test_build_predictor_restores_a_checkpoint(tmp_path, jax_tiny):
    live = serving.build_predictor(TINY, variables=jax_tiny, batch_size=4,
                                   img_size=IMG, dtype=torch.float32,
                                   device="cpu")
    path = tmp_path / "m.ckpt"
    save_checkpoint(str(path), TrainState.create(live.model, AdamW(1e-3)),
                    epoch=1)
    restored = serving.build_predictor(TINY, checkpoint=str(path),
                                       batch_size=4, img_size=IMG,
                                       dtype=torch.float32, device="cpu",
                                       seed=5)
    for (k, a), (k2, b) in zip(live.model.state_dict().items(),
                               restored.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    x = _requests()
    for (la, pa), (lb, pb) in zip([live.predict_many(x)],
                                  [restored.predict_many(x)]):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(pa, pb)
    with pytest.raises(ValueError, match="not both"):
        serving.build_predictor(TINY, variables=jax_tiny,
                                checkpoint=str(path), device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_export_round_trip_of_the_plain_path(tmp_path, jax_tiny, dtype):
    live = serving.build_predictor(TINY, variables=jax_tiny, batch_size=4,
                                   img_size=IMG, dtype=dtype, device="cpu")
    path = tmp_path / "m.ogvt"
    serving.export_predictor(live, str(path))
    header = serving.read_artifact_header(str(path))
    assert header["device"] == "cpu" and header["kernels"] is False
    assert (header["batch_size"], header["img_size"],
            header["num_classes"]) == (4, IMG, 10)
    loaded = serving.load_predictor(str(path))
    assert loaded.model is None and not loaded.kernels
    x = _requests()
    for req in (x[:3], x[0], x):  # ragged, one image, more than a batch
        la, pa = live.predict_many(req)
        lb, pb = loaded.predict_many(req)
        assert lb.dtype == np.int32 and pb.dtype == np.float32
        np.testing.assert_array_equal(lb, la)
        np.testing.assert_allclose(pb, pa, rtol=0, atol=1e-6)
    if dtype == torch.float32:  # the JAX predictor, same weights
        jpred = jax_build_predictor(TINY, variables=jax_tiny, batch_size=4,
                                    img_size=IMG, dtype=jnp.float32,
                                    use_pallas=False)
        want_l, want_p = jpred.predict_many(x)
        got_l, got_p = loaded.predict_many(x)
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_allclose(got_p, want_p, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="live predictor"):
        serving.export_predictor(loaded, str(tmp_path / "again.ogvt"))


def test_load_predictor_refuses_other_files(tmp_path, jax_tiny):
    bogus = tmp_path / "bogus.bin"
    bogus.write_bytes(b"not an artifact at all")
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    jpred = jax_build_predictor(TINY, variables=jax_tiny, batch_size=2,
                                img_size=IMG, use_pallas=False)
    jart = tmp_path / "jax.ogvt"
    jax_export_predictor(jpred, str(jart))
    assert jart.read_bytes()[:5] == b"OGVT1"
    ckpt = tmp_path / "m.ckpt"
    save_checkpoint(str(ckpt), TrainState.create(
        build_model(TINY, device="cpu"), AdamW(1e-3)), epoch=0)
    for path in (bogus, empty, jart, ckpt):
        with pytest.raises(ValueError, match="not an outgridvit_tpu_torch "
                           "predictor artifact"):
            serving.load_predictor(str(path))


def test_card_artifact_is_refused_without_a_card(tmp_path, jax_tiny):
    """An artifact whose header names the card (its weights live there)
    raises where torch sees no CUDA device, naming the device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    live = serving.build_predictor(TINY, variables=jax_tiny, batch_size=2,
                                   img_size=IMG, device="cpu")
    path = tmp_path / "m.ogvt"
    serving.export_predictor(live, str(path))
    raw = path.read_bytes()
    n = len(serving.ARTIFACT_MAGIC)
    (length,) = np.frombuffer(raw[n:n + 8], "<u8")
    header = raw[n + 8:n + 8 + int(length)].replace(
        b'"device": "cpu", "kernels": false',
        b'"device": "cuda", "kernels": true')
    path.write_bytes(raw[:n] + np.uint64(len(header)).tobytes() + header
                     + raw[n + 8 + int(length):])
    with pytest.raises(RuntimeError, match="exported on a CUDA device"):
        serving.load_predictor(str(path))


def test_export_model_cli_selfcheck(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = tmp_path / "m.ogvt"
    res = subprocess.run(
        [sys.executable, "-m", "outgridvit_tpu_torch.export_model",
         "--config", "configs/smoke_synthetic.yaml", "--device", "cpu",
         "--batch-size", "8", "--out", str(out), "--selfcheck"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "selfcheck OK" in res.stdout and "kernels off" in res.stdout
    assert serving.read_artifact_header(str(out))["batch_size"] == 8
