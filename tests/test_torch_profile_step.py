"""``profile_step.py``'s attribution of device kernels: each kernel of
``csrc/`` to the source that defines it, by the function its demangled
symbol names, and PyTorch's kernels to their kind."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import profile_step  # noqa: E402


def test_port_kernels_names_every_mlp_kernel_source():
    port = profile_step.port_kernels()
    assert port["mlp_branch_fwd"] == "csrc/mlp_branch.cu"
    assert port["mlp_fwd_kernel"] == "csrc/mlp_branch_mma.cu"
    assert port["tokens_kernel"] == port["weights_kernel"] == \
        "csrc/mlp_branch_bwd_mma.cu"
    assert port["mlp_bwd_tokens"] == "csrc/mlp_branch_bwd.cu"
    assert port["reduce_partials"] == "csrc/partials.cuh"


def test_port_kernels_names_every_attention_branch_kernel_source():
    port = profile_step.port_kernels()
    assert port["attn_bwd_tokens"] == port["attn_bwd_weights"] == \
        "csrc/attn_branch_bwd_mma.cu"
    assert port["attn_branch_fwd_mma"] == "csrc/attn_branch_mma.cu"
    assert port["attn_branch_fwd"] == port["attn_branch_bwd"] == \
        "csrc/attn_branch.cu"


def test_port_kernels_names_every_grid_core_kernel_source():
    port = profile_step.port_kernels()
    # #1 and #3 in bf16 (the tensor-core kernel), and in fp32
    assert port["th_fwd"] == port["th_bwd"] == "csrc/grid_mhsa_th.cu"
    assert port["grid_mhsa_fwd"] == port["grid_mhsa_bwd"] == \
        "csrc/grid_mhsa.cu"


def test_port_kernels_names_every_outlook_value_path_kernel_source():
    port = profile_step.port_kernels()
    # #7 / #8: the bf16 backward's tensor-core kernel, and the FMA kernels
    assert port["outlook_bwd_mma"] == "csrc/outlook_agg_bwd_mma.cu"
    assert port["outlook_fwd"] == port["outlook_bwd_proj"] == \
        port["outlook_bwd_dv"] == "csrc/outlook_agg.cu"


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::weights_kernel<0, 4>(__nv_bfloat16 "
     "const*, float const*)", "csrc/mlp_branch_bwd_mma.cu"),
    ("void ogvt::reduce_partials<float>(float const*, int)",
     "csrc/partials.cuh"),
    ("void (anonymous namespace)::th_fwd<4, true>(__nv_bfloat16 const*, "
     "__nv_bfloat16*, int, int, float, (anonymous namespace)::Mask)",
     "csrc/grid_mhsa_th.cu"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl_nocast<at::native::(anonymous namespace)::where_kernel_impl("
     "at::TensorIteratorBase&)>", "elementwise"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float>>",
     "reduction"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "gemm")])
def test_group_attributes_a_kernel(name, want):
    assert profile_step.group(name, profile_step.port_kernels()) == want
