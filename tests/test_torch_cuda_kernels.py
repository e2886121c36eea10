"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here launches a kernel, so it takes the ``cuda`` marker and skips
where there is no NVIDIA GPU. The module imports nothing of JAX, so it also
runs on a machine that has only PyTorch for CUDA, without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from speechflow_torch.ops import anti_alias as AA
from speechflow_torch.ops import attention as A

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    """The GPU, with TF32 off so that f32 comparisons stay f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(2, 100, 3, 128), (1, 257, 2, 64), (2, 64, 1, 40)])
def test_attention_kernel_matches_plain(cuda_device, rng, dtype, tol, shape):
    """bf16 tolerance: the kernel and the plain version both sum in f32 and
    round once; |out| <= ~4 here, one bf16 ulp there is 1.6e-2."""
    b, t_len = shape[:2]
    q, k, v = (_normal(rng, *shape).to(cuda_device, dtype) for _ in range(3))
    lens = torch.tensor([t_len, max(1, t_len // 3)][:b], device=cuda_device)
    valid = torch.arange(t_len, device=cuda_device)[None] < lens[:, None]
    before = A.fused_attention.launches
    out = A.fused_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert A.fused_attention.launches == before + 1
    ref = A.attention_reference(q, k, v, valid)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("taps", [8, 12])
@pytest.mark.parametrize("shape", [(2, 300, 24), (1, 1000, 70)])
def test_anti_alias_kernels_match_plain(cuda_device, rng, dtype, tol, taps, shape):
    """bf16 tolerance: both sides compute in f32 and round once (the split
    path also rounds the phases); |out| <= ~8, one bf16 ulp there is 3.2e-2."""
    c = shape[-1]
    x = _normal(rng, *shape).to(cuda_device, dtype)
    a = (0.3 * _normal(rng, c)).to(cuda_device)
    b = (0.3 * _normal(rng, c)).to(cuda_device)
    fused = AA.anti_alias_snake(x, a, b, taps)
    ye, yo = AA.aa_upsample_fir(x, taps)
    split = AA.aa_snake_downsample(ye, yo, a, b, taps)
    torch.cuda.synchronize()
    pe, po = AA.aa_upsample_fir_reference(x, taps)
    assert (ye.float() - pe.float()).abs().max().item() <= tol
    assert (yo.float() - po.float()).abs().max().item() <= tol
    ref = AA.anti_alias_snake_reference(x, a, b, taps)
    assert (fused.float() - ref.float()).abs().max().item() <= tol
    ref_split = AA.aa_snake_downsample_reference(pe, po, a, b, taps)
    assert (split.float() - ref_split.float()).abs().max().item() <= tol
