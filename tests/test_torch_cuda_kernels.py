"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here launches a kernel, so it takes the ``cuda`` marker and skips
where there is no NVIDIA GPU. The module imports nothing of JAX, so it also
runs on a machine that has only PyTorch for CUDA, without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import copy

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


def _check_attention(device, rng, dtype, tol, shape, valid):
    q, k, v = (_normal(rng, *shape).to(device, dtype) for _ in range(3))
    out = A.fused_attention(q, k, v, valid)
    torch.cuda.synchronize()
    ref = A.attention_reference(q, k, v, valid)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("t_len", [1, 127, 128, 129, 1000])
@pytest.mark.parametrize("dh", [40, 64, 128])
def test_attention_kernel_lengths_and_head_dims(cuda_device, rng, dtype, tol, t_len, dh):
    """T below, at and past one 128-row tile, and ragged; the bf16 kernel pads dh 40
    and 64 < dh < 128 with zeros through TMA; the second row has length 1."""
    valid = torch.arange(t_len, device=cuda_device)[None] < torch.tensor(
        [t_len, 1], device=cuda_device)[:, None]
    _check_attention(cuda_device, rng, dtype, tol, (2, t_len, 2, dh), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("holes", [[(256, 384)], [(0, 128)], [(0, 128), (512, 700)]],
                         ids=["middle-tile", "first-tile", "first-and-ragged"])
def test_attention_kernel_masks_with_holes(cuda_device, rng, dtype, tol, holes):
    """Whole padded key tiles (skipped by both kernels) in the middle and first,
    and a hole that is not tile-aligned; row 1 has length 1."""
    t_len = 1000
    valid = torch.ones(2, t_len, dtype=torch.bool, device=cuda_device)
    for start, stop in holes:
        valid[0, start:stop] = False
    valid[1, 1:] = False
    _check_attention(cuda_device, rng, dtype, tol, (2, t_len, 3, 128), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(1, 1, 4, 256), (8, 17, 4, 256), (1, 112, 4, 256),
                                   (8, 128, 4, 256), (2, 70, 3, 136), (2, 129, 2, 200)])
def test_attention_kernel_head_dims_above_128(cuda_device, rng, dtype, tol, shape):
    """128 < dh <= 256 (the XTTS prompt encoder: 4 heads of 256) through the
    TF32 kernel, ragged: row 1 holds a third of T, row 0 all of it."""
    b, t_len = shape[:2]
    lens = torch.tensor([t_len] + [max(1, t_len // 3)] * (b - 1), device=cuda_device)
    valid = torch.arange(t_len, device=cuda_device)[None] < lens[:, None]
    before = A.fused_attention.launches
    _check_attention(cuda_device, rng, dtype, tol, shape, valid)
    assert A.fused_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)])
def test_attention_kernel_skips_padded_tiles_exactly(cuda_device, rng, dtype, tol):
    """At the CFM's T and width, with whole padded key tiles and query tiles (a hole of
    128 rows, a sentence of 297 frames in 1024, a row of length 1): with the K/V rows of
    every padded key replaced by 1e4-scale noise, every valid row comes out bit for
    bit as before (a padded key tile is skipped; a partly padded one gets weight 0
    exactly), within the tolerance of the plain version, and padded rows are zero."""
    b, t_len, h, dh = 3, 1024, 6, 128
    valid = torch.arange(t_len)[None] < torch.tensor([1024, 297, 1])[:, None]
    valid[0, 128:256] = False
    q, k, v = (_normal(rng, b, t_len, h, dh) for _ in range(3))
    pad = ~valid
    noisy_k, noisy_v = k.clone(), v.clone()
    noisy_k[pad] = 1e4 * _normal(rng, int(pad.sum()), h, dh)
    noisy_v[pad] = 1e4 * _normal(rng, int(pad.sum()), h, dh)
    valid = valid.to(cuda_device)
    q, k, v, noisy_k, noisy_v = (x.to(cuda_device, dtype) for x in (q, k, v, noisy_k, noisy_v))
    out = A.fused_attention(q, k, v, valid)
    out_noisy = A.fused_attention(q, noisy_k, noisy_v, valid)
    torch.cuda.synchronize()
    keep = valid.cpu()
    assert torch.equal(out_noisy.cpu()[keep], out.cpu()[keep])
    assert out_noisy.cpu()[~keep].abs().max().item() == 0.0
    ref = A.attention_reference(q, k, v, valid)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 33, 3, 1), (2, 77, 3, 5), (2, 129, 3, 40),
                                   (2, 100, 5, 17)])
@pytest.mark.parametrize("offset", [0, 1])
def test_attention_kernel_f32_rows_not_16_byte_aligned(cuda_device, rng, shape, offset):
    """f32 takes any dh and H: rows of dh 1, 5, 17 or 40 at odd H are not 16-byte
    strided, and ``offset`` 1 starts q/k/v one float past a 16-byte boundary, so the
    kernel copies 4 bytes at a time."""
    b, t_len = shape[:2]
    n = int(np.prod(shape))
    flat = [_normal(rng, n + offset).to(cuda_device) for _ in range(3)]
    q, k, v = (x[offset:].view(shape) for x in flat)
    valid = torch.arange(t_len, device=cuda_device)[None] < torch.tensor(
        [t_len, max(1, t_len // 3)], device=cuda_device)[:, None]
    out = A.fused_attention(q, k, v, valid)
    torch.cuda.synchronize()
    ref = A.attention_reference(q, k, v, valid)
    assert (out - ref).abs().max().item() <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("t_len", [1, 17, 112, 1000])
@pytest.mark.parametrize("dh", [136, 200, 256])
def test_attention_kernel_wide_heads_at_lengths(cuda_device, rng, dtype, tol, t_len, dh):
    """128 < dh <= 256 in both types (the TF32 kernel), from one key to past 30 key
    tiles, ragged (row 1 holds a third of T), at 3 heads."""
    valid = torch.arange(t_len, device=cuda_device)[None] < torch.tensor(
        [t_len, max(1, t_len // 3)], device=cuda_device)[:, None]
    _check_attention(cuda_device, rng, dtype, tol, (2, t_len, 3, dh), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,dh", [(torch.float32, 5e-5, 128), (torch.bfloat16, 1.6e-2, 128),
                                          (torch.float32, 5e-5, 256)])
def test_attention_kernel_reads_the_strided_mask(cuda_device, rng, dtype, tol, dh):
    """The key validity as the blocks pass it, ``mask[:, 0, 0, :]`` of their 4-D bool
    mask (row stride T * T), read in place by both kernels: the same output as the
    contiguous vector, and within the tolerance of the plain version."""
    b, t_len, h = 3, 200, 2
    valid = torch.arange(t_len, device=cuda_device)[None] < torch.tensor(
        [200, 77, 1], device=cuda_device)[:, None]
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    q, k, v = (_normal(rng, b, t_len, h, dh).to(cuda_device, dtype) for _ in range(3))
    out = A.flash_attention_fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, A.fused_attention(q, k, v, valid))
    ref = A.attention_reference(q, k, v, valid)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 128), (torch.bfloat16, 128),
                                      (torch.float32, 256), (torch.bfloat16, 256)])
def test_fused_attention_launches_one_device_kernel(cuda_device, rng, dtype, dh):
    """A call, with the validity as a bool vector or as the strided view of the
    blocks' mask, runs exactly one device kernel (no cast or copy of the validity),
    and after the first call no shared-memory attribute is set again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, t_len, h = 2, 160, 3
    valid = torch.arange(t_len, device=cuda_device)[None] < torch.tensor(
        [160, 50], device=cuda_device)[:, None]
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    q, k, v = (_normal(rng, b, t_len, h, dh).to(cuda_device, dtype) for _ in range(3))
    for vv in (valid, mask[:, 0, 0, :]):
        A.fused_attention(q, k, v, vv)  # the library is loaded, attributes granted
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            A.fused_attention(q, k, v, vv)
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 1 and "attn_fwd" in kernels[0], kernels
        assert not any("FuncSetAttribute" in e.name for e in events)


@pytest.mark.cuda
def test_attention_kernel_refuses_head_dims_above_256(cuda_device):
    valid = torch.ones(1, 4, dtype=torch.bool, device=cuda_device)
    q = torch.zeros(1, 4, 1, 264, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        A.fused_attention(q, q, q, valid)


@pytest.mark.cuda
def test_xtts_synthesize_on_the_gpu_matches_the_cpu(cuda_device):
    """The XTTS debug recipe (a 2-layer GPT, a prompt of 70 frames) at temperature 0:
    the same tokens on the card (the prompt encoder's attention on the kernel)
    as on the CPU, and the waveform within 1e-4 of its scale."""
    from speechflow_torch.models.tts import XTTSModel, XTTSParams
    from speechflow_torch.scripts.train_tts import configs

    torch.manual_seed(0)
    debug = configs("debug", "configs/xtts_model.yml")[0]["model"]
    cpu = XTTSModel(XTTSParams.create(dict(debug, n_layers=2, n_symbols=40, n_speakers=2,
                                           prompt_dim=80)))
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(3)
    text = torch.from_numpy(rng.integers(1, 40, (2, 16)))
    mel = _normal(rng, 2, 70, 80)
    lens = torch.tensor([70, 41])
    sid = torch.tensor([0, 1])
    outs, tokens = [], []
    for model in (cpu, card):
        dev = next(model.parameters()).device
        before = A.fused_attention.launches
        args = (text.to(dev), sid.to(dev))
        kw = dict(max_tokens=24, temperature=0.0, prompt_mel=mel.to(dev),
                  prompt_mel_lengths=lens.to(dev))
        with torch.no_grad():
            p_emb, p_len = model._encode_prompt(mel.to(dev), lens.to(dev))
        tokens.append(model.gpt.generate(args[0], max_tokens=24, temperature=0.0,
                                         cond=model._cond(args[1]), prompt_emb=p_emb,
                                         prompt_lengths=p_len).cpu())
        outs.append(model.synthesize(*args, **kw).cpu())
        launched = A.fused_attention.launches - before
        assert launched == (0 if dev.type == "cpu" else 2)  # one prompt block, twice
    assert torch.equal(*tokens)
    assert (outs[1] - outs[0]).abs().max().item() <= 1e-4 * outs[0].abs().max().item()


@pytest.mark.cuda
def test_attention_kernel_rejects_what_tma_cannot_take(cuda_device):
    valid = torch.ones(1, 16, dtype=torch.bool, device=cuda_device)
    q = torch.zeros(1, 16, 1, 12, device=cuda_device, dtype=torch.bfloat16)
    before = A.fused_attention.launches
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q, valid)  # dh 12: rows are not 16-byte strided
    flat = torch.zeros(1 + 16 * 64, device=cuda_device, dtype=torch.bfloat16)
    q = flat[1:].view(1, 16, 1, 64)  # contiguous, but 2 bytes off a 16-byte boundary
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q, valid)
    assert A.fused_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("taps", [8, 12])
@pytest.mark.parametrize("shape", [(2, 300, 24), (1, 1000, 70), (2, 333, 33), (1, 517, 48)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [5, 12, 16])
def test_anti_alias_large_snake_arguments(cuda_device, rng, taps):
    """x * 30 and log alpha up to 1.5 put the sine's argument near 1000: the kernel's
    range reduction holds the f32 result to 1e-5 of the output's scale (|out| ~130,
    where one f32 ulp is 7.6e-6 and the two sides sum in other orders). Taps 5 and 16
    run the 16-tap kernel with a placed and a full filter."""
    b, t_len, c = 2, 700, 48
    x = (30.0 * _normal(rng, b, t_len, c)).to(cuda_device)
    a = torch.linspace(-0.5, 1.5, c, device=cuda_device)
    beta = (0.3 * _normal(rng, c)).to(cuda_device)
    out = AA.anti_alias_snake(x, a, beta, taps)
    ye, yo = AA.aa_upsample_fir(x, taps)
    split = AA.aa_snake_downsample(ye, yo, a, beta, taps)
    torch.cuda.synchronize()
    ref = AA.anti_alias_snake_reference(x, a, beta, taps)
    pe, po = AA.aa_upsample_fir_reference(x, taps)
    ref_split = AA.aa_snake_downsample_reference(ye, yo, a, beta, taps)
    scale = ref.abs().max().item()
    assert scale > 50.0
    assert (out - ref).abs().max().item() <= 1e-5 * scale
    assert (split - ref_split).abs().max().item() <= 1e-5 * scale
    assert max((ye - pe).abs().max().item(), (yo - po).abs().max().item()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [64, 16])
def test_folded_head_on_the_kernels_matches_plain(cuda_device, threshold):
    """The folded BigVGAN head on the card (kernels on the unfolded view, folded
    convs as channels-last conv2d) against the same head on the CPU (plain
    versions), f32; threshold 64 folds every stage, 16 leaves the first
    unfolded. Per call: the same launches as the unfolded head."""
    from speechflow_torch.models.vocoder.folded_head import FoldedSnakeHead
    from speechflow_torch.models.vocoder.heads import SnakeUpsampleHead
    from speechflow_torch.serving import init_random_

    head = init_random_(SnakeUpsampleHead(dim=12, upsample_rates=(2, 2, 2), channels=32,
                                          resblock_kernel_sizes=(3, 7)),
                        torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 40, 12, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = FoldedSnakeHead(head, target=48, threshold=threshold)(x)
        folded = FoldedSnakeHead(head.to(cuda_device), target=48, threshold=threshold)
        before = (AA.anti_alias_snake.launches, AA.aa_upsample_fir.launches,
                  AA.aa_snake_downsample.launches)
        out = folded(x.to(cuda_device))
        torch.cuda.synchronize()
    after = (AA.anti_alias_snake.launches, AA.aa_upsample_fir.launches,
             AA.aa_snake_downsample.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (3 * 2 * 2 + 1, 3, 3 * 2)
    assert (out.cpu() - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mlp", "gru"])
def test_g2p_on_the_gpu_matches_the_cpu(cuda_device, arch):
    """The G2P taggers run on the interface's device: an ensemble of 2 with
    seeded weights gives the same phonemes on the GPU as on the CPU."""
    from speechflow_torch.models.g2p import G2P

    rng = np.random.default_rng(5)
    chars = list("abcdefghijklmnopqrstuvwxyz'") + ["<", ">", "\0"]
    chunks = [(), ("AH0",), ("B",), ("K", "S"), ("IY1",), ("T",), ("N",), ("EH1",)]
    d, h, nch = 8, 6, len(chunks)

    def mat(*shape):
        return (rng.standard_normal(shape) * 2.0 / np.sqrt(shape[0])).astype(np.float32)

    def member():
        p = {"ce": mat(len(chars), d), "le": mat(2, d)}
        if arch == "gru":
            p.update(w1=mat(2 * h, 2 * h), b1=mat(2 * h), wo=mat(2 * h, nch), bo=mat(nch))
            for side in ("f_", "b_"):
                for g in "zrn":
                    p.update({side + "W" + g: mat(d, h), side + "U" + g: mat(h, h),
                              side + "b" + g: mat(h)})
        else:
            p.update(w1=mat(8 * d, 16), b1=mat(16), w2=mat(16, 16), b2=mat(16),
                     wo=mat(16, nch), bo=mat(nch))
        return p

    args = ({c: i for i, c in enumerate(chars)}, {"EN": 0, "RU": 1}, chunks,
            [member(), member()])
    words = ["zebra", "a", "xylophonic", "quick-silver", "don't", "supercalifragilistic"]
    on_gpu = G2P(*args, arch=arch, device=cuda_device)
    assert next(on_gpu.members.parameters()).is_cuda
    assert on_gpu.predict(words) == G2P(*args, arch=arch, device="cpu").predict(words)


def _grads(fn, inputs, cotangents):
    xs = [x.detach().requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)  # the result carries a gradient
    return torch.autograd.grad(outs, xs, cotangents)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("taps", [6, 8, 12])
@pytest.mark.parametrize("shape", [(2, 300, 24), (1, 1000, 33), (2, 130, 70)])
def test_anti_alias_vjps_match_plain_autograd(cuda_device, rng, dtype, tol, taps, shape):
    """The three entries' autograd Functions (kernel forward, VJP kernel)
    against PyTorch autograd of the plain versions: every input's gradient
    within ``tol`` of the plain gradient's largest magnitude (f32: sums in
    another order; bf16: one ulp of the gradient's scale), in the input's dtype."""
    c = shape[-1]
    x = _normal(rng, *shape).to(cuda_device, dtype)
    a, b = (0.3 * _normal(rng, c)).to(cuda_device), (0.3 * _normal(rng, c)).to(cuda_device)
    g, h = (_normal(rng, *shape).to(cuda_device, dtype) for _ in range(2))
    ye, yo = AA.aa_upsample_fir_reference(x, taps)
    cases = [
        (lambda *v: AA.anti_alias_snake(*v, taps), lambda *v: AA.anti_alias_snake_reference(
            *v, taps), (x, a, b), (g,)),
        (lambda v: AA.aa_upsample_fir(v, taps), lambda v: AA.aa_upsample_fir_reference(
            v, taps), (x,), (g, h)),
        (lambda *v: AA.aa_snake_downsample(*v, taps),
         lambda *v: AA.aa_snake_downsample_reference(*v, taps), (ye, yo, a, b), (g,)),
    ]
    for kern, plain, inputs, cots in cases:
        got, ref = _grads(kern, inputs, cots), _grads(plain, inputs, cots)
        for u, v in zip(got, ref):
            assert u.dtype == v.dtype
            assert (u.float() - v.float()).abs().max().item() <= tol * v.float().abs().max().item()


_VJPS = ("anti_alias_snake_vjp", "aa_upsample_fir_vjp", "aa_snake_downsample_vjp")


def _vjp_launches():
    return tuple(getattr(AA, name).launches for name in _VJPS)


def _aa_vjp_inputs(rng, device, dtype, shape):
    c = shape[-1]
    x, g, h = (_normal(rng, *shape).to(device, dtype) for _ in range(3))
    a, b = (0.3 * _normal(rng, c)).to(device), (0.3 * _normal(rng, c)).to(device)
    return x, a, b, g, h


def _assert_vjps_match(got, ref, tol):
    for u, v in zip(got, ref):
        assert u.dtype == v.dtype and u.shape == v.shape
        scale = v.float().abs().max().item()
        assert (u.float() - v.float()).abs().max().item() <= tol * scale


def _check_vjp_kernels(device, rng, dtype, tol, taps, shape):
    """Each VJP kernel against its plain version on the same inputs, each
    counting one launch."""
    x, a, b, g, h = _aa_vjp_inputs(rng, device, dtype, shape)
    ye, yo = AA.aa_upsample_fir_reference(x, taps)
    before = _vjp_launches()
    fused = AA.anti_alias_snake_vjp(x, a, b, g, taps)
    up = AA.aa_upsample_fir_vjp(g, h, taps)
    down = AA.aa_snake_downsample_vjp(ye, yo, a, b, g, taps)
    torch.cuda.synchronize()
    assert tuple(n - m for n, m in zip(_vjp_launches(), before)) == (1, 1, 1)
    _assert_vjps_match(fused, AA.anti_alias_snake_vjp_reference(x, a, b, g, taps), tol)
    assert up.dtype == dtype
    _assert_vjps_match((up,), (AA.aa_upsample_fir_vjp_reference(g, h, taps).to(dtype),), tol)
    _assert_vjps_match(down, AA.aa_snake_downsample_vjp_reference(ye, yo, a, b, g, taps), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("taps", [6, 8, 12, 16])
@pytest.mark.parametrize("shape", [(1, 1, 5), (2, 5, 7), (2, 300, 24), (1, 1000, 33),
                                   (3, 70, 1536), (4, 130, 48)])
def test_anti_alias_vjp_kernels_match_plain(cuda_device, rng, dtype, tol, taps, shape):
    """T = 1, T shorter than the filter, T not a multiple of the run length, odd C,
    C = 24 and 1536, B > 1; taps 16 is the full 16-tap kernel. f32: the kernel sums
    in another order and takes the reduced sine; bf16: one ulp of the gradient's
    scale, the kernel rounding once from f32 as the plain version does."""
    _check_vjp_kernels(cuda_device, rng, dtype, tol, taps, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1.6e-2)])
def test_anti_alias_vjp_kernels_at_a_training_stage(cuda_device, rng, dtype, tol):
    """A stage of the flagship head's training batch (B32, 1520 rows, 384 channels),
    where the threads walk the longest runs (64 rows)."""
    assert AA._vjp_run_len(32, 1520, 384, AA._sm_count(cuda_device)) == 64
    _check_vjp_kernels(cuda_device, rng, dtype, tol, 12, (32, 1520, 384))


@pytest.mark.cuda
@pytest.mark.parametrize("run", [8, 16, 32, 64])
def test_anti_alias_vjp_kernels_at_every_run_length(cuda_device, rng, monkeypatch, run):
    """Each run length the wrappers may choose, at a T that is a multiple of none of them."""
    monkeypatch.setattr(AA, "_vjp_run_len", lambda *shape: run)
    _check_vjp_kernels(cuda_device, rng, torch.float32, 1e-5, 12, (3, 333, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_anti_alias_upsample_vjp_with_one_cotangent(cuda_device, rng, dtype):
    """A missing cotangent of stage 1 is zero (the kernel reads no tensor for it)."""
    _, _, _, g, h = _aa_vjp_inputs(rng, cuda_device, dtype, (2, 333, 33))
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    for ge, go in ((g, None), (None, h)):
        got = AA.aa_upsample_fir_vjp(ge, go, 12)
        ref = AA.aa_upsample_fir_vjp_reference(ge, go, 12).to(dtype)
        _assert_vjps_match((got,), (ref,), tol)


@pytest.mark.cuda
def test_anti_alias_vjps_take_a_non_contiguous_cotangent(cuda_device, rng):
    x, a, b, g, _ = _aa_vjp_inputs(rng, cuda_device, torch.float32, (2, 200, 24))
    gt = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert not gt.is_contiguous()
    ye, yo = AA.aa_upsample_fir_reference(x, 12)
    _assert_vjps_match(AA.anti_alias_snake_vjp(x, a, b, gt),
                       AA.anti_alias_snake_vjp_reference(x, a, b, g), 1e-5)
    _assert_vjps_match(AA.aa_snake_downsample_vjp(ye, yo, a, b, gt),
                       AA.aa_snake_downsample_vjp_reference(ye, yo, a, b, g), 1e-5)
    _assert_vjps_match((AA.aa_upsample_fir_vjp(gt, gt),),
                       (AA.aa_upsample_fir_vjp_reference(g, g),), 1e-5)


@pytest.mark.cuda
def test_anti_alias_vjps_on_the_card_run_the_kernels_whatever_the_dtypes(cuda_device, rng):
    """float64 α and β reach the kernels as f32 copies (as in the forward) and their
    gradients come back in float64; float64 activations are refused, as by the forward."""
    x, a, b, g, h = _aa_vjp_inputs(rng, cuda_device, torch.float32, (2, 300, 24))
    a64, b64 = a.double(), b.double()
    ye, yo = AA.aa_upsample_fir_reference(x, 12)
    before = _vjp_launches()
    fused = AA.anti_alias_snake_vjp(x, a64, b64, g)
    down = AA.aa_snake_downsample_vjp(ye, yo, a64, b64, g)
    assert tuple(n - m for n, m in zip(_vjp_launches(), before)) == (1, 0, 1)
    _assert_vjps_match(fused, AA.anti_alias_snake_vjp_reference(x, a64, b64, g), 1e-5)
    _assert_vjps_match(down, AA.aa_snake_downsample_vjp_reference(ye, yo, a64, b64, g), 1e-5)
    x64, g64 = x.double(), g.double()
    for call in (lambda: AA.anti_alias_snake_vjp(x64, a, b, g64),
                 lambda: AA.aa_upsample_fir_vjp(g64, h.double()),
                 lambda: AA.aa_snake_downsample_vjp(ye.double(), yo.double(), a, b, g64)):
        with pytest.raises(TypeError):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_anti_alias_vjp_param_grads_are_bitwise_reproducible(cuda_device, rng, dtype):
    """dα and dβ come from partial sums reduced in a fixed order: two calls on the
    same inputs give the same bits (and so do the other gradients)."""
    x, a, b, g, _ = _aa_vjp_inputs(rng, cuda_device, dtype, (8, 3000, 48))
    ye, yo = AA.aa_upsample_fir_reference(x, 12)
    for fn, args in ((AA.anti_alias_snake_vjp, (x, a, b, g)),
                     (AA.aa_snake_downsample_vjp, (ye, yo, a, b, g))):
        first, second = fn(*args), fn(*args)
        assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
def test_anti_alias_vjps_launch_only_their_kernels(cuda_device, rng):
    """On contiguous inputs a VJP runs its kernel (and, with α and β, the fixed-order
    reduction) and nothing else on the device: every device event of the trace (the
    profiler's raw events, as the benchmark reads them; a ctypes launch has no op of
    its own to hang under in ``prof.events()``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, a, b, g, h = _aa_vjp_inputs(rng, cuda_device, torch.bfloat16, (4, 500, 96))
    ye, yo = AA.aa_upsample_fir_reference(x, 12)
    calls = ((lambda: AA.anti_alias_snake_vjp(x, a, b, g), 2),
             (lambda: AA.aa_upsample_fir_vjp(g, h), 1),
             (lambda: AA.aa_snake_downsample_vjp(ye, yo, a, b, g), 2))
    for call, n in calls:
        call()  # the library is loaded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        assert len(kernels) == n and all("aa_vjp" in k for k in kernels), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(2, 100, 3, 128), (4, 112, 4, 256)])
def test_fused_attention_vjp_matches_plain_autograd(cuda_device, rng, dtype, tol, shape):
    """Under autograd the wrapper launches the kernel once (its output as without
    autograd) and its backward is ``fused_attention_vjp``: q, k and v's gradients
    against PyTorch autograd of the plain version, each within ``tol`` of the plain
    gradient's largest magnitude (f32: sums in another order; bf16: one ulp of the
    gradient's scale), in the input's dtype. Keys and queries are padded, with
    1e4-scale values in the padded rows: their gradients are 0, and nothing of them
    may reach another row's."""
    b, t_len = shape[:2]
    lens = torch.tensor([t_len - 7 * i for i in range(b)], device=cuda_device)
    valid = torch.arange(t_len, device=cuda_device)[None] < lens[:, None]
    q, k, v, g = (_normal(rng, *shape).to(cuda_device) for _ in range(4))
    for x in (q, k, v):
        x[~valid] = 1e4 * _normal(rng, int((~valid).sum()), shape[2], shape[3]).to(cuda_device)
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    with torch.no_grad():
        plain_out = A.fused_attention(q, k, v, valid)
    before = A.fused_attention.launches
    got, ref = [], []
    for fn, grads in ((A.fused_attention, got), (A.attention_reference, ref)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, valid)
        out.backward(g)
        if fn is A.fused_attention:
            assert torch.equal(out, plain_out)
        grads.extend(x.grad for x in leaves)
    torch.cuda.synchronize()
    assert A.fused_attention.launches == before + 1
    for u, w in zip(got, ref):
        assert u.dtype == w.dtype == dtype
        assert (u.float() - w.float()).abs().max().item() <= tol * w.float().abs().max().item()
        assert not u[~valid].float().any()  # padded keys and queries get no gradient


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["transformer", "dit"])
def test_training_blocks_take_the_plain_attention_on_the_gpu(cuda_device, block):
    """A training call (``deterministic=False``) of a transformer or DiT block on
    the card takes the plain attention, launches no kernel, and its output and
    gradients (input and every parameter) equal the CPU's within 1e-4 of their
    scale at dropout 0 (or of 1e-3 of the largest gradient where that is more:
    the key bias's true gradient is 0, softmax being shift-invariant, so both
    sides hold only rounding there); at dropout 0.1 it also runs without a
    launch; the inference call under ``no_grad`` launches the kernel once."""
    from speechflow_torch.models.tts.common import DiTBlock, TransformerBlock

    gen = torch.Generator().manual_seed(0)
    if block == "dit":
        cpu = DiTBlock(64, 16, n_heads=4)
        with torch.no_grad():  # zero at init
            cpu.mod.weight.copy_(0.1 * torch.randn(cpu.mod.weight.shape, generator=gen))
        cond = torch.randn(2, 16, generator=gen)
    else:
        cpu, cond = TransformerBlock(64, n_heads=4, dropout=0.0), None
    card = copy.deepcopy(cpu).to(cuda_device)
    x = torch.randn(2, 100, 64, generator=gen)
    valid = torch.arange(100)[None] < torch.tensor([[100], [57]])
    mask = valid[:, None, None, :] & valid[:, None, :, None]

    def run(module, dev):
        xs = x.to(dev).detach().requires_grad_()  # a leaf of its own on every call
        args = (xs,) if cond is None else (xs, cond.to(dev))
        out = module(*args, mask.to(dev), deterministic=False)
        out.backward(torch.ones_like(out))
        grads = [xs.grad] + [p.grad for p in module.parameters()]
        return [out.detach()] + [g.detach() for g in grads]

    before = A.fused_attention.launches
    got, ref = run(card, cuda_device), run(cpu, "cpu")
    torch.cuda.synchronize()
    assert A.fused_attention.launches == before
    floor = 1e-3 * max(v.abs().max().item() for v in ref[1:])
    for u, v in zip(got, ref):
        assert (u.cpu() - v).abs().max().item() <= 1e-4 * max(v.abs().max().item(), floor)
    card.attn.dropout = 0.1
    run(card, cuda_device)
    assert A.fused_attention.launches == before
    with torch.no_grad():
        args = (x.to(cuda_device),) if cond is None else (x.to(cuda_device), cond.to(cuda_device))
        card(*args, mask.to(cuda_device))
    assert A.fused_attention.launches == before + 1


@pytest.mark.cuda
def test_tts_training_step_on_the_gpu_matches_the_cpu(cuda_device):
    """One ``Trainer`` step of a small CFM acoustic model (the debug recipe's
    widths with the CFM decoder, seeded random weights so that the DiT
    modulations, zero at initialisation, let the DiT trunk's gradients through,
    every dropout rate 0) on two utterances of the repo's corpus through the
    debug data pipeline, with the same injected u, z and CFG masks, on the card
    and on the CPU: no parameter's reference update is all zero but the attention
    key biases' (their true gradient is 0), the losses within 1e-4 of each loss,
    the updates of an SGD step at lr 1 (the clipped gradient) within 1e-3 of the
    largest update."""
    from speechflow_torch import serving
    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSCriterion
    from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_torch.models.tts.decoders import CFMDraws
    from speechflow_torch.scripts.common import model_config_from_info
    from speechflow_torch.scripts.train_tts import configs
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import Trainer, TrainerConfig

    model_cfg, data_cfg = configs("debug", data_root="tests/data/SEGS")
    model_cfg["model"]["decoder_type"] = "cfm"
    pipeline = DataPipeline.from_config(data_cfg)
    batch = pipeline.datasample_to_batch([s.copy() for s in pipeline.datasets["train"][:2]])
    cpu = serving.init_random_(
        ParallelTTSModel(ParallelTTSParams.create(model_config_from_info(model_cfg, pipeline))),
        torch.Generator().manual_seed(0))
    for m in cpu.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    card = copy.deepcopy(cpu).to(cuda_device)
    draws = cpu.decoder.draw(2, batch.mel.shape, torch.device("cpu"),
                             torch.Generator().manual_seed(1))._replace(
        drop_content=torch.tensor([True, False]).view(2, 1, 1),
        drop_condition=torch.tensor([False, True]).view(2, 1))
    sgd = OptimizerConfig.from_config(dict(method="sgd", lr=1.0, lr_schedule="ConstLR",
                                           grad_clip=1.0, betas=(0.0, 0.999)))
    results = []
    for model in (cpu, card):
        dev = next(model.parameters()).device
        model.decoder.draw = lambda *a, dev=dev, **k: CFMDraws(*(d.to(dev) for d in draws))
        before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        trainer = Trainer(model, TTSCriterion(**model_cfg["loss"]),
                          TTSBatchProcessor(), sgd, TrainerConfig(max_steps=1))
        losses = {k: float(v) for k, v in trainer.training_step(batch).items()}
        results.append((losses, {n: p.detach().cpu() - before[n]
                                 for n, p in model.named_parameters()}))
    (ref_l, ref_u), (got_l, got_u) = results
    assert set(got_l) == set(ref_l) and "cfm" in got_l
    for k, v in ref_l.items():
        assert abs(got_l[k] - v) <= 1e-4 * abs(v), k
    assert not [n for n, u in ref_u.items() if not u.any() and not n.endswith(".attn.key.bias")]
    scale = max(u.abs().max().item() for u in ref_u.values())
    assert scale > 0
    assert max((got_u[n] - u).abs().max().item() for n, u in ref_u.items()) <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("block_type", ["attention", "retention"])
def test_xtts_training_step_on_the_gpu_matches_the_cpu(cuda_device, block_type):
    """The XTTS debug recipe (2 GPT layers, a prompt encoder block of 4 heads) on a
    batch of 2 with ragged waveforms and prompts, on the card and on the CPU from
    the same weights, with the codes the CPU's codec encodes given to both (a code
    is an argmin: a rounding-level difference may flip one and change the target):
    the prompt encoder's attention launches the kernel under autograd;
    ``gpt_ce`` within 1e-5 relative; every gradient within 1e-3 of its tensor's
    scale, or of 1e-3 of the model's largest gradient where that is more (the
    attention key biases' true gradient is 0); the codec's gradient is 0 on both."""
    from speechflow_torch.models.tts import XTTSModel, XTTSParams
    from speechflow_torch.scripts.train_tts import configs

    torch.manual_seed(0)
    debug = configs("debug", "configs/xtts_model.yml")[0]["model"]
    cpu = XTTSModel(XTTSParams.create(dict(debug, n_layers=2, n_symbols=40, n_speakers=2,
                                           prompt_dim=80, block_type=block_type)))
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(4)
    inputs = {"transcription": torch.from_numpy(rng.integers(1, 40, (2, 16))),
              "waveform": 0.3 * _normal(rng, 2, 4096),
              "waveform_lengths": torch.tensor([4096, 2560]),
              "speaker_id": torch.tensor([0, 1]),
              "prompt_mel": _normal(rng, 2, 70, 80), "prompt_mel_lengths": torch.tensor([70, 41])}
    with torch.no_grad():
        codes = cpu.codec.encode(inputs["waveform"])
    results = []
    for model in (cpu, card):
        dev = next(model.parameters()).device
        model.codec.encode = lambda wav, dev=dev: codes.to(dev)
        before = A.fused_attention.launches
        loss = model({k: v.to(dev) for k, v in inputs.items()})["gpt_ce"]
        loss.backward()
        torch.cuda.synchronize()
        assert A.fused_attention.launches - before == (0 if dev.type == "cpu" else 1)
        results.append((loss.item(), {n: torch.zeros_like(p).cpu() if p.grad is None
                                      else p.grad.cpu() for n, p in model.named_parameters()}))
    (ref_l, ref_g), (got_l, got_g) = results
    assert abs(got_l - ref_l) <= 1e-5 * abs(ref_l)
    model_scale = max(g.abs().max().item() for g in ref_g.values())
    for name, r in ref_g.items():
        scale = max(r.abs().max().item(), 1e-3 * model_scale)
        assert (got_g[name] - r).abs().max().item() <= 1e-3 * scale, name
        assert r.any() != name.startswith("codec."), name


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 9, 16, 27, 48])
def test_attention_kernel_at_the_prosody_shape(cuda_device, rng, words):
    """The prosody model's inference call: one sentence, T = words rounded up to
    16, 4 heads of 64, f32 (the TF32 kernel), padded words masked."""
    t_len = words + (-words) % 16
    valid = torch.arange(t_len, device=cuda_device)[None] < words
    before = A.fused_attention.launches
    _check_attention(cuda_device, rng, torch.float32, 5e-5, (1, t_len, 4, 64), valid)
    assert A.fused_attention.launches == before + 1


@pytest.mark.cuda
def test_ecapa_hook_on_the_gpu_matches_the_cpu(cuda_device, tmp_path):
    """``make_ecapa_hook`` of one seeded embedder at default width on the GPU and on
    the CPU: the same embedding within 1e-4."""
    from speechflow_torch.data.processors.embeddings import make_ecapa_hook
    from speechflow_torch.models.biometric import ECAPAEmbedder, ECAPAParams
    from speechflow_torch.utils.state_io import save_module

    torch.manual_seed(0)
    params = ECAPAParams()
    path = str(save_module(ECAPAEmbedder(params), params, tmp_path / "ecapa.pkl"))
    gen = np.random.default_rng(1)
    wav = (0.3 * np.sin(np.arange(40000) * 0.05) + 0.05 * gen.normal(size=40000)).astype(
        np.float32)
    gpu = make_ecapa_hook(path)
    assert next(gpu.model.parameters()).is_cuda
    cpu = make_ecapa_hook(path, device="cpu")
    assert np.abs(gpu(wav, 24000) - cpu(wav, 24000)).max() <= 1e-4


@pytest.mark.cuda
def test_prosody_model_on_the_gpu_matches_the_cpu(cuda_device):
    """The prosody model's inference call (the kernel) on the GPU and on the CPU
    (the plain version), at the default preset's width: logits within 1e-4 of
    their scale, the same classes where the top-2 margin exceeds that."""
    from speechflow_torch.models.prosody import ProsodyModel, ProsodyParams

    torch.manual_seed(0)
    model = ProsodyModel(ProsodyParams()).eval()
    ids = torch.randint(1, 8000, (1, 32))
    batch = {"token_ids": ids, "lengths": torch.tensor([27], dtype=torch.int32)}
    ref = model(batch)
    before = A.fused_attention.launches
    got = copy.deepcopy(model).to(cuda_device)({k: v.to(cuda_device) for k, v in batch.items()})
    assert A.fused_attention.launches == before + 4
    for head in ("binary", "category"):
        r, g = ref[head][0, :27].detach(), got[head][0, :27].detach().cpu()
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("t_len", [1, 37, 128, 300])
def test_attention_kernel_at_the_aligner_head_dim(cuda_device, rng, dtype, tol, t_len):
    """The aligner's encoder at its default width: 2 heads of 96 (a head dim no
    other path runs), ragged keys (the second row is a third as long)."""
    valid = torch.arange(t_len, device=cuda_device)[None] < torch.tensor(
        [t_len, max(1, t_len // 3)], device=cuda_device)[:, None]
    _check_attention(cuda_device, rng, dtype, tol, (2, t_len, 2, 96), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
def test_fused_attention_vjp_at_the_aligner_head_dim(cuda_device, rng, dtype, tol):
    """dh 96 under autograd: one forward launch, q, k and v's gradients against
    PyTorch autograd of the plain version (as ``test_fused_attention_vjp_matches_plain_autograd``)."""
    shape = (3, 150, 2, 96)
    lens = torch.tensor([150, 91, 12], device=cuda_device)
    valid = torch.arange(150, device=cuda_device)[None] < lens[:, None]
    q, k, v, g = (_normal(rng, *shape).to(cuda_device, dtype) for _ in range(4))
    before = A.fused_attention.launches
    got, ref = [], []
    for fn, grads in ((A.fused_attention, got), (A.attention_reference, ref)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves, valid).backward(g)
        grads.extend(x.grad for x in leaves)
    torch.cuda.synchronize()
    assert A.fused_attention.launches == before + 1
    for u, w in zip(got, ref):
        assert (u.float() - w.float()).abs().max().item() <= tol * w.float().abs().max().item()


@pytest.mark.cuda
def test_aligner_align_on_the_gpu_matches_the_cpu(cuda_device):
    """``GlowTTSAligner.align`` at the recipe's default width (192 wide, 2 heads
    of 96, 6 flows), seeded: the GPU (the kernel, TF32 off) gives the CPU's
    durations exactly and one attention launch a layer."""
    from speechflow_torch.models.aligner import GlowTTSAligner, GlowTTSParams
    from speechflow_torch.models.tts import TTSForwardInput

    torch.manual_seed(0)
    model = GlowTTSAligner(GlowTTSParams(n_symbols=60, n_mels=80)).eval()
    for cp in model.flow.couplings:  # random couplings (fresh ones are the identity)
        torch.nn.init.normal_(cp.post.weight, std=0.02)
    gen = torch.Generator().manual_seed(1)
    inputs = TTSForwardInput(transcription=torch.randint(5, 60, (2, 40), generator=gen),
                             transcription_lengths=torch.tensor([40, 23]),
                             mel=torch.randn(2, 300, 80, generator=gen),
                             mel_lengths=torch.tensor([300, 170]))
    ref, _ = model.align(inputs)
    before = A.fused_attention.launches
    got, _ = copy.deepcopy(model).to(cuda_device).align(inputs.to(cuda_device))
    assert A.fused_attention.launches == before + model.p.encoder_layers
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["nsf_hifigan", "nsf_istft", "imdct_symexp", "imdct_cos"])
def test_vocoder_heads_on_the_gpu_match_the_cpu(cuda_device, head):
    """The NSF and MDCT heads at the recipes' default widths (Vocos 512, NSF 256
    channels, style 192), seeded, the same sine-source draws: the waveform on the
    GPU within 1e-4 of the CPU's largest magnitude."""
    from speechflow_torch.models.vocoder import Vocos, VocosParams

    torch.manual_seed(0)
    params = VocosParams.create(dict(head=head, style_dim=192, n_mels=100))
    model = Vocos(params).eval()
    gen = torch.Generator().manual_seed(2)
    mel = torch.randn(2, 40, 100, generator=gen)
    f0 = torch.where(torch.rand(2, 40, generator=gen) > 0.3,
                     100 + 200 * torch.rand(2, 40, generator=gen), torch.zeros(2, 40))
    style = torch.randn(2, 192, generator=gen)
    kw = {}
    if model.nsf_head:
        hop = model.head.total_up if head == "nsf_hifigan" else model.head.hop
        kw = dict(f0=f0, style=style,
                  sine_noise=model.head.sine_gen.draw(2, 40 * hop, "cpu", gen))
    with torch.no_grad():
        ref = model.from_features(mel, **kw)
        dev = {k: (tuple(x.to(cuda_device) for x in v) if isinstance(v, tuple) else
                   v.to(cuda_device)) for k, v in kw.items()}
        got = copy.deepcopy(model).to(cuda_device).from_features(mel.to(cuda_device), **dev)
    assert (got.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gru", "mlp"])
def test_g2p_training_on_the_gpu_matches_the_cpu(cuda_device, arch):
    """``train_g2p`` on the GPU (the stacked members' steps after the third a replayed
    CUDA graph) against the CPU's eager steps, dropout off, 2 members of 8 steps:
    every parameter within 1e-4 of its scale plus what AdamW makes of the
    gradients' rounding (8·lr at most where a gradient is ~eps)."""
    from pathlib import Path

    from speechflow_torch.models.g2p import mine_g2p_lexicon, train_g2p

    segs = Path(__file__).resolve().parent / "data" / "SEGS"
    lexicon = mine_g2p_lexicon(sorted(segs.rglob("*.TextGridStage3")))[:80]
    kw = dict(steps=8, ensemble=2, dropout=0.0, hidden=32, arch=arch)
    cpu = train_g2p(lexicon, device="cpu", **kw)
    gpu = train_g2p(lexicon, device=cuda_device, **kw)
    for pc, pg in zip(cpu.params, gpu.params):
        for k in pc:
            err = np.abs(pg[k] - pc[k])
            assert (err <= 1e-4 * max(np.abs(pc[k]).max(), 1e-30) + 8 * 3e-3).all(), k
            assert np.median(err) <= 1e-4 * max(np.abs(pc[k]).max(), 1e-30), k
    words = ["hello", "zebra", "quickly"]
    assert gpu.predict(words, use_lexicon=False) == cpu.predict(words, use_lexicon=False)


@pytest.mark.cuda
def test_g2p_training_with_dropout_on_the_gpu(cuda_device):
    """With dropout, the captured step's masks come from the seeded generator:
    two runs from one seed agree, and another seed gives other weights."""
    from pathlib import Path

    from speechflow_torch.models.g2p import mine_g2p_lexicon, train_g2p

    segs = Path(__file__).resolve().parent / "data" / "SEGS"
    lexicon = mine_g2p_lexicon(sorted(segs.rglob("*.TextGridStage3")))[:80]
    a, b, c = (train_g2p(lexicon, steps=30, ensemble=1, device=cuda_device, seed=s)
               for s in (4, 4, 5))
    for k in a.params:
        np.testing.assert_array_equal(a.params[k], b.params[k])
    assert not np.array_equal(a.params["wo"], c.params["wo"])


@pytest.mark.cuda
def test_cpc_perceptual_loss_on_the_gpu_matches_the_cpu(cuda_device, tmp_path):
    """The CPC perceptual loss and its gradient into the fake waveform on the
    GPU (f32, autocast on around it) against the CPU's."""
    from speechflow_torch.models.ssl import CPCModel, CPCParams
    from speechflow_torch.models.vocoder.criterion import make_cpc_perceptual_loss
    from speechflow_torch.utils.state_io import save_module

    torch.manual_seed(0)
    ckpt = save_module(CPCModel(CPCParams()), CPCParams(), tmp_path / "cpc.pkl")
    gen = torch.Generator().manual_seed(1)
    fake, real = 0.1 * torch.randn(2, 16000, generator=gen), 0.1 * torch.randn(2, 16000,
                                                                              generator=gen)
    grads = []
    for dev in ("cpu", cuda_device):
        x = fake.to(dev).detach().requires_grad_()
        with torch.autocast(torch.device(dev).type, dtype=torch.bfloat16):
            loss = make_cpc_perceptual_loss(str(ckpt), device=dev)(x, real.to(dev))
        assert loss.dtype == torch.float32
        loss.backward()
        grads.append((loss.item(), x.grad.cpu()))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert (g_gpu - g_cpu).abs().max().item() <= 1e-4 * g_cpu.abs().max().item()


@pytest.mark.cuda
def test_data_parallel_step_on_the_card_equals_one_process(cuda_device, tmp_path):
    """Two ranks on the one card (gloo, which reduces the CUDA gradients in place),
    each on half of a global batch whose halves differ in length: the debug CFM
    acoustic model's ``Trainer`` steps with ``use_mesh`` (SGD, dropout off, injected
    draws) give one process's losses and weights on the whole batch."""
    from speechflow_torch import serving
    from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
    from speechflow_torch.scripts import train_tts
    from speechflow_torch.server.worker import take_rows
    from tests import torch_dp_ranks as R

    params = dict(train_tts.configs("debug")[0]["model"], n_symbols=20, n_speakers=3,
                  n_langs=2, n_mels=16, decoder_type="cfm")
    params["variances"] = [dict(v) for v in params["variances"]]
    model = serving.init_random_(ParallelTTSModel(ParallelTTSParams.create(params)),
                                 torch.Generator().manual_seed(0))
    batch = R.tts_batch(4, 13, [13, 12, 7, 5], 16)
    shape = batch["mel"].shape
    draws = [tuple(a.numpy() for a in model.decoder.draw(
        4, shape, torch.device("cpu"), torch.Generator().manual_seed(k))) for k in range(2)]
    job = dict(kind="tts", params=params, loss=train_tts.configs("debug")[0]["loss"],
               weights=R._weights(model),
               opt=dict(method="sgd", lr=0.01, lr_schedule="ConstLR", grad_clip=1.0,
                        betas=(0.0, 0.999)))
    halves = [[0, 1], [2, 3]]
    ranks = R.run_world(2, {"tts": dict(job, batches=[[take_rows(batch, h, 4)] * 2
                                                      for h in halves],
                                        draws=[[tuple(a[h] for a in d) for d in draws]
                                               for h in halves])},
                        tmp_path, device="cuda")
    one = R.tts_steps(dict(job, batches=[[batch] * 2], draws=[draws]), 0, "cuda")
    assert {r["backend"] for r in ranks} == {"gloo"}
    a, b = ranks[0]["tts"], ranks[1]["tts"]
    assert a["losses"] == b["losses"]
    # 1e-4 (the card's f32 tolerance elsewhere): split over the ranks, the card's f32
    # sums round differently (a loss measured 1.8e-5 apart)
    for got, want in zip(a["losses"], one["losses"]):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-7, k
    scale = max(np.abs(v).max() for v in one["weights"].values())
    for k, v in one["weights"].items():
        assert np.array_equal(a["weights"][k], b["weights"][k]), k
        assert np.abs(a["weights"][k] - v).max() <= 1e-4 * scale, k

