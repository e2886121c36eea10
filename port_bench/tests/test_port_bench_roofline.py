"""The roofline arithmetic gives the bounds the repository measured its kernels
against (PERF.md's kernel table), at the shapes and lengths of those runs."""

import math

import debug_cells  # noqa: F401

from port_bench import core, roofline


def test_attention_bound_at_the_cfm_shape():
    # CFM B64 T1024 H6 dh128 bf16, rows 1024 - 37 (i mod 9) valid: the operations bound
    lens = [1024 - 37 * (i % 9) for i in range(64)]
    bound_ms = 1e3 * roofline.attention_bound_s(6, 128, lens, "bfloat16")
    assert math.isclose(bound_ms, 0.1552, abs_tol=5e-5)
    ops_ms = 1e3 * roofline.attention_ops(6, 128, lens) / roofline.PEAK_OPS["bfloat16"]
    assert bound_ms == ops_ms


def test_fused_anti_alias_bytes_bound_over_a_flagship_batch():
    # the fused entry's 37 launches of a B32 x 1024-frame batch: two of each MRF
    # branch's three activations at every stage, and the one before the output conv
    cfg = core.load_json(core.HERE / "configs" / "cfm-dit-bigvgan.json")["vocoder"]
    stages = roofline.head_stages(cfg["upsample_rates"], cfg["upsample_channels"])
    launches = [(32 * 1024 * up, ch) for up, ch in stages for _ in range(6)]
    launches.append((32 * 1024 * stages[-1][0], stages[-1][1]))
    assert len(launches) == 37
    total_ms = 1e3 * sum(roofline.activation_bound_s(n, c, "bfloat16") for n, c in launches)
    assert math.isclose(total_ms, 8.17, abs_tol=5e-3)
    first_ms = 1e3 * roofline.activation_bound_s(32 * 4096, 768, "bfloat16")
    assert math.isclose(first_ms, 0.1202, abs_tol=5e-5)


def test_head_bound_counts_a_shared_input_once():
    cfg = core.load_json(core.HERE / "configs" / "cfm-dit-bigvgan.json")["vocoder"]
    args = (32 * 1024, cfg["upsample_rates"], cfg["upsample_channels"], 3, 3, "bfloat16")
    every = sum(9 * roofline.activation_bound_s(32 * 1024 * up, ch, "bfloat16")
                for up, ch in roofline.head_stages(cfg["upsample_rates"],
                                                   cfg["upsample_channels"]))
    shared = roofline.head_activation_bound_s(*args)
    assert shared < every


def test_model_operations_scale_with_valid_work():
    cfg = core.load_json(core.HERE / "configs" / "cfm-dit-bigvgan.json")
    am = cfg["acoustic_model"]
    full = roofline.acoustic_ops(am, [128] * 32, [1024] * 32)
    half = roofline.acoustic_ops(am, [128] * 32, [512] * 32)
    assert 1.9 < full / half < 2.2
    assert 2.0e14 < full < 2.2e14  # about 208 TFLOP a flagship batch
    gan = core.load_json(core.HERE / "configs" / "bigvgan-gan-train.json")
    step = roofline.gan_step_ops(gan["generator"], gan["discriminator"], 32, 24064)
    assert 3.5e13 < step < 5.0e13
