"""Anti-aliased snake of the port against the JAX package (f32, CPU, 1e-5):
the fused and the split entries' plain versions against the XLA composition,
the split JAX entries and the TPU kernel in the Pallas interpreter. The CUDA
kernel is held against the plain versions in ``test_torch_cuda_kernels.py``,
on the GPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechflow_torch.ops import anti_alias as AA
from tests.torch_parity import n, t

torch.set_num_threads(1)
TOL = 1e-5


def _inputs(rng, b, t_len, c):
    x = rng.normal(size=(b, t_len, c)).astype(np.float32)
    alpha = (0.3 * rng.normal(size=c)).astype(np.float32)
    beta = (0.3 * rng.normal(size=c)).astype(np.float32)
    return x, alpha, beta


@pytest.mark.parametrize("taps", [6, 8, 12])
def test_filter_matches_jax(taps):
    from speechflow_tpu.ops.anti_alias import kaiser_sinc_filter

    np.testing.assert_array_equal(AA.kaiser_sinc_filter(taps=taps),
                                  kaiser_sinc_filter(taps=taps))


@pytest.mark.parametrize("taps", [6, 8, 12])
@pytest.mark.parametrize("t_len", [37, 300])
def test_fused_and_split_match_xla(rng, taps, t_len):
    from speechflow_tpu.ops import anti_alias as J

    x, alpha, beta = _inputs(rng, 2, t_len, 24)
    jx, ja, jb = jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta)
    ref = n(J.anti_alias_snake_xla(jx, ja, jb, taps))
    np.testing.assert_allclose(n(AA.anti_alias_snake(t(x), t(alpha), t(beta), taps)),
                               ref, atol=TOL)

    je, jo = J.aa_upsample_fir(jx, taps)
    ye, yo = AA.aa_upsample_fir(t(x), taps)
    np.testing.assert_allclose(n(ye), n(je), atol=TOL)
    np.testing.assert_allclose(n(yo), n(jo), atol=TOL)
    out = AA.aa_snake_downsample(ye, yo, t(alpha), t(beta), taps)
    np.testing.assert_allclose(n(out), n(J.aa_snake_downsample(je, jo, ja, jb, taps)),
                               atol=TOL)
    np.testing.assert_allclose(n(out), ref, atol=TOL)


@pytest.mark.parametrize("taps,t_len,tile", [(12, 700, 256), (8, 200, 512), (6, 300, 128)])
def test_fused_matches_pallas_kernel(rng, taps, t_len, tile):
    """T not a multiple of the TPU kernel's time tile; several tiles."""
    from speechflow_tpu.ops.anti_alias import anti_alias_snake_pallas

    x, alpha, beta = _inputs(rng, 1, t_len, 16)
    ref = n(anti_alias_snake_pallas(jnp.asarray(x), jnp.asarray(alpha),
                                    jnp.asarray(beta), taps=taps, tile_t=tile,
                                    interpret=True))
    np.testing.assert_allclose(n(AA.anti_alias_snake(t(x), t(alpha), t(beta), taps)),
                               ref, atol=TOL)


def test_wrappers_have_no_fallback_off_the_cpu():
    x = torch.empty(1, 8, 4, device="meta")
    p = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        AA.anti_alias_snake(x, p, p)
    with pytest.raises(ValueError):
        AA.aa_upsample_fir(x)
    with pytest.raises(ValueError):
        AA.aa_snake_downsample(x, x, p, p)

