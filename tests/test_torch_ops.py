"""The port's ops (unidefense_torch/ops) against the JAX package, on the CPU
in fp32. Inputs come from seeded numpy and go through both frameworks; the
Pallas kernels run in interpret mode, as tests/test_pallas.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidefense_torch.data.transforms import DevicePipeline
from unidefense_torch.ops import fft as tfft
from unidefense_torch.ops import resize as tresize
from unidefense_torch.ops.preprocess import normalize_flip, normalize_flip_plain
from unidefense_torch.ops.sfconv_cuda import sfconv_freq
from unidefense_torch.ops.sfconv_spatial import hilbert_row_matrix, sfconv_freq_spatial
from unidefense_tpu.ops import fft as jfft
from unidefense_tpu.ops import resize as jresize
from unidefense_tpu.ops.pallas_preprocess import normalize_flip as jax_normalize_flip
from unidefense_tpu.ops.sfconv_pallas import sfconv_freq_pallas
from unidefense_tpu.ops.sfconv_spatial import _hilbert_row_matrix
from unidefense_tpu.ops.sfconv_spatial import sfconv_freq_spatial as jax_sfconv_freq_spatial

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("flip", [False, True])
def test_normalize_flip_plain_matches_jax(flip):
    """K1's plain version == the Pallas kernel (interpret), flip applied to
    the JAX output with the same numpy mask; atol 1e-5."""
    u8 = _u8((4, 9, 7, 3))
    mask = np.array([True, False, True, True]) if flip else None
    ref = np.asarray(jax_normalize_flip(jnp.asarray(u8), None, mean=MEAN, std=STD,
                                        interpret=True))
    if flip:
        ref = np.where(mask[:, None, None, None], ref[:, :, ::-1, :], ref)
    got = normalize_flip(torch.from_numpy(u8), None if mask is None else torch.from_numpy(mask),
                         MEAN, STD)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_normalize_flip_bf16_output():
    u8 = torch.from_numpy(_u8((2, 5, 6, 3), 1))
    f32 = normalize_flip_plain(u8, None, MEAN, STD)
    bf = normalize_flip_plain(u8, None, MEAN, STD, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  f32.to(torch.bfloat16).float().numpy())


def test_device_pipeline_draws_flips_from_generator():
    """The mask comes from the explicit generator; hflip_p=1 flips all."""
    u8 = torch.from_numpy(_u8((6, 4, 5, 3), 2))
    plain = DevicePipeline(mean=MEAN, std=STD)(u8)
    flipped = DevicePipeline(mean=MEAN, std=STD, hflip_p=1.0)(u8, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(flipped.numpy(), plain.flip(2).numpy())
    g = torch.Generator().manual_seed(3)
    got = DevicePipeline(mean=MEAN, std=STD, hflip_p=0.5)(u8, g)
    mask = torch.rand(6, generator=torch.Generator().manual_seed(3)) < 0.5
    np.testing.assert_array_equal(got.numpy(), normalize_flip_plain(u8, mask, MEAN, STD).numpy())
    with pytest.raises(TypeError):
        DevicePipeline()(u8.float())


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("w", [7, 8, 95])
def test_hilbert_row_matrix_matches_jax(w):
    np.testing.assert_array_equal(hilbert_row_matrix(w).numpy(), _hilbert_row_matrix(w))


@pytest.mark.parametrize("shape", [(2, 8, 8, 5), (1, 6, 10, 3), (2, 5, 7, 4), (1, 9, 9, 6)])
def test_sfconv_freq_plain_matches_jax(shape):
    """K2's plain version == sfconv_freq_spatial and the Pallas kernel
    (interpret), rtol = atol = 1e-4."""
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    wp = rng.standard_normal((2 * c, 2 * c)).astype(np.float32)
    got = sfconv_freq(torch.from_numpy(x), torch.from_numpy(wp)).numpy()
    ref_spatial = np.asarray(jax_sfconv_freq_spatial(jnp.asarray(x), jnp.asarray(wp)))
    ref_kernel = np.asarray(sfconv_freq_pallas(jnp.asarray(x), jnp.asarray(wp), True))
    np.testing.assert_allclose(got, ref_spatial, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref_kernel, rtol=1e-4, atol=1e-4)


def test_sfconv_freq_equals_spectral_pipeline():
    """The closed form == irfft2(spectrum @ W) in the port's own fft ops."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 6, 9, 3)).astype(np.float32))
    wp = torch.from_numpy(rng.standard_normal((6, 6)).astype(np.float32))
    spectral = tfft.irfft2_packed(tfft.spectrum_channels(x) @ wp, (6, 9))
    np.testing.assert_allclose(sfconv_freq_spatial(x, wp).numpy(), spectral.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_sfconv_freq_cpu_grads_match_jax():
    """On the CPU the plain version's autograd applies; its grads == JAX's
    grads of the spatial form, rtol = atol = 1e-4."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    wp = rng.standard_normal((6, 6)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    gx_j, gw_j = jax.grad(
        lambda a, b: jnp.sum(jax_sfconv_freq_spatial(a, b) * cot), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(wp))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(wp).requires_grad_()
    (sfconv_freq(xt, wt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ fft, resize

@pytest.mark.parametrize("hw", [(8, 8), (12, 12), (24, 24), (95, 95)])
def test_spectrum_and_inverse_match_jax(hw):
    """Sizes inside (12, 24) and outside (8, 95) the JAX DFT-as-matmul
    range; tolerance 1e-4."""
    rng = np.random.default_rng(hw[0])
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    spec = tfft.spectrum_channels(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(spec, np.asarray(jfft.spectrum_channels(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    r = rng.standard_normal(spec.shape).astype(np.float32)  # not hermitian-consistent
    got = tfft.irfft2_packed(torch.from_numpy(r), hw).numpy()
    np.testing.assert_allclose(got, np.asarray(jfft.irfft2_packed(jnp.asarray(r), hw)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("src,dst", [((95, 95), (48, 48)), ((12, 20), (24, 24)), ((48, 48), (95, 95))])
def test_resize_matches_jax(src, dst):
    rng = np.random.default_rng(src[0] + dst[0])
    x = rng.standard_normal((2, *src, 4)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(tresize.bilinear_resize(xt, *dst).numpy(),
                               np.asarray(jresize.bilinear_resize(xj, *dst)), rtol=1e-4, atol=1e-4)
    if dst[0] <= src[0] and dst[1] <= src[1]:
        np.testing.assert_allclose(tresize.adaptive_avg_pool(xt, *dst).numpy(),
                                   np.asarray(jresize.adaptive_avg_pool(xj, *dst)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tresize.global_avg_pool(xt).numpy(),
                               np.asarray(jresize.global_avg_pool(xj)), rtol=1e-4, atol=1e-4)
