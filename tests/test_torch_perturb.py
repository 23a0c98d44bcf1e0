"""The port's losses and pass-2 perturbation (unidefense_torch/losses,
ops/{eig3,coral,perturb,style}, train/perturb) against the JAX package on
the CPU in fp32. Inputs come from seeded numpy; JAX's random draws are
taken in the test from the same keys the JAX functions split, and handed to
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidefense_torch import losses as tloss
from unidefense_torch.ops import coral as tcoral
from unidefense_torch.ops import fft as tfft
from unidefense_torch.ops import perturb as tpert
from unidefense_torch.ops import resize as tresize
from unidefense_torch.ops import style as tstyle
from unidefense_torch.ops.eig3 import sym_eig3x3
from unidefense_torch.train.perturb import PerturbDraws, perturb_input
from unidefense_tpu import losses as jloss
from unidefense_tpu.ops import fft as jfft
from unidefense_tpu.ops.coral import coral as jax_coral
from unidefense_tpu.ops.coral import coral_single as jax_coral_single
from unidefense_tpu.ops import perturb as jpert
from unidefense_tpu.ops import resize as jresize
from unidefense_tpu.ops import style as jstyle
from unidefense_tpu.ops.eig3 import sym_eig3x3 as jax_sym_eig3x3
from unidefense_tpu.train.perturb import perturb_input as jax_perturb_input

TOL = dict(rtol=1e-4, atol=1e-5)
SUM_REAL = SUM_FAKE = 2


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _image_batch(seed=0, shape=(4, 16, 16, 3)):
    """Normalised from uint8, as the step sees it: 256 values per channel,
    so the spatial style sort has ties everywhere."""
    u8 = np.random.default_rng(seed).integers(0, 256, shape)
    return ((u8 / 255.0 - 0.5) / 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _j(a):
    return np.asarray(a)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("name", ["cross_entropy", "bce", "mse", "kl_div", "aw_triplet",
                                  "factorization"])
def test_losses_match_jax(name):
    """Every registry loss on the same inputs, rtol 1e-5 (fp32, one
    reduction)."""
    rng = np.random.default_rng(1)
    logits, labels = _x((6, 2), 1), np.array([0, 0, 0, 1, 1, 1])
    feats = _x((6, 9), 2)
    args = {
        "cross_entropy": (logits, labels),
        "bce": (logits[:, 0], labels.astype(np.float32)),
        "mse": (_x((3, 4), 3), _x((3, 4), 4)),
        "kl_div": (np.log(rng.dirichlet(np.ones(7), 3)).astype(np.float32),
                   np.log(rng.dirichlet(np.ones(7), 3)).astype(np.float32)),
        "aw_triplet": (feats, labels),
        "factorization": (_x((6, 5), 5), _x((6, 5), 6)),
    }[name]
    extra = (3,) if name == "aw_triplet" else ()
    got = tloss.get_loss(name)(*map(_t, args), *extra)
    ref = jloss.get_loss(name)(*map(jnp.asarray, args), *extra)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_soft_margin_and_registry():
    x, y = _x((5,), 7), np.sign(_x((5,), 8))
    np.testing.assert_allclose(tloss.soft_margin(_t(x), _t(y)).item(),
                               float(jloss.soft_margin(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)
    assert set(tloss.LOSSES) == set(jloss.LOSSES)
    with pytest.raises(KeyError):
        tloss.get_loss("nope")


# ------------------------------------------------------- eig3 and CORAL

def test_sym_eig3x3_matches_jax():
    """On seeded covariances (and a degenerate multiple of I): eigenvalues
    and the sign-fixed eigenvectors, atol 1e-4 (Cardano's trigonometric
    form in fp32)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 3, 40)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) / 40 + np.eye(3, dtype=np.float32)
    cov = np.concatenate([cov, 2 * np.eye(3, dtype=np.float32)[None]])
    d, u = sym_eig3x3(_t(cov))
    jd, ju = jax_sym_eig3x3(jnp.asarray(cov))
    np.testing.assert_allclose(d.numpy(), _j(jd), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(u.numpy(), _j(ju), atol=1e-4)
    # U diag(d) Uᵀ reconstructs the input
    np.testing.assert_allclose((u * d[:, None, :] @ u.transpose(1, 2)).numpy(), cov, atol=1e-4)


def test_coral_matches_jax():
    src, tgt = _image_batch(1, (3, 12, 10, 3)), _x((3, 12, 10, 3), 2) * 0.3 + 0.1
    np.testing.assert_allclose(tcoral.coral(_t(src), _t(tgt)).numpy(),
                               _j(jax_coral(jnp.asarray(src), jnp.asarray(tgt))), **TOL)
    np.testing.assert_allclose(tcoral.coral_single(_t(src[0]), _t(tgt[0])).numpy(),
                               _j(jax_coral_single(jnp.asarray(src[0]), jnp.asarray(tgt[0]))),
                               **TOL)


# ------------------------------------------------------ fft and resize

def test_abs_angle_packed_matches_jax():
    r = _x((2, 5, 4, 6), 4)
    r[0, 0, 0, [0, 3]] = 0.0  # a zero bin: the 1e-20 floor
    for got, ref in zip(tfft.abs_angle_packed(_t(r)), jfft.abs_angle_packed(jnp.asarray(r))):
        np.testing.assert_allclose(got.numpy(), _j(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("src,dst", [((16, 16), (12, 12)), ((12, 12), (16, 16)), ((15, 9), (11, 6))])
def test_nearest_resize_matches_jax(src, dst):
    x = _x((2, *src, 3), 5)
    np.testing.assert_array_equal(tresize.nearest_resize(_t(x), *dst).numpy(),
                                  _j(jresize.nearest_resize(jnp.asarray(x), *dst)))


# ----------------------------------------------- pixel perturbations

def test_noise_blur_downscale_match_jax():
    """Noise with the JAX draw injected (exact up to fp32), the 5x5 blur
    (atol 1e-5: another summation order), the 0.75 down-up-scale (exact)."""
    x = _image_batch(2, (2, 15, 13, 3))
    key = jax.random.PRNGKey(3)
    normal = _j(jax.random.normal(key, x.shape, dtype=jnp.float32))
    np.testing.assert_allclose(tpert.random_noise(_t(x), _t(normal)).numpy(),
                               _j(jpert.random_noise(key, jnp.asarray(x))), atol=1e-7)
    np.testing.assert_allclose(tpert.gaussian_blur(_t(x), 5).numpy(),
                               _j(jpert.gaussian_blur(jnp.asarray(x), 5)), atol=1e-5)
    np.testing.assert_array_equal(tpert.downscale(_t(x)).numpy(),
                                  _j(jpert.downscale(jnp.asarray(x))))


# -------------------------------------------------- style transfers

def _lmda(key, n):
    return _j(jax.random.uniform(key, (n,), dtype=jnp.float32) / 2.0 + 0.5)


def test_frequency_style_transfer_matches_jax():
    content, style = _image_batch(3), _image_batch(4)
    key = jax.random.PRNGKey(5)
    got = tstyle.frequency_style_transfer(_t(content), _t(style), _t(_lmda(key, 4)))
    ref = jstyle.frequency_style_transfer(key, jnp.asarray(content), jnp.asarray(style))
    np.testing.assert_allclose(got.numpy(), _j(ref), **TOL)


def test_spatial_style_transfer_matches_jax_without_ties():
    """Continuous inputs have no ties, so the rank placement is defined and
    the outputs agree element for element."""
    content, style = _x((4, 9, 7, 3), 6), _x((4, 9, 7, 3), 7)
    key = jax.random.PRNGKey(6)
    got = tstyle.spatial_style_transfer(_t(content), _t(style), _t(_lmda(key, 4)))
    ref = jstyle.spatial_style_transfer(key, jnp.asarray(content), jnp.asarray(style))
    np.testing.assert_allclose(got.numpy(), _j(ref), rtol=1e-6, atol=1e-6)


def test_spatial_style_transfer_with_ties_keeps_values():
    """Inputs normalised from uint8 tie everywhere and rank order among ties
    is the sort's own choice: per sample and channel the output holds the
    same multiset of values (compared sorted), and the port places tied
    values in positional order."""
    content, style = _image_batch(8), _image_batch(9)
    key = jax.random.PRNGKey(7)
    got = tstyle.spatial_style_transfer(_t(content), _t(style), _t(_lmda(key, 4))).numpy()
    ref = _j(jstyle.spatial_style_transfer(key, jnp.asarray(content), jnp.asarray(style)))

    def per_channel_sorted(a):
        return np.sort(a.transpose(0, 3, 1, 2).reshape(4, 3, -1), axis=-1)

    np.testing.assert_allclose(per_channel_sorted(got), per_channel_sorted(ref), rtol=1e-6, atol=1e-6)
    order = np.argsort(content.transpose(0, 3, 1, 2).reshape(4, 3, -1), axis=-1, kind="stable")
    placed = np.take_along_axis(got.transpose(0, 3, 1, 2).reshape(4, 3, -1), order, axis=-1)
    assert np.all(np.diff(placed, axis=-1) >= 0)  # non-decreasing in the content's stable rank


# -------------------------------------------------- perturb_input

def jax_perturb_draws(kp, shape, sum_real=SUM_REAL, sum_fake=SUM_FAKE) -> PerturbDraws:
    """The draws ``unidefense_tpu.train.perturb.perturb_input(kp, …)`` makes,
    taken from the same split of ``kp``."""
    kb, kr, kf, ksp, ks, kpp, kpx = jax.random.split(kp, 7)
    return PerturbDraws(
        style=bool(jax.random.uniform(kb, ()) > 0.5),
        perm_real=_t(_j(jax.random.permutation(kr, sum_real))).long(),
        perm_fake=_t(_j(jax.random.permutation(kf, sum_fake))).long(),
        freq=bool(jax.random.randint(ksp, (), 0, 2) == 0),
        lmda=_t(_lmda(ks, shape[0])),
        pixel=int(jax.random.randint(kpp, (), 0, 3)),
        normal=_t(_j(jax.random.normal(kpx, shape, dtype=jnp.float32))),
    )


def _branch(d: PerturbDraws) -> str:
    if d.style:
        return "freq_style" if d.freq else "spatial_style"
    return ("noise", "blur", "downscale")[d.pixel]


def first_key_for(branch: str, shape, start: int = 0) -> int:
    """The first seed from ``start`` whose JAX draws take ``branch``."""
    for seed in range(start, start + 200):
        if _branch(jax_perturb_draws(jax.random.PRNGKey(seed), shape)) == branch:
            return seed
    raise AssertionError(f"no seed takes {branch}")


# one compile for every branch (the JAX function holds all five behind lax.cond)
_jax_perturb = jax.jit(lambda k, a: jax_perturb_input(k, a, SUM_REAL, SUM_FAKE))


@pytest.mark.parametrize("branch", ["freq_style", "spatial_style", "noise", "blur", "downscale"])
def test_perturb_input_matches_jax(branch):
    """Each of the five branches, draws from the same JAX key, CORAL on. The
    spatial branch runs on continuous inputs (no ties); atol 1e-4 covers
    CORAL's 3x3 eigendecomposition in fp32."""
    shape = (4, 16, 16, 3)
    x = _x(shape, 11) * 0.4 if branch == "spatial_style" else _image_batch(11, shape)
    key = jax.random.PRNGKey(first_key_for(branch, shape))
    draws = jax_perturb_draws(key, shape)
    assert _branch(draws) == branch
    got = perturb_input(_t(x), SUM_REAL, SUM_FAKE, draws=draws)
    ref = _jax_perturb(key, jnp.asarray(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _j(ref), rtol=1e-4, atol=1e-4)


def test_perturb_draws_from_generator():
    """Without injected draws every choice comes from the generator: the
    same seed gives the same output, and the permutations stay inside their
    real/fake groups."""
    x = _t(_image_batch(12))
    d = PerturbDraws.draw(torch.Generator().manual_seed(4), SUM_REAL, SUM_FAKE, tuple(x.shape))
    assert sorted(d.perm_real.tolist()) == [0, 1] and sorted(d.perm_fake.tolist()) == [0, 1]
    assert d.lmda.shape == (4,) and bool(((d.lmda >= 0.5) & (d.lmda < 1.0)).all())
    a = perturb_input(x, SUM_REAL, SUM_FAKE, torch.Generator().manual_seed(4))
    b = perturb_input(x, SUM_REAL, SUM_FAKE, torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not a.requires_grad
