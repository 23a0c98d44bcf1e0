"""The row-tiled SFConv kernels of the port (K3 ``sfconv_freq_v4``, K4
``sfconv_freq_v3`` and their backward sums) against the JAX Pallas kernels
in interpret mode on the CPU, in fp32, and the model's route to K3 against
the JAX model's gate.

Shapes cover several TPU row tiles (R < H), odd H, W that is no multiple of
8, and C from 1 to 8. Tolerances: rtol = atol = 1e-4 (fp32, another
summation order), as the K2 tests of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidefense_torch.models import layers as tl
from unidefense_torch.models.registry import build_model
from unidefense_torch.ops import sfconv_rowtiled as rt
from unidefense_torch.ops.sfconv_spatial import double_reversal, split_blocks
from unidefense_tpu.ops import sfconv_pallas as jp

TOL = dict(rtol=1e-4, atol=1e-4)

# (N, H, W, C); the TPU row tile R = _row_tile(H, W) is noted where R < H
SHAPES = [
    (2, 8, 8, 6),
    (1, 12, 48, 4),   # R = 6: two row tiles
    (2, 9, 100, 2),   # R = 3: three row tiles, odd H, W % 8 != 0
    (1, 7, 7, 5),     # odd H and W
    (2, 5, 10, 1),
    (1, 6, 12, 8),
    (1, 4, 3, 7),
    (2, 3, 5, 3),
]


def _inputs(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    wp = rng.standard_normal((2 * c, 2 * c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, wp, g


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _blocks(wp):
    """The four (C, C) blocks, split in fp32 by the port."""
    return [b.numpy() for b in split_blocks(_t(wp), wp.shape[0] // 2)]


def test_shapes_cover_several_row_tiles():
    tiles = [h // jp._row_tile(h, w) for _, h, w, _ in SHAPES]
    assert max(tiles) >= 3 and any(h % 2 for _, h, _, _ in SHAPES)
    assert {c for *_, c in SHAPES} == set(range(1, 9))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("version", ["v4", "v3"])
def test_forward_matches_pallas_interpret(version, shape):
    """sfconv_freq_v4 / _v3 on a CPU tensor (the plain version) ==
    sfconv_freq_pallas_v4 / _v3 in interpret mode."""
    x, wp, _ = _inputs(shape)
    jfn = jp.sfconv_freq_pallas_v4 if version == "v4" else jp.sfconv_freq_pallas_v3
    tfn = rt.sfconv_freq_v4 if version == "v4" else rt.sfconv_freq_v3
    ref = jfn(jnp.asarray(x), jnp.asarray(wp), True)
    got = tfn(_t(x), _t(wp))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("version", ["v4", "v3"])
def test_backward_matches_pallas_vjp(version, shape):
    """(x̄, w̄) of the plain backward == jax.vjp of the Pallas function in
    interpret mode (its custom VJP with the fused backward kernel)."""
    x, wp, g = _inputs(shape)
    jfn = jp.sfconv_freq_pallas_v4 if version == "v4" else jp.sfconv_freq_pallas_v3
    bwd = rt.sfconv_freq_v4_bwd if version == "v4" else rt.sfconv_freq_v3_bwd
    _, vjp = jax.vjp(lambda a, b: jfn(a, b, True), jnp.asarray(x), jnp.asarray(wp))
    jx, jw = vjp(jnp.asarray(g))
    tx, tw = bwd(_t(x), _t(g), _t(wp))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_k3_outputs_and_sums_match_the_pallas_kernels(shape):
    """K3's two outputs and K3-bwd's outputs, one by one, against
    _kernel_call_v4 and _bwd_kernel_call_v4: the port stores o2 and x2
    reversed, and K3-bwd's second sum is −a2b (A2's block not negated)."""
    x, wp, g = _inputs(shape)
    a1, a2, b1, b2 = _blocks(wp)
    jo1, jo2 = jp._kernel_call_v4(jnp.asarray(x), a1, a2, b1, b2, interpret=True)
    o1, o2r = rt.split_output_plain(_t(x), torch.stack([_t(a1), _t(a2), _t(b1), _t(b2)]))
    np.testing.assert_allclose(o1.numpy(), np.asarray(jo1), **TOL)
    np.testing.assert_allclose(o2r.numpy(), double_reversal(_t(jo2)).numpy(), **TOL)

    rg = double_reversal(_t(g)).numpy()
    jx1, jx2, a1b, a2b, b1b, b2b = jp._bwd_kernel_call_v4(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(rg), a1.T, a2.T, b1.T, b2.T, interpret=True)
    tblocks = torch.stack([_t(a1.T), -_t(a2.T), _t(b1.T), _t(b2.T)])
    x1, x2r = rt.split_output_plain(_t(g), tblocks)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), **TOL)
    np.testing.assert_allclose(x2r.numpy(), double_reversal(_t(jx2)).numpy(), **TOL)
    c = shape[-1]
    sums = rt.v4_weight_sums_plain(_t(x), _t(g)).numpy()
    for got, ref in zip(np.split(sums, 4), (a1b, -np.asarray(a2b), b1b, b2b)):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    assert sums.shape == (4 * c, c)


@pytest.mark.parametrize("shape", SHAPES[:4], ids=str)
def test_k4_output_and_sums_match_the_pallas_kernels(shape):
    """K4's output and K4-bwd's outputs against _kernel_call_v3 and
    _bwd_kernel_call_v3: K4-bwd's second and fourth sums are −a2b and −b2b
    (A2's and B2's blocks not negated)."""
    x, wp, g = _inputs(shape)
    a1, a2, b1, b2 = _blocks(wp)
    rx = double_reversal(_t(x))
    rg = double_reversal(_t(g))
    jout = jp._kernel_call_v3(jnp.asarray(x), jnp.asarray(rx.numpy()), a1, a2, b1, b2,
                              interpret=True)
    out = rt.v3_blocks_plain(_t(x), rx, torch.stack([_t(a1), _t(a2), _t(b1), _t(b2)]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)

    jxbar, a1b, a2b, b1b, b2b = jp._bwd_kernel_call_v3(
        jnp.asarray(x), jnp.asarray(rx.numpy()), jnp.asarray(g), jnp.asarray(rg.numpy()),
        a1.T, -a2.T, b1.T, b2.T, interpret=True)
    xbar = rt.v3_blocks_plain(_t(g), rg, torch.stack([_t(a1.T), -_t(a2.T), _t(b1.T), _t(b2.T)]))
    np.testing.assert_allclose(xbar.numpy(), np.asarray(jxbar), **TOL)
    sums = rt.v3_weight_sums_plain(_t(x), rx, _t(g)).numpy()
    for got, ref in zip(np.split(sums, 4), (a1b, -np.asarray(a2b), b1b, -np.asarray(b2b))):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ------------------------------------------------------------- the route

ROUTE_SHAPES = [(20, hw, hw, c) for hw, c in (
    (95, 192), (48, 336), (24, 672), (24, 960), (12, 1632),
    (64, 192), (32, 336), (16, 672), (16, 960), (8, 1632), (80, 192))] + [
    (2, 48, 24, 336),     # not square
    (2, 96, 96, 1100),    # W >= 80 with blocks past the K2 gate's 8 MiB
    (2, 80, 80, 1024),    # exactly 8 MiB: past the gate too
]


@pytest.mark.parametrize("raw", ["", "48,24", "32, 16", "95,80,96,48", "12,8,64"])
def test_route_picks_k3_where_the_jax_model_takes_v4(monkeypatch, raw):
    """uses_v4 == the JAX model's choice of sfconv_freq_pallas_v4
    (models/layers.py:247-253) with its TPU backend check passed, for every
    UDEB4 shape, the A/B tool's 80² and the gate's edges; the default
    widths parse UD_SFCONV_V4 as the JAX gate does."""
    monkeypatch.setenv("UD_SFCONV_V4", raw)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jp.v4_widths.cache_clear()
    try:
        widths = jp.v4_widths()
        assert rt.default_v4_widths() == widths
        for shape in ROUTE_SHAPES:
            jax_v4 = not jp.pallas_eligible(shape) and shape[2] in widths and shape[1] == shape[2]
            assert rt.uses_v4(shape, rt.default_v4_widths()) == jax_v4, shape
    finally:
        monkeypatch.undo()
        jp.v4_widths.cache_clear()


def test_model_routes_listed_square_widths_to_k3(monkeypatch):
    """The b0 twin at 64² has square SFConv inputs of width 16, 8, 4 and 2:
    with v4_widths {8, 4} exactly those of width 8 and 4 go through
    sfconv_freq_v4, the rest through sfconv_freq; the output matches the
    default route (same function)."""
    seen = {"v4": [], "v2": []}

    def spy(key, fn):
        def call(x, w):
            seen[key].append(tuple(x.shape))
            return fn(x, w)
        return call

    cfg = {"extractor": "efficientnet-b0", "delimiter": [1, 3, 5, 8, 11, 15, 16]}
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)
    outs = []
    for widths in ((8, 4), ()):
        torch.manual_seed(0)
        model = build_model("UDEB4", cfg, v4_widths=widths).eval()
        for m in model.modules():
            if isinstance(m, tl.SFConv):
                m.sf_coef.data.zero_()
        monkeypatch.setattr(tl, "sfconv_freq_v4", spy("v4", tl.sfconv_freq_v4))
        monkeypatch.setattr(tl, "sfconv_freq", spy("v2", tl.sfconv_freq))
        with torch.no_grad():
            outs.append(model(x)["cls_out"])
        monkeypatch.undo()
        if widths:
            assert seen["v4"] and {s[2] for s in seen["v4"]} == {8, 4}
            assert {s[2] for s in seen["v2"]} == {16, 2}
            seen = {"v4": [], "v2": []}
    assert not seen["v4"] and {s[2] for s in seen["v2"]} == {16, 8, 4, 2}
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("raw,widths", [("", frozenset()), ("8, 4", frozenset({8, 4}))])
def test_build_model_reads_the_route_from_the_environment(monkeypatch, raw, widths):
    """build_model given no v4_widths reads UD_SFCONV_V4 once and hands the
    widths to every SFConv; given widths, it ignores the variable."""
    monkeypatch.setenv("UD_SFCONV_V4", raw)
    cfg = {"extractor": "efficientnet-b0", "delimiter": [1, 3, 5, 8, 11, 15, 16]}
    for given, want in ((None, widths), ((16,), frozenset({16}))):
        model = build_model("UDEB4", cfg, v4_widths=given)
        routes = {m.v4_widths for m in model.modules() if isinstance(m, tl.SFConv)}
        assert routes == {want}
