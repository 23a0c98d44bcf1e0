"""Launch geometry of the bf16 channel mix on wgmma (K2, K3, K4) and of the
bf16 weight sums (K2-bwd, K3-bwd, K4-bwd), which the CUDA kernels take from
``ops/sfconv_cuda.py``: tiles, ring stages, shared memory, grids, the rows
each tile loads or stores (K2's mirror operand and K3's o2 are
double_reversal's rows) and the split-K ranges; and the signed blocks every
mix adds. The kernels run only on the card; what they are told to do is
checked here, at every SFConv shape of UDEB4, UDR18 and UDR50 at 380² and
256² and of the per-op A/B tool."""

import pytest
import torch

from unidefense_torch.ops import sfconv_cuda as k2
from unidefense_torch.ops import sfconv_rowtiled as rt
from unidefense_torch.ops.sfconv_spatial import (
    double_reversal, hilbert_row_matrix, sfconv_freq_blocks, sfconv_freq_spatial)

# (H=W, C): UDEB4 at 380² and 256², the A/B tool's 80²/C192 and 12²/C960,
# then those of UDR18 and UDR50 at 380² and 256² (C = 128, 256, 512)
SHAPES = [(95, 192), (48, 336), (24, 672), (24, 960), (12, 1632),
          (64, 192), (32, 336), (16, 672), (16, 960), (8, 1632),
          (80, 192), (12, 960),
          (95, 128), (64, 128), (48, 128), (32, 128), (48, 256), (32, 256),
          (24, 256), (16, 256), (24, 512), (16, 512), (12, 512), (8, 512)]
BATCHES = [1, 20, 32]  # one frame, a training step (10 + 10), a serving batch
_ids = [f"{hw}x{c}" for hw, c in SHAPES]


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("hw,c", SHAPES, ids=_ids)
def test_mix_geometry_fits_the_card(hw, c, n):
    g = k2.mix_geometry(n, hw, hw, c)
    assert g.smem <= k2.SMEM_LIMIT
    assert g.grid[0] * g.bn >= c > (g.grid[0] - 1) * g.bn
    assert g.grid[1] == g.groups <= k2.GRID_YZ_LIMIT and g.grid[2] == 1
    assert 1 <= g.rows and g.rows * hw <= 128 < (g.rows + 1) * hw
    assert g.groups * g.rows >= n * hw > (g.groups - 1) * g.rows
    assert g.stages >= 3
    # 64-channel tiles only where 128 would pad more than a fifth of C
    assert g.bn == (64 if c == 192 else 128)


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("hw,c", SHAPES, ids=_ids)
def test_rowtiled_mix_geometry_fits_the_card(hw, c, n, kernel):
    """K3's and K4's mix: at most the card's shared memory, a grid that
    covers C and every image row exactly once, a ring of at least 3 stages
    (K3's one-A-tile stage takes 4), and K2's BN rule."""
    g = k2.mix_geometry(n, hw, hw, c, kernel)
    assert g.smem <= k2.SMEM_LIMIT
    stage = k2.A_TILES[kernel] * 128 * 128 + 2 * g.bn * 128
    assert g.smem == g.stages * (stage + 16) + 1024 + 128 * 8
    assert g.grid[0] * g.bn >= c > (g.grid[0] - 1) * g.bn
    assert g.grid[1] == g.groups <= k2.GRID_YZ_LIMIT and g.grid[2] == 1
    assert 1 <= g.rows and g.rows * hw <= 128 < (g.rows + 1) * hw
    assert g.groups * g.rows >= n * hw > (g.groups - 1) * g.rows
    assert g.stages == (4 if kernel == "K3" or g.bn == 64 else 3)
    assert g.bn == (64 if c == 192 else 128)
    # K4's stage is K2's; K3's drops the second A tile
    assert (g == k2.mix_geometry(n, hw, hw, c, "K2")) == (kernel == "K4")


@pytest.mark.parametrize("hw,c", SHAPES, ids=_ids)
def test_k3_stores_o2_at_the_mirror_pixel(hw, c):
    """K3's epilogue writes o2 of each tile row at that row's mirror pixel:
    scattering o2 through the store map gives double_reversal(o2), every
    pixel written once; o1 goes to the core pixel, which covers every pixel
    once too."""
    n = 2
    g = k2.mix_geometry(n, hw, hw, c, "K3")
    core, mirror = k2.mix_tile_pixels(n, hw, hw, g.rows)
    valid = core >= 0
    o2 = torch.arange(n * hw * hw * 2, dtype=torch.float64).reshape(n, hw, hw, 2)
    stored = torch.full_like(o2.reshape(-1, 2), float("nan"))
    stored[mirror[valid]] = o2.reshape(-1, 2)[core[valid]]
    assert torch.equal(stored.reshape(o2.shape), double_reversal(o2))
    assert torch.equal(mirror[valid].sort().values, torch.arange(n * hw * hw))
    assert torch.equal(core[valid].sort().values, torch.arange(n * hw * hw))


@pytest.mark.parametrize("hw,c", SHAPES, ids=_ids)
def test_mix_tiles_load_every_pixel_once_and_its_mirror(hw, c):
    """Gathering x at each tile row's mirror pixel gives double_reversal(x)
    at the tile row's core pixel; the core rows cover every pixel once."""
    n = 2
    g = k2.mix_geometry(n, hw, hw, c)
    core, mirror = k2.mix_tile_pixels(n, hw, hw, g.rows)
    assert core.shape == mirror.shape == (g.groups, 128)
    valid = core >= 0
    assert torch.equal(valid, mirror >= 0)
    assert torch.equal(core[valid].sort().values, torch.arange(n * hw * hw))
    x = torch.arange(n * hw * hw * 3, dtype=torch.float64).reshape(n, hw, hw, 3)
    flat, rev = x.reshape(-1, 3), double_reversal(x).reshape(-1, 3)
    assert torch.equal(flat[mirror[valid]], rev[core[valid]])
    # each tile's valid rows are its first R*W rows (fewer in the last tile)
    counts = valid.sum(dim=1)
    assert bool((counts[:-1] == g.rows * hw).all()) and 0 < counts[-1] <= g.rows * hw
    assert torch.equal(valid, torch.arange(128) < counts[:, None])


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("hw,c", SHAPES, ids=_ids)
def test_sums_geometry_splits_whole_rows(hw, c, n):
    s = k2.sums_geometry(n, hw, hw, c)
    assert s.smem <= k2.SMEM_LIMIT
    assert s.grid == (s.tiles, 2 * s.tiles, s.splits)
    assert s.tiles * 128 >= c > (s.tiles - 1) * 128
    assert max(s.grid[1:]) <= k2.GRID_YZ_LIMIT
    ranges = s.ranges(n * hw)
    assert len(ranges) == s.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == n * hw
    assert all(b < e for b, e in ranges)  # no split is empty
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(s.splits - 1))
    assert s.workspace == (s.splits * 4 * c * c * 4 if s.splits > 1 else 0)
    assert s.workspace <= 64 * 2**20
    if s.splits > 1:  # each split sums at least 1024 pixel rows but the last
        assert all((e - b) * hw >= 1024 or e == n * hw for b, e in ranges)


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_mix_geometry_refuses_a_grid_it_cannot_launch(kernel):
    with pytest.raises(ValueError, match="row groups"):
        k2.mix_geometry(1, 65_536, 65, 8, kernel)


def _added_plain(x, blocks):
    """What the bf16 and fp32 K2 kernels compute from the blocks they are
    handed: x@b0 + hx@b1 + R(x@b2 + hx@b3), hx = hm @ x per image row."""
    b0, b1, b2, b3 = blocks.to(x.dtype)
    hm = hilbert_row_matrix(x.shape[2]).to(x.dtype)
    hx = torch.einsum("dv,nhvc->nhdc", hm, x)
    return x @ b0 + hx @ b1 + double_reversal(x @ b2 + hx @ b3)


def test_added_blocks_give_the_forward_and_x_bar():
    """The kernel adds every block it is handed: (A1, −A2, B1, B2) is the
    forward, (A1ᵀ, A2ᵀ, B1ᵀ, B2ᵀ) the input gradient, both in float64
    against the plain forms."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 8, generator=gen, dtype=torch.float64)
    w = torch.randn(16, 16, generator=gen, dtype=torch.float64)
    fwd = _added_plain(x, k2._added_blocks(w, 8).double())
    torch.testing.assert_close(fwd, sfconv_freq_spatial(x, w), rtol=0, atol=1e-5)
    xbar = _added_plain(x, k2._added_blocks(w, 8, transposed=True).double())
    ref = sfconv_freq_blocks(x, *k2._transposed_blocks(w, 8))
    torch.testing.assert_close(xbar, ref, rtol=0, atol=1e-5)



def _added_v3(x, blocks):
    """What the bf16 and fp32 K4 kernels compute from the blocks they are
    handed: x@b0 + hx@b1 + rx@b2 + h(rx)@b3, rx = R(x)."""
    b0, b1, b2, b3 = blocks.to(x.dtype)
    hm = hilbert_row_matrix(x.shape[2]).to(x.dtype)
    rx = double_reversal(x)
    hx, hr = (torch.einsum("dv,nhvc->nhdc", hm, t) for t in (x, rx))
    return x @ b0 + hx @ b1 + rx @ b2 + hr @ b3


@pytest.mark.parametrize("version", ["v4", "v3"])
def test_signed_blocks_give_k3_and_k4_and_their_x_bar(version):
    """K3 adds (A1, −A2, B1, B2) as K2 does, and its x̄ (A1ᵀ, A2ᵀ, B1ᵀ,
    B2ᵀ): o1 + R(o2) through the adding form equals sfconv_freq_v4_plain and
    x̄ of sfconv_freq_v4_bwd_plain. K4 adds (A1, −A2, B1, −B2) and its x̄
    (A1ᵀ, A2ᵀ, B1ᵀ, −B2ᵀ), the fourth block negated by the split: equal to
    sfconv_freq_v3_plain and x̄ of sfconv_freq_v3_bwd_plain. float64."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 5, 8, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 6, 5, 8, generator=gen, dtype=torch.float64)
    w = torch.randn(16, 16, generator=gen, dtype=torch.float64)
    form, neg = (_added_plain, False) if version == "v4" else (_added_v3, True)
    plain = getattr(rt, f"sfconv_freq_{version}_plain")
    bwd_plain = getattr(rt, f"sfconv_freq_{version}_bwd_plain")
    fwd = form(x, k2._added_blocks(w, 8, negate_last=neg).double())
    torch.testing.assert_close(fwd, plain(x, w), rtol=0, atol=1e-5)
    xbar = form(g, k2._added_blocks(w, 8, transposed=True, negate_last=neg).double())
    torch.testing.assert_close(xbar, bwd_plain(x, g, w)[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("transposed", [False, True])
def test_negate_last_flips_only_the_fourth_block(transposed):
    """The fourth-block sign is exact negation and touches nothing else."""
    w = torch.randn(24, 24, generator=torch.Generator().manual_seed(2))
    plus = k2._added_blocks(w, 12, transposed)
    minus = k2._added_blocks(w, 12, transposed, negate_last=True)
    assert torch.equal(minus[:3], plus[:3]) and torch.equal(minus[3], -plus[3])
