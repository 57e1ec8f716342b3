"""The fused deformable-conv kernel's arithmetic, emulated on the CPU.

``csrc/deform_sample.cu`` computes the windowed DCNv2 forward from x,
offsets, mask and the weight in one launch: a block per tile of ``rows``
output rows x 32 columns and up to 32 output channels, the tile's input
halo staged in shared memory with zeros outside the image, C walked in
chunks of 16 channels, and per tap the 32 pixels of a warp sampled from the
halo into m16n8k8 A fragments (a lane's four channels as its columns t and
t + 4 of two k-steps), multiplied by the tap's weight as a 3xTF32 product
whose sums start from zero for each tap and are folded into float32
totals. Here that walk is emulated lane by lane in numpy, with the
fragment layouts of ``csrc/tf32x3.cuh`` and the tensor core's truncating
adds (``tests/test_torch_tf32x3.py``), and held against JAX's
``modulated_deform_conv_windowed`` and its interpreted Pallas
``deform_conv_fused`` at the card's tolerance, under the tilings the C
entry picks at the learned bounds' shapes and under others. Also: the
launch grid writes every output once, and every kernel's ctypes argument
types match its C entry.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.ops.pallas.deform_sample import (  # noqa: E402
    deform_conv_fused as jax_deform_conv_fused,
)
from stereoformer_tpu_torch import kernels  # noqa: E402
from test_torch_kernels import DEFORM_RTOL  # noqa: E402
from test_torch_tf32x3 import round_toward_zero, split  # noqa: E402

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4   # a lane's group and thread in group
# the kernel's output columns a tile and input channels a chunk
TILE_W, CHUNK = 32, 16


class Tiling(NamedTuple):
    """A tiling of the kernel (its struct Plan): ``rows`` output rows a tile
    of 32 columns, ``mt`` m16n8 tiles of pixels a warp, ``ts`` slices of
    the taps, ``halo`` staged or not, ``nt`` m16n8 tiles of output channels
    a block, ``kg`` taps of weight staged at a time, and the grid."""
    rows: int
    mt: int
    ts: int
    halo: bool
    nt: int
    kg: int
    grid: tuple


def tiling(B, Ho, Wo, Co, K, rows, mt, ts, halo=True, kg=None):
    """The tiling the C entry runs when it is given rows, mt, ts and halo:
    up to 32 output channels a block, spread evenly over the blocks, and
    (here) the weight of ``kg`` taps (default: all K) staged at a time."""
    nco = -(-Co // 32)
    nt = -(-Co // (8 * nco))
    return Tiling(rows, mt, ts, halo, nt, kg or K,
                  (-(-Wo // TILE_W), -(-Ho // rows), B * nco))


def _fma(a, b, c):
    """fmaf, to within a double rounding: the product exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _tile_outputs(plan, B, Ho, Wo, Co):
    """For every block, warp, lane and accumulator of the kernel under
    ``plan``, the output (b, i, j, o) it stores, or -1 where the kernel
    stores nothing, and the 16-pixel tile of the row that holds it: index
    arrays [ncol, nrow, B * nco, warps, 32, mt, nt, 4] of the kernel's
    store arithmetic (a warp takes 16 mt pixels of a tile row)."""
    ncol, nrow, nz = plan.grid
    nco = nz // B
    NC = 8 * plan.nt
    bx, by, bz, warp, lane, m, n, e = np.ix_(
        np.arange(ncol), np.arange(nrow), np.arange(nz),
        np.arange(plan.rows * 2 // plan.mt), LANE, np.arange(plan.mt),
        np.arange(plan.nt), np.arange(4))
    h, e1 = e // 2, e % 2
    b, n0 = bz // nco, (bz % nco) * NC
    r, q0 = warp // (2 // plan.mt), 16 * plan.mt * (warp % (2 // plan.mt))
    i = by * plan.rows + r
    j = bx * TILE_W + q0 + 16 * m + 8 * h + lane // 4
    o = n0 + 8 * n + 2 * (lane % 4) + e1
    stored = (i < Ho) & (j < Wo) & (o < Co)
    return [np.where(stored, a, -1) for a in np.broadcast_arrays(b, i, j, o)
            ] + [np.broadcast_to((q0 + 16 * m) // 16, stored.shape)]


def emulate(x, off, mask, w, k, pad, dil, R, plan):
    """out [B, Ho, Wo, Co] as csrc/deform_sample.cu computes it under
    ``plan``, lane by lane, in float32."""
    B, H, W, C = x.shape
    K, Co = k * k, w.shape[-1]
    w = w.reshape(K, C, Co)
    Ho = H + 2 * pad - dil * (k - 1)
    Wo = W + 2 * pad - dil * (k - 1)
    ncol, nrow, nz = plan.grid
    nco, NC, rows = nz // B, 8 * plan.nt, plan.rows
    Hp, Wp = nrow * rows, ncol * TILE_W          # the grid's output extent
    reach = dil * (k - 1) + 2 * R + 1
    # x zero-padded, channels to whole chunks: the halo of the tile at
    # (i0, j0) is xp[:, i0:i0 + rows + reach, j0:j0 + 32 + reach]
    Cp = -(-C // CHUNK) * CHUNK
    xp = np.zeros((B, Hp + reach, Wp + reach, Cp), np.float32)
    xp[:, pad + R:pad + R + H, pad + R:pad + R + W, :C] = x
    offp = np.zeros((B, Hp, Wp, K, 2), np.float32)
    offp[:, :Ho, :Wo] = off
    mp = np.zeros((B, Hp, Wp, K), np.float32)      # 0 past the output
    mp[:, :Ho, :Wo] = 1.0 if mask is None else mask
    # each (b, i, tile column) is one warp; its lanes' pixels are columns
    bi, ii, jj = np.ix_(np.arange(B), np.arange(Hp), np.arange(Wp))
    r_in_tile, q = ii % rows, jj % TILE_W
    # each slice of the taps (a warp each) sums its own; slice 0 adds the
    # others' sums in order
    slices = np.zeros((plan.ts, nco, 2, plan.nt, B, Hp, ncol, 16, 8),
                      np.float32)
    slice_of = [max(s for s in range(plan.ts) if K * s // plan.ts <= kk)
                for kk in range(K)]
    for c0 in range(0, C, CHUNK):
        for k0 in range(0, K, plan.kg):
            kn = min(plan.kg, K - k0)
            # the staged weight: [kk][cc][o], zero past C and Co
            staged = np.zeros((nco, kn, CHUNK, NC), np.float32)
            for z in range(nco):
                blk = w[k0:k0 + kn, c0:c0 + CHUNK, z * NC:(z + 1) * NC]
                staged[z, :, :blk.shape[1], :blk.shape[2]] = blk
            for kk in range(k0, k0 + kn):
                ky, kx = divmod(kk, k)
                dy = np.minimum(np.maximum(offp[..., kk, 0], -R), R)
                dx = np.minimum(np.maximum(offp[..., kk, 1], -R), R)
                m = mp[..., kk]
                fy, fx = np.floor(dy), np.floor(dx)
                ty, tx = dy - fy, dx - fx
                wy0, wy1 = m * (1 - ty), m * ty
                cw = [wy0 * (1 - tx), wy0 * tx, wy1 * (1 - tx), wy1 * tx]
                ly = r_in_tile + dil * ky + fy.astype(int) + R
                lx = q + dil * kx + fx.astype(int) + R
                if plan.halo:   # the four corners lie in the staged halo
                    assert ly.min() >= 0 and ly.max() + 1 < rows + reach
                    assert lx.min() >= 0 and lx.max() + 1 < TILE_W + reach
                Y, X = ii - r_in_tile + ly, jj - q + lx
                cs = slice(c0, c0 + CHUNK)
                corners = [xp[bi, Y, X, cs], xp[bi, Y, X + 1, cs],
                           xp[bi, Y + 1, X, cs], xp[bi, Y + 1, X + 1, cs]]
                a = cw[0][..., None] * corners[0]
                for wgt, v in zip(cw[1:], corners[1:]):
                    a = _fma(wgt[..., None], v, a)
                # v[u] of lane (g, t): pixel g + 8u, channels 4t .. 4t + 3
                a = a.reshape(B, Hp, ncol, TILE_W, CHUNK)
                v = a[:, :, :, G[:, None, None] + 8 * np.arange(4)[:, None],
                      4 * T[:, None, None] + np.arange(4)]
                for mt in range(2):
                    lo, hi = v[..., 2 * mt, :], v[..., 2 * mt + 1, :]
                    A = []
                    for s in range(2):
                        frag = [lo[..., 2 * s], hi[..., 2 * s],
                                lo[..., 2 * s + 1], hi[..., 2 * s + 1]]
                        mat = np.zeros((B, Hp, ncol, 16, 8), np.float32)
                        mat[..., G, T], mat[..., G + 8, T] = frag[0], frag[1]
                        mat[..., G, T + 4] = frag[2]
                        mat[..., G + 8, T + 4] = frag[3]
                        A.append(split(mat))
                    for z in range(nco):
                        for n in range(plan.nt):
                            # lane (g, t): channels 4t + 2s and 4t + 2s + 1
                            # of output 8n + g, split as loaded
                            wk = staged[z, kk - k0][:, 8 * n + G]
                            part = np.zeros((B, Hp, ncol, 16, 8), np.float32)
                            for s in range(2):
                                mat = np.zeros((8, 8), np.float32)
                                mat[T, G] = wk[4 * T + 2 * s, LANE]
                                mat[T + 4, G] = wk[4 * T + 2 * s + 1, LANE]
                                (ab, asm), (bb, bsm) = A[s], [
                                    p.astype(np.float64) for p in split(mat)]
                                for p, qq in ((asm, bb), (ab, bsm), (ab, bb)):
                                    part = round_toward_zero(
                                        part + p.astype(np.float64) @ qq)
                            slices[slice_of[kk], z, mt, n] += part
    total = slices[0]
    for later in slices[1:]:
        total = total + later
    out = np.full((B, Ho, Wo, Co), np.nan, np.float32)
    ob, oi, oj, oo, tile = _tile_outputs(plan, B, Ho, Wo, Co)
    # accumulator (m, n, 2h + e) of lane (g, t) is D[g + 8h][2t + e] of its
    # 16-pixel tile
    bx, by, bz, warp, lane, _, n, e = np.ix_(
        *[np.arange(d) for d in ob.shape])
    r = warp // (2 // plan.mt)
    vals = total[bz % nco, tile, n, bz // nco, by * rows + r, bx,
                 lane // 4 + 8 * (e // 2), 2 * (lane % 4) + e % 2]
    keep = ob >= 0
    out[ob[keep], oi[keep], oj[keep], oo[keep]] = vals[keep]
    return out


def _inputs(rng, shape, k, scale, with_mask=True):
    B, H, W, C, Co = shape
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    if scale == "integer":
        off = rng.choice(np.array([0.0, 0.0, 1.0, -1.0, 2.0, -2.0, 3.0],
                                  np.float32), size=(B, H, W, k * k, 2))
    else:
        off = rng.uniform(-scale, scale, (B, H, W, k * k, 2)).astype(
            np.float32)
    mask = (rng.random((B, H, W, k * k)).astype(np.float32) if with_mask
            else None)
    w = (rng.standard_normal((k * k * C, Co)) / np.sqrt(k * k * C)).astype(
        np.float32)
    return x, off, mask, w


# (B, H, W, C, Co), k, padding, dilation, window, offset scale, mask; the
# outputs are H x W (padding keeps the size), and no 32-column tile divides W
CASES = {
    "C8-Co6-w2": ((2, 13, 17, 8, 6), 3, 1, 1, 2, 1.8, True),
    "C16-Co16-dil2": ((1, 19, 37, 16, 16), 3, 2, 2, 2, 1.8, True),
    "C40-Co32-w1": ((1, 11, 45, 40, 32), 3, 1, 1, 1, 1.3, True),
    "C16-Co16-w3-no-mask": ((2, 9, 33, 16, 16), 3, 1, 1, 3, 3.5, False),
    "C8-Co40-w2-integer": ((1, 7, 20, 8, 40), 3, 1, 1, 2, "integer", True),
    "k5-C8-Co32-w1": ((1, 9, 20, 8, 32), 5, 2, 1, 1, 1.3, True),
}


@pytest.fixture(scope="module")
def references():
    """case -> (inputs, JAX's windowed form, its interpreted Pallas
    kernel)."""
    refs = {}
    for n, (case, (shape, k, pad, dil, R, scale, with_mask)) in enumerate(
            CASES.items()):
        args = _inputs(np.random.default_rng(30 + n), shape, k, scale,
                       with_mask)
        x, off, mask, w = (None if a is None else jnp.asarray(a)
                           for a in args)
        windowed = jops.modulated_deform_conv_windowed(
            x, off, mask, w, kernel_size=k, padding=pad, dilation=dil,
            window=R)
        pallas = jax_deform_conv_fused(x, off, mask, w, k, pad, dil, R, 8,
                                       True)
        refs[case] = (args, np.asarray(windowed), np.asarray(pallas))
    return refs


def _out_size(H, W, k, pad, dil):
    return H + 2 * pad - dil * (k - 1), W + 2 * pad - dil * (k - 1)


# rows, mt, ts, kg: the C entry's pick at the eval shape [8, 72, 120, 16]
# (six-row tiles, a warp a row) and at the train shape [4, 40, 80, 16]
# (four-row tiles, two warps a row, the taps in three slices; here also the
# weight staged four taps at a time), and tilings it picks for none
TILINGS = {"6-row-tiles": (6, 2, 1, None),
           "4-row-tiles-16px-3-slices-4-tap-groups": (4, 1, 3, 4),
           "1-row-tiles": (1, 2, 1, None),
           "3-row-tiles-16px-2-slices": (3, 1, 2, None)}


@pytest.mark.parametrize("tile", list(TILINGS))
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_matches_jax(references, case, tile):
    """The kernel's walk, under the tilings the C entry picks at the learned
    bounds' shapes and under other tiles, warp widths, tap slices and
    weight groups, against JAX's windowed form and interpreted Pallas
    kernel, at the card's tolerance."""
    shape, k, pad, dil, R, _, _ = CASES[case]
    (x, off, mask, w), windowed, pallas = references[case]
    B, H, W, C, Co = shape
    rows, mt, ts, kg = TILINGS[tile]
    plan = tiling(B, *_out_size(H, W, k, pad, dil), Co, k * k, rows, mt, ts,
                  kg=kg)
    got = emulate(x, off, mask, w, k, pad, dil, R, plan)
    for want in (windowed, pallas):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=DEFORM_RTOL * np.abs(want).max())


@pytest.mark.parametrize("case", ["C16-Co16-dil2", "C8-Co40-w2-integer"])
def test_device_memory_reads_match_the_halo(references, case):
    """halo = 0 (the corners read from x in device memory, for a halo too
    wide for shared memory) takes the same values as the staged halo."""
    shape, k, pad, dil, R, _, _ = CASES[case]
    (x, off, mask, w), windowed, _ = references[case]
    B, H, W, C, Co = shape
    plan = tiling(B, *_out_size(H, W, k, pad, dil), Co, k * k, 1, 2, 1,
                  halo=False)
    got = emulate(x, off, mask, w, k, pad, dil, R, plan)
    np.testing.assert_allclose(got, windowed, rtol=0,
                               atol=DEFORM_RTOL * np.abs(windowed).max())


@pytest.mark.parametrize("shape,k,pad,dil", [
    ((8, 72, 120, 16, 16), 3, 1, 1), ((4, 40, 80, 16, 16), 3, 1, 1),
    ((2, 13, 17, 8, 6), 3, 1, 1), ((1, 19, 37, 16, 16), 3, 2, 2),
    ((1, 33, 65, 128, 128), 3, 1, 1), ((3, 17, 97, 16, 40), 5, 2, 1),
    ((1, 5, 7, 4, 3), 3, 0, 1)],
    ids=["eval", "train", "odd", "dil2", "wide-C-w8", "k5-Co40", "tiny"])
@pytest.mark.parametrize("rows,mt", [(6, 2), (1, 2), (3, 2), (8, 2),
                                     (1, 1), (6, 1), (8, 1)])
def test_grid_writes_every_output_once(shape, k, pad, dil, rows, mt):
    B, H, W, C, Co = shape
    Ho, Wo = _out_size(H, W, k, pad, dil)
    plan = tiling(B, Ho, Wo, Co, k * k, rows, mt, 1)
    ob, oi, oj, oo, _ = _tile_outputs(plan, B, Ho, Wo, Co)
    keep = ob >= 0
    count = np.zeros((B, Ho, Wo, Co), np.int64)
    np.add.at(count, (ob[keep], oi[keep], oj[keep], oo[keep]), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_argument_types_match_the_c_entry(name):
    """Each kernel's ctypes argument types are its C entry's parameters:
    a pointer for every pointer, an int for every int (ctypes would pass a
    missing or extra argument through unchecked)."""
    source, symbol, argtypes = kernels.KERNELS[name]
    text = (kernels.CSRC / source).read_text()
    start = text.index(f'extern "C" int {symbol}(') + len(symbol) + 16
    params = " ".join(text[start:text.index(")", start)].split()).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.split()[0] == "int" for p in params), params
    assert list(argtypes) == want
