"""The 3xTF32 arithmetic of the conv kernels, emulated on the CPU.

``csrc/tf32x3.cuh`` splits each float32 operand into big (the TF32 rounding
of a, as ``cvt.rna.tf32.f32`` gives it) and small = a - big, which the
tensor core reads truncated to TF32, and sums small*big + big*small +
big*big in float32. Here the same split is made with integer operations on
the float32 bits, and the conv2d_dw and stride-2 conv products are taken on
the parts in float32: three products hold the kernels' float32 tolerances
against float64, one TF32 product does not. The tensor core also truncates
each sum it accumulates; emulated with round-toward-zero adds, a long sum
drifts past DW_RTOL unless each tile's sum is folded into a float32 total,
as the kernels do. Also on the CPU: the kernels' grids on the card, and
their build hash over the headers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereoformer_tpu_torch import kernels, ops  # noqa: E402
from stereoformer_tpu_torch.ops.dw_conv import dw_plan  # noqa: E402
from stereoformer_tpu_torch.ops.fused_conv import s2_blocks  # noqa: E402
from test_torch_kernels import DW_RTOL, S2_RTOL  # noqa: E402

# RAFT's sites: the stride-2 convs at eval, B=2, 576x960 (B, H, W, C, Co)
# and conv2d_dw's at the train step, B=4, 320x720 (B, H, W, C = Co)
RAFT_S2_SITES = [(4, 576, 960, 64, 96), (4, 288, 480, 96, 128),
                 (2, 576, 960, 64, 96), (2, 288, 480, 96, 128),
                 (2, 144, 240, 128, 128), (2, 72, 120, 128, 128)]
RAFT_DW_SITES = [(8, 320, 720, 64), (4, 320, 720, 64), (8, 160, 360, 96),
                 (4, 160, 360, 96)]
H100_SMS = 132


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits (half an ulp added to the magnitude's bits, the low 13
    bits cleared)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_truncate(a: np.ndarray) -> np.ndarray:
    """How the tensor core reads a float32 as TF32: the low 13 bits
    dropped."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray):
    big = tf32_rna(a)
    return big, tf32_truncate(a - big)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(10000) * 10.0 ** rng.integers(-6, 6, 10000)
         ).astype(np.float32)
    # the same rounding in float64: 11 significant bits, ties away from 0
    m, e = np.frexp(a.astype(np.float64))
    want = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) * 2.0 ** (e - 11)
    np.testing.assert_array_equal(tf32_rna(a).astype(np.float64), want)
    # ties: 1 + 2^-11 sits halfway between two TF32 values
    tie = np.float32(1 + 2 ** -11)
    assert tf32_rna(tie) == np.float32(1 + 2 ** -10)
    assert tf32_rna(-tie) == np.float32(-(1 + 2 ** -10))
    assert tf32_truncate(tie) == np.float32(1.0)


def _dw_parts(x, g):
    (xb, xs), (gb, gs) = split(x), split(g)
    return [ops.conv2d_dw_plain(_t(p), _t(q))
            for p, q in ((xs, gb), (xb, gs), (xb, gb))]


def test_dw_in_three_tf32_products_holds_the_float32_tolerance():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 48, 64)).astype(np.float32)
    g = rng.standard_normal((2, 20, 48, 64)).astype(np.float32)
    want = ops.conv2d_dw_plain(_t(x).double(), _t(g).double())
    tol = DW_RTOL * want.abs().max().item()
    small_big, big_small, big_big = _dw_parts(x, g)
    three = (small_big + big_small + big_big).double()
    assert (three - want).abs().max().item() <= tol
    # one TF32 product misses it by far
    assert (big_big.double() - want).abs().max().item() > 10 * tol


def _s2_parts(x, w, b):
    (xb, xs), (wb, ws) = split(x), split(w)
    zero = torch.zeros_like(_t(b))
    return [ops.conv3x3_s2_plain(_t(p), _t(q), zero)
            for p, q in ((xs, wb), (xb, ws), (xb, wb))]


def test_s2_in_three_tf32_products_holds_the_float32_tolerance():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 18, 66, 96)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 96, 128)) / np.sqrt(9 * 96)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    want = ops.conv3x3_s2_plain(_t(x).double(), _t(w).double(),
                                _t(b).double())
    tol = S2_RTOL * want.abs().max().item()
    small_big, big_small, big_big = _s2_parts(x, w, b)
    three = (small_big + big_small + big_big + _t(b)).double()
    assert (three - want).abs().max().item() <= tol
    assert ((big_big + _t(b)).double() - want).abs().max().item() > 10 * tol


def round_toward_zero(s: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def mma_sum(a: np.ndarray, b: np.ndarray, fold_every: int) -> np.ndarray:
    """a [M, K] . b [K, N] as the kernels sum it: k-steps of 8, each adding
    its small*big, big*small and big*big products (exact) to a float32
    fragment with one round-toward-zero add per MMA, as the tensor core
    accumulates; every ``fold_every`` k-steps the fragment is added to a
    float32 total with a round-to-nearest add and restarts from zero
    (``fold``; 0: never)."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    parts = [(p.astype(np.float64), q.astype(np.float64))
             for p, q in ((asm, bb), (ab, bsm), (ab, bb))]
    frag = np.zeros((a.shape[0], b.shape[1]), np.float32)
    total = np.zeros_like(frag)
    for i, k in enumerate(range(0, a.shape[1], 8)):
        for p, q in parts:
            frag = round_toward_zero(frag + p[:, k:k + 8] @ q[k:k + 8])
        if fold_every and (i + 1) % fold_every == 0:
            total, frag = total + frag, np.zeros_like(frag)
    return total + frag


def test_round_toward_zero():
    s = np.array([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30, 3.0])
    np.testing.assert_array_equal(
        round_toward_zero(s), np.float32([1.0, -1.0, 1 - 2.0 ** -24, 3.0]))


def test_dw_needs_the_fold_of_its_truncating_sums():
    """conv2d_dw's K is a run of pixels (about 28 k at RAFT's largest site,
    a tenth of it here): summed in one fragment, the truncating adds drift
    past DW_RTOL; folded every 2 x 40-pixel tile (10 k-steps), as the kernel
    does, the sum holds it."""
    rng = np.random.default_rng(3)
    xt = rng.standard_normal((32, 2560)).astype(np.float32)
    g = rng.standard_normal((2560, 32)).astype(np.float32)
    want = xt.astype(np.float64) @ g.astype(np.float64)
    tol = DW_RTOL * np.abs(want).max()
    assert np.abs(mma_sum(xt, g, 0) - want).max() > 2 * tol
    assert np.abs(mma_sum(xt, g, 10) - want).max() <= tol


@pytest.mark.parametrize("site", RAFT_S2_SITES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}x{s[3]}-{s[4]}"
                              for s in RAFT_S2_SITES])
def test_s2_grid_puts_a_block_on_every_sm(site):
    B, H, W, _, Co = site
    blocks = s2_blocks(B, H, W, Co)
    # 4 x 32 output pixels and 32 output channels a block
    assert blocks == B * -(-(H // 2) // 4) * -(-(W // 2) // 32) * -(-Co // 32)
    assert blocks >= H100_SMS


@pytest.mark.parametrize("site", RAFT_DW_SITES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}x{s[3]}"
                              for s in RAFT_DW_SITES])
def test_dw_plan_fills_the_card_in_whole_waves(site):
    C = site[3]
    nsplit, blocks = dw_plan(C, H100_SMS)
    assert blocks == nsplit * 3 * (C // 32)
    assert blocks >= H100_SMS
    slots = H100_SMS * {64: 3, 96: 2}[C]
    assert blocks % slots == 0


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "probe.cu").write_text('#include "probe.cuh"\n')
    (csrc / "probe.cuh").write_text("#define PROBE 1\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setitem(kernels.KERNELS, "probe", ("probe.cu", "probe", ()))
    before = kernels._library_path("probe")
    assert kernels._library_path("probe") == before
    (csrc / "probe.cuh").write_text("#define PROBE 2\n")
    after = kernels._library_path("probe")
    assert after != before and after.parent == build
    (csrc / "probe.cu").write_text('#include "probe.cuh"\n// edited\n')
    assert kernels._library_path("probe") != after
