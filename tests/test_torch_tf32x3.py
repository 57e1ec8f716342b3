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
as the kernels do. The stride-1 fused conv is emulated whole, as its kernel
sums it: prologue, 3xTF32 k-steps with truncating adds folded per 8-channel
chunk, bias, and the moments of the result; and its bf16 form, as its own
mainloop sums it: exact bf16 products in k-steps of 16 (mma.sync
m16n8k16) with one truncating add each into one float32 fragment over all
of C (no fold), one rounding to bf16. The bf16 weight gradient as its
kernel sums it at RAFT's largest site (k-steps of 16 exact products,
truncating adds, folded every 96 k-steps into float32 totals, the grid's
partials in double): folded it holds DW_RTOL, unfolded it does not; and
its walk of strips and runs of rows, with each of its two mainloops'
choice of stage rows, takes every product once. Also on the CPU: the
kernels' grids on the card (both forms of the fused conv and of dw), the
fused conv's moment scratch and dw's partials, and their build hash over
the headers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereoformer_tpu_torch import kernels, ops  # noqa: E402
from stereoformer_tpu_torch.ops import dw_conv, fused_conv  # noqa: E402
from stereoformer_tpu_torch.ops.dw_conv import dw_plan  # noqa: E402
from stereoformer_tpu_torch.ops.fused_conv import (  # noqa: E402
    fused_blocks,
    s2_blocks,
)
from test_torch_kernels import (  # noqa: E402
    CONV_RTOL,
    DW_RTOL,
    MOMENT_RTOL,
    S2_RTOL,
)

# RAFT's sites: the stride-2 convs at eval, B=2, 576x960 (B, H, W, C, Co)
# and conv2d_dw's at the train step, B=4, 320x720 (B, H, W, C = Co)
RAFT_S2_SITES = [(4, 576, 960, 64, 96), (4, 288, 480, 96, 128),
                 (2, 576, 960, 64, 96), (2, 288, 480, 96, 128),
                 (2, 144, 240, 128, 128), (2, 72, 120, 128, 128)]
RAFT_DW_SITES = [(8, 320, 720, 64), (4, 320, 720, 64), (8, 160, 360, 96),
                 (4, 160, 360, 96)]
# the stride-1 fused conv's sites (B, H, W, C = Co): the forward at eval,
# B=2, 576x960, and the backward's dx at the train step, B=4, 320x720
RAFT_FUSED_SITES = [(4, 576, 960, 64), (2, 576, 960, 64), (4, 288, 480, 96),
                    (2, 288, 480, 96)] + RAFT_DW_SITES
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


@pytest.mark.parametrize("C,Co", [(64, 96), (96, 64), (72, 64), (88, 96)])
def test_dw_plan_takes_c_other_than_co(C, Co):
    """Where C differs from Co (RAFT's 64 -> 96 layer2 entry, and C no
    multiple of a chunk): the template is Co's, a split's blocks cover C in
    whole chunks (the last zero-filled), and the grid fills the card in
    whole waves, in both forms."""
    nsplit, blocks = dw_plan(C, H100_SMS, Co=Co)
    assert blocks == nsplit * 3 * -(-C // 32)
    assert blocks % (H100_SMS * {64: 3, 96: 2}[Co]) == 0
    tiling = kernels.DW_BF16_TILING[Co]
    nsplit, blocks = dw_plan(C, H100_SMS, torch.bfloat16, Co)
    assert blocks == nsplit * -(-C // tiling["KC"])
    assert blocks % (H100_SMS * tiling["MINB"]) == 0


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



def test_dw_bf16_tiling_is_built_from_one_table(monkeypatch):
    """csrc/conv2d_dw.cu reads its bf16 tiling from -D defines, and the
    build passes exactly the names it reads, from kernels.DW_BF16_TILING,
    the table dw_plan plans the grid by; a change of the table names
    another library and another plan."""
    import re

    read = set(re.findall(r"\b(DW(?:64|96)_[A-Z0-9]+)\b",
                          (kernels.CSRC / "conv2d_dw.cu").read_text()))
    flags = kernels.nvcc_flags("conv2d_dw.cu")
    passed = {f[2:].split("=")[0] for f in flags if f.startswith("-D")}
    assert read == passed and len(passed) == 12
    assert kernels.nvcc_flags("conv2d_fused.cu") == kernels.NVCC_FLAGS
    before = kernels._library_path("conv2d_dw_bf16")
    tiling = {C: dict(t) for C, t in kernels.DW_BF16_TILING.items()}
    tiling[96]["MINB"] = 2
    monkeypatch.setattr(kernels, "DW_BF16_TILING", tiling)
    assert kernels._library_path("conv2d_dw_bf16") != before
    assert dw_plan(96, H100_SMS, torch.bfloat16) == dw_conv.whole_waves(
        2 * H100_SMS, 96 // tiling[96]["KC"])


def _fused_gemm_operands(z, w, kc=8):
    """The fused conv's implicit GEMM for one image: z [H, W, C] (the
    prologue's output), w [3, 3, C, Co] -> Xcol [H W, 9 C'] and W [9 C', Co]
    with K in the kernel's order: kc-channel chunk, then tap, then channel;
    C' is C rounded up to a whole chunk, the channels past C zero (as the
    kernel zero-fills them)."""
    H, W, C = z.shape
    Cp = -(-C // kc) * kc
    zp = np.pad(z, ((1, 1), (1, 1), (0, Cp - C)))
    w = np.pad(w, ((0, 0), (0, 0), (0, Cp - C), (0, 0)))
    taps = np.stack([zp[ky:ky + H, kx:kx + W] for ky in range(3)
                     for kx in range(3)], axis=2)            # [H, W, 9, C']
    xcol = taps.reshape(H, W, 9, Cp // kc, kc).transpose(0, 1, 3, 2, 4)
    wk = w.reshape(9, Cp // kc, kc, -1).transpose(1, 0, 2, 3)
    return xcol.reshape(H * W, 9 * Cp), wk.reshape(9 * Cp, -1)


@pytest.mark.parametrize("shape", [(19, 40, 64, 64), (9, 33, 96, 96)],
                         ids=["19x40-C64", "9x33-C96"])
def test_fused_conv_in_three_tf32_products_holds_the_float32_tolerance(shape):
    """y = conv3x3(relu(x s + t), w) + b for one image, as the kernel sums
    it: the prologue in float32, 3xTF32 k-steps of 8 channels with
    truncating adds, folded into float32 totals after each chunk's 9 taps,
    then the bias. It holds CONV_RTOL against float64, one TF32 pass does
    not; the moments of that y, summed per 4 x 32 tile in float32 and
    across tiles in float64, hold MOMENT_RTOL."""
    H, W, C, Co = shape
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Co)) / np.sqrt(9 * C)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(Co)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (1, C)).astype(np.float32)
    t = (0.5 * rng.standard_normal((1, C))).astype(np.float32)
    want = ops.conv3x3_plain(*(_t(a).double() for a in (x, w, b)),
                             s=_t(s).double(), t=_t(t).double())[0].numpy()
    tol = CONV_RTOL * np.abs(want).max()
    # fmaf(x, s, t): the float64 product is exact, one rounding to float32
    z = np.maximum((x[0].astype(np.float64) * s[0] + t[0]).astype(np.float32),
                   np.float32(0))
    xcol, wk = _fused_gemm_operands(z, w)
    y = (mma_sum(xcol, wk, fold_every=9) + b).reshape(H, W, Co)
    assert np.abs(y - want).max() <= tol
    one = tf32_rna(xcol).astype(np.float64) @ tf32_rna(wk).astype(np.float64)
    assert np.abs((one + b).reshape(H, W, Co) - want).max() > 10 * tol
    # the kernel's moments: float32 sums per 4 x 32 tile, then float64
    Hp, Wp = -(-H // 4) * 4, -(-W // 32) * 32
    tiles = np.pad(y, ((0, Hp - H), (0, Wp - W), (0, 0))).reshape(
        Hp // 4, 4, Wp // 32, 32, Co)
    for got, ref in ((tiles, want), (tiles * tiles, want * want)):
        part = got.sum((1, 3), dtype=np.float32)
        got_m = part.astype(np.float64).sum((0, 1))
        ref_m = ref.sum((0, 1))
        np.testing.assert_allclose(got_m, ref_m, rtol=MOMENT_RTOL,
                                   atol=MOMENT_RTOL * np.abs(ref_m).max())


def mma_sum_bf16(a: np.ndarray, b: np.ndarray, fold_every: int) -> np.ndarray:
    """a [M, K] . b [K, N] of bf16 values as the bf16 fused conv sums it
    (mma.sync m16n8k16, float32 accumulators): k-steps of 16, each adding
    its 16 exact products (a bf16 x bf16 product is exact in float32) to a
    float32 fragment with one round-toward-zero add; every ``fold_every``
    k-steps the fragment is added to a float32 total with a round-to-nearest
    add and restarts from zero (``fold``; 0: never)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    frag = np.zeros((a.shape[0], b.shape[1]), np.float32)
    total = np.zeros_like(frag)
    for i, k in enumerate(range(0, a.shape[1], 16)):
        frag = round_toward_zero(frag + a[:, k:k + 16] @ b[k:k + 16])
        if fold_every and (i + 1) % fold_every == 0:
            total, frag = total + frag, np.zeros_like(frag)
    return total + frag


def to_bf16(a) -> np.ndarray:
    """Round to bf16 (to nearest, ties to even), as float32 values."""
    return _t(np.asarray(a, np.float32)).bfloat16().float().numpy()


# the bf16 form's chunk by Co and its tile (csrc/conv2d_fused.cu,
# bfk::Cfg::KC, bfk::BTH and TW): 16 input channels (one k-step a tap) in
# the blocks of Co = 64, 32 (two) in those of Co = 96; 8 x 32 pixels
BF16_KC = {64: 16, 96: 32}
BF16_TILE = (8, 32)


@pytest.mark.parametrize("shape", [(19, 40, 64, 64), (9, 33, 72, 96),
                                   (9, 33, 96, 96)],
                         ids=["19x40-C64", "9x33-C72-tail-96", "9x33-C96"])
def test_fused_conv_bf16_mma_holds_one_bf16_ulp(shape):
    """The bf16 form as its mainloop sums it, for one image: the prologue
    bf16(relu(x s + t)), k-steps of 16 channels (a tap's) in chunks of 16
    (Co = 64) or 32 channels (Co = 96), the channels past C zero (C = 72:
    a tail chunk of 8), exact
    products and one truncating add per MMA into one float32 fragment over
    all of C (36 to 54 MMAs: the kernel does not fold), then the bias and
    one rounding to bf16. Every output is within one bf16 ulp of the plain
    version (float32 sums, one rounding), or near 0 within 2^-20 of the
    largest output, as chip_smoke.py's bf16_close holds the card; the
    moments of the rounded output, summed per 8 x 32 tile in float32 and
    across tiles in float64, within MOMENT_RTOL beyond what the outputs
    that round to the neighbouring bf16 move them by."""
    H, W, C, Co = shape
    rng = np.random.default_rng(5)
    x = to_bf16(rng.standard_normal((1, H, W, C)))
    w = to_bf16(rng.standard_normal((3, 3, C, Co)) / np.sqrt(9 * C))
    b = to_bf16(0.1 * rng.standard_normal(Co))
    s = rng.uniform(0.5, 1.5, (1, C)).astype(np.float32)
    t = (0.5 * rng.standard_normal((1, C))).astype(np.float32)
    want, *want_m = ops.conv3x3_plain(
        *(_t(a).bfloat16() for a in (x, w, b)), s=_t(s), t=_t(t),
        with_stats=True)
    want = want[0].float().numpy()
    # the prologue's FMA (the float64 product is exact), rounded to bf16
    z = to_bf16(np.maximum(
        (x[0].astype(np.float64) * s[0] + t[0]).astype(np.float32), 0))
    xcol, wk = _fused_gemm_operands(z, w, BF16_KC[Co])
    y = to_bf16((mma_sum_bf16(xcol, wk, fold_every=0) + b).reshape(H, W, Co))
    big = np.maximum(np.abs(y), np.abs(want)).clip(1e-30)
    ulp = 2.0 ** -7 * np.exp2(np.floor(np.log2(big)))
    tol = np.maximum(ulp, 2.0 ** -20 * np.abs(want).max())
    assert (np.abs(y - want) <= tol).all()
    # the kernel's moments: float32 sums per 8 x 32 tile, then float64
    th, tw = BF16_TILE
    Hp, Wp = -(-H // th) * th, -(-W // tw) * tw
    tiles = np.pad(y, ((0, Hp - H), (0, Wp - W), (0, 0))).reshape(
        Hp // th, th, Wp // tw, tw, Co)
    yg, yw = y.astype(np.float64), want.astype(np.float64)
    slack = (np.abs(yg - yw).sum((0, 1)),
             np.abs(yg ** 2 - yw ** 2).sum((0, 1)))
    for got, ref, sl in zip((tiles, tiles * tiles), want_m, slack):
        part = got.sum((1, 3), dtype=np.float32)
        got_m = part.astype(np.float64).sum((0, 1))
        ref_m = ref[0].double().numpy()
        tol_m = MOMENT_RTOL * (np.abs(ref_m) + np.abs(ref_m).max()) + sl
        assert (np.abs(got_m - ref_m) <= tol_m).all()


# conv2d_dw's bf16 form (csrc/conv2d_dw.cu, bfd): k-steps an accumulator
# takes between folds (FOLD_K) and x rows a stage (RS); its tiling by
# C = Co is kernels.DW_BF16_TILING
BF16_DW_FOLD = 96
BF16_DW_RS = 3


def dw_bf16_sum(xt: np.ndarray, g: np.ndarray, nsplit: int,
                fold_every: int) -> np.ndarray:
    """xt [M, K] . g [K, N] of bf16 values as conv2d_dw's bf16 form sums
    it: K in nsplit equal runs (the grid's splits), each summed by its
    block in k-steps of 16 pixels (one mma.sync m16n8k16: exact products,
    one round-toward-zero add into a float32 fragment), the fragment added
    to a float32 total with a round-to-nearest add every ``fold_every``
    k-steps and at the end (0: at the end only); the nsplit partials summed
    in double in split order and rounded once to float32 (the reduction)."""
    M, K = xt.shape
    steps = K // nsplit // 16
    a = xt.astype(np.float64).reshape(M, nsplit, steps, 16).transpose(1, 2,
                                                                      0, 3)
    b = g.astype(np.float64).reshape(nsplit, steps, 16, -1)
    frag = np.zeros((nsplit, M, g.shape[1]), np.float32)
    total = np.zeros_like(frag)
    for i in range(steps):
        frag = round_toward_zero(frag + a[:, i] @ b[:, i])
        if fold_every and (i + 1) % fold_every == 0:
            total, frag = total + frag, np.zeros_like(frag)
    total = total + frag
    return total.astype(np.float64).sum(0).astype(np.float32)


def _dw_bf16_sum_at_raft_fnet_layer1(fold_every, seed=6):
    """dw_bf16_sum over the pixels of RAFT's largest site (fnet layer1 of
    the train step, B=8, 320x720: 1.84 M) at the bf16 plan's split, for a
    16 x 16 corner of dw; -> (the float32 sums, the float64 sums)."""
    rng = np.random.default_rng(seed)
    nsplit, _ = dw_plan(64, H100_SMS, torch.bfloat16)
    K = 8 * 320 * 720
    K = -(-K // (16 * nsplit)) * 16 * nsplit
    xt = to_bf16(rng.standard_normal((16, K)))
    g = to_bf16(rng.standard_normal((K, 16)))
    want = xt.astype(np.float64) @ g.astype(np.float64)
    return dw_bf16_sum(xt, g, nsplit, fold_every), want


def test_dw_bf16_sums_hold_the_tolerance_with_the_fold():
    """The bf16 dw as its mainloop sums it at RAFT's largest site, folded
    every BF16_DW_FOLD k-steps: every output within one bf16 ulp of the
    float64 sum rounded once, and the float32 sums within DW_RTOL of the
    largest |dw| (the near-0 clause of DW_BF16_RTOL = 2e-5, and of the card
    tests' stricter 1e-5: what an output whose sum cancels is held to)."""
    got, want = _dw_bf16_sum_at_raft_fnet_layer1(BF16_DW_FOLD)
    y, ref = to_bf16(got), to_bf16(want)
    big = np.maximum(np.abs(y), np.abs(ref)).clip(1e-30)
    ulp = 2.0 ** -7 * np.exp2(np.floor(np.log2(big)))
    assert (np.abs(y - ref) <= np.maximum(
        ulp, DW_RTOL * np.abs(want).max())).all()
    assert np.abs(got - want).max() <= DW_RTOL * np.abs(want).max()


def test_dw_bf16_needs_the_fold_of_its_truncating_sums():
    """Without the fold each block sums its ~14 k pixels (870 MMAs) in one
    fragment, and the truncating adds drift: the float32 sums miss DW_RTOL
    of the largest |dw|, the card tests' tolerance for the bf16 dw, where
    the fold holds a tenth of it."""
    got, want = _dw_bf16_sum_at_raft_fnet_layer1(0)
    assert np.abs(got - want).max() > DW_RTOL * np.abs(want).max()


def dw_bf16_walk(x: np.ndarray, g: np.ndarray, nsplit: int, kc: int,
                 tw: int, mainloop: int) -> np.ndarray:
    """dw of x, g [B, H, W, C] (float64) as conv2d_dw's bf16 form walks
    them: block (slice, split) takes KC = ``kc`` input channels and the
    items [nitems s / nsplit, nitems (s + 1) / nsplit) of the rows of every
    ``tw``-column strip of every image; each run of rows of one strip,
    ha .. hb - 1, is walked as x rows ha - 1 .. hb in stages of RS rows,
    the last padded. A stage holds what its TMA boxes hold, x rows
    r .. r + RS - 1 (columns x0 - 1 .. x0 + tw) and g rows r + 1 .. r + RS
    (columns x0 ..), zero outside the image, and flags (bit i: g row
    r - 1 + i is in the run). The stage's products as ``mainloop`` takes
    them (csrc/conv2d_dw.cu, WG): 0, step k of x row r + k with the g rows
    r + k + 1 - di of a three-slot ring of g fragments (slot
    (k + 2 - di) % 3, zeroed outside the run); 1, x row r + k with g row
    r + k + 1 - di, row k - di of the stage or k - di + RS of the previous
    one. The partials summed."""
    B, H, W, C = x.shape
    Co, rs = g.shape[3], BF16_DW_RS
    nstrips = -(-W // tw)
    nitems = B * nstrips * H
    part = np.zeros((nsplit, 9, C, Co))

    def box(t, b, rows, x0, w, c0, ch):
        out = np.zeros((len(rows), w, ch))
        for i, row in enumerate(rows):
            if 0 <= row < H:
                lo, hi = max(x0, 0), min(x0 + w, W)
                out[i, lo - x0:hi - x0] = t[b, row, lo:hi, c0:c0 + ch]
        return out

    for c0 in range(0, C, kc):
        for split in range(nsplit):
            i0, i1 = nitems * split // nsplit, nitems * (split + 1) // nsplit
            stages, i = [], i0
            while i < i1:
                n = min(H - i % H, i1 - i)
                b, s = divmod(i // H, nstrips)
                ha, hb = i % H, i % H + n
                for r in range(ha - 1, hb + 1, rs):
                    flags = [ha <= r - 1 + j < hb for j in range(rs + 2)]
                    stages.append((
                        box(x, b, range(r, r + rs), s * tw - 1, tw + 2, c0,
                            kc),
                        box(g, b, range(r + 1, r + rs + 1), s * tw, tw, 0,
                            Co), flags))
                i += n
            acc = np.zeros((9, kc, Co))
            ring = np.zeros((3, tw, Co))
            prev = stages[0] if stages else None
            for xs, gs, f in stages:
                for k in range(rs):
                    ring[(k + 2) % 3] = gs[k] if f[k + 2] else 0.0
                    for di in range(3):
                        if mainloop == 0:
                            xr, gr = xs[k], ring[(k + 2 - di) % 3]
                        else:
                            if not f[k + 2 - di]:
                                continue
                            xr = xs[k]
                            gr = (gs[k - di] if k - di >= 0
                                  else prev[1][k - di + rs])
                        for dj in range(3):
                            acc[3 * di + dj] += xr[dj:dj + tw].T @ gr
                prev = (xs, gs, f)
            part[split, :, c0:c0 + kc] = acc
    return part.sum(0).reshape(3, 3, C, Co)


# (B, H, W, C, nsplit): W off the strip and under it, images of 1 and 2
# rows, runs that end inside an image, splits with no rows (nsplit above
# the items), and the plan's own nsplit
WALK_CASES = [(2, 7, 37, 64, 5), (1, 1, 5, 64, 3), (1, 2, 9, 96, 4),
              (2, 19, 40, 64, 7), (1, 9, 33, 96, None), (2, 3, 5, 64, 1),
              (3, 4, 16, 64, None)]


@pytest.mark.parametrize("mainloop", [0, 1], ids=["mma", "wgmma"])
@pytest.mark.parametrize("case", WALK_CASES,
                         ids=["x".join(map(str, c[:4])) + f"-s{c[4]}"
                              for c in WALK_CASES])
def test_dw_bf16_walk_takes_every_product_once(case, mainloop):
    """The bf16 form's walk (runs, stages, the zero rows and the run's
    flags) and each mainloop's choice of the stage rows a product reads
    take each product of dw once: equal to the plain version in float64.
    At the slice and strip widths of the plan for C."""
    B, H, W, C, nsplit = case
    nsplit = nsplit or dw_plan(C, H100_SMS, torch.bfloat16)[0]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, H, W, C))
    g = rng.standard_normal((B, H, W, C))
    tiling = kernels.DW_BF16_TILING[C]
    got = dw_bf16_walk(x, g, nsplit, tiling["KC"], tiling["TW"], mainloop)
    want = ops.conv2d_dw_plain(_t(x), _t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("site", RAFT_DW_SITES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}x{s[3]}"
                              for s in RAFT_DW_SITES])
def test_dw_bf16_plan_fills_the_card_in_whole_waves(site):
    """The bf16 form's grid: C / KC blocks a split, whole waves of the
    card's resident slots, and every block gets rows at RAFT's sites: the
    splits share the rows of every TW-column strip of every image."""
    B, H, W, C = site
    tiling = kernels.DW_BF16_TILING[C]
    nsplit, blocks = dw_plan(C, H100_SMS, torch.bfloat16)
    assert blocks == nsplit * (C // tiling["KC"])
    assert blocks >= H100_SMS
    assert blocks % (H100_SMS * tiling["MINB"]) == 0
    assert B * -(-W // tiling["TW"]) * H >= nsplit


@pytest.mark.parametrize("shape,dtype", [
    pytest.param((2, 19, 40, 64), torch.float32, id="f32-C64"),
    pytest.param((1, 9, 33, 96), torch.float32, id="f32-C96"),
    pytest.param((2, 19, 40, 64), torch.bfloat16, id="bf16-C64"),
    pytest.param((1, 9, 33, 96), torch.bfloat16, id="bf16-C96")])
def test_dw_scratch_is_what_the_grid_writes(shape, dtype, monkeypatch):
    """The wrapper sizes the partials' scratch [nsplit, 9, C, Co] by the
    form's plan and passes the kernel that nsplit, the grid's splits, each
    of which writes one partial. The allocations are recorded and the
    launch replaced, so no card is needed."""
    B, H, W, C = shape
    shapes, launched = [], []
    new_empty = torch.Tensor.new_empty

    def recording_new_empty(self, size, *args, **kwargs):
        shapes.append((tuple(size), kwargs.get("dtype")))
        return new_empty(self, size, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "new_empty", recording_new_empty)
    monkeypatch.setattr(kernels, "launch", lambda *a: launched.append(a))
    x = torch.zeros(shape, dtype=dtype)
    name = "conv2d_dw_bf16" if dtype == torch.bfloat16 else "conv2d_dw"
    dw_conv._launch(name, x, x, H100_SMS)
    nsplit, _ = dw_plan(C, H100_SMS, dtype)
    assert launched and launched[0][0] == name
    assert launched[0][-6:] == (B, H, W, C, C, nsplit)
    assert shapes[0] == ((nsplit, 9, C, C), torch.float32)
    assert shapes[1] == ((3, 3, C, C), None)


def _site_id(s):
    return "x".join(map(str, s[:4])) + (f"-{s[4]}" if len(s) > 4 else "")


# the float32 form at every site, the bf16 form at every site (the eval's
# forward; the train sites are the bf16 dx's shapes)
FUSED_FORMS = [pytest.param(s, torch.float32, id=_site_id(s))
               for s in RAFT_FUSED_SITES] + [
    pytest.param(s, torch.bfloat16, id="bf16-" + _site_id(s))
    for s in RAFT_FUSED_SITES]
# output rows and columns of a tile, and output channels of a block by Co:
# 4 x 32 and 32 in the 3xTF32 form; 8 x 32 and all of Co = 64, half of
# Co = 96 in the bf16 form
FUSED_TILE = {torch.float32: (4, 32), torch.bfloat16: (8, 32)}
FUSED_CB = {torch.float32: {64: 32, 96: 32},
            torch.bfloat16: {64: 64, 96: 48}}


@pytest.mark.parametrize("site,dtype", FUSED_FORMS)
def test_fused_grid_puts_a_block_on_every_sm(site, dtype):
    B, H, W, Co = site
    blocks = fused_blocks(B, H, W, Co, dtype)
    th, tw = FUSED_TILE[dtype]
    cb = FUSED_CB[dtype][Co]
    assert blocks == B * -(-H // th) * -(-W // tw) * (Co // cb)
    assert blocks >= H100_SMS


SCRATCH_SHAPES = [(2, 19, 40, 64, 96), (1, 37, 53, 96, 64),
                  (1, 17, 45, 72, 96), (2, 9, 33, 96, 96)]


@pytest.mark.parametrize("shape,dtype", [
    pytest.param(SCRATCH_SHAPES[0], torch.float32, id="H-tail-C64-96"),
    pytest.param(SCRATCH_SHAPES[1], torch.float32, id="tails-C96-64"),
    pytest.param(SCRATCH_SHAPES[0], torch.bfloat16, id="bf16-H-tail-C64-96"),
    pytest.param(SCRATCH_SHAPES[1], torch.bfloat16, id="bf16-tails-C96-64"),
    pytest.param(SCRATCH_SHAPES[2], torch.bfloat16, id="bf16-C72-96"),
    pytest.param(SCRATCH_SHAPES[3], torch.bfloat16, id="bf16-C96-96")])
def test_fused_moment_scratch_has_one_partial_per_block(shape, dtype,
                                                        monkeypatch):
    """The wrapper sizes the moments' scratch [B, tiles, 2, Co] by the
    form's tile (4 x 32 or 8 x 32 pixels): B * tiles * (Co / CB) is the grid
    of fused_blocks, with CB the form's output channels a block, so every
    (tile, channel block) writes its own channels' partials. The
    allocations are recorded and the launch replaced, so no card is
    needed."""
    B, H, W, C, Co = shape
    shapes, launched = [], []
    new_empty = torch.Tensor.new_empty

    def recording_new_empty(self, size, *args, **kwargs):
        shapes.append(tuple(size))
        return new_empty(self, size, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "new_empty", recording_new_empty)
    monkeypatch.setattr(kernels, "check_inputs", lambda *a: None)
    monkeypatch.setattr(kernels, "launch", lambda *a: launched.append(a))
    x = torch.zeros(B, H, W, C, dtype=dtype)
    w, b = torch.zeros(3, 3, C, Co, dtype=dtype), torch.zeros(Co, dtype=dtype)
    fused_conv._launch(x, w, b, None, None, None, False, True)
    name = "conv2d_fused_bf16" if dtype == torch.bfloat16 else "conv2d_fused"
    assert launched and launched[0][0] == name
    assert launched[0][-6:] == (B, H, W, C, Co, 0)
    part = [sh for sh in shapes if len(sh) == 4 and sh[2] == 2]
    assert len(part) == 1 and part[0][0] == B and part[0][3] == Co
    th, tw = FUSED_TILE[dtype]
    assert part[0][1] == -(-H // th) * -(-W // tw)
    assert (B * part[0][1] * (Co // FUSED_CB[dtype][Co])
            == fused_blocks(B, H, W, Co, dtype))
