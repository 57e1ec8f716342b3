"""The bf16 correlation volume's tensor-core kernel, emulated on the CPU.

``csrc/corr_band.cu``'s bf16 form (namespace ``bfc``) forms S = L.R^T of
each image row with mma.sync m16n8k16: exact bf16 products, 16 channels a
k step in channel order (a C that is a multiple of 8 but not of 16 has its
last step half zero-filled), one truncating float32 add per step into the
accumulator and no fold; then the band out[w][d] = S[w][w - d], times 1/C
rounded to float32, rounded to bf16 once (0 where w < d). Here those sums
are emulated in numpy (``test_torch_tf32x3.mma_sum_bf16``) and held within
one bf16 ulp of the plain version and of JAX's ``correlation_volume`` in
bf16 at C = 256 (D = 24 and 96), C = 72, 16 and 8.

The kernel's grid, from ``ops.cost_volume.corr_bf16_plan``: persistent
blocks of 16-pixel warps walking tasks (b, h, tile, span) with the
kernel's index arithmetic, every output (b, h, w, d) written exactly once
and every band entry read from the R slab row that holds pixel w - d, at
W < D, ragged W, D = 50, 96, 256 and 1024 and LowCNN's eval and train
shapes; the plan's choices on a card of 132 SMs; its shared memory within
an SM's; its copy of the kernel's geometry against the source; and the
ptxas report that names each template's registers.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu_torch import kernels, ops  # noqa: E402
from stereoformer_tpu_torch.ops import cost_volume  # noqa: E402
from stereoformer_tpu_torch.ops.cost_volume import (  # noqa: E402
    corr_bf16_plan,
    corr_bf16_smem,
    corr_bf16_span,
)
from test_torch_tf32x3 import H100_SMS, mma_sum_bf16, to_bf16  # noqa: E402

BF16_ULP = 2.0 ** -7
# near 0, where the sums cancel: the float32 sums' own error, relative to
# the largest output (tests/test_torch_kernels.py::F32_SUM_RTOL)
F32_SUM_RTOL = 2.0 ** -20


def kernel_volume(left: np.ndarray, right: np.ndarray, D: int) -> np.ndarray:
    """The volume [B, H, W, D] of bf16-valued float32 features [B, H, W, C]
    as the kernel sums and rounds it."""
    B, H, W, C = left.shape
    rc = np.float32(1) / np.float32(C)
    out = np.zeros((B, H, W, D), np.float32)
    w = np.arange(W)[:, None]
    d = np.arange(D)[None, :]
    inside = w >= d
    for b in range(B):
        for h in range(H):
            s = mma_sum_bf16(left[b, h], right[b, h].T, fold_every=0)
            band = s[w, np.where(inside, w - d, 0)]
            out[b, h] = np.where(inside, to_bf16(band * rc), 0)
    return out


def _within_one_ulp(got: np.ndarray, want: np.ndarray) -> None:
    """Each output within one bf16 ulp of ``want``, or near 0 within
    F32_SUM_RTOL of the largest |want|, as tests/test_torch_kernels.py's
    _bf16_close holds the card."""
    big = np.maximum(np.abs(got), np.abs(want)).clip(1e-30)
    tol = np.maximum(BF16_ULP * np.exp2(np.floor(np.log2(big))),
                     F32_SUM_RTOL * np.abs(want).max())
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("shape,D", [((1, 2, 120, 256), 24),
                                     ((1, 2, 120, 256), 96),
                                     ((2, 2, 57, 72), 24),
                                     ((1, 3, 40, 16), 50),
                                     ((1, 2, 33, 8), 40)],
                         ids=["C256-D24", "C256-D96", "C72-k16-tail",
                              "C16-W<D", "C8-half-k16"])
def test_kernel_sums_hold_one_bf16_ulp_without_a_fold(shape, D):
    """C / 16 truncating adds an output (16 at C = 256), no fold: within
    one bf16 ulp of the plain version (float32 sums, / C, one rounding)
    and of JAX's correlation_volume in bf16."""
    rng = np.random.default_rng(D + shape[3])
    left = to_bf16(rng.standard_normal(shape))
    right = to_bf16(rng.standard_normal(shape))
    got = kernel_volume(left, right, D)
    plain = ops.correlation_volume(torch.from_numpy(left).bfloat16(),
                                   torch.from_numpy(right).bfloat16(), D)
    _within_one_ulp(got, plain.float().numpy())
    want = jax.jit(lambda a, b: jops.correlation_volume(a, b, D))(
        jnp.asarray(left, jnp.bfloat16), jnp.asarray(right, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    _within_one_ulp(got, np.asarray(want, np.float32))


def test_truncating_sums_are_what_the_emulation_adds():
    """The emulation is not the plain sum: its truncating adds move some
    float32 sums by an ulp or more at C = 256."""
    rng = np.random.default_rng(3)
    a = to_bf16(rng.standard_normal((64, 256)))
    b = to_bf16(rng.standard_normal((256, 64)))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert (mma_sum_bf16(a, b, 0) != exact.astype(np.float32)).mean() > 0.1


# ---- the grid ----

def _warp_band(nt: int, span: int) -> np.ndarray:
    """How often each entry [m, dr] of a warp's band tile is written by its
    lanes (g, t) from accumulators j, e (bf16mma.cuh's C fragment), with
    the kernel's d - dspan = m - n + span - 1."""
    band = np.zeros((16, span), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(nt):
            for e in range(4):
                m = g + 8 * (e >> 1)
                n = 8 * j + 2 * t + (e & 1)
                dr = m - n + span - 1
                if 0 <= dr < span:
                    band[m, dr] += 1
    return band


def walk(B, H, W, C, D, plan) -> np.ndarray:
    """The outputs [B * H, W, D] the kernel writes on ``plan``'s grid,
    from its index arithmetic: block i takes tasks i, i + blocks, ...;
    task t is row t // (tiles * spans), tile (rem // spans + row) % tiles,
    span rem % spans; warp g of the task's tile writes pixels w0 + 16 g
    .. + 15 (those inside W) and the span's disparities inside D. Checks
    on the way that every slab row a band entry reads holds R pixel
    w - d and lies in the rows the block stages and loads."""
    nw, span, spans, nt = (plan[k] for k in ("warps", "span", "spans", "nt"))
    tiles, tasks, blocks = plan["tiles"], plan["tasks"], plan["blocks"]
    tw = 16 * nw
    assert (_warp_band(nt, span) == 1).all()
    # the rows the block loads (tw + span - 1, the rest zero-filled) lie in
    # its slab (warp g's n8 tiles, in ldmatrix.x4 pairs, from row 16 g)
    assert tw + span - 1 <= 16 * (nw - 1) + 8 * (nt + nt % 2)
    m, dr = np.arange(16)[:, None], np.arange(span)[None, :]
    count = np.zeros((B * H, W, D), np.int64)
    seen = np.zeros(tasks, np.int64)
    for blk in range(blocks):
        mine = (tasks - blk + blocks - 1) // blocks
        for i in range(mine):
            t = blk + i * blocks
            seen[t] += 1
            row = t // (tiles * spans)
            rem = t % (tiles * spans)
            w0 = ((rem // spans + row) % tiles) * tw
            dspan = (rem % spans) * span
            rbase = w0 - dspan - (span - 1)
            for g in range(nw):
                wb = w0 + 16 * g
                # band entry (m, dr) reads slab row 16 g + n, n = m - dr +
                # span - 1: a row the block loads, R pixel w - d
                n = m - dr + span - 1
                assert ((0 <= n) & (16 * g + n < tw + span - 1)).all()
                assert (rbase + 16 * g + n == (wb + m) - (dspan + dr)).all()
                npx, sv = min(16, W - wb), min(span, D - dspan)
                if npx > 0:
                    count[row, wb:wb + npx, dspan:dspan + sv] += 1
    assert (seen == 1).all()
    return count


GRID_CASES = [((1, 3, 10, 40), 24), ((1, 2, 97, 64), 50),
              ((1, 2, 33, 64), 96), ((1, 2, 300, 16), 256),
              ((1, 2, 70, 32), 1024), ((2, 2, 81, 16), 200),
              ((8, 72, 120, 256), 24), ((4, 40, 80, 256), 24),
              ((8, 72, 120, 256), 96)]
GRID_IDS = ["W<D", "ragged-W-D50", "D96", "D256", "D1024", "two-spans-D200",
            "eval", "train", "eval-D96"]


@pytest.mark.parametrize("shape,D", GRID_CASES, ids=GRID_IDS)
def test_grid_writes_every_output_once(shape, D):
    plan = corr_bf16_plan(*shape, D, H100_SMS)
    assert (walk(*shape, D, plan) == 1).all()


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_every_width_and_a_short_grid_write_every_output_once(warps):
    """Any width, on a grid of a third of the tasks (each block walks
    three), as tests/test_torch_kernels.py launches them on the card."""
    shape, D = (2, 3, 77, 72), 24
    plan = dict(corr_bf16_plan(*shape, D, H100_SMS, warps))
    plan["blocks"] = max(1, plan["tasks"] // 3)
    assert (walk(*shape, D, plan) == 1).all()


def test_spans_split_d_as_the_kernel_takes_it():
    """One span of D up to 129 (16 + D - 1 R columns in 18 n8 tiles), else
    spans of a multiple of 8 up to 128; each span fits its template."""
    for D in range(1, 1025):
        span, spans, nt = corr_bf16_span(D)
        assert spans == -(-D // span) and (spans - 1) * span < D
        assert nt in cost_volume.BF16_NT and 16 + span - 1 <= 8 * nt
        if spans > 1:
            assert span % 8 == 0 and span <= cost_volume.BF16_MAX_SPAN
        else:
            assert span == D


def test_plan_fills_the_card():
    """On 132 SMs: each eval shape's grid is one whole wave of resident
    blocks (blocks = 132 per_sm, at least two a SM), whose busiest SM
    takes ceil(tasks / 132) tasks, the least it can (the round-robin walk
    gives SM s the tasks s, s + 132, ...); D = 96 takes whole rows (8
    warps: its R slab is read once a row, where 4-warp tiles restage 1.5x
    of it) and leaves a partial last task on 48 of the 132 SMs. The train
    shape's 480 blocks put 3 or 4 blocks on every SM, all resident at
    once. Every grid keeps at least two blocks on an SM."""
    for D, warps in ((24, 4), (96, 8)):
        plan = corr_bf16_plan(8, 72, 120, 256, D, H100_SMS)
        assert plan["warps"] == warps and plan["per_sm"] >= 2
        assert plan["blocks"] == H100_SMS * plan["per_sm"]
        tasks_on = np.bincount(np.arange(plan["tasks"]) % plan["blocks"]
                               % H100_SMS)
        assert tasks_on.max() == -(-plan["tasks"] // H100_SMS)
    plan = corr_bf16_plan(4, 40, 80, 256, 24, H100_SMS)
    assert plan["blocks"] == plan["tasks"] <= H100_SMS * plan["per_sm"]
    assert 3 * H100_SMS <= plan["blocks"] <= 4 * H100_SMS
    for shape, D in GRID_CASES:
        assert corr_bf16_plan(*shape, D, H100_SMS)["per_sm"] >= 2


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_shared_memory_fits_an_sm(warps):
    """Every span's block of any width fits the H100's 227 KB a block, and
    its warps' band tiles (16 rows of the span rounded up to an odd
    multiple of 8) fit the ring slot they take."""
    for D in (1, 24, 25, 49, 50, 96, 97, 129, 1024):
        span, _, nt = corr_bf16_span(D)
        smem = corr_bf16_smem(warps, nt)
        assert smem <= 227 * 1024
        stage = smem // cost_volume.corr_bf16_ring(nt)[1]
        assert warps * 16 * ((-(-span // 8) * 8) | 8) * 2 <= stage


def test_plan_holds_the_kernels_geometry():
    """ops/cost_volume.py's copy of csrc/corr_band.cu's bf16 geometry: the
    stage's channels, the ring's stages, the templates, the widest span
    and the band's rows."""
    src = (kernels.CSRC / "corr_band.cu").read_text()
    bfc = src[src.index("namespace bfc {"):]
    assert int(re.search(r"constexpr int KC = (\d+);", bfc).group(1)) == (
        cost_volume.BF16_KC)
    assert int(re.search(r"constexpr int MAX_SPAN = (\d+);", bfc).group(1)) \
        == cost_volume.BF16_MAX_SPAN
    le, a, b = map(int, re.search(
        r"constexpr int stages\(int nt\) \{ return nt <= (\d+) \? (\d+) : "
        r"(\d+); \}", bfc).groups())
    for nt in cost_volume.BF16_NT:
        assert cost_volume.corr_bf16_ring(nt) == (
            cost_volume.BF16_KC, a if nt <= le else b)
    assert sorted(set(map(int, re.findall(r"launch_nt<(\d+)>", bfc)))) == \
        list(cost_volume.BF16_NT)
    assert "return ((span + 7) & ~7) | 8;" in bfc


def test_ptxas_report_names_each_template():
    """kernels.parse_ptxas reads nvcc's -Xptxas -v report (as the build
    log keeps it, and the probe's variant builds give it) by entry, the
    bf16 templates by their n8 tiles."""
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN3bfc21corr_band_bf16_"
        f"kernelILi{nt}EEEvPK13__nv_bfloat16S3_PS1_iiiiiii' for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN3bfc21corr_band_bf16_"
        f"kernelILi{nt}EEEvPK13__nv_bfloat16S3_PS1_iiiiiii\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
        f"spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers"
        for nt, regs, spill in ((18, 128, 8), (5, 63, 0)))
    assert kernels.parse_ptxas(log) == {
        "corr_band_bf16_kernel<18>": {"registers": 128, "spill_stores": 8,
                                      "spill_loads": 8},
        "corr_band_bf16_kernel<5>": {"registers": 63, "spill_stores": 0,
                                     "spill_loads": 0}}
