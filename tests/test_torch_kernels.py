"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card and
skips with a reason where there is none. Run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels.py`` (the suite's
conftest sets up JAX, which the card's machine need not have).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from stereoformer_tpu_torch import ops  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 dot products over C in another order than the plain version's
CORR_TOL = 1e-5
# disparities up to ~26 px; exp and division in another order
LOCAL_TOL = 1e-4
# gradients of O(1) cotangents times candidates up to ~26 px, summed in
# another order than the plain version's dense [S, D] contraction
LOCAL_BWD_TOL = 1e-4
# past the old kernels' limits (D > 48 or S > 32) candidates reach D + 2 px
# and values and gradients grow with them, so both are held relative to
# each output's largest magnitude (the two absolute tolerances above are
# ~5e-6 and ~1.5e-5 of it at the main path's D = 24, S = 21; the kernels'
# order, emulated in tests/test_torch_refine_kernels.py, stays within
# 3e-7 of it up to D = 256, S = 128)
LOCAL_REL_TOL = 5e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _randn(rng, shape, device):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)


def _edge_candidates(rng, shape, device, D=24):
    cands = rng.uniform(-2, D + 2, shape).astype(np.float32)
    special = np.array([0.0, D - 1.0, 5.0, 4.5, 6.0, -1.0, D, 11.0],
                       np.float32)
    pick = rng.random(shape) < 0.3
    cands[pick] = rng.choice(special, size=int(pick.sum()))
    return torch.from_numpy(cands).to(device)


@pytest.mark.parametrize("shape", [(2, 8, 120, 256), (1, 3, 10, 40),
                                   (1, 2, 97, 36), (1, 2, 300, 64)],
                         ids=["main-width", "W<D", "ragged-W-C", "W>tile"])
def test_corr_band_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(0)
    left = _randn(rng, shape, cuda_device)
    right = _randn(rng, shape, cuda_device)
    got = ops.correlation_volume(left, right, 24)
    want = ops.correlation_volume_plain(left, right, 24)
    torch.cuda.synchronize()
    assert got.shape == shape[:3] + (24,)
    torch.testing.assert_close(got, want, rtol=0, atol=CORR_TOL)


@pytest.mark.parametrize("shape", [(2, 72, 120), (1, 7, 19)],
                         ids=["main-width", "ragged-N"])
def test_local_soft_argmin_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(1)
    vol = _randn(rng, shape + (24,), cuda_device)
    cands = _edge_candidates(rng, shape + (21,), cuda_device)
    got = ops.local_soft_argmin(vol, cands)
    want = ops.local_soft_argmin_plain(vol, cands)
    torch.cuda.synchronize()
    assert got.shape == shape + (1,)
    torch.testing.assert_close(got, want, rtol=0, atol=LOCAL_TOL)


@pytest.mark.parametrize("shape,D", [((2, 8, 120, 256), 50),
                                     ((1, 3, 40, 64), 96),
                                     ((1, 2, 97, 36), 96),
                                     ((1, 2, 300, 64), 256)],
                         ids=["D50", "W<D96", "ragged-W-D96", "D256"])
def test_corr_band_matches_plain_past_the_old_limit(cuda_device, shape, D):
    """D > 64, where the old kernel refused: spans of 32 disparities in
    further blocks, a W below D and a W that no 32-pixel tile divides."""
    rng = np.random.default_rng(8)
    left = _randn(rng, shape, cuda_device)
    right = _randn(rng, shape, cuda_device)
    got = ops.correlation_volume(left, right, D)
    want = ops.correlation_volume_plain(left, right, D)
    torch.cuda.synchronize()
    assert got.shape == shape[:3] + (D,)
    torch.testing.assert_close(got, want, rtol=0, atol=CORR_TOL)


@pytest.mark.parametrize("shape,D,S", [((2, 9, 37), 50, 21),
                                       ((2, 9, 37), 50, 33),
                                       ((2, 9, 37), 96, 33),
                                       ((2, 9, 37), 256, 128),
                                       ((4, 72, 120), 96, 33),
                                       ((8, 72, 120), 96, 33)],
                         ids=["D50-S21", "D50-S33", "D96-S33", "D256-S128",
                              "2-lanes-D96", "1-lane-D96"])
def test_local_soft_argmin_matches_plain_past_the_old_limits(cuda_device,
                                                             shape, D, S):
    """Forward and backward kernels where the old ones refused (D > 48 or
    S > 32), with edge candidates, relative to each output's largest
    magnitude (LOCAL_REL_TOL); the kernels take 4, 2 or 1 lanes a pixel
    by the pixel count."""
    rng = np.random.default_rng(9)
    vol = _randn(rng, shape + (D,), cuda_device).requires_grad_(True)
    cands = _edge_candidates(rng, shape + (S,), cuda_device, D)
    cands.requires_grad_(True)
    g = _randn(rng, shape + (1,), cuda_device)
    out = ops.local_soft_argmin(vol, cands)
    out.backward(g)
    want = ops.local_soft_argmin_plain(vol.detach(), cands.detach())
    want_v, want_c = ops.local_soft_argmin_backward_plain(
        vol.detach(), cands.detach(), g)
    torch.cuda.synchronize()
    for got, w in ((out, want), (vol.grad, want_v), (cands.grad, want_c)):
        torch.testing.assert_close(
            got, w, rtol=0, atol=LOCAL_REL_TOL * w.abs().max().item())


@pytest.mark.parametrize("D,S", [(24, 21), (96, 33)])
def test_local_soft_argmin_backward_is_deterministic(cuda_device, D, S):
    """No atomics: a second call gives the same bits."""
    rng = np.random.default_rng(10)
    shape = (4, 40, 80)
    vol = _randn(rng, shape + (D,), cuda_device).requires_grad_(True)
    cands = _edge_candidates(rng, shape + (S,), cuda_device, D)
    cands.requires_grad_(True)
    g = _randn(rng, shape + (1,), cuda_device)
    out = ops.local_soft_argmin(vol, cands)
    first = torch.autograd.grad(out, (vol, cands), g, retain_graph=True)
    second = torch.autograd.grad(out, (vol, cands), g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_lowcnn_gru_with_a_wide_range_matches_the_cpu(cuda_device):
    """LowCNN_gru(max_disp=400, num_samples=32), D = 50 and S = 33, which
    the old kernels refused: eval on the card against the port on the CPU
    at 64x256, 12 GRU steps, TF32 off, the same seeded weights with the
    convs scaled as chip_smoke.py's ``moderate_weights`` scales them (so
    the softmaxes are neither flat nor one-hot)."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(11)
    left, right = (torch.from_numpy(rng.standard_normal(
        (2, 64, 256, 3)).astype(np.float32)) for _ in range(2))
    kw = dict(max_disp=400, num_samples=32)
    cpu = get_model("LowCNN_gru", device="cpu", **kw)
    cpu.load_state_dict({k: v * np.sqrt(1.25 / 2.0) if v.dim() == 4 else v
                         for k, v in cpu.state_dict().items()})
    card = get_model("LowCNN_gru", device=cuda_device, **kw)
    card.load_state_dict(cpu.state_dict())
    n = ops.local_soft_argmin.launches
    with torch.inference_mode():
        want = cpu(left, right, iters=12)
        got = card(left.to(cuda_device), right.to(cuda_device), iters=12)
    torch.backends.cudnn.allow_tf32 = True
    assert ops.local_soft_argmin.launches == n + 12
    # float32 on both sides, sums in other orders (chip_smoke.py's parity
    # phase): 1e-3 px at the volume's soft-argmin, 5e-3 after the GRU steps
    torch.testing.assert_close(got["disp_low"].cpu(), want["disp_low"],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(got["disparities"][-1].cpu(),
                               want["disparities"][-1], rtol=0, atol=5e-3)


def test_cross_attention_eval_matches_the_cpu(cuda_device):
    """CrossAttentionStereo (the registry's widths) on the card against the
    port on the CPU at 64x256, 12 GRU steps, TF32 off, moderate seeded
    weights as above: local_soft_argmin launched once a step, corr_band
    never; the disparities within the tolerances above."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    left, right = (torch.from_numpy(rng.standard_normal(
        (2, 64, 256, 3)).astype(np.float32)) for _ in range(2))
    cpu = get_model("CrossAttentionStereo", device="cpu")
    cpu.load_state_dict({k: v * np.sqrt(1.25 / 2.0) if v.dim() == 4 else v
                         for k, v in cpu.state_dict().items()})
    card = get_model("CrossAttentionStereo", device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    n_local = ops.local_soft_argmin.launches
    n_corr = ops.correlation_volume.launches
    with torch.inference_mode():
        want = cpu(left, right, iters=12)
        got = card(left.to(cuda_device), right.to(cuda_device), iters=12)
    torch.backends.cudnn.allow_tf32 = True
    assert ops.local_soft_argmin.launches == n_local + 12
    assert ops.correlation_volume.launches == n_corr
    torch.testing.assert_close(got["disp_low"].cpu(), want["disp_low"],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(got["disparities"][-1].cpu(),
                               want["disparities"][-1], rtol=0, atol=5e-3)


def test_cli_evaluate_on_the_card_matches_the_cpu(cuda_device, capsys):
    """cli.evaluate --device cuda on dummy (8 pairs at 64x128, 2 GRU
    iterations, random seeded weights, TF32 off) against --device cpu:
    corr_band once and local_soft_argmin twice a batch; EPE within 1e-3 px,
    P1 and D1 within 1e-3 (a pixel within rounding of a threshold may fall
    either way)."""
    from stereoformer_tpu_torch.cli import evaluate

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ["--dataset", "dummy", "--crop_h", "64", "--crop_w", "128",
            "--iters", "2", "--workers", "0", "--test_batch", "4"]
    want = evaluate.main(args + ["--device", "cpu"])
    n_corr = ops.correlation_volume.launches
    n_local = ops.local_soft_argmin.launches
    got = evaluate.main(args + ["--device", "cuda"])
    torch.backends.cudnn.allow_tf32 = True
    assert ops.correlation_volume.launches == n_corr + 2
    assert ops.local_soft_argmin.launches == n_local + 4
    assert got["images"] == want["images"] == 8
    assert abs(got["EPE"] - want["EPE"]) <= 1e-3, (got, want)
    for k in ("P1", "D1"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got, want)


def test_wrappers_count_launches(cuda_device):
    rng = np.random.default_rng(2)
    feat = _randn(rng, (1, 4, 40, 32), cuda_device)
    n_corr = ops.correlation_volume.launches
    n_local = ops.local_soft_argmin.launches
    vol = ops.correlation_volume(feat, feat, 24)
    ops.local_soft_argmin(vol, _edge_candidates(rng, (1, 4, 40, 21),
                                                cuda_device))
    assert ops.correlation_volume.launches == n_corr + 1
    assert ops.local_soft_argmin.launches == n_local + 1


def test_backward_counts_its_launches(cuda_device):
    rng = np.random.default_rng(6)
    vol = _randn(rng, (1, 4, 40, 24), cuda_device).requires_grad_(True)
    cands = _edge_candidates(rng, (1, 4, 40, 21), cuda_device)
    n_fwd = ops.local_soft_argmin.launches
    n_bwd = ops.local_soft_argmin.backward_launches
    disp = ops.local_soft_argmin(vol, cands)
    assert ops.local_soft_argmin.backward_launches == n_bwd
    disp.sum().backward()
    assert ops.local_soft_argmin.launches == n_fwd + 1
    assert ops.local_soft_argmin.backward_launches == n_bwd + 1


@pytest.mark.parametrize("shape", [(4, 40, 80), (2, 72, 120), (1, 7, 19)],
                         ids=["train-width", "eval-width", "ragged-N"])
def test_local_soft_argmin_backward_matches_plain(cuda_device, shape):
    """The backward kernel against the closed form, with edge candidates
    (integers, the clip bounds, values beyond them)."""
    rng = np.random.default_rng(3)
    vol = _randn(rng, shape + (24,), cuda_device).requires_grad_(True)
    cands = _edge_candidates(rng, shape + (21,), cuda_device)
    cands.requires_grad_(True)
    g = _randn(rng, shape + (1,), cuda_device)
    n = ops.local_soft_argmin.backward_launches
    ops.local_soft_argmin(vol, cands).backward(g)
    want_v, want_c = ops.local_soft_argmin_backward_plain(
        vol.detach(), cands.detach(), g)
    torch.cuda.synchronize()
    assert ops.local_soft_argmin.backward_launches == n + 1
    torch.testing.assert_close(vol.grad, want_v, rtol=0, atol=LOCAL_BWD_TOL)
    torch.testing.assert_close(cands.grad, want_c, rtol=0, atol=LOCAL_BWD_TOL)


def test_corr_band_backward_matches_plain_autograd(cuda_device):
    rng = np.random.default_rng(5)
    left = _randn(rng, (2, 5, 40, 64), cuda_device).requires_grad_(True)
    right = _randn(rng, (2, 5, 40, 64), cuda_device).requires_grad_(True)
    g = _randn(rng, (2, 5, 40, 24), cuda_device)
    ops.correlation_volume(left, right, 24).backward(g)
    got = (left.grad, right.grad)
    left.grad = right.grad = None
    ops.correlation_volume_plain(left, right, 24).backward(g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], left.grad, rtol=0, atol=CORR_TOL)
    torch.testing.assert_close(got[1], right.grad, rtol=0, atol=CORR_TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.default_rng(4)
    feat = _randn(rng, (1, 2, 30, 16), cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ops.correlation_volume(feat.double(), feat.double(), 24)
    with pytest.raises(ValueError, match="contiguous"):
        ops.correlation_volume(feat.transpose(1, 2), feat.transpose(1, 2), 24)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.correlation_volume(feat, feat.cpu(), 24)
    odd = _randn(rng, (1, 2, 30, 18), cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.correlation_volume(odd, odd, 24)
    with pytest.raises(ValueError, match="max_disp <= 1024"):
        ops.correlation_volume(feat, feat, 1025)
    flat = _randn(rng, (2 * 30 * 16 + 1,), cuda_device)
    shifted = flat[1:].view(1, 2, 30, 16)     # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.correlation_volume(shifted, shifted, 24)
    vol = _randn(rng, (1, 2, 30, 24), cuda_device)
    with pytest.raises(ValueError, match="S <= 128"):
        ops.local_soft_argmin(vol, _randn(rng, (1, 2, 30, 129), cuda_device))
    with pytest.raises(ValueError, match="D <= 1024"):
        ops.local_soft_argmin(_randn(rng, (1, 2, 30, 1025), cuda_device),
                              _randn(rng, (1, 2, 30, 21), cuda_device))


# float32 sums of 9*C products: the kernel's 3xTF32 products (each operand
# split into a TF32 big and small part) summed per 8-channel chunk on the
# tensor cores and folded into float32 totals, against cuDNN with TF32 off,
# and fmaf in the prologue against a multiply and an add; relative to the
# output's largest magnitude
CONV_RTOL = 1e-5
# the moments, relative to each moment's magnitude: the kernel sums per
# block in float32 and across blocks in float64, the plain version in float64
MOMENT_RTOL = 1e-5


def _conv_inputs(rng, shape, device):
    B, H, W, C, Co = shape
    x = _randn(rng, (B, H, W, C), device)
    w = _randn(rng, (3, 3, C, Co), device) / (9 * C) ** 0.5
    b = 0.1 * _randn(rng, (Co,), device)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, (B, C)).astype(np.float32)
                         ).to(device)
    t = 0.5 * _randn(rng, (B, C), device)
    r = _randn(rng, (B, H, W, Co), device)
    return x, w, b, s, t, r


@pytest.mark.parametrize("shape", [(2, 64, 120, 64, 64), (1, 37, 53, 96, 96),
                                   (2, 19, 40, 64, 64), (1, 9, 33, 96, 96),
                                   (1, 35, 70, 64, 64)],
                         ids=["main-width", "edge-C96", "H-tail-C64",
                              "tails-C96", "tails-4x32-C64"])
@pytest.mark.parametrize("variant", ["res-relu", "bare", "prologue",
                                     "stats", "prologue-stats"])
def test_conv2d_fused_matches_plain(cuda_device, shape, variant):
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(7)
    x, w, b, s, t, r = _conv_inputs(rng, shape, cuda_device)
    kw = {"res-relu": dict(residual=r, relu=True), "bare": {},
          "prologue": dict(s=s, t=t, relu=True),
          "stats": dict(with_stats=True),
          "prologue-stats": dict(s=s, t=t, with_stats=True)}[variant]
    n = ops.conv2d_fused.launches
    if "s" in kw and kw.get("with_stats"):
        got = ops.conv2d_fused_prologue_stats(x, w, b, s, t)
    elif kw.get("with_stats"):
        got = ops.conv2d_fused_stats(x, w, b)
    elif "s" in kw:
        got = ops.conv2d_fused_prologue(x, w, b, s, t, True)
    else:
        got = ops.conv2d_fused(x, w, b, kw.get("residual"),
                               kw.get("relu", False))
    want = ops.conv3x3_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    assert ops.conv2d_fused.launches == n + 1
    if not kw.get("with_stats"):
        got, want = (got,), (want,)
    y_tol = CONV_RTOL * want[0].abs().max().item()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=y_tol)
    for g, m in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, m, rtol=MOMENT_RTOL,
                                   atol=MOMENT_RTOL * m.abs().max().item())


def test_conv2d_fused_is_deterministic(cuda_device):
    """The moments are reduced without atomics, in a fixed order: two
    calls on the same inputs give the same bits in y, S1 and S2."""
    rng = np.random.default_rng(11)
    for shape in ((2, 35, 70, 64, 64), (1, 37, 53, 96, 96)):
        x, w, b, s, t, _ = _conv_inputs(rng, shape, cuda_device)
        first = ops.conv2d_fused_prologue_stats(x, w, b, s, t)
        second = ops.conv2d_fused_prologue_stats(x, w, b, s, t)
        torch.cuda.synchronize()
        for a, c in zip(first, second):
            assert torch.equal(a, c)


def test_conv2d_fused_prologue_padding_is_zero(cuda_device):
    """x = 0, s = t = w = 1: the output counts its in-image taps."""
    B, H, W, C, Co = 2, 11, 40, 64, 64
    x = torch.zeros(B, H, W, C, device=cuda_device)
    y = ops.conv2d_fused_prologue(
        x, torch.ones(3, 3, C, Co, device=cuda_device),
        torch.zeros(Co, device=cuda_device), torch.ones(B, C, device=cuda_device),
        torch.ones(B, C, device=cuda_device))
    taps = torch.full((H, W), 9.0)
    taps[0, :] = taps[-1, :] = taps[:, 0] = taps[:, -1] = 6.0
    taps[0, 0] = taps[0, -1] = taps[-1, 0] = taps[-1, -1] = 4.0
    want = (C * taps)[None, ..., None].expand(B, H, W, Co)
    torch.testing.assert_close(y.cpu(), want, rtol=0, atol=0)


def test_conv2d_fused_rejects_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.default_rng(8)
    x, w, b, s, t, r = _conv_inputs(rng, (1, 8, 16, 64, 64), cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.conv2d_fused(x[..., :60].contiguous(), w[:, :, :60].contiguous(),
                         b)
    with pytest.raises(ValueError, match="Co in"):
        ops.conv2d_fused(x, w[..., :48].contiguous(), b[:48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.conv2d_fused(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="s and t"):
        ops.conv2d_fused_prologue(x, w, b, s[:, :32].contiguous(),
                                  t[:, :32].contiguous())
    with pytest.raises(ValueError, match="Co in"):
        ops.conv2d_dw(x, r[..., :32].contiguous())
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.conv2d_dw(x[..., :60].contiguous(), r)
    with pytest.raises(ValueError, match="contiguous"):
        ops.conv2d_dw(x.transpose(1, 2), r.transpose(1, 2))


# dw sums B*H*W products per element: float32 partial sums of a block's
# pixels added in float64, against float64 sums; relative to the largest
# |dw|
DW_RTOL = 1e-5


# C other than Co: RAFT's 64 -> 96 layer2 entry at downsample=1 (the
# context net's, B=4 at 320x720), its reverse, and C no multiple of the
# 32-channel chunk (the last chunk zero-filled)
@pytest.mark.parametrize("shape", [(2, 64, 120, 64, 64), (1, 37, 53, 96, 96),
                                   (2, 19, 40, 64, 64), (1, 9, 33, 96, 96),
                                   (4, 160, 360, 96, 96),
                                   (4, 320, 720, 64, 96), (1, 37, 53, 96, 64),
                                   (2, 19, 40, 72, 64), (1, 9, 33, 88, 96)],
                         ids=["main-width", "edge-C96", "H-tail-C64",
                              "tails-C96", "raft-cnet-layer2",
                              "raft-ds1-cnet-layer2-entry", "C96-Co64",
                              "C72-Co64", "C88-Co96"])
def test_conv2d_dw_matches_plain(cuda_device, shape):
    B, H, W, C, Co = shape
    rng = np.random.default_rng(9)
    x = _randn(rng, (B, H, W, C), cuda_device)
    g = _randn(rng, (B, H, W, Co), cuda_device)
    n = ops.conv2d_dw.launches
    got = ops.conv2d_dw(x, g)
    want = ops.conv2d_dw_plain(x.double(), g.double())
    torch.cuda.synchronize()
    assert ops.conv2d_dw.launches == n + 1
    assert got.shape == (3, 3, C, Co) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=DW_RTOL * want.abs().max().item())


def test_conv2d_dw_is_deterministic(cuda_device):
    """The partials are summed in a fixed order: two calls on the same
    inputs give the same bits."""
    rng = np.random.default_rng(10)
    for C in (64, 96):
        x = _randn(rng, (2, 40, 90, C), cuda_device)
        g = _randn(rng, (2, 40, 90, C), cuda_device)
        first = ops.conv2d_dw(x, g)
        second = ops.conv2d_dw(x, g)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


# the backward's gradients against autograd of the plain version on
# float64 copies (cuDNN's float32 weight gradient is itself less exact than
# the kernel's at large shapes), norm-wise relative to the plain gradient:
# float32 sums (the CPU measures 6.6e-7 against JAX)
BWD_RTOL = 1e-5
# and elementwise, relative to the largest magnitude
BWD_ATOL = 2e-5
_BWD_VARIANTS = {"bare": (False, False, False, False),
                 "res-relu": (True, False, False, True),
                 "prologue-linear": (False, True, False, False),
                 "prologue-relu": (False, True, False, True),
                 "stats": (False, False, True, False),
                 "prologue-stats": (False, True, True, False)}


@pytest.mark.parametrize("shape", [(2, 64, 120, 64, 64), (1, 19, 53, 96, 96),
                                   (1, 19, 53, 64, 96)],
                         ids=["main-width", "tails-C96", "C64-Co96"])
@pytest.mark.parametrize("variant", list(_BWD_VARIANTS))
def test_conv2d_fused_backward_matches_plain_autograd(cuda_device, shape,
                                                      variant):
    """The backward on the card (dx on conv2d_fused, dw on conv2d_dw, the
    rest torch ops) against autograd of conv3x3_plain, from a loss that
    uses y and both moments. With an output ReLU the reference applies the
    kernel's mask (y > 0) to its pre-activation: an output within float32
    rounding of 0 would else pass its gradient on one side and block it on
    the other."""
    torch.backends.cudnn.allow_tf32 = False
    res, pro, stats, relu = _BWD_VARIANTS[variant]
    rng = np.random.default_rng(10)
    x, w, b, s, t, r = _conv_inputs(rng, shape, cuda_device)
    B, H, W, C, Co = shape
    cy = _randn(rng, (B, H, W, Co), cuda_device)
    c1 = 0.1 * _randn(rng, (B, Co), cuda_device)
    c2 = 0.01 * _randn(rng, (B, Co), cuda_device)
    inputs = {"x": x, "w": w, "b": b}
    if res:
        inputs["r"] = r
    if pro:
        inputs.update(s=s, t=t)

    def grads(fn, dtype=torch.float32, mask=None):
        v = {k: a.detach().to(dtype, copy=True).requires_grad_(True)
             for k, a in inputs.items()}
        out = fn(v["x"], v["w"], v["b"], v.get("r"), relu and mask is None,
                 v.get("s"), v.get("t"), stats)
        y = out[0] if stats else out
        if mask is not None:
            out = y * mask
        if stats:
            loss = ((out[0] * cy).sum() + (out[1] * c1).sum()
                    + (out[2] * c2).sum())
        else:
            loss = (out * cy).sum()
        return y.detach(), dict(zip(v, torch.autograd.grad(
            loss, list(v.values()))))

    n = ops.conv2d_fused.launches, ops.conv2d_dw.launches
    y, got = grads(ops.fused_conv.conv3x3_fused)
    torch.cuda.synchronize()
    # the forward and the dx conv; one dw
    assert (ops.conv2d_fused.launches, ops.conv2d_dw.launches) == (
        n[0] + 2, n[1] + 1)
    _, want = grads(ops.conv3x3_plain, torch.float64,
                    (y > 0).double() if relu else None)
    torch.backends.cudnn.allow_tf32 = True
    for k, wk in want.items():
        err = ((got[k].double() - wk).norm() / wk.norm()).item()
        assert err <= BWD_RTOL, (k, err)
        torch.testing.assert_close(got[k].double(), wk, rtol=0,
                                   atol=BWD_ATOL * wk.abs().max().item())


def test_gpu_backward_runs_the_kernels_and_skips_what_needs_no_grad(
        cuda_device):
    """x needs no gradient: the backward launches no dx conv, only dw; with
    x needing one it launches both."""
    rng = np.random.default_rng(11)
    x, w, b, _, _, _ = _conv_inputs(rng, (1, 8, 40, 64, 64), cuda_device)
    wg = w.clone().requires_grad_(True)
    n = ops.conv2d_fused.launches, ops.conv2d_dw.launches
    ops.conv2d_fused(x, wg, b).sum().backward()
    torch.cuda.synchronize()
    assert (ops.conv2d_fused.launches, ops.conv2d_dw.launches) == (
        n[0] + 1, n[1] + 1)
    xg = x.clone().requires_grad_(True)
    ops.conv2d_fused(xg, wg, b).sum().backward()
    torch.cuda.synchronize()
    assert (ops.conv2d_fused.launches, ops.conv2d_dw.launches) == (
        n[0] + 3, n[1] + 2)
    assert xg.grad is not None and b.grad is None


# deform_sample: float32 sums of K taps x 4 corners x C products (the
# contraction in 3xTF32, each tap's sum folded into a float32 total)
# against float64; relative to the output's largest magnitude
DEFORM_RTOL = 1e-5
# shape (B, H, W, C, Co), padding, dilation, offset scale or "integer",
# window, kernel size
DEFORM_CASES = {
    "train-width": ((4, 40, 80, 16, 16), 1, 1, 1.8, 2, 3),
    "eval-width": ((2, 72, 120, 16, 16), 1, 1, 1.8, 2, 3),
    "odd-W-Co6": ((2, 13, 17, 8, 6), 1, 1, 1.8, 2, 3),
    "dilation-2": ((1, 19, 37, 16, 16), 2, 2, 1.8, 2, 3),
    "beyond-window": ((1, 24, 40, 16, 16), 1, 1, 5.0, 2, 3),
    "integer": ((1, 24, 40, 16, 16), 1, 1, "integer", 2, 3),
    "Co-32": ((1, 24, 40, 16, 32), 1, 1, 1.8, 2, 3),
    # C over several 16-channel chunks, Co over several 32-channel blocks
    "C64-window-1": ((2, 24, 40, 64, 64), 1, 1, 1.3, 1, 3),
    "C128-window-3": ((1, 24, 40, 128, 128), 1, 1, 3.5, 3, 3),
    "window-8": ((1, 30, 50, 16, 16), 1, 1, 9.0, 8, 3),
    # one row's halo too wide for shared memory: corners from device memory
    "window-24-no-halo": ((1, 12, 40, 16, 16), 1, 1, 26.0, 24, 3),
    # tile edges: one column past a 32-column tile, rows no tile divides
    "tile-edges": ((3, 17, 33, 16, 16), 1, 1, 1.8, 2, 3),
    "C40-Co24": ((2, 20, 50, 40, 24), 1, 1, 1.8, 2, 3),
    # C and Co no multiple of 4: 4-byte copies and scalar stores
    "C6-Co5": ((2, 13, 17, 6, 5), 1, 1, 1.8, 2, 3),
    # 25 taps: the weight staged in groups of taps
    "k5-Co32": ((1, 20, 40, 8, 32), 2, 1, 1.8, 2, 5),
}


def _deform_inputs(rng, shape, scale, device, k=3):
    B, H, W, C, Co = shape
    K = k * k
    x = _randn(rng, (B, H, W, C), device)
    if scale == "integer":
        off = rng.choice(np.array([0.0, 0.0, 1.0, -1.0, 2.0, -2.0, 3.0]),
                         size=(B, H, W, K, 2)).astype(np.float32)
    else:
        off = (rng.random((B, H, W, K, 2)) * 2 * scale - scale).astype(
            np.float32)
    mask = torch.from_numpy(rng.random((B, H, W, K)).astype(np.float32))
    w = _randn(rng, (K * C, Co), device) / np.sqrt(K * C)
    return x, torch.from_numpy(off).to(device), mask.to(device), w


@pytest.mark.parametrize("case", list(DEFORM_CASES))
def test_deform_sample_matches_plain(cuda_device, case):
    """The fused kernel against the plain windowed form on float64 copies,
    one launch per call, and the same bits on a second call."""
    shape, pad, dil, scale, window, k = DEFORM_CASES[case]
    rng = np.random.default_rng(12)
    x, off, mask, w = _deform_inputs(rng, shape, scale, cuda_device, k)
    n = ops.deform_conv_fused.launches
    got = ops.deform_conv_fused(x, off, mask, w, k, pad, dil, window)
    again = ops.deform_conv_fused(x, off, mask, w, k, pad, dil, window)
    torch.cuda.synchronize()
    assert ops.deform_conv_fused.launches == n + 2
    assert torch.equal(got, again)
    want = ops.modulated_deform_conv_windowed(
        x.double(), off.double(), mask.double(), w.double(), kernel_size=k,
        padding=pad, dilation=dil, window=window)
    Ho = shape[1] + 2 * pad - dil * (k - 1)
    Wo = shape[2] + 2 * pad - dil * (k - 1)
    assert got.shape == want.shape == (shape[0], Ho, Wo, shape[4])
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=DEFORM_RTOL * want.abs().max().item())


@pytest.mark.parametrize("rows,mt,ts", [(1, 2, 1), (3, 2, 2), (8, 2, 1),
                                        (1, 1, 3), (4, 1, 2), (8, 1, 1)])
@pytest.mark.parametrize("halo", [True, False])
@pytest.mark.parametrize("case", ["C40-Co24", "C6-Co5", "k5-Co32",
                                  "eval-width"])
def test_deform_sample_every_tiling_matches_plain(cuda_device, case, rows,
                                                  mt, ts, halo):
    """The kernel under tilings the C entry does not pick for these shapes:
    1 to 8 rows a tile, 32 or 16 pixels a warp, the taps in 1 to 3 slices,
    the halo staged or the corners read from device memory."""
    from stereoformer_tpu_torch.ops.deform import deform_sample_launch

    shape, pad, dil, scale, window, k = DEFORM_CASES[case]
    rng = np.random.default_rng(18)
    x, off, mask, w = _deform_inputs(rng, shape, scale, cuda_device, k)
    plan = dict(rows=rows, mt=mt, ts=ts, halo=int(halo))
    got = deform_sample_launch(x, off, mask, w, k, pad, dil, window, plan)
    torch.cuda.synchronize()
    assert (plan["rows"], plan["mt"], plan["ts"], plan["halo"]) == (
        rows, mt, ts, int(halo))
    want = ops.modulated_deform_conv_windowed(
        x.double(), off.double(), mask.double(), w.double(), kernel_size=k,
        padding=pad, dilation=dil, window=window)
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=DEFORM_RTOL * want.abs().max().item())


# the H100's shared memory a block can take
SMEM_MAX = 232448


@pytest.mark.parametrize("C,Co,k,dil,R", [
    (16, 16, 3, 1, 2), (128, 128, 3, 1, 8), (16, 16, 3, 1, 20),
    (16, 16, 3, 1, 60), (8, 6, 7, 3, 2), (64, 32, 11, 1, 1)])
def test_deform_sample_plan_fits_shared_memory(cuda_device, C, Co, k, dil,
                                               R):
    """Any k, dilation and window gets a tiling within the H100's shared
    memory, and the launch is taken: tiles shrink, and the halo goes only
    where one row's would not fit."""
    from stereoformer_tpu_torch.ops.deform import deform_sample_launch

    rng = np.random.default_rng(19)
    x, off, mask, w = _deform_inputs(rng, (2, 72, 120, C, Co), 1.8,
                                     cuda_device, k)
    Ho, Wo = 72 + 2 - dil * (k - 1), 120 + 2 - dil * (k - 1)
    off, mask = off[:, :Ho, :Wo].contiguous(), mask[:, :Ho, :Wo].contiguous()
    plan = {}
    got = deform_sample_launch(x, off, mask, w, k, 1, dil, R, plan)
    torch.cuda.synchronize()
    assert got.shape == (2, Ho, Wo, Co) and bool(torch.isfinite(got).all())
    assert plan["smem"] <= SMEM_MAX
    assert 1 <= plan["nt"] <= 4 and 1 <= plan["kg"] <= k * k
    assert 1 <= plan["ts"] <= min(3, k * k) and 1 <= plan["rows"] <= 8
    if not plan["halo"]:
        one_row_halo = (1 + dil * (k - 1) + 2 * R + 1) * (
            32 + dil * (k - 1) + 2 * R + 1) * 16 * 4
        assert plan["rows"] == 1 and plan["smem"] + one_row_halo > SMEM_MAX


def test_deform_sample_plan_at_the_learned_bounds_shapes(cuda_device):
    """C = Co = 16 at the eval and train shapes on a card of 132 SMs: one
    Co block of two m16n8 tiles, all nine taps' weight staged at once, the
    halo in shared memory; at eval six-row tiles of a warp a row (384
    blocks, 18 warps on the busiest SM), at train four-row tiles of two
    warps a row and the taps in three slices (120 blocks, 24 warps an
    SM)."""
    from stereoformer_tpu_torch.ops.deform import deform_sample_launch

    if torch.cuda.get_device_properties(
            cuda_device).multi_processor_count != 132:
        pytest.skip("the tilings are those of a card of 132 SMs")
    rng = np.random.default_rng(20)
    for shape, rows, mt, ts in (((8, 72, 120, 16, 16), 6, 2, 1),
                                ((4, 40, 80, 16, 16), 4, 1, 3)):
        plan = {}
        deform_sample_launch(*_deform_inputs(rng, shape, 1.8, cuda_device),
                             plan=plan)
        torch.cuda.synchronize()
        assert (plan["nt"], plan["kg"], plan["halo"]) == (2, 9, 1)
        assert (plan["rows"], plan["mt"], plan["ts"]) == (rows, mt, ts)


def test_deform_sample_runs_no_matmul(cuda_device, monkeypatch):
    """The GPU route is the one fused kernel: no torch.matmul for G."""
    rng = np.random.default_rng(16)
    x, off, mask, w = _deform_inputs(rng, (2, 40, 80, 16, 16), 1.8,
                                     cuda_device)

    def refuse(*args, **kwargs):
        raise AssertionError("deform_conv_fused called a matrix product")

    for owner, name in ((torch, "matmul"), (torch, "mm"), (torch, "einsum"),
                        (torch.Tensor, "matmul"),
                        (torch.Tensor, "__matmul__")):
        monkeypatch.setattr(owner, name, refuse)
    n = ops.deform_conv_fused.launches
    got = ops.deform_conv_fused(x, off, mask, w)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert ops.deform_conv_fused.launches == n + 1
    want = ops.modulated_deform_conv_windowed(
        x.double(), off.double(), mask.double(), w.double())
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=DEFORM_RTOL * want.abs().max().item())


def test_deform_sample_takes_the_weight_as_taps(cuda_device):
    """weight [K, C, Co] gives the bits of [K*C, Co]."""
    rng = np.random.default_rng(17)
    x, off, mask, w = _deform_inputs(rng, (1, 24, 40, 16, 16), 1.8,
                                     cuda_device)
    flat = ops.deform_conv_fused(x, off, mask, w)
    taps = ops.deform_conv_fused(x, off, mask, w.reshape(9, 16, 16))
    torch.cuda.synchronize()
    assert torch.equal(flat, taps)


def test_deform_sample_without_mask(cuda_device):
    rng = np.random.default_rng(13)
    x, off, _, w = _deform_inputs(rng, (1, 9, 21, 8, 6), 1.8, cuda_device)
    got = ops.deform_conv_fused(x, off, None, w)
    want = ops.modulated_deform_conv_windowed(
        x.double(), off.double(), None, w.double())
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=DEFORM_RTOL * want.abs().max().item())


def test_deform_backward_is_autograd_of_the_plain_form(cuda_device):
    """One launch forward and none backward; the gradients are the plain
    windowed form's."""
    rng = np.random.default_rng(14)
    inputs = _deform_inputs(rng, (2, 16, 24, 16, 16), 1.8, cuda_device)
    g = _randn(rng, (2, 16, 24, 16), cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    n = ops.deform_conv_fused.launches
    ops.deform_conv_fused(*leaves).backward(g)
    torch.cuda.synchronize()
    assert ops.deform_conv_fused.launches == n + 1
    ref = [t.double().requires_grad_(True) for t in inputs]
    ops.modulated_deform_conv_windowed(*ref).backward(g.double())
    for got, want in zip(leaves, ref):
        # the same float32 arithmetic as the plain form, against float64
        torch.testing.assert_close(got.grad.double(), want.grad, rtol=0,
                                   atol=1e-5 * want.grad.abs().max().item())


def test_deform_conv_module_launches_the_kernel(cuda_device):
    from stereoformer_tpu_torch.nn import DeformConv
    from stereoformer_tpu_torch.weights import seeded_state_dict

    m = DeformConv(16, 16)
    m.load_state_dict(seeded_state_dict(m))
    m = m.to(cuda_device)
    x = _randn(np.random.default_rng(15), (2, 16, 40, 80), cuda_device)
    n = ops.deform_conv_fused.launches
    out = m(x)
    torch.cuda.synchronize()
    assert ops.deform_conv_fused.launches == n + 1
    # zero offset conv: the plain conv modulated by 0.5
    want = 0.5 * torch.nn.functional.conv2d(x.double(), m.weight.double(),
                                            padding=1) + m.bias.double()[
                                                :, None, None]
    torch.testing.assert_close(out.double(), want, rtol=0,
                               atol=DEFORM_RTOL * want.abs().max().item())


def test_deform_sample_rejects_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.default_rng(16)
    x, off, mask, w = _deform_inputs(rng, (1, 8, 12, 8, 6), 1.0, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ops.deform_conv_fused(x.double(), off.double(), mask.double(),
                              w.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.deform_conv_fused(x, off.transpose(1, 2).contiguous().transpose(
            1, 2), mask, w)
    with pytest.raises(ValueError, match="offsets must be"):
        ops.deform_conv_fused(x, off[:, :, :-1].contiguous(), mask, w)
    with pytest.raises(ValueError, match="weight must be"):
        ops.deform_conv_fused(x, off, mask, w[:-1].contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        ops.deform_conv_fused(x, off.cpu(), mask, w)


# --- the stride-2 fused conv (csrc/conv2d_s2.cu) ---------------------------

# float32 sums of 9 C products in another order than cuDNN's float64: relative
# to the largest |y|
S2_RTOL = 1e-5


@pytest.mark.parametrize("shape", [(2, 20, 48, 16, 24), (2, 144, 240, 128, 128),
                                   (1, 34, 70, 6, 10), (1, 18, 66, 96, 128),
                                   (2, 72, 120, 128, 128)],
                         ids=["jax-test", "raft-cnet-down1a", "odd-C-Co",
                              "tile-tails", "raft-cnet-layer5"])
@pytest.mark.parametrize("relu", [False, True], ids=["bare", "relu"])
def test_conv2d_s2_matches_plain(cuda_device, shape, relu):
    B, H, W, C, Co = shape
    rng = np.random.default_rng(20)
    x = _randn(rng, (B, H, W, C), cuda_device)
    w = _randn(rng, (3, 3, C, Co), cuda_device) / np.sqrt(9 * C)
    b = 0.1 * _randn(rng, (Co,), cuda_device)
    n = ops.conv2d_fused_s2.launches
    got = ops.conv2d_fused_s2(x, w, b, relu)
    torch.cuda.synchronize()
    assert ops.conv2d_fused_s2.launches == n + 1
    want = ops.conv3x3_s2_plain(x.double(), w.double(), b.double(), relu)
    assert got.shape == (B, H // 2, W // 2, Co)
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=S2_RTOL * want.abs().max().item())


def test_conv2d_s2_gradient_is_autograd_of_the_plain_version(cuda_device):
    """The backward is cuDNN's VJP of the plain conv: held against float64
    with TF32 off (in TF32 it is ~1e-3 off)."""
    rng = np.random.default_rng(21)
    args = [_randn(rng, s, cuda_device) for s in
            ((2, 20, 48, 16), (3, 3, 16, 24), (24,))]
    g = _randn(rng, (2, 10, 24, 24), cuda_device)
    got = [a.clone().requires_grad_(True) for a in args]
    torch.backends.cudnn.allow_tf32 = False
    try:
        ops.conv2d_fused_s2(*got, True).backward(g)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want = [a.double().requires_grad_(True) for a in args]
    ops.conv3x3_s2_plain(*want, True).backward(g.double())
    for a, r in zip(got, want):
        torch.testing.assert_close(a.grad.double(), r.grad, rtol=0,
                                   atol=1e-5 * r.grad.abs().max().item())


def test_conv2d_s2_rejects_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.default_rng(22)
    x = _randn(rng, (1, 8, 12, 8), cuda_device)
    w = _randn(rng, (3, 3, 8, 4), cuda_device)
    b = _randn(rng, (4,), cuda_device)
    with pytest.raises(ValueError, match="even"):
        ops.conv2d_fused_s2(x[:, :7].contiguous(), w, b)
    with pytest.raises(TypeError, match="float32"):
        ops.conv2d_fused_s2(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="w \\[3, 3, 8, Co\\]"):
        ops.conv2d_fused_s2(x, w[:, :, :4].contiguous(), b)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.conv2d_fused_s2(x, w.cpu(), b)


# --- the row gather (csrc/row_gather.cu) -----------------------------------

def test_row_gather_matches_plain(cuda_device):
    rng = np.random.default_rng(23)
    img = _randn(rng, (8640, 64), cuda_device)
    idx = torch.from_numpy(rng.integers(0, 8640, (5000, 64)).astype(
        np.int32)).to(cuda_device)
    n = ops.take_rows.launches
    got = ops.take_rows(img, idx)
    torch.cuda.synchronize()
    assert ops.take_rows.launches == n + 1
    assert torch.equal(got, ops.take_rows_plain(img, idx))
    assert torch.equal(got, torch.gather(img, 0, idx.long()))


def test_row_gather_probe_runs_on_the_card(cuda_device):
    from stereoformer_tpu_torch.scripts import gather_probe

    n = ops.take_rows.launches
    out = gather_probe.main([])
    assert out.device.type == "cuda" and out.shape == (8640, 64)
    assert ops.take_rows.launches == n + 1


def test_row_gather_refuses_an_index_out_of_range(cuda_device):
    rng = np.random.default_rng(24)
    img = _randn(rng, (10, 4), cuda_device)
    for bad in (10, -1):
        idx = torch.zeros((3, 4), dtype=torch.int32, device=cuda_device)
        idx[1, 2] = bad
        n = ops.take_rows.launches
        with pytest.raises(IndexError, match="in \\[0, 10\\)"):
            ops.take_rows(img, idx)
        assert ops.take_rows.launches == n
    with pytest.raises(ValueError, match="int32"):
        ops.take_rows(img, torch.zeros((3, 4), dtype=torch.int64,
                                       device=cuda_device))


# --- the bf16 forms ---------------------------------------------------------

BF16_ULP = 2.0 ** -7
# where the float32 sums cancel to near 0 the two summation orders' own
# error, relative to the largest output, exceeds a bf16 ulp of the output
F32_SUM_RTOL = 2.0 ** -20


def _bf16_close(got, want, rtol=F32_SUM_RTOL):
    """Each output of bf16 ``got`` within one bf16 ulp of ``want`` (the
    plain version's bf16, or float64 sums rounded to bf16 once), or near 0
    within the float32 sums' error, ``rtol`` of the largest |want|."""
    assert got.dtype == torch.bfloat16
    assert want.dtype in (torch.bfloat16, torch.float64)
    ref = want.to(torch.bfloat16).double().cpu()
    got = got.double().cpu()
    assert got.shape == ref.shape
    big = torch.maximum(got.abs(), ref.abs()).clamp(min=1e-30)
    ulp = BF16_ULP * torch.exp2(torch.floor(torch.log2(big)))
    tol = ulp.clamp(min=rtol * want.abs().max().item())
    assert ((got - ref).abs() <= tol).all(), (got - ref).abs().max()


@pytest.mark.parametrize("shape,D", [((8, 72, 120, 256), 24),
                                     ((8, 72, 120, 256), 96),
                                     ((4, 40, 80, 256), 24),
                                     ((1, 3, 10, 40), 24),
                                     ((1, 2, 97, 64), 50),
                                     ((1, 2, 300, 16), 256)],
                         ids=["eval", "eval-D96", "train", "W<D",
                              "ragged-W-D50", "W>tile-D256"])
def test_corr_band_bf16_matches_plain(cuda_device, shape, D):
    """The bf16 form: float32 sums over C, / C, one rounding; counted
    apart from the float32 form."""
    rng = np.random.default_rng(21)
    left = _randn(rng, shape, cuda_device).bfloat16()
    right = _randn(rng, shape, cuda_device).bfloat16()
    n32 = ops.correlation_volume.launches
    n16 = ops.correlation_volume.bf16_launches
    got = ops.correlation_volume(left, right, D)
    want = ops.correlation_volume_plain(left, right, D)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert ops.correlation_volume.bf16_launches == n16 + 1
    assert ops.correlation_volume.launches == n32
    _bf16_close(got, want)


@pytest.mark.parametrize("shape,D", [((2, 3, 57, 72), 24),
                                     ((1, 2, 33, 8), 40),
                                     ((1, 2, 70, 32), 1024),
                                     ((1, 2, 65, 256), 24),
                                     ((1, 2, 129, 256), 96),
                                     ((2, 2, 81, 16), 200)],
                         ids=["C72-k16-tail", "C8-half-k16", "D1024",
                              "W-past-64px-tile", "W-past-128px-tile-D96",
                              "two-spans-D200"])
def test_corr_band_bf16_edges_match_plain(cuda_device, shape, D):
    """The tensor-core form's edges: a C whose last k16 step is half
    zero-filled (C = 72, and C = 8, one half step), D split into spans of
    128 (and of 104), W one pixel past a tile of 64 and of 128 pixels."""
    rng = np.random.default_rng(25)
    left = _randn(rng, shape, cuda_device).bfloat16()
    right = _randn(rng, shape, cuda_device).bfloat16()
    got = ops.correlation_volume(left, right, D)
    torch.cuda.synchronize()
    _bf16_close(got, ops.correlation_volume_plain(left, right, D))


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("shape,D", [((2, 3, 77, 72), 24),
                                     ((1, 2, 50, 64), 96)],
                         ids=["C72-D24", "D96"])
def test_corr_band_bf16_every_block_width_matches_plain(cuda_device, shape, D,
                                                        warps):
    """Every width the plan may pick (1, 2, 4 or 8 warps of 16 pixels a
    block), on a grid of fewer blocks than tasks, so that each block walks
    several tasks through its ring."""
    from stereoformer_tpu_torch import kernels
    from stereoformer_tpu_torch.ops.cost_volume import corr_bf16_plan

    rng = np.random.default_rng(26)
    left = _randn(rng, shape, cuda_device).bfloat16()
    right = _randn(rng, shape, cuda_device).bfloat16()
    B, H, W, C = shape
    plan = corr_bf16_plan(B, H, W, C, D, 132, warps)
    got = torch.empty((B, H, W, D), dtype=torch.bfloat16, device=cuda_device)
    kernels.launch("corr_band_bf16", cuda_device, left.data_ptr(),
                   right.data_ptr(), got.data_ptr(), B, H, W, C, D,
                   warps, plan["span"], max(1, plan["tasks"] // 3))
    torch.cuda.synchronize()
    _bf16_close(got, ops.correlation_volume_plain(left, right, D))


def test_corr_band_bf16_entry_refuses_a_bad_plan(cuda_device):
    """The C entry returns cudaErrorInvalidValue (1) for a plan it does not
    take: 9 warps, a split D whose span is no multiple of 8 or over 128,
    more blocks than tasks; the launch wrapper raises on it."""
    from stereoformer_tpu_torch import kernels

    feat = torch.zeros((1, 2, 40, 32), dtype=torch.bfloat16,
                       device=cuda_device)
    out = torch.empty((1, 2, 40, 300), dtype=torch.bfloat16,
                      device=cuda_device)
    ptrs = (feat.data_ptr(), feat.data_ptr(), out.data_ptr(), 1, 2, 40, 32)
    for D, warps, span, blocks in ((24, 9, 24, 1), (300, 1, 100, 1),
                                   (300, 1, 136, 1), (24, 4, 24, 3)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            kernels.launch("corr_band_bf16", cuda_device, *ptrs, D, warps,
                           span, blocks)


def test_corr_band_bf16_is_deterministic(cuda_device):
    """No atomics, a fixed order of k steps: a second call gives the same
    bits."""
    rng = np.random.default_rng(27)
    left = _randn(rng, (8, 72, 120, 256), cuda_device).bfloat16()
    right = _randn(rng, (8, 72, 120, 256), cuda_device).bfloat16()
    for D in (24, 96):
        first = ops.correlation_volume(left, right, D)
        assert torch.equal(first, ops.correlation_volume(left, right, D))


@pytest.mark.parametrize("shape", [(4, 576, 960, 64, 64), (2, 288, 480, 96, 96),
                                   (1, 37, 53, 96, 96), (2, 19, 40, 64, 64),
                                   (1, 35, 70, 64, 64), (2, 19, 40, 72, 64),
                                   (1, 17, 45, 72, 96), (1, 9, 33, 64, 96),
                                   (2, 35, 70, 96, 64)],
                         ids=["fnet-layer1", "cnet-layer2", "edge-C96",
                              "H-tail-C64", "tails-4x32-C64",
                              "C72-tail-chunk-Co64", "C72-tail-chunk-Co96",
                              "C64-Co96", "C96-Co64"])
@pytest.mark.parametrize("variant", ["res-relu", "bare", "prologue",
                                     "stats", "prologue-stats"])
def test_conv2d_fused_bf16_matches_plain(cuda_device, shape, variant):
    """Every entry in bf16: one bf16 ulp per output, the moments (float32
    sums of the rounded outputs) within MOMENT_RTOL."""
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(22)
    x, w, b, s, t, r = _conv_inputs(rng, shape, cuda_device)
    x, w, b, r = (a.bfloat16() for a in (x, w, b, r))
    kw = {"res-relu": dict(residual=r, relu=True), "bare": {},
          "prologue": dict(s=s, t=t, relu=True),
          "stats": dict(with_stats=True),
          "prologue-stats": dict(s=s, t=t, with_stats=True)}[variant]
    n32 = ops.conv2d_fused.launches
    n16 = ops.conv2d_fused.bf16_launches
    if "s" in kw and kw.get("with_stats"):
        got = ops.conv2d_fused_prologue_stats(x, w, b, s, t)
    elif kw.get("with_stats"):
        got = ops.conv2d_fused_stats(x, w, b)
    elif "s" in kw:
        got = ops.conv2d_fused_prologue(x, w, b, s, t, True)
    else:
        got = ops.conv2d_fused(x, w, b, kw.get("residual"),
                               kw.get("relu", False))
    want = ops.conv3x3_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    assert ops.conv2d_fused.bf16_launches == n16 + 1
    assert ops.conv2d_fused.launches == n32
    if not kw.get("with_stats"):
        got, want = (got,), (want,)
    assert got[0].dtype == torch.bfloat16
    _bf16_close(got[0], want[0])
    # the moments within MOMENT_RTOL, beyond what the outputs that round
    # to the neighbouring bf16 (the sums' order) move them by
    yg, yw = got[0].double(), want[0].double()
    slack = ((yg - yw).abs().sum((1, 2)), (yg ** 2 - yw ** 2).abs().sum((1, 2)))
    for g, m, sl in zip(got[1:], want[1:], slack):
        assert g.dtype == torch.float32
        m = m.double()
        tol = MOMENT_RTOL * (m.abs() + m.abs().max()) + sl
        assert ((g.double() - m).abs() <= tol).all()


def test_bf16_forms_reject_what_they_do_not_take(cuda_device):
    rng = np.random.default_rng(23)
    feat = _randn(rng, (1, 2, 30, 20), cuda_device).bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.correlation_volume(feat, feat, 24)
    x, w, b, s, t, _ = _conv_inputs(rng, (1, 8, 16, 64, 64), cuda_device)
    with pytest.raises(TypeError, match="conv2d_fused_bf16"):
        ops.conv2d_fused(x.bfloat16(), w, b.bfloat16())
    with pytest.raises(TypeError, match="conv2d_fused_bf16"):
        ops.conv2d_fused_prologue(x.bfloat16(), w.bfloat16(), b.bfloat16(),
                                  s.bfloat16(), t.bfloat16())
    with pytest.raises(TypeError, match="local_soft_argmin"):
        ops.local_soft_argmin(_randn(rng, (1, 2, 30, 24), cuda_device)
                              .bfloat16(),
                              _randn(rng, (1, 2, 30, 21), cuda_device))
    g = _randn(rng, (1, 8, 16, 64), cuda_device)
    with pytest.raises(TypeError, match="conv2d_dw_bf16"):
        ops.conv2d_dw(x.bfloat16(), g)
    with pytest.raises(ValueError, match="conv2d_dw_bf16"):
        ops.conv2d_dw(x[..., :60].contiguous().bfloat16(), g.bfloat16())
    # the bf16 backward's dx conv takes the kernel's widths: at a site with
    # C = 32 it would have 32 outputs, and raises naming the kernel
    x32 = x[..., :32].contiguous().bfloat16()
    w32 = w[:, :, :32].contiguous().bfloat16()
    y = ops.conv2d_fused(x32, w32, b.bfloat16(), None, False)
    with pytest.raises(ValueError, match="conv2d_fused"):
        ops.fused_conv.fused_conv_backward(x32, w32, y, y,
                                           needs=(True,) + (False,) * 5)


def test_bf16_models_launch_the_bf16_forms(cuda_device):
    """LowCNN_gru and RAFT_Stereo in bf16 on the card: the bf16 forms
    launch (corr_band once, the fused conv 14 times), the float32 forms of
    those two never; finite float32 disparities."""
    from stereoformer_tpu_torch.models import get_model

    rng = np.random.default_rng(24)
    counts = ("launches", "bf16_launches")
    for name, want16 in (("LowCNN_gru", (1, 0)), ("RAFT_Stereo", (0, 14))):
        model = get_model(name, device=cuda_device, dtype=torch.bfloat16)
        left = _randn(rng, (1, 64, 128, 3), cuda_device)
        right = _randn(rng, (1, 64, 128, 3), cuda_device)
        before = [getattr(op, c) for op in (ops.correlation_volume,
                                            ops.conv2d_fused) for c in counts]
        with torch.inference_mode():
            out = model(left, right, iters=2)
        torch.cuda.synchronize()
        after = [getattr(op, c) for op in (ops.correlation_volume,
                                           ops.conv2d_fused) for c in counts]
        d = [a - b for a, b in zip(after, before)]
        assert (d[0], d[2]) == (0, 0), d
        assert (d[1], d[3]) == want16, d
        disp = out["disparities"][-1]
        assert disp.dtype == torch.float32 and torch.isfinite(disp).all()


# --- bf16 training: the backward's kernel forms ----------------------------

# the bf16 dw of a sum over up to B H W = 1.8 M pixels: each output within
# one bf16 ulp of the float64 sum rounded once, or near 0, where the sum
# cancels, within the float32 tile sums' own error, DW_RTOL of the largest.
# The bf16 dw walks 16-column strips down runs of rows: W off the strip
# (53, 33, 50, 21) and under it (5, 7), images of 1 and 2 rows (the ring's
# first and last rows at once), and runs that end inside an image (3 x 97
# rows of 4 strips, 2 x 150 of 3, over the 132 or 44 splits of the grid)
BF16_TRAIN_SHAPES = [(8, 320, 720, 64), (4, 160, 360, 96), (1, 37, 53, 96),
                     (2, 19, 40, 64), (1, 9, 33, 96), (2, 3, 5, 64),
                     (1, 1, 40, 64), (1, 2, 21, 96), (1, 11, 7, 96),
                     (3, 97, 50, 64), (2, 150, 48, 96)]
BF16_TRAIN_IDS = ["fnet-layer1", "cnet-layer2", "edge-C96", "H-tail-C64",
                  "tails-C96", "tiny-C64", "H1-C64", "H2-C96",
                  "W-under-strip-C96", "runs-end-inside-C64",
                  "runs-end-inside-C96"]


@pytest.mark.parametrize("shape", BF16_TRAIN_SHAPES, ids=BF16_TRAIN_IDS)
def test_conv2d_dw_bf16_matches_plain(cuda_device, shape):
    """The bf16 form of conv2d_dw: bf16 x and g, float32 sums, one rounding;
    counted apart from the float32 form, and the same bits on a second
    call."""
    rng = np.random.default_rng(25)
    B, H, W, C = shape
    x = _randn(rng, shape, cuda_device).bfloat16()
    g = _randn(rng, shape, cuda_device).bfloat16()
    n32, n16 = ops.conv2d_dw.launches, ops.conv2d_dw.bf16_launches
    got = ops.conv2d_dw(x, g)
    torch.cuda.synchronize()
    assert (ops.conv2d_dw.launches, ops.conv2d_dw.bf16_launches) == (
        n32, n16 + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 3, C, C)
    _bf16_close(got, ops.conv2d_dw_plain(x.double(), g.double()), DW_RTOL)
    assert torch.equal(ops.conv2d_dw(x, g), got)


# the bf16 dw at C other than Co: RAFT's 64 -> 96 layer2 entry at
# downsample=1 (the context net's, B=4 at 320x720), its reverse (C = 96 in
# the 64-channel slices of Co = 64, the second half zero-filled), C no
# multiple of a slice, and C = 32 under one
BF16_DW_C_CO = [(4, 320, 720, 64, 96), (1, 37, 53, 96, 64),
                (2, 19, 40, 72, 64), (1, 9, 33, 88, 96), (2, 3, 5, 32, 64)]


@pytest.mark.parametrize("shape", BF16_DW_C_CO,
                         ids=["raft-ds1-cnet-layer2-entry", "C96-Co64",
                              "C72-Co64", "C88-Co96", "C32-Co64"])
def test_conv2d_dw_bf16_takes_c_other_than_co(cuda_device, shape):
    """The bf16 dw where C differs from Co: within one bf16 ulp of the
    float64 sum (test_conv2d_dw_bf16_matches_plain's bound), one bf16
    launch, the same bits on a second call."""
    rng = np.random.default_rng(29)
    B, H, W, C, Co = shape
    x = _randn(rng, (B, H, W, C), cuda_device).bfloat16()
    g = _randn(rng, (B, H, W, Co), cuda_device).bfloat16()
    n16 = ops.conv2d_dw.bf16_launches
    got = ops.conv2d_dw(x, g)
    torch.cuda.synchronize()
    assert ops.conv2d_dw.bf16_launches == n16 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (3, 3, C, Co)
    _bf16_close(got, ops.conv2d_dw_plain(x.double(), g.double()), DW_RTOL)
    assert torch.equal(ops.conv2d_dw(x, g), got)


def test_raft_downsample1_runs_the_kernels_at_its_16_sites(cuda_device):
    """RAFT_Stereo(downsample=1) routes layer2's 64 -> 96 entry too: 16
    fused-conv launches an eval forward, and a train step's 32 (16 of them
    dx) and 16 dw launches, in float32 and in bf16."""
    from stereoformer_tpu_torch import train
    from stereoformer_tpu_torch.models import get_model

    rng = np.random.default_rng(30)
    for dtype in (torch.float32, torch.bfloat16):
        model = get_model("RAFT_Stereo", device=cuda_device, dtype=dtype,
                          downsample=1)
        bf = dtype == torch.bfloat16
        fused = (ops.conv2d_fused, "bf16_launches" if bf else "launches")
        dw = (ops.conv2d_dw, "bf16_launches" if bf else "launches")
        left = _randn(rng, (1, 32, 64, 3), cuda_device)
        right = _randn(rng, (1, 32, 64, 3), cuda_device)
        n = getattr(*fused)
        with torch.inference_mode():
            out = model(left, right, iters=2)
        torch.cuda.synchronize()
        assert getattr(*fused) - n == 16
        assert torch.isfinite(out["disparities"][-1]).all()
        tx = train.Amsgrad(1e-3)
        state = train.TrainState.create(model, tx)
        batch = {"img_left": left, "img_right": right,
                 "gt_disp": 4 + _randn(rng, (1, 32, 64, 1), cuda_device)}
        n = getattr(*fused), getattr(*dw)
        state, m = train.make_train_step(tx, "sequence", iters=2)(state,
                                                                  batch)
        torch.cuda.synchronize()
        assert (getattr(*fused) - n[0], getattr(*dw) - n[1]) == (32, 16)
        assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("shape", BF16_TRAIN_SHAPES, ids=BF16_TRAIN_IDS)
def test_conv2d_fused_bf16_dx_matches_plain(cuda_device, shape):
    """The bf16 backward's dx conv (the bf16 fused conv of the cotangent
    with the flipped, io-transposed weights, no bias) against the plain
    version, counted in bf16_launches and bf16_dx_launches; the same bits
    on a second call."""
    from stereoformer_tpu_torch.ops.fused_conv import _dx_conv

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(26)
    C = shape[3]
    g = _randn(rng, shape, cuda_device).bfloat16()
    w = (_randn(rng, (3, 3, C, C), cuda_device) / np.sqrt(9 * C)).bfloat16()
    w_rot = w.flip((0, 1)).transpose(2, 3).contiguous()
    zero = torch.zeros(C, device=cuda_device, dtype=torch.bfloat16)
    n16 = ops.conv2d_fused.bf16_launches
    ndx = ops.conv2d_fused.bf16_dx_launches
    got = _dx_conv(g, w_rot, zero)
    torch.cuda.synchronize()
    assert (ops.conv2d_fused.bf16_launches,
            ops.conv2d_fused.bf16_dx_launches) == (n16 + 1, ndx + 1)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, ops.conv3x3_plain(g, w_rot, zero))
    assert torch.equal(_dx_conv(g, w_rot, zero), got)
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.parametrize("variant", list(_BWD_VARIANTS))
def test_conv2d_fused_bf16_backward_matches_plain(cuda_device, variant):
    """The fused conv's bf16 backward on the card (the bf16 dx and dw
    kernels) against the same backward on CPU copies (their plain
    versions): the bf16 gradients within one bf16 ulp of the largest, s
    and t's float32 gradients likewise; one forward, one dx and one dw
    launch, no float32 form."""
    res, pro, stats, relu = _BWD_VARIANTS[variant]
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(27)
    x, w, b, s, t, r = _conv_inputs(rng, (2, 19, 40, 64, 64), cuda_device)
    x, w, b, r = (a.bfloat16() for a in (x, w, b, r))
    gy = _randn(rng, (2, 19, 40, 64), cuda_device).bfloat16()
    g1, g2 = (0.1 * _randn(rng, (2, 64), cuda_device) for _ in range(2))
    names = ["x", "w", "b"] + (["r"] if res else []) + (["s", "t"] if pro
                                                        else [])
    vals = dict(x=x, w=w, b=b, r=r, s=s, t=t)
    grads = {}
    for dev in ("cpu", cuda_device):
        v = {k: vals[k].to(dev).requires_grad_(True) for k in names}
        before = (ops.conv2d_fused.launches, ops.conv2d_fused.bf16_launches,
                  ops.conv2d_fused.bf16_dx_launches, ops.conv2d_dw.launches,
                  ops.conv2d_dw.bf16_launches)
        out = ops.fused_conv.conv3x3_fused(
            v["x"], v["w"], v["b"], v.get("r"), relu, v.get("s"), v.get("t"),
            stats)
        outs = out if stats else (out,)
        cots = ((gy.to(dev), g1.to(dev), g2.to(dev)) if stats
                else (gy.to(dev),))
        grads[str(dev)] = torch.autograd.grad(outs, [v[k] for k in names],
                                              cots)
        after = (ops.conv2d_fused.launches, ops.conv2d_fused.bf16_launches,
                 ops.conv2d_fused.bf16_dx_launches, ops.conv2d_dw.launches,
                 ops.conv2d_dw.bf16_launches)
        want = (0, 0, 0, 0, 0) if dev == "cpu" else (0, 2, 1, 0, 1)
        assert tuple(a - b_ for a, b_ in zip(after, before)) == want
    torch.cuda.synchronize()
    for k, got, ref in zip(names, grads[str(cuda_device)], grads["cpu"]):
        assert got.dtype == ref.dtype, k
        got, ref = got.float().cpu(), ref.float()
        big = ref.abs().max().item()
        tol = BF16_ULP * 2.0 ** np.floor(np.log2(big))
        assert (got - ref).abs().max().item() <= tol, k
    torch.backends.cudnn.allow_tf32 = True


def test_bf16_train_steps_launch_the_bf16_forms(cuda_device):
    """One bf16 train step each: RAFT_Stereo launches the bf16 fused conv
    14 times forward and 14 times as dx, the bf16 dw 14 times, and no
    float32 conv form; LowCNN_gru corr_band's bf16 form once and the
    refinement kernels once per iteration; every gradient finite and every
    parameter float32."""
    from stereoformer_tpu_torch import train
    from stereoformer_tpu_torch.models import get_model

    rng = np.random.default_rng(28)
    for name, iters in (("RAFT_Stereo", 2), ("LowCNN_gru", 2)):
        model = get_model(name, device=cuda_device, dtype=torch.bfloat16)
        tx = train.Amsgrad(1e-3)
        state = train.TrainState.create(model, tx)
        batch = {"img_left": _randn(rng, (2, 64, 128, 3), cuda_device),
                 "img_right": _randn(rng, (2, 64, 128, 3), cuda_device),
                 "gt_disp": 10 + _randn(rng, (2, 64, 128, 1), cuda_device)}
        counters = [(ops.conv2d_fused, "launches"),
                    (ops.conv2d_fused, "bf16_launches"),
                    (ops.conv2d_fused, "bf16_dx_launches"),
                    (ops.conv2d_dw, "launches"),
                    (ops.conv2d_dw, "bf16_launches"),
                    (ops.correlation_volume, "launches"),
                    (ops.correlation_volume, "bf16_launches"),
                    (ops.local_soft_argmin, "launches"),
                    (ops.local_soft_argmin, "backward_launches")]
        before = [getattr(o, c) for o, c in counters]
        state, m = train.make_train_step(tx, "sequence", iters=iters)(
            state, batch)
        torch.cuda.synchronize()
        d = [getattr(o, c) - b_ for (o, c), b_ in zip(counters, before)]
        want = ([0, 28, 14, 0, 14, 0, 0, 0, 0] if name == "RAFT_Stereo"
                else [0, 0, 0, 0, 0, 0, 1, iters, iters])
        assert d == want, (name, d)
        assert np.isfinite(float(m["loss"]))
        for k, p in model.named_parameters():
            assert p.dtype == torch.float32 and torch.isfinite(p.grad).all(), k
