"""Weight gradient of a stride-1 3x3 SAME convolution (NHWC, HWIO).

Counterpart of the Pallas kernel
``stereoformer_tpu/ops/pallas/dw_conv.py::conv2d_dw_pallas``, which the
fused conv's backward calls for its weight gradient:

    conv2d_dw(x, g) -> dw,
    dw[di, dj, c, co] = sum_{b, h, w} xp[b, h + di, w + dj, c] * g[b, h, w, co]

x [B, H, W, C] (the conv's input), g [B, H, W, Co] (its output's cotangent),
xp the zero-padded x; dw [3, 3, C, Co], all float32. CPU tensors take the
plain version (``conv2d_dw_plain``); CUDA tensors launch the kernel
``csrc/conv2d_dw.cu`` or raise, counting launches in ``conv2d_dw.launches``.
The kernel takes Co = 64 or 96, the fused conv's output widths, and C a
multiple of 8 (in 32-channel chunks, the last zero-filled past C): every
site ``nn/blocks.py::kernel_routes`` sends to the fused conv, RAFT's
64 -> 96 entry at ``downsample=1`` among them.

bf16 x and g give a bf16 dw, as the fused conv's bf16 backward takes it
(the Pallas kernel's float32 sums cast to the bf16 weight by ``_dw``): the
products summed in float32, one rounding. CPU tensors take the plain
version of that form; CUDA tensors launch the kernel's bf16 form
(``conv2d_dw_bf16``, the same source, on the bf16 tensor cores: a block
takes a slice of input channels and all nine taps and walks strips of
columns down runs of rows, each staged row read once), counted in
``conv2d_dw.bf16_launches``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import kernels

# the output widths the kernel has templates for (csrc/conv2d_dw.cu)
KERNEL_CO = (64, 96)
# input channels per block (csrc/conv2d_dw.cu: KC)
_CHUNK = 32
# blocks of each template resident on one SM (csrc/conv2d_dw.cu: MINB)
_BLOCKS_PER_SM = {64: 3, 96: 2}


def whole_waves(slots: int, per_split: int) -> tuple:
    """(nsplit, blocks): the fewest splits of ``per_split`` blocks each
    whose blocks fill ``slots`` resident slots in whole waves."""
    nsplit = slots // math.gcd(slots, per_split)
    return nsplit, nsplit * per_split


def dw_plan(C: int, sms: int, dtype=torch.float32, Co: int = None) -> tuple:
    """(nsplit, blocks) of the kernel's grid for C input and Co output
    channels (Co = C where not given) on a card with ``sms`` SMs, nsplit
    the fewest splits of the pixels whose blocks fill the card's resident
    slots in whole waves. The float32 form has 3 * ceil(C/32) blocks a
    split (tap row, channel chunk), the bf16 form ceil(C / KC) (a slice of
    KC input channels, all nine taps, KC by Co in
    ``kernels.DW_BF16_TILING``); each block writes one partial of dw, so
    the scratch holds nsplit * 9 * C * Co floats."""
    Co = C if Co is None else Co
    if dtype == torch.bfloat16:
        tiling = kernels.DW_BF16_TILING[Co]
        return whole_waves(sms * tiling["MINB"], -(-C // tiling["KC"]))
    return whole_waves(sms * _BLOCKS_PER_SM[Co], 3 * -(-C // _CHUNK))


def conv2d_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The tap formulation (``stereoformer_tpu/ops/convgrad.py::
    conv2d_dw_tap``): one contraction over (b, h, w) per tap, of the shifted
    slice of the zero-padded x with g. bf16 x and g are multiplied and
    summed in float32 (their products are exact there) and dw is rounded
    to bf16 once."""
    if x.dtype == torch.bfloat16:
        return conv2d_dw_plain(x.float(), g.float()).to(torch.bfloat16)
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [torch.einsum("bhwc,bhwo->co", xp[:, di:di + H, dj:dj + W], g)
            for di in range(3) for dj in range(3)]
    return torch.stack(taps).reshape(3, 3, C, g.shape[-1])


def conv2d_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw [3, 3, C, Co] of a stride-1 3x3 SAME conv with input x and output
    cotangent g, of their dtype (float32 or bf16): the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    if x.device.type == "cpu" and g.device.type == "cpu":
        return conv2d_dw_plain(x, g)
    bf16 = x.dtype == torch.bfloat16
    name = "conv2d_dw_bf16" if bf16 else "conv2d_dw"
    kernels.check_inputs(name, x, g)
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(
            f"{name}: the kernel takes x [B, H, W, C] and g [B, H, W, Co], "
            f"got {tuple(x.shape)} and {tuple(g.shape)}")
    B, H, W, C = x.shape
    Co = g.shape[3]
    if C % 8 or Co not in KERNEL_CO:
        raise ValueError(
            f"{name}: the kernel takes C a multiple of 8 and Co in "
            f"{KERNEL_CO}, got C={C}, Co={Co}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    dw = _launch(name, x, g, sms)
    if bf16:
        conv2d_dw.bf16_launches += 1
    else:
        conv2d_dw.launches += 1
    return dw


def _launch(name: str, x: torch.Tensor, g: torch.Tensor,
            sms: int) -> torch.Tensor:
    """Allocate dw and the partials' scratch by ``dw_plan`` for a card with
    ``sms`` SMs, and launch kernel ``name``."""
    B, H, W, C = x.shape
    Co = g.shape[3]
    nsplit, _ = dw_plan(C, sms, x.dtype, Co)
    part = x.new_empty((nsplit, 9, C, Co), dtype=torch.float32)
    dw = x.new_empty((3, 3, C, Co))
    kernels.launch(name, x.device, x.data_ptr(), g.data_ptr(),
                   part.data_ptr(), dw.data_ptr(), B, H, W, C, Co, nsplit)
    return dw


conv2d_dw.launches = 0
conv2d_dw.bf16_launches = 0
