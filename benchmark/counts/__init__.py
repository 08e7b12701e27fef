"""Operations and bytes computed from shapes, whatever implements them.

``network_convs`` lists every convolution of the depth and pose networks
of a monodepth2 configuration with its output size; ``conv_flops`` counts
them as ``torch.utils.flop_counter`` does (2 per multiply-add; a backward
pass computes the input's gradient, unless the input is an image, and the
weight's, each as many as the forward). The matmuls of the camera geometry
and of the resizes (under 0.2% of a step's) are not counted.

``kernels()`` reads one file per port kernel that the cells launch (K1-K3)
from ``kernels/``: a regular expression on the kernel's name and the bytes
and float operations of one output pixel. A cell that launches another
port kernel brings its file. ``least_seconds`` is the larger of the bytes' time at the
device's memory rate and the operations' at its float32 rate: every launch
of these kernels on the cells' path is at the batch's full size, so a
launch covers batch x height x width pixels.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ENC_CH = (64, 64, 128, 256, 512)
DEC_CH = (16, 32, 64, 128, 256)


def _resnet18(n: int, in_ch: int, h: int, w: int):
    """(cin, cout, k, in_hw, out_hw, n, input_grad, transposed) of a
    ResNet-18 over n images of (h, w)."""
    out = [(in_ch, 64, 7, (h, w), (h // 2, w // 2), n, False, False)]
    size = (h // 4, w // 4)
    cin = 64
    for stage in range(1, 5):
        cout = ENC_CH[stage]
        for block in range(2):
            stride = 2 if stage > 1 and block == 0 else 1
            o = (size[0] // stride, size[1] // stride)
            out.append((cin, cout, 3, size, o, n, True, False))
            out.append((cout, cout, 3, o, o, n, True, False))
            if stride != 1 or cin != cout:
                out.append((cin, cout, 1, size, o, n, True, False))
            size, cin = o, cout
    return out


def _decoder(n: int, h: int, w: int, variant: str, scales):
    out = []
    for i in range(4, -1, -1):
        s_in = (h >> (i + 1), w >> (i + 1))
        s_out = (h >> i, w >> i)
        cin = ENC_CH[-1] if i == 4 else DEC_CH[i + 1]
        out.append((cin, DEC_CH[i], 3, s_in, s_in, n, True, False))
        if variant == "fork":
            out.append((DEC_CH[i], DEC_CH[i], 3, s_in, s_out, n, True, True))
        skip = ENC_CH[i - 1] if i > 0 else 0
        out.append((DEC_CH[i] + skip, DEC_CH[i], 3, s_out, s_out, n, True,
                    False))
        if i in scales:
            out.append((DEC_CH[i], 1, 3, s_out, s_out, n, True, False))
    return out


def _pose_decoder(n: int, h: int, w: int):
    s = (h >> 5, w >> 5)
    return [(512, 256, 1, s, s, n, True, False),
            (256, 256, 3, s, s, n, True, False),
            (256, 256, 3, s, s, n, True, False),
            (256, 12, 1, s, s, n, True, False)]


def network_convs(options: dict, batch: int, pose: bool = True):
    h, w = options["height"], options["width"]
    convs = _resnet18(batch, 3, h, w) + _decoder(
        batch, h, w, options["depth_decoder_variant"], options["scales"])
    if pose:
        pairs = 2 * batch  # one pair per source frame, stacked
        convs += _resnet18(pairs, 6, h, w) + _pose_decoder(pairs, h, w)
    return convs


def _forward(conv) -> int:
    cin, cout, k, in_hw, out_hw, n, _, transposed = conv
    hw = in_hw if transposed else out_hw
    return 2 * n * hw[0] * hw[1] * k * k * cin * cout


def conv_flops(options: dict, batch: int, backward: bool = True,
               pose: bool = True) -> int:
    total = 0
    for conv in network_convs(options, batch, pose):
        f = _forward(conv)
        total += f
        if backward:
            total += f * (2 if conv[6] else 1)
    return total


def train_step_flops(options: dict) -> int:
    """Convolution operations of one training step (forward and
    backward of the depth network and the pose network over both pairs)."""
    return conv_flops(options, options["batch_size"])


def depth_forward_flops(options: dict, images: int = 1) -> int:
    """Convolution operations of the depth network's forward pass."""
    return conv_flops(options, images, backward=False, pose=False)


def kernels() -> List[dict]:
    out = []
    for path in sorted((HERE / "kernels").glob("*.json")):
        with open(path) as f:
            entry = json.load(f)
        entry["name"] = path.stem
        entry["regex"] = re.compile(entry["match"])
        out.append(entry)
    return out


def port_kernel(name: str, table: List[dict]) -> Optional[dict]:
    for entry in table:
        if entry["regex"].search(name):
            return entry
    return None


def least_seconds(entry: dict, pixels: int, peak: dict) -> Tuple[float,
                                                                 str]:
    """-> (seconds, "bytes" or "operations") for one launch."""
    t_bytes = entry["bytes_per_pixel"] * pixels / peak["hbm_bytes_per_s"]
    t_ops = entry["flops_per_pixel"] * pixels / peak["flops_per_s"]["float32"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

