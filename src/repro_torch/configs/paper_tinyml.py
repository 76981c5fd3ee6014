"""The paper's own evaluation workloads (Sec. 5.2) as GEMM tables (a copy of
``repro.configs.paper_tinyml``, data only).

Conv layers are im2col GEMMs in the paper's convention: X is (M, N), W is
(N, K) with N the reduction dim — M = spatial positions (batch 1, the
on-device continual-learning setting), N = k*k*C_in, K = C_out.

Training a conv costs 3 GEMMs of equal MACs (FW, dW, dX); the dW/dX GEMMs
have transposed dims, which matters for leftovers.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GemmShape:
    name: str
    M: int
    N: int
    K: int
    kind: str = "conv"  # conv | depthwise | linear | attn


# ResNet8 (TinyMLPerf CIFAR-10, 32x32x3) -------------------------------------
RESNET8 = [
    GemmShape("conv1_3x3x3-16", 1024, 27, 16),
    GemmShape("s1_conv1_3x3x16-16", 1024, 144, 16),
    GemmShape("s1_conv2_3x3x16-16", 1024, 144, 16),
    GemmShape("s2_conv1_3x3x16-32_s2", 256, 144, 32),
    GemmShape("s2_conv2_3x3x32-32", 256, 288, 32),
    GemmShape("s2_skip_1x1x16-32", 256, 16, 32),
    GemmShape("s3_conv1_3x3x32-64_s2", 64, 288, 64),
    GemmShape("s3_conv2_3x3x64-64", 64, 576, 64),
    GemmShape("s3_skip_1x1x32-64", 64, 32, 64),
    GemmShape("fc_64-10", 1, 64, 10, kind="linear"),
]

# Paper Sec. 5.2.2: the two Im2Col passes cost ~3M cycles in software on the
# 8 cores; the DataMover halves that.
RESNET8_IM2COL_SW_CYCLES = 3.0e6
RESNET8_OTHER_SW_CYCLES = 1.0e6  # norm/act/pool/loss bookkeeping


def _mnv2_blocks(width: float = 0.35, res: int = 96):
    """MobileNetV2 inverted-residual stack (t, c, n, s) at given width."""
    cfgs = [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    def c8(c):
        c = int(c * width)
        return max(8, c - c % 8)

    layers = []
    cin, sp = c8(32), res // 2
    layers.append(GemmShape("stem_3x3x3", sp * sp, 27, c8(32)))
    for t, c, n, s in cfgs:
        cout = c8(c)
        for i in range(n):
            stride = s if i == 0 else 1
            sp_out = sp // stride
            hidden = cin * t
            if t != 1:
                layers.append(
                    GemmShape(f"pw_exp_{cin}-{hidden}", sp * sp, cin, hidden)
                )
            # depthwise 3x3: per-channel vector GEMMs (M=spatial, N=9, K=1)
            layers.append(
                GemmShape(
                    f"dw_3x3_{hidden}", sp_out * sp_out, 9, hidden,
                    kind="depthwise",
                )
            )
            layers.append(
                GemmShape(f"pw_proj_{hidden}-{cout}", sp_out * sp_out, hidden, cout)
            )
            cin, sp = cout, sp_out
    layers.append(GemmShape(f"head_{cin}-1280w", sp * sp, cin, c8(1280)))
    return layers


MOBILENETV2 = _mnv2_blocks()

# TinyTransformer (Burrello et al. [54]) — encoder block on S=64, d=64, 8H.
_S, _D, _H, _FF = 64, 64, 8, 128
TINY_TRANSFORMER = [
    GemmShape("Linear1_qkv", _S, _D, 3 * _D, kind="linear"),
    GemmShape("Matmul1_qk", _S * _H, _D // _H, _S, kind="attn"),
    GemmShape("Matmul2_av", _S * _H, _S, _D // _H, kind="attn"),
    GemmShape("Linear2_out", _S, _D, _D, kind="linear"),
    GemmShape("FFN_up", _S, _D, _FF, kind="linear"),
    GemmShape("FFN_down", _S, _FF, _D, kind="linear"),
]


def training_gemms(layers):
    """FW + dW + dX GEMM set for one training step."""
    out = []
    for g in layers:
        out.append(dataclasses.replace(g, name=g.name + "_fw"))
        out.append(GemmShape(g.name + "_dw", g.N, g.M, g.K, g.kind))
        out.append(GemmShape(g.name + "_dx", g.M, g.K, g.N, g.kind))
    return out
