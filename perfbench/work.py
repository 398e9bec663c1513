"""The yardstick's arithmetic: the chip's published peaks, the least time
a piece of work needs on them, the bytes and operations of the program's
hand kernels at the shapes a forward gives them, and the FLOPs of a
forward or a training pass counted over the benchmark's own reference.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit; a card set lower runs slower, so every reading is
printed beside the card's power limit.  The kernel counts are frozen here
from ``chip_smoke.py``'s bounds of the same calls (``check_pvt_mlp``,
``check_sra_attention``): each input byte read once and each output byte
written once, operations outside the matrix products counted per token.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_ops_per_s": 67e12,        # float32 outside the tensor cores
    "tf32_flops_per_s": 495e12,    # dense TF32 on the tensor cores
    "bf16_flops_per_s": 989e12,    # dense bf16 / fp16 on the tensor cores
}

BF16, F32 = 2, 4  # bytes an element


def bound_s(nbytes: float, ops: float, mma_ops: float = 0.0,
            mma_per_s: float = PEAKS["bf16_flops_per_s"]) -> tuple[float, str]:
    """The least time of a piece of work: the larger of its bytes over the
    memory rate and its operations over their unit's rate (products on the
    tensor cores at ``mma_per_s``, the rest at float32's rate; products at
    float32's rate share its unit).  Returns (seconds, "bytes" or
    "operations")."""
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    work = {PEAKS["f32_ops_per_s"]: ops}
    work[mma_per_s] = work.get(mma_per_s, 0.0) + mma_ops
    t_ops = max(n / rate for rate, n in work.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pvt_stages(config: dict, size: int) -> list[dict]:
    """Per stage of a PVTv2 configuration at input ``size``: tokens a side,
    width, heads, MLP ratio, spatial reduction, depth and K/V tokens."""
    m = config["model"]
    out, side = [], size // 4
    for s in range(4):
        sr = m["sr_ratios"][s]
        out.append({"side": side, "d": m["embed_dims"][s],
                    "heads": m["num_heads"][s], "ratio": m["mlp_ratios"][s],
                    "sr": sr, "depth": m["depths"][s],
                    "tkv": (side // sr) ** 2})
        side //= 2
    return out


def mlp_block_call(batch: int, st: dict,
                   mode: str) -> tuple[float, float, float]:
    """(bytes, operations, product operations) of one bf16 ``mlp_block``
    call (``stats`` or ``final_ln`` mode) at a stage: x, the LayerNorm
    parameters (float32, the stage-end pair included), fc1, the depthwise
    3x3 and fc2 (bf16) read, the output (and in ``stats`` mode its float32
    mean and rstd) written.  Per token outside the products: LN 7D, fc1
    bias C, nine taps 18C, dw bias C, GELU 17C, fc2 bias and residual 2D,
    the epilogue's statistics or LayerNorm 7D."""
    d, c = st["d"], st["d"] * st["ratio"]
    m = batch * st["side"] ** 2
    params = 4 * d * F32 + (2 * c * d + c * 9 + 2 * c + d) * BF16
    nbytes = 2 * m * d * BF16 + params + (8 * m if mode == "stats" else 0)
    return nbytes, m * (16 * d + 37 * c), 4 * m * d * c


def sra_attention_call(batch: int, st: dict) -> tuple[float, float, float]:
    """(bytes, operations, product operations) of one bf16
    ``sra_attention`` call at a stage: x, K/V, LN1 (float32), q and proj
    (bf16) read, the output written.  Per token outside the products: LN
    7D, q bias and scale 2D, softmax 4 Tkv a head, the division D, proj
    bias and residual 2D."""
    d, m, tkv = st["d"], batch * st["side"] ** 2, st["tkv"]
    params = 2 * d * F32 + (2 * d * d + 2 * d) * BF16
    nbytes = 2 * m * d * BF16 + batch * tkv * 2 * d * BF16 + params
    return (nbytes, m * (12 * d + 4 * st["heads"] * tkv),
            4 * m * d * d + 4 * m * tkv * d)


def forward_bound_s(kernel: str, config: dict, size: int, batch: int) -> float:
    """The least time of one forward's calls of ``kernel`` (``mlp_block``:
    a ``stats`` call in each non-last block of a stage and a ``final_ln``
    call in its last; ``sra_attention``: one a block)."""
    total = 0.0
    for st in pvt_stages(config, size):
        if kernel == "mlp_block":
            calls = [("stats", st["depth"] - 1), ("final_ln", 1)]
            total += sum(n * bound_s(*mlp_block_call(batch, st, mode))[0]
                         for mode, n in calls)
        elif kernel == "sra_attention":
            total += st["depth"] * bound_s(*sra_attention_call(batch, st))[0]
        else:
            raise ValueError(f"no work count for kernel {kernel!r}")
    return total


def forward_calls(kernel: str, config: dict) -> int:
    """Launches of ``kernel`` in one forward (one a block)."""
    if kernel not in ("mlp_block", "sra_attention"):
        raise ValueError(f"no work count for kernel {kernel!r}")
    return sum(config["model"]["depths"])


def flops_per_image(config: dict, size: int, train: bool) -> float:
    """FLOPs of one image at ``size`` through the benchmark's reference,
    counted by ``FlopCounterMode`` on the meta device (no arithmetic
    runs): the eval forward, or with ``train`` the training forward and
    the backward to every parameter.  The count is the reference's, so it
    does not move when the program restructures a layer."""
    from perfbench.reference import pranet

    with torch.device("meta"):
        ref = pranet.build(config)
        x = torch.empty((1, 3, size, size))
    ref.train(train)
    with FlopCounterMode(display=False) as counter:
        if train:
            out = ref(x)
            sum(o.sum() for o in out).backward()
        else:
            with torch.no_grad():
                ref(x)
    return float(counter.get_total_flops())
