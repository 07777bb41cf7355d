"""The HTS-AT tower's window attention from the configuration tree: its FLOPs
and least bytes per voice, and the attention kernels a training step launches.

Stage i has width C = embed_dim 2^i, grid R = grid_0 / 2^i, window W =
min(window, R), N = W^2 tokens a window and (R / W)^2 windows a voice. Per
window and layer, the forward's two products (q k^T and p v) are 2 N^2 C
each over the C = heads x head dim columns; the backward's four (dq, dk, dv,
dp) are twice the forward's: 3 x 4 N^2 C in all. Softmax, scaling and the
additive bias are not counted.

Least bytes, per token and layer, in bf16: the forward reads q, k and v and
writes o (4 C values); the backward reads q, k, v, o and dO and writes dQ,
dK and dV (8 C values): 24 C bytes. Each layer's float32 bias table is read
once a step. So the intensity is 4 N^2 C x 3 / (24 C N) = N / 2 = 32 FLOP a
byte at W = 8: below the card's ridge (989 TFLOP/s over 3.35 TB/s, ~295),
so the bytes set the bound.

A training step runs the memory-efficient attention's two kernels once per
layer (the only fused SDPA backend that takes an additive mask requiring a
gradient). The names are those the H100's trace showed with torch 2.11
(PERF.md): ``fmha_cutlassF_bf16_aligned_64x64_rf_sm80`` forward and
``fmha_cutlassB_bf16_aligned_64x64_k32_seqaligned_sm80`` backward.
``KERNEL_MARKS`` are substrings of those names; another backend matches
none of them, and the metric reads nothing rather than a wrong time.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.reference.htsat import PATCH_SIZE

KERNEL_MARKS = ("fmha_cutlassF_", "fmha_cutlassB_")
LAUNCHES_PER_LAYER = len(KERNEL_MARKS)
BYTES = 2  # bf16


def _htsat(tree):
    tower = tree.get("audio_tower") or {}
    return tower.get("htsat") if tower.get("name") == "htsat" else None


def stages(tree) -> List[Tuple[int, int, int, int, int]]:
    """(grid, width, window, heads, blocks) of each stage; [] without an HTS-AT tower."""
    h = _htsat(tree)
    if h is None:
        return []
    grid = h["spec_size"] // PATCH_SIZE
    out = []
    for i, (depth, heads) in enumerate(zip(h["depths"], h["num_heads"])):
        r = grid // 2 ** i
        out.append((r, h["embed_dim"] * 2 ** i, min(h["window"], r), heads, depth))
    return out


def flops_per_voice(tree, backward: bool = True) -> float:
    """The attention products' FLOPs of one voice over every layer: the forward,
    and with ``backward`` the backward's too (3 x the forward)."""
    forward = sum(depth * (r // w) ** 2 * 4.0 * (w * w) ** 2 * c for r, c, w, _, depth in stages(tree))
    return 3.0 * forward if backward else forward


def bytes_per_voice(tree) -> float:
    """Least bytes of one voice over every layer, forward and backward: 24 C a token."""
    return sum(depth * r * r * 12.0 * c * BYTES for r, c, _, _, depth in stages(tree))


def table_bytes_per_step(tree) -> float:
    """Every layer's float32 bias table, read once a step."""
    return sum(depth * (2 * w - 1) ** 2 * heads * 4.0 for _, _, w, heads, depth in stages(tree))


def launches_per_step(tree) -> int:
    """The attention kernel launches of one training step."""
    return LAUNCHES_PER_LAYER * sum(depth for *_, depth in stages(tree))


def is_attention_kernel(name: str) -> bool:
    return any(mark in name for mark in KERNEL_MARKS)
