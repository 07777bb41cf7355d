"""The AST tower's attention from the configuration tree: its FLOPs per voice
and the attention kernels a training step launches.

Per layer and voice, the forward's two products are q k^T and p v, each
2 N^2 x head dim per head, so 4 N^2 D over the D = heads x head dim columns;
the backward's four (dq, dk, dv, dp) are twice the forward's. N is the tokens
a voice: 2 class tokens and the patch grid. Softmax and scaling are not
counted.

A training step runs the fused attention's kernels once per layer. The
names and the count are those the H100's trace showed with torch 2.11
(PERF.md), where SDPA takes the cuDNN backend under bf16 autocast:
per layer and step one forward (``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_*``),
and in the backward ``cudnn::fusion::compute_dot_do_o_specialized``, the
backward proper (``..._sdpa_sm90_flash_bprop_*``) and
``cudnn::fusion::convert_dq_to_16bits``. ``KERNEL_MARKS`` are substrings of
those names; another backend matches none of them, and the metric reads
nothing rather than a wrong time.
"""

from __future__ import annotations

KERNEL_MARKS = ("_native_sdpa_sm90_flash_fprop", "_native_sdpa_sm90_flash_bprop",
                "cudnn::fusion::compute_dot_do_o", "cudnn::fusion::convert_dq_to_16bits")
LAUNCHES_PER_LAYER = len(KERNEL_MARKS)


def _ast(tree):
    tower = tree.get("audio_tower") or {}
    return tower.get("ast") if tower.get("name") == "ast" else None


def tokens(tree) -> int:
    """Tokens a voice: 2 class tokens and the patch grid; 0 without an AST tower."""
    a = _ast(tree)
    if a is None:
        return 0
    grid_f = (a["input_fdim"] - a["patch_size"]) // a["fstride"] + 1
    grid_t = (a["input_tdim"] - a["patch_size"]) // a["tstride"] + 1
    return 2 + grid_f * grid_t


def flops_per_voice(tree, backward: bool = True) -> float:
    """The attention products' FLOPs of one voice over every layer: the forward,
    and with ``backward`` the backward's too (3 x the forward)."""
    a = _ast(tree)
    if a is None:
        return 0.0
    n = tokens(tree)
    forward = 4.0 * n * n * a["embed_dim"] * a["depth"]
    return 3.0 * forward if backward else forward


def launches_per_step(tree) -> int:
    """The attention kernel launches of one training step."""
    a = _ast(tree)
    return 0 if a is None else LAUNCHES_PER_LAYER * a["depth"]


def is_attention_kernel(name: str) -> bool:
    return any(mark in name for mark in KERNEL_MARKS)
