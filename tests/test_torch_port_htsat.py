"""The HTS-AT audio tower (``models/htsat.py``, ``audio_tower.name: htsat``)
against the benchmark's plain float32 reference (``portbench/reference/htsat.py``).

A tiny HTS-AT on the port tests' 1 s / batch-4 synth, float32 on the CPU: 8
mel bins, 92 frames stretched to 128 and folded into a 32 x 32 image, 4 x 4
patches, width 32 and two stages of two blocks: a grid of 8 in windows of 4
(the second block shifts by 2), then a grid of 4 in one window of 4 (no
shift), heads of 16. The cases:
- the front end against the reference's, and its geometry at 4 s;
- roll, window partition, the relative-position index and the shift mask
  against a loop over each window and token pair;
- the tower's output and every parameter's gradient, the bias tables' with
  them, from the same weights;
- one VICReg ``train_step`` against the reference's step;
- the downstream task on frozen HTS-AT towers; the counters, the refused
  vision trunk and the spans under a profiler.

The tests marked ``cuda`` run on the card (this file imports neither JAX nor
``conftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_htsat.py

They hold an eager step and a CUDA graph of 4 steps replayed twice against 9
eager steps at bf16; check that the biased window attention takes the
memory-efficient backend forward and backward, never the math path; and hold
one block's bias-table gradient, summed over 64 voices by that backend's
backward, against the reference's at HTSAT-base's stage-1 and stage-4 shapes.
"""

import copy

import pytest
import torch

from inverse_audio_synthesis_tpu_torch.models.htsat import (
    HTSAT,
    MASK_VALUE,
    SwinBlock,
    relative_position_index,
    shift_mask,
    window_merge,
    window_partition,
)
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
from inverse_audio_synthesis_tpu_torch.utils.config import load_config
from portbench.reference import htsat as RH

torch.set_num_threads(2)

TINY = ["vicreg=fast", "dim=32", "embeddim=64", "vicreg.mlp='64-%d'", "vicreg.batch_size=4",
        "image.height=105", "image.width=140", "torchsynth.buffer_size_seconds=1.0", "precision=f32",
        "audio_to_params.batch_size=4"]
HTSAT_TINY = ["audio_tower.name=htsat", "vicreg.pretrained_vision_model=false", "audio_tower.htsat.mel_bins=8",
              "audio_tower.htsat.spec_size=32", "audio_tower.htsat.embed_dim=32", "audio_tower.htsat.depths=[2,2]",
              "audio_tower.htsat.num_heads=[2,4]", "audio_tower.htsat.window=4"]
CPU = ["platform=cpu"]
BATCH_NUM = 7


def _task(extra=()):
    return VicregPretrainTask(load_config(overrides=TINY + HTSAT_TINY + list(extra)))


def _reference_tower(cfg):
    return RH.HTSAT(cfg.dim, cfg.torchsynth.rate, **dict(cfg.audio_tower.htsat))


@pytest.fixture(scope="module")
def htsat_task():
    task = _task(CPU)
    return task, task.init_state()


def test_frontend_matches_the_reference(htsat_task):
    """The image of the synth's 1 s voices: the port's log-mel (``torch.stft``,
    ``ops/stft.py``'s slaney filterbank), ``bn0`` on the batch and the bicubic
    stretch (``F.interpolate``) against the reference's framing, rfft, own
    mel, BatchNorm and interpolation matrix: measured 2.3e-7 relative; the
    limit is some 20 times that, as float32 rounding."""
    task, state = htsat_task
    audio, _ = task.synthesize(BATCH_NUM)
    ref = _reference_tower(task.cfg)
    ref.load_state_dict(state.model.backbone_audio.state_dict(), strict=False)
    got, want = state.model.backbone_audio.frontend(audio), ref.image(audio)
    assert got.shape == want.shape == (4, 1, 32, 32)
    assert torch.linalg.vector_norm(got - want) <= 5e-6 * torch.linalg.vector_norm(want)


def test_geometry_at_4_s():
    """HTSAT-base at 4 s and 44.1 kHz: 368 frames of 64 mel bins stretched to
    1,024 and folded into 256 x 256; 4,096, 1,024, 256 and 64 tokens; 64, 16, 4
    and 1 windows a voice and block; 8 of the 18 blocks shift."""
    cfg = load_config(overrides=["audio_tower.name=htsat"] + CPU)
    tower = HTSAT(dim=16, sample_rate=44100, **dict(cfg.audio_tower.htsat))
    assert tower.logmel(torch.randn(1, 1, 176400)).shape == (1, 368, 64)
    assert tower.frontend(torch.randn(2, 1, 176400)).shape == (2, 1, 256, 256)
    assert tower.tokens_per_stage == (4096, 1024, 256, 64)
    assert tower.windows_per_voice == (64, 16, 4, 1)
    assert (tower.shifted_blocks, tower.total_blocks) == (8, 18)
    shifts = [[blk.shift for blk in s.blocks] for s in tower.layers]
    assert shifts == [[0, 4], [0, 4], [0, 4] * 6, [0, 0]]
    assert [s.blocks[0].window for s in tower.layers] == [8, 8, 8, 8]


@pytest.mark.parametrize("grid, window, shift", [(8, 4, 2), (16, 8, 4), (4, 4, 0)])
def test_roll_partition_and_mask_against_a_loop(grid, window, shift):
    """Each window of the rolled grid holds the tokens a loop over the window's
    rows and columns picks from the unrolled grid ((y + s) mod R, (x + s) mod
    R); merging and rolling back restores the grid; the index of every token
    pair is (dy + W - 1)(2W - 1) + dx + W - 1; the mask is -100 exactly where
    the pair's unrolled positions fall in different regions (split at R - W
    and R - s on each axis of the rolled grid)."""
    x = torch.randn(2, grid, grid, 3)
    rolled = torch.roll(x, (-shift, -shift), (1, 2))
    windows = window_partition(rolled, window)
    n = grid // window
    mask = shift_mask(grid, window, shift) if shift else torch.zeros(n * n, window ** 2, window ** 2)
    index = relative_position_index(window)

    def region(p):
        return 0 if p < grid - window else (1 if p < grid - shift else 2)

    for w in range(n * n):
        wy, wx = divmod(w, n)
        cells = [(wy * window + i, wx * window + j) for i in range(window) for j in range(window)]
        for t, (y, xx) in enumerate(cells):
            assert torch.equal(windows[:, w, t], x[:, (y + shift) % grid, (xx + shift) % grid])
        for a, (ya, xa) in enumerate(cells):
            for b, (yb, xb) in enumerate(cells):
                dy, dx = ya - yb, xa - xb
                assert index[a, b] == (dy + window - 1) * (2 * window - 1) + dx + window - 1
                same = (region(ya), region(xa)) == (region(yb), region(xb)) if shift else True
                assert mask[w, a, b] == (0.0 if same else MASK_VALUE)
    back = torch.roll(window_merge(windows, window, grid), (shift, shift), (1, 2))
    assert torch.equal(back, x)


def test_tower_and_gradients_match_the_reference(htsat_task):
    """The tower's output and every parameter's gradient of a fixed linear
    function of it, the relative-position bias tables' and ``bn0``'s among
    them, from the same weights, in float32: the two differ in the order of
    sums only (SDPA's math path with the bias and mask as its ``attn_mask``
    against written-out attention; measured 3.2e-7 relative on the output,
    5.7e-7 on the worst gradient; the limits are some 20 times those)."""
    task, _ = htsat_task
    tower = _task(CPU).init_state().model.backbone_audio
    ref = _reference_tower(task.cfg)
    ref.load_state_dict(tower.state_dict(), strict=False)
    audio, _ = task.synthesize(BATCH_NUM)
    out, want = tower(audio), ref(audio)
    assert torch.linalg.vector_norm(out - want) <= 5e-6 * torch.linalg.vector_norm(want)
    cotangent = torch.randn(want.shape, generator=torch.Generator().manual_seed(0))
    grads = dict(zip([n for n, _ in tower.named_parameters()],
                     torch.autograd.grad((out * cotangent).sum(), list(tower.parameters()))))
    ref_grads = dict(zip([n for n, _ in ref.named_parameters()],
                         torch.autograd.grad((want * cotangent).sum(), list(ref.parameters()))))
    tables = [n for n in grads if n.endswith("relative_position_bias_table")]
    assert set(grads) == set(ref_grads) and len(grads) == 65 and len(tables) == 4
    for name, g in ref_grads.items():
        assert torch.linalg.vector_norm(grads[name] - g) <= 1e-5 * torch.linalg.vector_norm(g) + 1e-9, name
    assert all(torch.linalg.vector_norm(ref_grads[n]) > 0 for n in tables)


def test_one_train_step_matches_the_reference():
    """One VICReg step with the HTS-AT tower against the reference's (the same
    weights, batch number, dropout generator and LARS): loss and terms within
    5e-5 relative, and every parameter's change within 5e-3 of its norm or the
    median leaf's. LARS scales each change by its gradient's norm, so the
    smallest gradients carry the most relative round-off; leaves whose
    reference gradient is under 1e-3 of the median leaf's are round-off on
    both sides and left out, as the benchmark leaves them out: a bias whose
    shift a LayerNorm or BatchNorm removes."""
    task = _task(CPU)
    state = task.init_state()
    weights = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, metrics = task.train_step(state, BATCH_NUM)
    tree = copy.deepcopy(task.cfg.to_dict())
    ref = RH.pretrain(tree, weights, [BATCH_NUM], torch.device("cpu"))
    for term in ("loss", "repr_loss", "std_loss", "cov_loss"):
        assert float(metrics[f"vicreg/train/{term}"]) == pytest.approx(ref[term][0], rel=5e-5), term
    after = dict(state.model.named_parameters())
    changes = {n: torch.linalg.vector_norm(ref["params"][n] - weights[n]) for n in weights}
    median = torch.stack(list(changes.values())).median()
    grads = {n: torch.linalg.vector_norm(g) for n, g in ref["grad"].items()}
    moving = [n for n in weights if grads[n] >= 1e-3 * torch.stack(list(grads.values())).median()]
    assert len(moving) > len(weights) - 10
    assert any(n.endswith("relative_position_bias_table") for n in moving)
    for name in moving:
        want = ref["params"][name]
        gap = torch.linalg.vector_norm((after[name].detach() - weights[name]) - (want - weights[name]))
        assert gap <= 5e-3 * max(changes[name], median), name


def test_downstream_trains_on_frozen_htsat_towers():
    """``AudioToParamsTask`` on the HTS-AT towers: two steps, finite, the towers
    (and ``bn0``'s running statistics) unchanged."""
    cfg = load_config(overrides=TINY + HTSAT_TINY + CPU + ["audio_to_params.loss=param_mse"])
    pretrain = VicregPretrainTask(cfg)
    towers = pretrain.init_state()
    before = {n: t.detach().clone() for n, t in towers.model.state_dict().items()}
    task = AudioToParamsTask(cfg, pretrain, towers)
    state = task.init_state()
    assert isinstance(task.frozen.backbone_audio, HTSAT)
    for n in (3, 4):
        state, metrics = task.train_step(state, n)
        assert torch.isfinite(metrics["audio_to_params/train/loss"])
    for name, t in task.frozen.state_dict().items():
        assert torch.equal(t, before[name]), name


def test_htsat_counters_refused_trunk_and_spans():
    """The task's tower line; a vision trunk file is refused; an eager step
    under a profiler records the front end, the encoder and each stage."""
    with pytest.raises(ValueError, match="MobileNetV3-Small trunk"):
        _task(CPU + ["vicreg.vision_weights_path=tests/golden/vision_trunk_fixture.pkl"]).init_state()
    task = _task(CPU)
    state = task.init_state()
    assert task.audio_tower == ("htsat (tokens a stage 64/16; windows a voice and block 4/1; "
                                "shifted blocks 1 of 4; SDPA backends MATH)")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        task.train_step(state, BATCH_NUM)
    names = {e.name for e in prof.events()}
    assert {"tower/frontend", "tower/encoder", "tower/stage1", "tower/stage2", "step/forward"} <= names
    assert "tower/stage3" not in names


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused attention and the step graph run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_htsat_steps_give_the_eager_steps(cuda_device):
    """9 bf16 steps: one eager step, then a CUDA graph of 4 replayed twice,
    against 9 eager steps. The graph holds the roll, the bicubic stretch, the
    bias gather and the biased attention. The stretch's and the gather's
    backward add in no fixed order (atomics), so the two agree to rounding,
    not bit for bit: losses within 1e-3, every parameter within 1e-3 of its
    change's norm (or the median leaf's)."""
    runs = []
    nums = [1000 + i for i in range(9)]
    for graphed in (True, False):
        task = _task(["precision=bf16", "vicreg.batch_size=8"])
        state = task.init_state()
        start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        losses = []
        if graphed:
            for dispatch in (nums[:1], nums[1:5], nums[5:]):
                state, metrics = task.train_step_multi(state, dispatch)
                losses += metrics["vicreg/train/loss"].tolist()
            assert set(task._graphs) == {4}
        else:
            for n in nums:
                state, metrics = task.train_step(state, n)
                losses.append(float(metrics["vicreg/train/loss"]))
        runs.append((losses, start, {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    (graph_losses, start, graph_after), (eager_losses, _, eager_after) = runs
    assert len(graph_losses) == len(eager_losses) == 9
    assert graph_losses == pytest.approx(eager_losses, rel=1e-3)
    changes = {n: torch.linalg.vector_norm(eager_after[n].float() - start[n].float()) for n in start}
    median = torch.stack(list(changes.values())).median()
    for n in start:
        gap = torch.linalg.vector_norm(graph_after[n].float() - eager_after[n].float())
        assert gap <= 1e-3 * max(changes[n], median), n


@pytest.mark.cuda
def test_window_attention_takes_the_memory_efficient_backend(cuda_device):
    """Under bf16 autocast every block's biased window attention runs the
    memory-efficient SDPA operator forward and backward, and the bias tables
    get their gradient from it; where no fused backend takes the call
    (float64), the guard raises instead of falling back to the math path."""
    task = _task(["precision=bf16"])
    tower = task.init_state().model.backbone_audio
    assert tower.sdpa_backends and all(b.name != "MATH" for b in tower.sdpa_backends)
    audio, _ = task.synthesize(BATCH_NUM)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = tower(audio)
        out.float().square().sum().backward()
    names = [e.name for e in prof.events()]
    assert not any("_math" in n for n in names), sorted({n for n in names if "attention" in n})
    assert names.count("aten::_efficient_attention_forward") == tower.total_blocks
    assert names.count("aten::_efficient_attention_backward") == tower.total_blocks
    tables = [p for n, p in tower.named_parameters() if n.endswith("relative_position_bias_table")]
    assert all(p.grad is not None and torch.linalg.vector_norm(p.grad) > 0 for p in tables)
    with pytest.raises(RuntimeError):
        tower.double()(audio.double())


def _block_bias_gradient(device, batch, grid, dim, heads, shift, backends):
    """One Swin block (window 8) from a seeded init, its bias table drawn at the
    benchmark's scale (normal / sqrt(heads)), under bf16 autocast, and the
    reference's float32 block (TF32 off) from the same weights, on a batch of
    random float32 tokens: (the bias table's gradient of a fixed linear function
    of each block's output, the reference's; each block's output)."""
    from torch.nn.attention import sdpa_kernel

    from portbench.reference import strict

    strict()
    gen = torch.Generator().manual_seed(0)
    block = SwinBlock(dim, grid, 8, heads, shift, gen)
    with torch.no_grad():
        table = block.attn.relative_position_bias_table
        table.copy_(torch.randn(table.shape, generator=gen) / heads ** 0.5)
    ref = RH.SwinBlock(dim, grid, 8, heads, shift)
    ref.load_state_dict(block.state_dict())
    block, ref = block.to(device), ref.to(device)
    x = torch.randn(batch, grid * grid, dim, generator=gen).to(device)
    cotangent = torch.randn(x.shape, generator=gen).to(device)
    with sdpa_kernel(list(backends)):
        with torch.autocast(device.type, dtype=torch.bfloat16):
            out = block(x)
        (grad,) = torch.autograd.grad((out.float() * cotangent).sum(), [block.attn.relative_position_bias_table])
    want = ref(x)
    (want_grad,) = torch.autograd.grad((want * cotangent).sum(), [ref.attn.relative_position_bias_table])
    return grad.float(), want_grad, out.detach().float(), want.detach()


@pytest.mark.cuda
@pytest.mark.parametrize("grid, dim, heads, shift", [(64, 128, 4, 4), (8, 1024, 32, 0)], ids=["stage1", "stage4"])
def test_block_bias_gradient_under_memory_efficient_attention(cuda_device, grid, dim, heads, shift):
    """The bias table's gradient through the memory-efficient backward's
    per-voice mask gradient, summed over the batch by autograd, at batch 64:
    stage 1 (a 64 x 64 grid at width 128, 4 heads, shifted by 4, so the mask
    is in it) and stage 4 (one 8 x 8 window at width 1,024, 32 heads, no
    shift). Against the float32 reference block: the gradient within 1e-2
    of the reference's norm (H100, torch 2.11: 5.63e-3 at stage 1, 5.55e-3
    at stage 4; a gradient at half its value reads 0.5), the output within
    1e-2 (1.7e-4, 1.5e-3)."""
    from torch.nn.attention import SDPBackend

    grad, want, out, want_out = _block_bias_gradient(cuda_device, 64, grid, dim, heads, shift,
                                                     [SDPBackend.EFFICIENT_ATTENTION])
    gap = float(torch.linalg.vector_norm(grad - want) / torch.linalg.vector_norm(want))
    out_gap = float(torch.linalg.vector_norm(out - want_out) / torch.linalg.vector_norm(want_out))
    print(f"bias gradient gap {gap:.4e}, output gap {out_gap:.4e}")
    assert gap <= 1e-2 and out_gap <= 1e-2
