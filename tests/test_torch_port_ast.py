"""The AST audio tower (``models/ast.py``, ``audio_tower.name: ast``) against
the benchmark's plain float32 reference (``portbench/reference/ast.py``).

A tiny AST (width 64, 2 blocks, 4 heads, 32 mel bins, 100 frames: 2 + 2 x 9
tokens) on the port tests' 1 s / batch-4 synth, float32 on the CPU:
- the port's Kaldi fbank against the reference's, and its geometry at 4 s;
- the tower's output and every parameter's gradient from the same weights;
- one VICReg ``train_step`` against the reference's step: loss, its terms and
  every parameter's change;
- a tree without ``audio_tower`` builds today's MobileNetV3-Small model; the
  downstream task builds and steps on frozen AST towers; a vision trunk file
  is refused; the tower's spans under a profiler.

The tests marked ``cuda`` run on the card (this file imports neither JAX nor
``conftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_ast.py

They hold an eager step and a CUDA graph of 4 steps replayed twice against 9
eager steps at bf16, and check that the attention takes a fused backend, never
the math path.
"""

import copy

import pytest
import torch

from inverse_audio_synthesis_tpu_torch.models.ast import AST, frame_geometry, kaldi_fbank
from inverse_audio_synthesis_tpu_torch.models.audioembed import AudioEmbedding
from inverse_audio_synthesis_tpu_torch.models.paramembed import ParamEmbed
from inverse_audio_synthesis_tpu_torch.models.vicreg import VICRegModule, parse_projector_spec
from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask, build_vicreg_model
from inverse_audio_synthesis_tpu_torch.utils.config import load_config
from portbench.reference import ast as RA

torch.set_num_threads(2)

TINY = ["vicreg=fast", "dim=32", "embeddim=64", "vicreg.mlp='64-%d'", "vicreg.batch_size=4",
        "image.height=105", "image.width=140", "torchsynth.buffer_size_seconds=1.0", "precision=f32",
        "audio_to_params.batch_size=4"]
AST_TINY = ["audio_tower.name=ast", "vicreg.pretrained_vision_model=false", "audio_tower.ast.input_fdim=32",
            "audio_tower.ast.input_tdim=100", "audio_tower.ast.embed_dim=64", "audio_tower.ast.depth=2",
            "audio_tower.ast.num_heads=4", "audio_tower.ast.mlp_dim=256"]
CPU = ["platform=cpu"]
BATCH_NUM = 7


def _task(extra=()):
    return VicregPretrainTask(load_config(overrides=TINY + AST_TINY + list(extra)))


def _reference_tower(cfg):
    return RA.AST(cfg.dim, cfg.torchsynth.rate, **dict(cfg.audio_tower.ast))


@pytest.fixture(scope="module")
def ast_task():
    task = _task(CPU)
    return task, task.init_state()


def test_fbank_matches_the_reference(ast_task):
    """The normalised fbank of the synth's 1 s voices. Both run in float32 with
    their own framing, window and banks (the port's in float64 cast once, the
    reference's the same way, its power as re^2 + im^2): measured 4.4e-8 of the
    features' spread; the limit is 20 times that, as float32 rounding."""
    task, state = ast_task
    audio, _ = task.synthesize(BATCH_NUM)
    got = state.model.backbone_audio.fbank(audio)
    want = _reference_tower(task.cfg).features(audio)
    assert got.shape == want.shape == (4, 100, 32)
    pad = (0 - task.cfg.audio_tower.ast.norm_mean) / (2 * task.cfg.audio_tower.ast.norm_std)
    assert torch.allclose(got[:, 98:], torch.full((4, 2, 32), pad))  # 98 frames, padded to 100
    assert torch.linalg.vector_norm(got - want) <= 1e-6 * torch.linalg.vector_norm(want - want.mean())


def test_fbank_geometry_at_4_s():
    """4 s at 44.1 kHz: a 1,102-sample window every 441, a 2,048-point FFT,
    398 frames, padded to 400; 128 bins, 12 x 39 patches and 2 class tokens."""
    assert frame_geometry(44100, 25.0, 10.0) == (1102, 441, 2048)
    tower = AST(dim=16, sample_rate=44100, embed_dim=32, depth=1, num_heads=2, mlp_dim=64)
    assert tower.tokens_per_voice == 470 and tower.n_fft == 2048 and tower.shift == 441
    frames = kaldi_fbank(torch.randn(1, 176400), tower.window, tower.mel_banks, tower.shift, tower.n_fft)
    assert frames.shape == (1, 398, 128) and tower.fbank(torch.randn(1, 1, 176400)).shape == (1, 400, 128)


def test_tower_and_gradients_match_the_reference(ast_task):
    """The tower's output and every parameter's gradient of a fixed linear
    function of it, from the same weights, in float32: the two differ in the
    order of sums only (SDPA's math path against written-out attention;
    measured 2.3e-7 relative on the output, 5.8e-7 on the worst gradient; the
    limits are some 20 times those)."""
    task, _ = ast_task
    tower = _task(CPU).init_state().model.backbone_audio
    ref = _reference_tower(task.cfg)
    ref.load_state_dict(tower.state_dict())
    audio, _ = task.synthesize(BATCH_NUM)
    out, want = tower(audio), ref(audio)
    assert torch.linalg.vector_norm(out - want) <= 5e-6 * torch.linalg.vector_norm(want)
    cotangent = torch.randn(want.shape, generator=torch.Generator().manual_seed(0))
    grads = dict(zip([n for n, _ in tower.named_parameters()],
                     torch.autograd.grad((out * cotangent).sum(), list(tower.parameters()))))
    ref_grads = dict(zip([n for n, _ in ref.named_parameters()],
                         torch.autograd.grad((want * cotangent).sum(), list(ref.parameters()))))
    assert set(grads) == set(ref_grads) and len(grads) == 5 + 12 * 2 + 2 + 4
    for name, g in ref_grads.items():
        assert torch.linalg.vector_norm(grads[name] - g) <= 1e-5 * torch.linalg.vector_norm(g) + 1e-9, name


def test_one_train_step_matches_the_reference():
    """One VICReg step with the AST tower against the reference's (the same
    weights, batch number, dropout generator and LARS): loss and terms within
    5e-5 relative (measured 1.5e-6 on the loss, 6.0e-6 on the covariance term,
    which the projector's BatchNorm amplifies), and every parameter's change
    within 5e-3 of its norm or the median leaf's (measured 8.6e-4 at worst:
    LARS scales each change by its gradient's norm, the smallest gradients
    carry the most relative round-off). Leaves whose reference gradient is
    under 1e-3 of the median leaf's are round-off on both sides and left out,
    as the benchmark leaves them out: a bias whose shift a BatchNorm removes
    (``mlp_head.0.bias`` feeds the projector's first BatchNorm)."""
    task = _task(CPU)
    state = task.init_state()
    weights = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, metrics = task.train_step(state, BATCH_NUM)
    tree = copy.deepcopy(task.cfg.to_dict())
    ref = RA.pretrain(tree, weights, [BATCH_NUM], torch.device("cpu"))
    for term in ("loss", "repr_loss", "std_loss", "cov_loss"):
        assert float(metrics[f"vicreg/train/{term}"]) == pytest.approx(ref[term][0], rel=5e-5), term
    after = dict(state.model.named_parameters())
    changes = {n: torch.linalg.vector_norm(ref["params"][n] - weights[n]) for n in weights}
    median = torch.stack(list(changes.values())).median()
    grads = {n: torch.linalg.vector_norm(g) for n, g in ref["grad"].items()}
    moving = [n for n in weights if grads[n] >= 1e-3 * torch.stack(list(grads.values())).median()]
    assert len(moving) > len(weights) - 10
    for name in moving:
        want = ref["params"][name]
        gap = torch.linalg.vector_norm((after[name].detach() - weights[name]) - (want - weights[name]))
        assert gap <= 5e-3 * max(changes[name], median), name


def _mobilenet_model_as_before(cfg, generator):
    """The model build_vicreg_model made before ``audio_tower`` existed."""
    return VICRegModule(
        backbone_audio=AudioEmbedding(dim=cfg.dim, image_size=(cfg.image.height, cfg.image.width),
                                      generator=generator),
        backbone_param=ParamEmbed(nparams=cfg.nparams, dim=cfg.dim, hidden_norm=cfg.param_embed.hidden_norm,
                                  dropout=cfg.param_embed.dropout, generator=generator),
        projector_dims=parse_projector_spec(cfg.vicreg.mlp, cfg.dim, cfg.embeddim),
        generator=generator,
    )


def test_a_tree_without_the_key_builds_todays_model():
    """Without ``audio_tower`` (as every benchmark tree before the AST has it)
    the model is MobileNetV3-Small's: the same names, weights and outputs."""
    cfg = load_config(overrides=TINY + CPU)
    del cfg["audio_tower"]
    got = build_vicreg_model(cfg, torch.Generator().manual_seed(3)).eval()
    want = _mobilenet_model_as_before(cfg, torch.Generator().manual_seed(3)).eval()
    assert isinstance(got.backbone_audio, AudioEmbedding)
    assert list(got.state_dict()) == list(want.state_dict())
    for (name, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), name
    task = VicregPretrainTask(cfg)
    audio, params01 = task.synthesize(BATCH_NUM)
    with torch.no_grad():
        for a, b in zip(got(audio, params01), want(audio, params01)):
            assert torch.equal(a, b)


def test_downstream_trains_on_frozen_ast_towers():
    """``AudioToParamsTask`` on the AST towers: two steps, finite, the towers
    unchanged."""
    cfg = load_config(overrides=TINY + AST_TINY + CPU + ["audio_to_params.loss=param_mse"])
    pretrain = VicregPretrainTask(cfg)
    towers = pretrain.init_state()
    before = {n: p.detach().clone() for n, p in towers.model.named_parameters()}
    task = AudioToParamsTask(cfg, pretrain, towers)
    state = task.init_state()
    assert isinstance(task.frozen.backbone_audio, AST)
    for n in (3, 4):
        state, metrics = task.train_step(state, n)
        assert torch.isfinite(metrics["audio_to_params/train/loss"])
    for name, p in task.frozen.named_parameters():
        assert torch.equal(p, before[name]), name


def test_ast_refuses_a_vision_trunk_and_logs_its_counters():
    with pytest.raises(ValueError, match="MobileNetV3-Small trunk"):
        _task(CPU + ["vicreg.vision_weights_path=tests/golden/vision_trunk_fixture.pkl"]).init_state()
    task = _task(CPU)
    task.init_state()
    assert task.audio_tower == "ast (20 tokens a voice; SDPA backends MATH)"


def test_the_towers_spans_in_a_profiled_eager_step():
    task = _task(CPU)
    state = task.init_state()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        task.train_step(state, BATCH_NUM)
    names = {e.name for e in prof.events()}
    assert {"tower/frontend", "tower/encoder", "step/forward"} <= names


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused attention and the step graph run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_ast_steps_give_the_eager_steps(cuda_device):
    """9 bf16 steps: one eager step, then a CUDA graph of 4 replayed twice,
    against 9 eager steps. The attention's backward (cuDNN's on the H100)
    accumulates dq in float32 across blocks in no fixed order, so the two
    agree to rounding, not bit for bit: losses within 1e-3, every parameter
    within 1e-3 of its change's norm (or the median leaf's)."""
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
            assert task._use_graphs and set(task._graphs) == {4}
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
def test_attention_takes_a_fused_backend_never_the_math_path(cuda_device):
    """Under bf16 autocast the tower's attention runs a fused SDPA operator
    forward and backward; where no fused backend takes the call (float64), the
    guard raises instead of falling back to the math path."""
    task = _task(["precision=bf16"])
    tower = task.init_state().model.backbone_audio
    assert tower.sdpa_backends and all(b.name != "MATH" for b in tower.sdpa_backends)
    audio, _ = task.synthesize(BATCH_NUM)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = tower(audio)
        out.float().square().sum().backward()
    names = {e.name for e in prof.events()}
    assert not any("_math" in n for n in names), sorted(n for n in names if "attention" in n)
    assert any(n.startswith("aten::_scaled_dot_product_") and "math" not in n for n in names)
    with pytest.raises(RuntimeError):
        tower.double()(audio.double())
