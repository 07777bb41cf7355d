"""The LARS step's three stages (``ops/lars.py``, ``csrc/lars.cu``) and the
optimizer around them (``train/optim.py:FusedLars``).

On the CPU: the plain stages against the per-tensor update the optimizer made
before them (a copy of it is below, ``per_tensor_updates``), bit for bit given
the same norms; the optimizer's CPU step against that per-tensor step, norms
included, bit for bit; the plain fold against the float64 norms and
``torch._foreach_norm``; the bf16 rounding
of ``grads_bf16`` against the cast; the non-finite guard; flash's undecayed step
where a norm is 0; weight decay 0; ``exclude_bias_and_norm``; that
``MomentumLars`` and ``Sgd`` keep their plain code; the launch counters under a
graph's recording; that ``portbench/faults.py:unchanged_state`` still leaves the
parameters as they were; and the benchmark's byte count (``portbench/counts/
lars.py``) and ``lars_roofline.train`` reader. The tests marked ``cuda`` hold the kernels to the
plain stages at the parameter lists of vicreg-full and vicreg-ast (built on the
meta device, random data): the update bit for bit given the kernel's norms, the
norms within 2e-6 of the float64 norms and of ``_foreach_norm``, two launches alike, a graph's replay
equal to an eager step, the guard, a non-contiguous tensor refused, and the
counters; they skip here. This file imports neither JAX nor ``conftest``, so the
card runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_lars.py
"""

import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu_torch.ops import launches
from inverse_audio_synthesis_tpu_torch.ops import lars as L
from inverse_audio_synthesis_tpu_torch.train.optim import (
    FusedLars,
    Fp32Master,
    MomentumLars,
    Sgd,
    make_optimizer,
    schedule_value,
)

torch.set_num_threads(2)

SCHEDULE = {"name": "LinearWarmupCosineAnnealingLR",
            "args": {"warmup_epochs": 2, "max_epochs": 10, "warmup_start_lr": 0.01, "eta_min": 0.001}}
# the pretraining cells' models, as overrides of the port's configuration
MODELS = {"vicreg-full": ["vicreg=full"], "vicreg-ast": ["vicreg=full", "audio_tower.name=ast"]}
# name -> shape; "big" spans two chunks, "z" is all zeros (a zero norm)
SHAPES = {"big": (300, 100), "w": (16, 8), "b": (8,), "z": (4, 4), "bn.weight": (8,)}


def _tensors(seed, gscale=0.1, dtype=np.float32):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params["z"][:] = 0.0
    grads = {k: (rng.randn(*s) * gscale).astype(dtype) for k, s in SHAPES.items()}
    names = list(SHAPES)
    return names, [torch.from_numpy(params[k]) for k in names], [torch.from_numpy(grads[k]) for k in names]


def per_tensor_updates(opt, grads, g_norm, w_norm, lr):
    """``FusedLars.updates`` as it was before the three stages, from given norms
    (``g_norm`` per tensor, ``w_norm`` per decayed tensor, by index)."""
    wd = opt.weight_decay
    isfinite = torch.isfinite(torch.stack(list(g_norm) + list(w_norm.values()))).all()
    out = []
    for i, (g, w) in enumerate(zip([g.float() for g in grads], opt.params)):
        if i not in w_norm:
            upd = -lr * g
        else:
            wn, gn = w_norm[i], g_norm[i]
            cond = (wn > 0.0) & (gn > 0.0)
            local_lr = torch.where(cond, opt.trust_coefficient * wn / (gn + wd * wn + opt.eps), 1.0)
            upd = -lr * (local_lr * (g + torch.where(cond, wd, 0.0) * w.float()))
        out.append(torch.where(isfinite, upd, 0.0))
    return out


CASES = {
    # args, gradient scale, the optimizer's grads_bf16, the gradients' dtype
    "flash": ({"base_lr": 2.0, "weight_decay": 1e-6}, 0.1, False, torch.float32),
    "weight_decay_0": ({"base_lr": 2.0, "weight_decay": 0.0}, 0.1, False, torch.float32),
    "exclude_bias_and_norm": ({"base_lr": 2.0, "weight_decay": 1e-3, "exclude_bias_and_norm": True}, 0.1,
                              False, torch.float32),
    "heavy_decay": ({"base_lr": 2.0, "weight_decay": 0.1}, 0.01, False, torch.float32),
    "zero_gradient": ({"base_lr": 2.0, "weight_decay": 0.1}, 0.0, False, torch.float32),
    "grads_bf16": ({"base_lr": 2.0, "weight_decay": 1e-6}, 0.1, True, torch.float32),
    "bf16_gradients": ({"base_lr": 2.0, "weight_decay": 1e-6}, 0.1, False, torch.bfloat16),
}


def _case(case, seed=0):
    args, gscale, grads_bf16, gdtype = CASES[case]
    names, params, grads = _tensors(seed, gscale)
    opt, schedule = make_optimizer({"name": "lars", "args": args}, 64, params, SCHEDULE, names=names,
                                   grads_bf16=grads_bf16)
    opt.count.fill_(3)  # a learning rate above 0
    return opt, schedule, [g.to(gdtype) for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_stages_equal_the_per_tensor_update(case):
    """Given the norms ``_foreach_norm`` takes, the plain fold's factors and the
    plain update added to the parameters are the per-tensor code's, bit for bit."""
    opt, schedule, grads = _case(case)
    plan = opt._plan
    gf = [L.gradient_plain(plan, i, g) for i, g in enumerate(grads)]
    g_norm = list(torch._foreach_norm(gf))
    decayed = [i for i in range(len(grads)) if opt._decays(i)]
    w_norm = dict(zip(decayed, torch._foreach_norm([opt.params[i] for i in decayed]))) if decayed else {}
    lr = schedule_value(schedule, opt.count)
    want = [p + u for p, u in zip(opt.params, per_tensor_updates(opt, gf, g_norm, w_norm, lr))]
    norms = torch.stack([torch.stack([g_norm[i], w_norm.get(i, torch.zeros(()))]) for i in range(len(grads))])
    local_lr, wdc, neglr, ok = L.factors_plain(plan, norms, lr)
    got = [p + u for p, u in zip(opt.params, L.updates_plain(plan, grads, local_lr, wdc, neglr, ok))]
    for name, a, b in zip(SHAPES, want, got):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_step_is_the_per_tensor_step(case):
    """On the CPU a step is the one the optimizer made before the kernels, bit
    for bit: the gradients of >= 2 dims cast to bf16 under grads_bf16 (as the
    tasks cast them), each tensor's norms by ``_foreach_norm``, the per-tensor
    update added; the count advanced and nothing counted as non-finite."""
    opt, schedule, grads = _case(case)
    gs = [g.to(torch.bfloat16) if opt.grads_bf16 and g.dim() >= 2 else g for g in grads]
    gf = [g.float() for g in gs]
    g_norm = list(torch._foreach_norm(gf))
    decayed = [i for i in range(len(grads)) if opt._decays(i)]
    w_norm = dict(zip(decayed, torch._foreach_norm([opt.params[i].float() for i in decayed]))) if decayed else {}
    lr = schedule_value(schedule, opt.count)
    want = [p + u for p, u in zip(opt.params, per_tensor_updates(opt, gs, g_norm, w_norm, lr))]
    assert opt.path == "plain"
    opt.step(grads)
    for name, a, b in zip(SHAPES, want, opt.params):
        assert torch.equal(a, b), name
    assert int(opt.count) == 4 and int(opt.total_notfinite) == 0


def _norms64(tensors):
    """Each tensor's L2 norm in float64."""
    return torch.stack([t.double().norm() for t in tensors])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fold_agrees_with_the_norms(case):
    """The chunks' sums of squares folded in float64: within 1e-6 of the float64
    norm, gradients and (for the tensors LARS adapts) weights, and at least as
    close to it as ``torch._foreach_norm``, which is 2.2e-6 off for the
    bf16-rounded 30,000-element gradient here."""
    opt, _, grads = _case(case)
    plan = opt._plan
    assert plan.n_chunks == len(SHAPES) + 1  # "big" spans two chunks
    norms = L.fold_plain(plan, L.norm_partials_plain(plan, grads)).double()
    gf = [L.gradient_plain(plan, i, g) for i, g in enumerate(grads)]
    for got, exact, foreach in ((norms[:, 0], _norms64(gf), torch.stack(torch._foreach_norm(gf))),
                                (norms[:, 1], _norms64(opt.params) * plan.lars_mask,
                                 torch.stack(torch._foreach_norm(opt.params)) * plan.lars_mask)):
        err = (got - exact).abs()
        assert bool((err <= 1e-6 * exact).all()), err / exact
        assert bool((err <= (foreach.double() - exact).abs() + 1e-7 * exact).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grads_bf16_rounds_as_the_cast_did(seed):
    """The optimizer's bf16 rounding is the cast the tasks made before: a step on
    float32 gradients with grads_bf16 equals a step without it on the gradients
    of >= 2 dims cast to bf16, bit for bit; the rounding itself is
    ``g.to(torch.bfloat16).float()`` at rounding edges, infinities and
    subnormals too."""
    names, params, grads = _tensors(seed)
    other = [p.clone() for p in params]
    args = {"base_lr": 2.0, "weight_decay": 1e-6}
    rounded, _ = make_optimizer({"name": "lars", "args": args}, 64, params, SCHEDULE, names=names, grads_bf16=True)
    cast, _ = make_optimizer({"name": "lars", "args": args}, 64, other, SCHEDULE, names=names)
    for opt in (rounded, cast):
        opt.count.fill_(3)
    rounded.step(grads)
    cast.step([g.to(torch.bfloat16) if g.dim() >= 2 else g for g in grads])
    for name, a, b in zip(names, params, other):
        assert torch.equal(a, b), name
    edges = torch.tensor([1.0 + 2**-8, 1.0 + 3 * 2**-8, -(1.0 + 2**-8), 3.4e38, float("inf"), -float("inf"),
                          1e-40, -1e-41, 0.0, -0.0, 1.00390625, 65504.0], dtype=torch.float32)
    x = torch.cat([edges, torch.randn(4096, generator=torch.Generator().manual_seed(seed)) * 10.0 ** seed])
    plan = L.LarsPlan([x], [True], [True], 0.0, 0.001, 1e-8)
    got, want = L.gradient_plain(plan, 0, x), x.to(torch.bfloat16).float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("where", ["nan_in_matrix", "inf_in_bias", "nan_in_decayed_weight"])
def test_nonfinite_step_is_rejected(where):
    """No update, the count held, the counter + 1; the next finite step applies."""
    names, params, grads = _tensors(5)
    if where == "nan_in_matrix":
        grads[names.index("w")][3, 2] = float("nan")
    elif where == "inf_in_bias":
        grads[names.index("b")][1] = float("inf")
    else:
        params[names.index("big")][7, 7] = float("nan")
    opt, _ = make_optimizer({"name": "lars", "args": {"base_lr": 2.0, "weight_decay": 1e-6}}, 64, params,
                            SCHEDULE, names=names)
    opt.count.fill_(3)
    before = [p.clone() for p in params]
    opt.step(grads)
    assert int(opt.count) == 3 and int(opt.total_notfinite) == 1
    for name, a, b in zip(names, before, params):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name
    if where != "nan_in_decayed_weight":
        opt.step(_tensors(6)[2])
        assert int(opt.count) == 4 and int(opt.total_notfinite) == 1
        assert not torch.equal(before[0], params[0])


def test_zero_norm_tensor_takes_the_undecayed_step():
    """flash: where ||w|| or ||g|| is 0 the update is -lr * g, with no decay."""
    opt, schedule, grads = _case("heavy_decay")
    z = list(SHAPES).index("z")
    before = opt.params[z].clone()
    lr = schedule_value(schedule, opt.count)
    opt.step(grads)
    assert torch.equal(opt.params[z], before + (-lr) * grads[z])
    assert bool((opt.params[z] != 0).any())


def test_weight_decay_zero_is_plain_sgd():
    opt, schedule, grads = _case("weight_decay_0")
    assert not any(opt._plan.lars)
    before = [p.clone() for p in opt.params]
    lr = schedule_value(schedule, opt.count)
    opt.step(grads)
    for name, p, b, g in zip(SHAPES, opt.params, before, grads):
        assert torch.equal(p, b + (-lr) * g), name


def test_exclude_bias_and_norm_adapts_only_matrices():
    opt, schedule, grads = _case("exclude_bias_and_norm")
    assert opt._plan.lars == tuple(len(s) >= 2 for s in SHAPES.values())
    before = [p.clone() for p in opt.params]
    lr = schedule_value(schedule, opt.count)
    opt.step(grads)
    for name, p, b, g in zip(SHAPES, opt.params, before, grads):
        plain = torch.equal(p, b + (-lr) * g)
        assert plain == (len(SHAPES[name]) < 2 or name == "z"), name


@pytest.mark.parametrize("cfg", [{"name": "lars", "args": {"base_lr": 2.0, "weight_decay": 1e-6}},
                                 {"name": "sgd", "args": {"lr": 0.1}}], ids=["lars", "sgd"])
def test_momentum_and_sgd_keep_their_plain_code(cfg):
    """MomentumLars does not inherit the kernel path: it is no FusedLars and has no
    plan; Sgd neither, with momentum or without."""
    names, params, _ = _tensors(0)
    for momentum in (0.0, 0.9):
        opt, _ = make_optimizer(cfg, 64, params, SCHEDULE, momentum=momentum, names=names)
        fused = cfg["name"] == "lars" and not momentum
        assert isinstance(opt, FusedLars) == fused and hasattr(opt, "_plan") == fused
        assert opt.path == "plain"
        assert isinstance(opt, MomentumLars if cfg["name"] == "lars" and momentum else (FusedLars, Sgd))


@pytest.mark.parametrize("masters", [False, True], ids=["float32", "fp32_masters"])
def test_unchanged_state_fault_leaves_the_parameters(masters):
    """portbench's ``unchanged_state`` fault patches ``_Guarded.step``: the step
    computes the updates and applies none."""
    from portbench import faults

    names, params, grads = _tensors(2)
    cfg = {"name": "lars", "args": {"base_lr": 2.0, "weight_decay": 1e-6}}
    if masters:
        params = [p.to(torch.bfloat16) if p.dim() >= 2 else p for p in params]
        opt = Fp32Master(params, lambda m: make_optimizer(cfg, 64, m, SCHEDULE, names=names)[0], names)
        grads = [g.to(p.dtype) for g, p in zip(grads, params)]
    else:
        opt, _ = make_optimizer(cfg, 64, params, SCHEDULE, names=names)
    opt.count.fill_(3)
    before = [p.clone() for p in params]
    with faults.unchanged_state():
        opt.step(grads)
    assert all(torch.equal(a, b) for a, b in zip(before, params))
    opt.step(grads)
    assert not all(torch.equal(a, b) for a, b in zip(before, params))


def test_a_graph_recording_counts_every_kernel_module():
    """Launches made while a capture records go to the recording, of both kernel
    modules; each replay adds them to their own module's counts."""
    from inverse_audio_synthesis_tpu_torch.ops import render as R

    L.reset_launch_counts()
    R.reset_launch_counts()
    with launches.recording_launches() as recorded:
        for name in ("lars_norm", "lars_fold", "lars_update", "render_fwd"):
            launches.count(name)
    assert L.launch_counts == {"lars_norm": 0, "lars_fold": 0, "lars_update": 0}
    assert recorded == {"render_fwd": 1, "render_bwd": 0, "lars_norm": 1, "lars_fold": 1, "lars_update": 1}
    launches.count_replay(recorded)
    launches.count_replay(recorded)
    assert L.launch_counts == {"lars_norm": 2, "lars_fold": 2, "lars_update": 2}
    assert R.launch_counts == {"render_fwd": 2, "render_bwd": 0}
    L.reset_launch_counts()
    R.reset_launch_counts()


# -- the benchmark's count and metric ---------------------------------------------------


BENCH_CONFIGS = {"vicreg-full": (171, 173_298_976), "vicreg-ast": (174, 231_244_544)}


def _bench_tree(config):
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "portbench" / "configs" / f"{config}.json"
    return json.loads(path.read_text())["config"]


@pytest.mark.parametrize("config", sorted(BENCH_CONFIGS))
def test_lars_least_bytes_count_every_parameter(config):
    """12 bytes a parameter (read g and w, write w, all float32) over the
    reference model's parameters, which are the port's: the same tensors and
    sizes as the meta-built port model; 10 for a bf16 gradient of >= 2 dims."""
    from portbench.counts import lars as LC
    from inverse_audio_synthesis_tpu_torch.train.pretrain import build_vicreg_model
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    tensors, params = BENCH_CONFIGS[config]
    with torch.device("meta"):
        port = build_vicreg_model(load_config(overrides=MODELS[config] + ["platform=cpu"]))
    assert len(list(port.parameters())) == tensors and sum(p.numel() for p in port.parameters()) == params
    tree = _bench_tree(config)
    assert LC.least_bytes(tree) == 12 * params
    matrices = sum(p.numel() for p in port.parameters() if p.dim() >= 2)
    assert LC.least_bytes({**tree, "weights_bf16": True}) == 12 * params - 2 * matrices


@pytest.mark.parametrize("launches_a_step", [3, 2, 0])
def test_lars_roofline_reads_three_launches_a_step(launches_a_step):
    """The least time over the ``lars_`` kernels' device time where the trace
    holds 3 of them a profiled step; None otherwise (a program without them)."""
    from portbench.core import spec

    reader = spec.metric_reader("lars_roofline.train")
    tree = _bench_tree("vicreg-full")
    steps, seconds = 7, 0.0125
    kernels = {"void (anonymous namespace)::lars_norm_kernel<384>(...)": (seconds / 2, launches_a_step * steps),
               "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>(...)": (1.0, 99)}
    ctx = {"config": tree, "profiled": [{"steps": 3}, {"steps": 4}],
           "trace": {"kernels": kernels if launches_a_step else {}}}
    got = reader.read(ctx)
    if launches_a_step != 3:
        assert got is None
        return
    assert got == pytest.approx(100.0 * 12 * 173_298_976 * steps / 3.35e12 / (seconds / 2))


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LARS kernels have no CPU mode")
    return torch.device("cuda")


def _model_tensors(model, device, seed=0, grad_dtype=torch.float32):
    """The model's parameter names and shapes (built on the meta device) with
    random weights and gradients on ``device``."""
    from inverse_audio_synthesis_tpu_torch.train.pretrain import build_vicreg_model
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    with torch.device("meta"):
        meta = build_vicreg_model(load_config(overrides=MODELS[model] + ["platform=cpu"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    named = list(meta.named_parameters())
    params = [torch.randn(p.shape, generator=gen, device=device) * 0.05 for _, p in named]
    grads = [(torch.randn(p.shape, generator=gen, device=device) * 1e-3).to(grad_dtype) for _, p in named]
    return [n for n, _ in named], params, grads


def _fused(params, names, grads_bf16=False, wd=1e-6):
    opt, schedule = make_optimizer({"name": "lars", "args": {"base_lr": 3.2, "weight_decay": wd}}, 16, params,
                                   SCHEDULE, names=names, grads_bf16=grads_bf16)
    opt.count.fill_(3)
    return opt, schedule


@pytest.mark.cuda
@pytest.mark.parametrize("grads", ["float32", "grads_bf16", "bf16"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_kernel_update_is_the_plain_update_given_its_norms(cuda_device, model, grads):
    """One kernel step against the plain stages on a copy, given the kernel's
    norms: the factors and the updated parameters bit for bit; the norms within
    2e-6 of ``_foreach_norm``; three launches; the count advanced."""
    names, params, gs = _model_tensors(model, cuda_device,
                                       grad_dtype=torch.bfloat16 if grads == "bf16" else torch.float32)
    copy = [p.clone() for p in params]
    opt, schedule = _fused(params, names, grads_bf16=grads == "grads_bf16")
    plain, _ = _fused(copy, names, grads_bf16=grads == "grads_bf16")
    assert opt.path == "kernel" and opt._plan.n_chunks > len(params)
    lr = schedule_value(schedule, opt.count)
    L.reset_launch_counts()
    opt.step(gs)
    torch.cuda.synchronize()
    assert L.launch_counts == {"lars_norm": 1, "lars_fold": 1, "lars_update": 1}
    assert int(opt.count) == 4 and int(opt.total_notfinite) == 0
    plan = plain._plan
    norms = opt._plan.norms.clone()
    gf = [L.gradient_plain(plan, i, g) for i, g in enumerate(gs)]
    for got, exact, foreach in ((norms[:, 0], _norms64(gf), torch.stack(torch._foreach_norm(gf))),
                                (norms[:, 1], _norms64(copy), torch.stack(torch._foreach_norm(copy)))):
        assert bool(((got.double() - exact).abs() <= 2e-6 * exact).all())
        torch.testing.assert_close(got, foreach, rtol=2e-6, atol=0.0)
    local_lr, wdc, neglr, ok = L.factors_plain(plan, norms, lr)
    assert torch.equal(opt._plan.factors, torch.stack([local_lr, wdc], 1))
    assert torch.equal(opt._plan.step, torch.stack([neglr, ok.float()]))
    for p, u in zip(copy, L.updates_plain(plan, gs, local_lr, wdc, neglr, ok)):
        p.add_(u)
    torch.cuda.synchronize()
    bad = [n for n, a, b in zip(names, params, copy) if not torch.equal(a, b)]
    assert not bad, bad[:5]


@pytest.mark.cuda
def test_two_kernel_steps_give_the_same_bits(cuda_device):
    names, params, grads = _model_tensors("vicreg-full", cuda_device, seed=1)
    copy = [p.clone() for p in params]
    runs = []
    for ps in (params, copy):
        opt, _ = _fused(ps, names, grads_bf16=True)
        opt.step(grads)
        opt.step(grads)
        runs.append((opt._plan.partials.clone(), opt._plan.norms.clone()))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(params, copy))


@pytest.mark.cuda
def test_a_graph_replay_is_the_eager_step(cuda_device):
    """Two steps captured into a CUDA graph, replayed: the parameters, count and
    norms of two eager steps, bit for bit; the graph's launches recorded at
    capture and counted at the replay."""
    names, params, grads = _model_tensors("vicreg-ast", cuda_device, seed=2)
    copy = [p.clone() for p in params]
    eager, _ = _fused(params, names, grads_bf16=True)
    graphed, _ = _fused(copy, names, grads_bf16=True)
    static = [g.clone() for g in grads]
    eager.step(grads)  # the library is loaded outside the capture
    graphed.step(static)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), launches.recording_launches() as recorded:
        with torch.cuda.graph(graph, stream=stream):
            graphed.step(static)
            graphed.step(static)
    torch.cuda.current_stream().wait_stream(stream)
    assert recorded["lars_norm"] == recorded["lars_fold"] == recorded["lars_update"] == 2
    L.reset_launch_counts()
    graph.replay()
    launches.count_replay(recorded)
    eager.step(grads)
    eager.step(grads)
    torch.cuda.synchronize()
    assert L.launch_counts == {"lars_norm": 4, "lars_fold": 4, "lars_update": 4}
    assert int(eager.count) == int(graphed.count) == 6
    assert torch.equal(eager._plan.norms, graphed._plan.norms)
    assert all(torch.equal(a, b) for a, b in zip(params, copy))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["gradient", "weight"])
def test_the_guard_on_the_card(cuda_device, where):
    names, params, grads = _model_tensors("vicreg-full", cuda_device, seed=3)
    (grads if where == "gradient" else params)[-3].view(-1)[5] = float("nan")
    opt, _ = _fused(params, names)
    before = [p.clone() for p in params]
    opt.step(grads)
    torch.cuda.synchronize()
    assert int(opt.count) == 3 and int(opt.total_notfinite) == 1 and float(opt._plan.step[1]) == 0.0
    for a, b in zip(before, params):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
def test_tensors_the_kernels_do_not_take_raise(cuda_device):
    base = torch.randn(8, 6, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous float32"):
        FusedLars([base.t(), torch.randn(4, device=cuda_device)], 0.1, weight_decay=1e-6)
    with pytest.raises(ValueError, match="contiguous float32"):
        FusedLars([base.double()], 0.1, weight_decay=1e-6)
    with pytest.raises(ValueError, match=f"at most {L.MAX_TENSORS}"):
        FusedLars([torch.zeros(2, device=cuda_device) for _ in range(L.MAX_TENSORS + 1)], 0.1)
    opt = FusedLars([base, torch.randn(4, device=cuda_device)], 0.1, weight_decay=1e-6)
    L.reset_launch_counts()
    with pytest.raises(ValueError, match="gradient 0"):
        opt.step([torch.randn(6, 8, device=cuda_device).t(), torch.randn(4, device=cuda_device)])
    with pytest.raises(ValueError, match="gradient 1"):
        opt.step([torch.randn(8, 6, device=cuda_device), torch.randn(4, device=cuda_device).half()])
    assert L.launch_counts["lars_fold"] == 0 and int(opt.count) == 0
    opt.step([torch.randn(8, 6, device=cuda_device), torch.randn(4, device=cuda_device)])
    torch.cuda.synchronize()
    assert L.launch_counts["lars_fold"] == 1 and int(opt.count) == 1
