#!/usr/bin/env python3
"""Is the `combined` downstream gradient's ill-conditioning the objective's own?

    python tools/probe_combined_conditioning.py [--batch 8] [--batch-nums 7 8 9] [overrides ...]

On the CPU, in float32, one downstream train step of the `combined` objective
(param_mse 1.0 + mel_l1 0.1, the grad-through-synth term) at a small batch of
4 s voices, with `torchsynth.render_bwd=jnp` (the gradient of the portable
render), narrow towers and dropout 0, in the JAX package's `AudioToParamsTask`
and in the port's, from the same tower and head weights. The head's input, the
frozen audio representation, is the same array in both: a seeded normal draw
(random-init towers map every voice to nearly the same representation, and the
head's train-mode BatchNorm would amplify the towers' float32 differences
between the packages). Each package takes the step twice: from that
representation, and with each of its values moved up by one float32 ulp
(`nextafter`). Printed per batch number and objective (`combined`, and its two
terms alone): the gradient's relative change ||g' - g|| / ||g|| and norm ratio
in each package, and the port's gradient against JAX's; then one JSON line. A
change of the same order in both packages makes the ill-conditioning the
objective's nature; one in the port alone would be a port fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OBJECTIVES = ("combined", "param_mse", "mel_l1")


def overrides_for(batch: int, objective: str, extra) -> list:
    """Narrow widths (the tiny test config's), 4 s voices on the default 240 x 245
    pseudo-image, float32, the portable render's gradient."""
    return [
        "dim=32", "embeddim=64", "vicreg.mlp='64-%d'", "precision=f32",
        "image.height=240", "image.width=245", "torchsynth.buffer_size_seconds=4.0",
        f"audio_to_params.batch_size={batch}", f"audio_to_params.loss={objective}",
        "audio_to_params.dropout=0", "param_embed.dropout=0", "torchsynth.render_bwd=jnp",
        "mel.method=fft", "mel.test_method=fft", *extra,
    ]


def representation(batch: int, dim: int, nudge: bool) -> np.ndarray:
    r = np.random.RandomState(0).randn(batch, dim).astype(np.float32)
    return np.nextafter(r, np.float32(np.inf)) if nudge else r


def jax_gradients(overrides, batch_nums, rep: np.ndarray):
    """(per batch number the flat head-gradient tree of one JAX step from the
    initial head, tower variables, head variables)."""
    import jax
    import jax.numpy as jnp
    import optax

    jax.config.update("jax_platforms", "cpu")
    from inverse_audio_synthesis_tpu.parallel.mesh import create_mesh
    from inverse_audio_synthesis_tpu.train.downstream import AudioToParamsTask
    from inverse_audio_synthesis_tpu.train.pretrain import VicregPretrainTask
    from inverse_audio_synthesis_tpu.utils.config import load_config
    from inverse_audio_synthesis_tpu_torch.models.jax_weights import flatten

    cfg = load_config(overrides=overrides)
    mesh = create_mesh(1, 1, devices=jax.devices()[:1])
    pre = VicregPretrainTask(cfg, mesh)
    towers = pre.init_state()
    task = AudioToParamsTask(cfg, mesh, pre, towers)
    # the state's "optimizer" keeps the gradient and applies nothing
    task.tx = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )
    task._audio_repr = lambda frozen, audio: jnp.asarray(rep)
    init = task.init_state()
    head = jax.device_get({"params": init.params, "batch_stats": init.batch_stats})
    grads = []
    for n in batch_nums:
        state, _ = task.train_step(task.init_state(), n)
        grads.append(flatten({"params": jax.device_get(state.opt_state)}))
    return grads, jax.device_get({"params": towers.params, "batch_stats": towers.batch_stats}), head


def port_gradients(overrides, batch_nums, rep: np.ndarray, towers, head):
    """Per batch number the port's flat head-gradient tree (JAX layout) of one
    step from the same weights."""
    import torch

    from inverse_audio_synthesis_tpu_torch.models.jax_weights import (
        export_jax_variables,
        flatten,
        load_jax_variables,
    )
    from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask
    from inverse_audio_synthesis_tpu_torch.utils.config import load_config

    cfg = load_config(overrides=overrides + ["platform=cpu"])
    pre = VicregPretrainTask(cfg)
    frozen = pre.init_state()
    load_jax_variables(frozen.model, towers)
    task = AudioToParamsTask(cfg, pre, frozen)
    task._audio_repr = lambda audio: torch.from_numpy(rep)
    out = []
    for n in batch_nums:
        state = task.init_state()
        load_jax_variables(state.model, head)
        seen = []
        step = state.optimizer.step
        state.optimizer.step = lambda grads: (seen.append([g.detach().clone() for g in grads]), step(grads))
        task.train_step(state, n)
        with torch.no_grad():  # the head's tensors set to their gradients, then in JAX's layout
            for p, g in zip(state.optimizer.params, seen[0]):
                p.copy_(g)
        out.append(flatten(export_jax_variables(state.model, {"params": head["params"]})))
    return out


def gap(ref: dict, got: dict):
    """(||got - ref|| / ||ref||, ||got|| / ||ref||) over every tensor."""
    keys = sorted(ref)
    sq = lambda d: sum(float(np.sum(np.asarray(d[k], np.float64) ** 2)) for k in keys)
    diff = {k: np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64) for k in keys}
    return (sq(diff) / sq(ref)) ** 0.5, (sq(got) / sq(ref)) ** 0.5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batch-nums", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()

    import torch

    torch.set_num_threads(4)
    rows = []
    for objective in OBJECTIVES:
        over = overrides_for(args.batch, objective, args.overrides)
        t0 = time.time()
        rep, rep_nudged = representation(args.batch, 32, False), representation(args.batch, 32, True)
        jax_ref, towers, head = jax_gradients(over, args.batch_nums, rep)
        jax_nudged, _, _ = jax_gradients(over, args.batch_nums, rep_nudged)
        port_ref = port_gradients(over, args.batch_nums, rep, towers, head)
        port_nudged = port_gradients(over, args.batch_nums, rep_nudged, towers, head)
        for n, jr, jn, pr, pn in zip(args.batch_nums, jax_ref, jax_nudged, port_ref, port_nudged):
            row = {"objective": objective, "batch_num": n}
            row["jax_rel"], row["jax_norm_ratio"] = gap(jr, jn)
            row["port_rel"], row["port_norm_ratio"] = gap(pr, pn)
            row["port_vs_jax_rel"], row["port_vs_jax_norm_ratio"] = gap(jr, pr)
            rows.append(row)
            print(f"{objective}, batch {args.batch}, 4 s voices, render_bwd=jnp, batch number {n}: one ulp "
                  f"of the representation moves the gradient by {row['jax_rel']:.4e} of its norm in JAX "
                  f"(norm ratio {row['jax_norm_ratio']:.6f}) and by {row['port_rel']:.4e} in the port "
                  f"({row['port_norm_ratio']:.6f}); the port against JAX: {row['port_vs_jax_rel']:.4e} "
                  f"({row['port_vs_jax_norm_ratio']:.6f}) [{time.time() - t0:.0f} s]", flush=True)
    print(json.dumps({"batch": args.batch, "seconds": 4.0, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
