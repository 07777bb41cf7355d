"""Nearest-neighbour retrieval eval CLI of the PyTorch port.

    python -m inverse_audio_synthesis_tpu_torch.evaluate_audio_representations \
        [vicreg_checkpoint=<dir>] [retrieval.n_batches=100] ... [platform=cpu]

Same config keys and output as the JAX package's root
``evaluate_audio_representations.py``: loads the VICReg checkpoint
(``vicreg_checkpoint``, default ``<run_dir>/checkpoints/vicreg``), embeds
``retrieval.test_batch_size`` query sounds with the projector's output, runs the
planted-query gate, then streams ``retrieval.n_batches`` candidate batches of
``retrieval.predict_batch_size`` in sub-chunks of ``retrieval.inner_chunk``,
logging each improvement as a (query, silence, match) clip. State and the
convergence curves go to ``<run_dir>/retrieval``; a rerun resumes. Exits 75 when
stopped by a signal. Runs on the CUDA device; ``platform=cpu`` runs on the CPU.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

from inverse_audio_synthesis_tpu_torch.eval.retrieval import RetrievalEvaluator
from inverse_audio_synthesis_tpu_torch.train.pretrain import restore_vicreg, synth_config_from_cfg
from inverse_audio_synthesis_tpu_torch.utils.config import load_config
from inverse_audio_synthesis_tpu_torch.utils.logging import MetricsLogger


def app(cfg) -> int:
    task, state, step = restore_vicreg(cfg)
    if step is not None:
        print(f"loaded vicreg checkpoint step {step}")
    run_dir = Path(cfg.get("run_dir", "runs"))
    # the reference's 16 queries and 1024-candidate batches
    test_bs = cfg.get_dotted("retrieval.test_batch_size", 16)
    predict_bs = cfg.get_dotted("retrieval.predict_batch_size", 1024)
    n_batches = cfg.get_dotted("retrieval.n_batches", 100)

    logger = MetricsLogger(
        run_dir=str(run_dir),
        config=cfg.to_dict(),
        use_wandb=cfg.get("log") == "wand",
        run_name="retrieval-torch-" + time.strftime("%Y%m%d-%H%M%S"),
    )
    try:
        evaluator = RetrievalEvaluator(
            embed_fn=lambda audio: task.project_audio(state, audio),
            query_synth=synth_config_from_cfg(cfg, test_bs),
            candidate_synth=synth_config_from_cfg(cfg, predict_bs),
            inner_chunk=cfg.get_dotted("retrieval.inner_chunk", 128),
            device=task.device,
        )
        # the query params rendered through the candidate pipeline must sit at
        # distance ~0 from the stored query embeddings before millions of
        # candidates are streamed
        evaluator.assert_planted_queries_found()
        print("planted-query check OK (query/candidate pipelines consistent)")
        result = evaluator.run(
            n_batches,
            logger=logger,
            sample_rate=cfg.torchsynth.rate,
            artifact_dir=str(run_dir / "retrieval"),
        )
        if not result["completed"]:
            # partial distances are not the final metric; a rerun resumes
            print(f"preempted after {result['batches_done']}/{n_batches} candidate "
                  "batches; state saved — rerun to resume")
            return 75
        print("final per-query min distances:", result["best_dist"].round(4).tolist())
        print(
            "NN param-MAE (chance floor 0.333):",
            result["nn_param_mae"].round(4).tolist(),
            f"mean {float(result['nn_param_mae'].mean()):.4f}",
        )
        print(f"convergence artifacts: {run_dir / 'retrieval'}/convergence.{{csv,png}}")
        logger.log({
            "retrieval/mean_min_dist": float(result["best_dist"].mean()),
            # comparable across checkpoints, unlike embedding distances (chance 1/3)
            "retrieval/mean_nn_param_mae": float(result["nn_param_mae"].mean()),
        })
    finally:
        logger.finish()
    return 0


if __name__ == "__main__":
    sys.exit(app(load_config(overrides=sys.argv[1:])))
