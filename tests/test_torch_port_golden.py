"""The port's synth at the full 4 s / 44.1 kHz / 441 Hz geometry against the
audio and controls the JAX package wrote (``tests/golden/torchsynth_probes``).

Only the ``.npz`` files are read: no JAX runs here. ``tests/test_synth.py`` pins
the JAX package to the same files, so they are the JAX functions' output. Each
probe holds 4 voices: ``params01`` [4, 78], ``natural`` [4, 78], ``routed``
[4, 5, 1764], ``midi_f0`` [4] and ``audio`` [4, 176400] in float16.

The bounds. Natural values and ``midi_f0`` are those of ``tests/test_synth.py``
and tighter. ``routed`` is held at 2e-5 (``tests/test_torch_port_synth.py``),
except at one control sample per voice at most: where both LFOs' square and saw
shapes sit within float32 rounding of a jump (the corner probe's voice 1 at
sample 1151), the two packages' last-bit differences put the jump on either
side of the sample. Audio is cast to float16 as the probes are. Over the first
0.25 s it is held to the JAX probe test's 2e-3 (``tests/test_synth.py``);
over 4 s the control-rate differences (~1e-5) integrate into the phase, so
each voice is held at a rel-rms of 0.1, which a wrong curve, noise row or
mod routing (O(1)) exceeds. The port's two renders (portable, and the fused
render's plain version) are held to each other at the repo's render bound,
0.08 max and 0.01 rel-rms (``tests/test_pallas_render.py``).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from inverse_audio_synthesis_tpu_torch.synth import SynthConfig, from_0to1
from inverse_audio_synthesis_tpu_torch.synth.voice import (
    VOICE_PARAM_SPECS,
    compute_controls,
    render_voice,
    render_voice_fused,
    sample_voice_params,
)

torch.set_num_threads(2)

PROBE_DIR = Path(__file__).resolve().parent / "golden" / "torchsynth_probes"
PROBES = ("batch0", "batch1", "mid", "corners")
CFG = SynthConfig(batch_size=4, buffer_size_seconds=4.0)
HEAD = 11_025  # the first 0.25 s
ROUTED_ATOL = 2e-5
HEAD_MAX = 2e-3
VOICE_REL_RMS = 0.1
PATHS_MAX, PATHS_REL_RMS = 0.08, 0.01
RENDERS = {"portable": render_voice, "fused": render_voice_fused}


@functools.lru_cache(maxsize=None)
def _probe(name):
    return dict(np.load(PROBE_DIR / f"probe_{name}.npz"))


@functools.lru_cache(maxsize=None)
def _audio(name, path):
    with torch.no_grad():
        return RENDERS[path](torch.from_numpy(_probe(name)["params01"]), CFG).numpy()


def _voice_rel_rms(ref, x):
    return np.sqrt(np.mean((x - ref) ** 2, axis=-1)) / (np.sqrt(np.mean(ref**2, axis=-1)) + 1e-12)


@pytest.mark.parametrize("batch_num", [0, 1])
def test_probe_params_are_sample_voice_params(batch_num):
    got = sample_voice_params(batch_num, CFG).numpy()
    np.testing.assert_array_equal(got, _probe(f"batch{batch_num}")["params01"])


@pytest.mark.parametrize("name", PROBES)
def test_probe_controls(name):
    d = _probe(name)
    params01 = torch.from_numpy(d["params01"])
    natural = torch.stack([from_0to1(s, params01[:, i]) for i, s in enumerate(VOICE_PARAM_SPECS)], 1)
    np.testing.assert_allclose(natural.numpy(), d["natural"], rtol=1e-5, atol=1e-5)
    _, routed, midi_f0 = compute_controls(params01, CFG)
    np.testing.assert_allclose(midi_f0.numpy(), d["midi_f0"], rtol=0, atol=1e-6)
    assert routed.shape == d["routed"].shape
    err = np.abs(routed.numpy() - d["routed"]).max(axis=1)  # [voice, control sample]
    for v in range(err.shape[0]):
        over = np.nonzero(err[v] > ROUTED_ATOL)[0]
        for t in over:
            print(f"probe {name} voice {v} control sample {t}: routed differs by {err[v, t]:.3e}")
        assert len(over) <= 1, f"probe {name} voice {v}: routed beyond {ROUTED_ATOL} at {over.tolist()}"


@pytest.mark.parametrize("path", sorted(RENDERS))
@pytest.mark.parametrize("name", PROBES)
def test_probe_audio(name, path):
    ref = _probe(name)["audio"].astype(np.float32)
    got = _audio(name, path)
    assert got.shape == ref.shape and np.isfinite(got).all()
    q = got.astype(np.float16).astype(np.float32)
    head = float(np.abs(q[:, :HEAD] - ref[:, :HEAD]).max())
    rel = _voice_rel_rms(ref, q)
    print(f"probe {name} {path}: max first 0.25 s {head:.3e}, max 4 s {np.abs(q - ref).max():.3e}, "
          f"per-voice rel-rms {np.array2string(rel, precision=4)}")
    assert head <= HEAD_MAX
    assert rel.max() <= VOICE_REL_RMS


@pytest.mark.parametrize("name", PROBES)
def test_probe_port_paths_agree(name):
    portable, fused = _audio(name, "portable"), _audio(name, "fused")
    assert np.abs(portable - fused).max() <= PATHS_MAX
    assert _voice_rel_rms(fused, portable).max() <= PATHS_REL_RMS
