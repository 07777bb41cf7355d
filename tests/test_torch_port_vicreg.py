"""VICReg's covariance term (``models/vicreg.py:cov_off_diag_sq_sum``) against
a float64 evaluation through the d x d covariance, with the batch narrower and
wider than the embedding.

The term takes the operands ``vicreg_loss`` gives it (centred, rounded to bf16,
then float32) and accumulates its products in float32; the reference takes the
same operands in float64 through ``off_diagonal_sq_sum(opᵀ op / denom)``. On
the CPU at small widths; the tests marked ``cuda`` take the pretraining cells'
shapes (16 and 64 rows of width 8192) and hold the memory that one forward and
backward of the loss adds under 64 MiB (the d x d form adds over 1 GiB there).
They skip here. This file imports neither JAX nor ``conftest``, so the card
runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -rP tests/test_torch_port_vicreg.py
"""

import pytest
import torch

from inverse_audio_synthesis_tpu_torch.models.vicreg import (
    cov_off_diag_sq_sum,
    off_diagonal_sq_sum,
    vicreg_loss,
)

torch.set_num_threads(2)

MIB = 2**20


def _inputs(n, d, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device)
    return x, x + 0.3 * torch.randn(n, d, generator=gen, device=device)


def _operand(z):
    """The loss's covariance operand of ``z``: centred in float32, rounded to bf16."""
    return (z - z.mean(dim=0)).to(torch.bfloat16).float()


def _gaps(n, d, device, seed=0):
    """Relative gaps of (the loss's cov_loss, the term, the term's gradient)
    from their float64 d x d evaluation on the same bf16 operands."""
    x, y = _inputs(n, d, device, seed)
    denom = n - 1
    cov_loss = vicreg_loss(x, y, cov_operand_dtype=torch.bfloat16)[3]
    ops = [_operand(z).double().requires_grad_() for z in (x, y)]
    terms = [off_diagonal_sq_sum(op.T @ op / denom) for op in ops]
    ref_loss = sum(t.item() for t in terms) / d
    op = ops[0].detach().float().requires_grad_()
    term = cov_off_diag_sq_sum(op, denom)
    (grad,) = torch.autograd.grad(term, op)
    (ref_grad,) = torch.autograd.grad(terms[0], ops[0])
    return (abs(float(cov_loss) - ref_loss) / abs(ref_loss),
            abs(term.item() - terms[0].item()) / abs(terms[0].item()),
            float(torch.linalg.norm(grad.double() - ref_grad) / torch.linalg.norm(ref_grad)))


@pytest.mark.parametrize("n,d", [(16, 256), (48, 32)])
def test_term_matches_the_float64_covariance_on_the_cpu(n, d):
    """The Gram sum at 16 x 256 and 48 x 32 (n > d) within 1e-5 of float64."""
    cov_loss_gap, term_gap, grad_gap = _gaps(n, d, torch.device("cpu"))
    assert max(cov_loss_gap, term_gap, grad_gap) <= 1e-5, (cov_loss_gap, term_gap, grad_gap)


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test measures the card's allocator and cuBLAS's sums")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64])
def test_gram_form_on_the_card(cuda_device, n):
    """At the pretraining cells' 16 and 64 rows of width 8192:
    the loss's cov_loss, the term and its gradient within 1e-5 of float64 d x d;
    and one forward and backward of the loss raises the allocator's peak by less
    than 64 MiB over what it held before."""
    d = 8192
    cov_loss_gap, term_gap, grad_gap = _gaps(n, d, cuda_device, seed=n)
    print(f"{torch.cuda.get_device_name(cuda_device)} n={n} d={d}: cov_loss gap {cov_loss_gap:.3e}, "
          f"term gap {term_gap:.3e}, gradient gap {grad_gap:.3e}")
    assert max(cov_loss_gap, term_gap, grad_gap) <= 1e-5

    x, y = (z.requires_grad_() for z in _inputs(n, d, cuda_device, seed=n + 1))
    for _ in range(2):  # the first pass makes cuBLAS's workspace and the allocator's blocks
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        torch.autograd.grad(vicreg_loss(x, y, cov_operand_dtype=torch.bfloat16)[0], (x, y))
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(cuda_device) - held
    print(f"n={n} d={d}: peak rise over one forward and backward {rise} bytes ({rise / MIB:.3f} MiB)")
    assert rise < 64 * MIB
