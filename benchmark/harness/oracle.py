"""The comparison that decides ``correct``: the program's first train steps
against the plain reference's from the same weights, batches and noise.

Three numbers are compared, each with its own limit (the cell's workload
file):

- ``loss``: the first step's loss gap, |L - L_ref| / |L_ref|;
- ``grad``: the first gradient as RMSProp got it, worked out from its
  state after one step (trace = -lr g / sqrt(nu + eps) with the mean square
  nu = 0.9 + 0.1 g^2, so g = -trace sqrt(nu + eps) / lr, as well conditioned
  for a large gradient as for a small one): by the worst leaf,
  the gap between the program's norm of the leaf and the reference's,
  |‖g‖ - ‖g_ref‖|, over the larger of ‖g_ref‖ and the median leaf's;
- ``change``: the weights' change over the checked steps, the same gap of
  norms taken leaf by leaf, and of those the median leaf's.

The later steps' losses and the worst leaf's change are kept beside them
(``loss_steps``, ``change_worst``) but not compared: from step 2 on, float32
runs from the same start part by up to ~1e-2 in the loss and up to ~0.8 of
a small leaf's change (a bias, an initial state), the float32 reference
from float64 as much as the program does, with no presence draw parting
(``look.py``): rounding that the steps amplify.  So only the first step's
loss, its gradient and the median leaf's change separate sound runs from
the control.

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding, such as a parameter that gets no gradient) are
left out of ``grad`` and ``change``.
"""
from __future__ import annotations

import statistics
from typing import Dict, Mapping, Tuple

import torch

NOUGHT = 1e-3  # of the median leaf's gradient norm
EPS = 1e-10  # RMSProp's, inside the root


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in leaves.items()}


def gradient_from_state(trace: torch.Tensor, nu: torch.Tensor, lr: float) -> torch.Tensor:
    """The gradient of RMSProp's first step, from its trace and mean square
    after it."""
    return -trace.double() * torch.sqrt(nu.double() + EPS) / lr


def leaf_gaps(got: Mapping[str, float], want: Mapping[str, float],
              names) -> Dict[str, float]:
    """{leaf: |got - want| / max(want, median want)}."""
    median = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in names}


def compare(program: Dict, reference: Dict, initial: Mapping[str, torch.Tensor],
            lr: float) -> Dict:
    """The three numbers, and beside them what is not compared.

    :param program: losses (per step), trace and nu (RMSProp's after step
        1, by leaf) or grads (the first step's, by leaf, where the reference
        stands in the program's place), params (after the checked steps)
    :param reference: losses, grads (the first step's, by leaf), params
    :param initial: the weights both started from
    """
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    ref_grad = _norms(reference["grads"])
    median = statistics.median(ref_grad.values())
    counted = sorted(n for n, v in ref_grad.items() if v >= NOUGHT * median)
    if "grads" in program:
        got_grad = _norms({n: program["grads"][n] for n in counted})
    else:
        got_grad = _norms({n: gradient_from_state(program["trace"][n], program["nu"][n], lr)
                           for n in counted})
    grads = leaf_gaps(got_grad, ref_grad, counted)
    grad_leaf = max(grads, key=grads.get)
    moved = {n: program["params"][n].double() - initial[n].double() for n in counted}
    ref_moved = {n: reference["params"][n].double() - initial[n].double() for n in counted}
    changes = leaf_gaps(_norms(moved), _norms(ref_moved), counted)
    change_leaf = max(changes, key=changes.get)
    return dict(loss=losses[0], grad=grads[grad_leaf],
                change=statistics.median(changes.values()), loss_steps=losses,
                change_worst=changes[change_leaf], grad_leaf=grad_leaf,
                change_leaf=change_leaf, leaves=len(counted), grad_gaps=grads,
                change_gaps=changes)


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
