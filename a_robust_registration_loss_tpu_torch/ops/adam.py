"""optax.adam written out, with a keep mask: the one Adam of the port.

The classical registration steps a (6,) twist, or (B, 6) twists that share
one count, freezing the rows of a pair with no usable line
(``train/classical.py:adam_update``); the trainers step the flat
concatenation of a model's parameters and skip the whole step on a
non-finite loss or gradient (``train/harness.py:guarded_update``). Both are
``step`` with a different ``keep``. Each operation rounds as optax's does.

``optax.adam(schedule)`` keeps the schedule's step count beside Adam's. The
two move together until a trainer restarts the schedule and keeps the
moments (RPM-Net's handover from identity pretraining to training), so a
scheduled optimiser carries a ``ScheduledAdamState``: Adam's state and the
schedule's own count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


class AdamState(NamedTuple):
    """optax.adam's state: the count of the bias correction (and of a
    constant learning rate's steps) and the two moments, shaped like the
    parameters."""
    count: torch.Tensor  # () int32, shared by every row
    mu: torch.Tensor
    nu: torch.Tensor


class ScheduledAdamState(NamedTuple):
    """optax.adam(schedule)'s state: Adam's, and the count the schedule is
    read at, which may restart while Adam's goes on."""
    adam: AdamState
    count: torch.Tensor  # () int32


def init(params: torch.Tensor) -> AdamState:
    """A fresh state for the parameter tensor ``params``."""
    return AdamState(torch.zeros((), dtype=torch.int32, device=params.device),
                     torch.zeros_like(params), torch.zeros_like(params))


def step(lr, grads, state: AdamState, params, keep):
    """One Adam step of ``params`` with the learning rate ``lr`` (a float,
    or a 0-d tensor such as a schedule's value at ``state.count``).

    keep: a bool tensor that broadcasts against ``params``, a 0-d flag or
    one per row. Where it is False the parameters and both moments stay
    bitwise as they were; the count advances where any entry is True.
    Returns (new params, new AdamState); nothing syncs with the host."""
    mu = (1 - B1) * grads + B1 * state.mu
    nu = (1 - B2) * (grads * grads) + B2 * state.nu
    count = state.count + 1
    mu_hat = mu / (1 - B1 ** count)
    nu_hat = nu / (1 - B2 ** count)
    new_params = params + -lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))
    return (torch.where(keep, new_params, params),
            AdamState(torch.where(keep.any(), count, state.count),
                      torch.where(keep, mu, state.mu),
                      torch.where(keep, nu, state.nu)))
