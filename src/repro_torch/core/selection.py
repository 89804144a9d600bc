"""Strategy dispatch + adaptive-selection schedule (paper Algorithm 1),
after ``repro/core/selection.py``.

``select()`` maps a strategy name to its selector over a proxy matrix.  The
port has ``gradmatch`` (per-class and pooled), ``gradmatch-pb``, the CRAIG
greedy tiers (``craig`` = dense oracle, ``craig-lazy`` = certified lazy
greedy with identical selections, ``craig-lazy-otf`` = the same with the
similarity rebuilt on the fly, ``craig-stochastic`` = seeded stochastic
greedy), ``craig-pb``, ``glister``, ``random`` and ``full``; the
reference's other strategies raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

``warm_start_epochs()`` is the paper's warm-start budget split (§4), and
``SelectionSchedule`` answers "is epoch t a selection epoch?".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import craig as craig_lib
from repro_torch.core import glister as glister_lib
from repro_torch.core import gradmatch as gm_lib
from repro_torch.core import random_sel
from repro_torch.core.gradmatch import SelectionResult

STRATEGIES = ("gradmatch", "gradmatch-pb", "craig", "craig-lazy",
              "craig-lazy-otf", "craig-stochastic", "craig-pb", "glister",
              "random", "full")

# CRAIG tiers of the shared greedy engine (core/greedy.py): "craig-lazy"
# selects index-identically to "craig"; "craig-lazy-otf" is the same lazy
# greedy with the similarity rebuilt from the gradients on the fly;
# "craig-stochastic" is the seeded approximate tier.
_CRAIG_METHODS = {"craig": "dense", "craig-lazy": "lazy",
                  "craig-lazy-otf": "lazy",
                  "craig-stochastic": "stochastic"}
_CRAIG_ON_THE_FLY = frozenset({"craig-lazy-otf"})

# Strategies of the JAX package that later slices port (ROADMAP.md queue 1).
NOT_PORTED = {
    "gradmatch-stream": "queue 1 item 6 (core/streaming.py)",
    "gradmatch-partitioned": "queue 1 item 9 (core/partition.py)",
    "gradmatch-continual": "queue 1 item 8 (continual selection)",
}


def check_strategy(strategy: str) -> None:
    """Raise for a strategy the port does not run (yet)."""
    if strategy in NOT_PORTED:
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported to repro_torch yet: "
            f"ROADMAP.md {NOT_PORTED[strategy]}")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: {STRATEGIES}")


def select(
    strategy: str,
    generator: Optional[torch.Generator],
    proxies: torch.Tensor,            # (n, d) per-example gradient proxies
    k: int,
    labels: Optional[torch.Tensor] = None,
    num_classes: int = 0,
    batch_size: int = 32,
    lam: float = 0.5,
    eps: float = 1e-10,
    val_target: Optional[torch.Tensor] = None,   # (d,) validation-grad sum
    per_class: bool = True,
    omp_method: str = "incremental",   # OMP solver for gradmatch strategies
) -> SelectionResult:
    """Resolve one selection round.  ``val_target`` switches isValid=True.

    PB variants interpret ``k`` as an example budget and convert it to
    ``k // batch_size`` mini-batches; their result indexes *batches* — use
    ``expand_if_pb`` to map back to examples.  ``generator`` draws the
    ``random`` subset and the ``craig-stochastic`` samples (default there:
    seeded 0 on the proxies' device); the other strategies do not use it.
    """
    check_strategy(strategy)
    n = proxies.shape[0]
    dev = proxies.device
    if strategy == "full":
        w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        return SelectionResult(torch.arange(n, dtype=torch.int32, device=dev),
                               w, torch.ones((n,), dtype=torch.bool,
                                             device=dev),
                               torch.zeros((), device=dev))
    if strategy == "random":
        if generator is None:
            raise ValueError("strategy 'random' needs a torch.Generator")
        return random_sel.random_select(generator, n, k)
    if strategy == "gradmatch":
        if per_class and labels is not None and num_classes > 1 and (
                val_target is None):
            return gm_lib.gradmatch_per_class(
                proxies, labels, num_classes, k, lam=lam, eps=eps,
                method=omp_method)
        return gm_lib.gradmatch(proxies, k, target=val_target, lam=lam,
                                eps=eps, method=omp_method)
    if strategy == "gradmatch-pb":
        return gm_lib.gradmatch_pb(
            proxies, batch_size, max(k // batch_size, 1), lam=lam, eps=eps,
            target=val_target, method=omp_method)
    if strategy in _CRAIG_METHODS:
        return craig_lib.craig(
            proxies, k, method=_CRAIG_METHODS[strategy], generator=generator,
            on_the_fly=True if strategy in _CRAIG_ON_THE_FLY else None)
    if strategy == "craig-pb":
        return craig_lib.craig_pb(proxies, batch_size,
                                  max(k // batch_size, 1))
    tgt = val_target if val_target is not None else proxies.sum(0)
    return glister_lib.glister(proxies, tgt, k)


def expand_if_pb(strategy: str, sel: SelectionResult, batch_size: int,
                 n_examples: int) -> SelectionResult:
    if strategy.endswith("-pb"):
        return gm_lib.expand_batch_selection(sel, batch_size, n_examples)
    return sel


def warm_start_epochs(total_epochs: int, budget_frac: float,
                      kappa: float = 0.5) -> tuple[int, int]:
    """(T_f full-data epochs, T_s subset epochs) per the paper's split.

    ``budget_frac`` is ``k/n`` and must sit in (0, 1); ``kappa`` in (0, 1]
    scales the total compute.
    """
    if total_epochs <= 0:
        raise ValueError(f"total_epochs must be positive, got {total_epochs}")
    if not 0.0 < budget_frac < 1.0:
        raise ValueError(
            f"budget_frac must be in (0, 1), got {budget_frac}; a fraction "
            ">= 1 makes the warm start longer than full-data training — "
            "use strategy='full' for a full-data run")
    if not 0.0 < kappa <= 1.0:
        raise ValueError(f"kappa must be in (0, 1], got {kappa}")
    t_s = max(int(round(kappa * total_epochs)), 1)
    t_f = int(round(t_s * budget_frac))
    return t_f, t_s


@dataclass(frozen=True)
class SelectionSchedule:
    select_every: int = 20         # R
    warm_epochs: int = 0           # T_f
    # The run length this schedule is meant for, when given: a warm start
    # covering the whole run (no selection epoch would ever fire) is
    # rejected.
    total_epochs: Optional[int] = None

    def __post_init__(self):
        if self.select_every <= 0:
            raise ValueError(
                f"select_every (R) must be positive, got "
                f"{self.select_every}; R <= 0 never re-selects")
        if self.warm_epochs < 0:
            raise ValueError(
                f"warm_epochs must be >= 0, got {self.warm_epochs}")
        if (self.total_epochs is not None
                and self.warm_epochs >= self.total_epochs):
            raise ValueError(
                f"warm_epochs={self.warm_epochs} >= total_epochs="
                f"{self.total_epochs}: the warm start swallows the whole "
                "run and no selection epoch ever fires")

    def is_selection_epoch(self, epoch: int) -> bool:
        """Selection at the first post-warm epoch, then every R."""
        if epoch < self.warm_epochs:
            return False
        return (epoch - self.warm_epochs) % self.select_every == 0
