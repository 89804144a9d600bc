"""Strategy dispatch + adaptive-selection schedule (paper Algorithm 1),
after ``repro/core/selection.py``.

``select()`` maps a strategy name to its selector over a proxy matrix.  The
port has ``gradmatch`` (per-class and pooled), ``gradmatch-pb``, the CRAIG
greedy tiers (``craig`` = dense oracle, ``craig-lazy`` = certified lazy
greedy with identical selections, ``craig-lazy-otf`` = the same with the
similarity rebuilt on the fly, ``craig-stochastic`` = seeded stochastic
greedy), ``craig-pb``, ``glister``, ``gradmatch-stream`` (the certified
streaming OMP of ``core/streaming.py``), ``gradmatch-partitioned``
(partition-and-merge, ``core/partition.py``), ``gradmatch-continual``
(the bounded buffer of ``continual/buffer.py``), ``random`` and ``full``:
every strategy of the reference.

``warm_start_epochs()`` is the paper's warm-start budget split (§4), and
``SelectionSchedule`` answers "is epoch t a selection epoch?".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.continual import buffer as continual_lib
from repro_torch.core import craig as craig_lib
from repro_torch.core import glister as glister_lib
from repro_torch.core import gradmatch as gm_lib
from repro_torch.core import partition as part_lib
from repro_torch.core import random_sel
from repro_torch.core import streaming as stream_lib
from repro_torch.core.gradmatch import SelectionResult

STRATEGIES = ("gradmatch", "gradmatch-pb", "gradmatch-stream",
              "gradmatch-partitioned", "gradmatch-continual", "craig",
              "craig-lazy",
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

# Strategies of the JAX package that later slices port, each with the
# ROADMAP.md queue 1 item that ports it, by its title: none is left.
NOT_PORTED: dict = {}


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
    chunk_size: int = 2048,            # gradmatch-stream: pool chunk rows
    stream_buffer: int = 256,          # gradmatch-stream: top-M buffer slots
    stream_cache_bytes: int = stream_lib.DEFAULT_CACHE_BYTES,
    partitions: Optional[int] = None,  # gradmatch-partitioned: P (None: auto)
    buffer_cap: Optional[int] = None,       # gradmatch-continual: buffer rows
    continual_batch: Optional[int] = None,  # gradmatch-continual: admit size
) -> SelectionResult:
    """Resolve one selection round.  ``val_target`` switches isValid=True.

    PB variants interpret ``k`` as an example budget and convert it to
    ``k // batch_size`` mini-batches; their result indexes *batches* — use
    ``expand_if_pb`` to map back to examples.  ``generator`` draws the
    ``random`` subset and the ``craig-stochastic`` samples (default there:
    seeded 0 on the proxies' device); the other strategies do not use it.

    ``"gradmatch-stream"`` runs the certified streaming OMP over the
    proxies chunked by ``chunk_size``: the subset of pooled ``"gradmatch"``
    at ``O(chunk + stream_buffer·d + stream_cache_bytes)`` peak pool
    memory, with the engine's ``SelectStats`` on the result.
    ``stream_cache_bytes`` must be positive here (a cacheless solve is
    only available on ``streaming.omp_select_streaming``).

    ``"gradmatch-partitioned"`` runs partition-and-merge selection: one
    partition a class under ``"gradmatch"``'s per-class criteria, else
    ``partitions`` hashed partitions (``None``: automatic).
    ``"gradmatch-continual"`` streams the proxies through a bounded buffer
    of ``buffer_cap`` rows (``None``: the whole pool, where it selects
    pooled ``"gradmatch"``'s subset) in admission batches of
    ``continual_batch``.  A knob passed to a strategy that cannot honour
    it is rejected, not ignored.
    """
    check_strategy(strategy)
    if partitions is not None:
        if strategy != "gradmatch-partitioned":
            raise ValueError(
                f"partitions={partitions} only applies to "
                f"'gradmatch-partitioned', not {strategy!r} — it would be "
                "silently ignored (drop it, or switch strategy)")
        if partitions < 1:
            raise ValueError(
                f"partitions must be >= 1, got {partitions}; omit it (or "
                "pass None) for automatic partition sizing")
    for name, val in (("buffer_cap", buffer_cap),
                      ("continual_batch", continual_batch)):
        if val is None:
            continue
        if strategy != "gradmatch-continual":
            raise ValueError(
                f"{name}={val} only applies to 'gradmatch-continual', not "
                f"{strategy!r} — it would be silently ignored")
        if val < 1:
            raise ValueError(f"{name} must be >= 1, got {val}")
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
    if strategy == "gradmatch-stream":
        if stream_cache_bytes <= 0:
            # A cacheless solve re-pays a loader pass for every commit;
            # through this in-memory path that is a typo or a unit slip.
            raise ValueError(
                f"stream_cache_bytes must be > 0, got "
                f"{stream_cache_bytes}: the compressed chunk cache is "
                "what lets gradmatch-stream commit rounds without "
                "re-reading the pool.  Pass bytes (e.g. 1 << 24); to "
                "deliberately run cacheless use "
                "streaming.omp_select_streaming(cache_bytes=0) directly.")
        return stream_lib.gradmatch_streaming_array(
            proxies, k, target=val_target, lam=lam, eps=eps,
            chunk_size=chunk_size, buffer_size=stream_buffer,
            cache_bytes=stream_cache_bytes)
    if strategy == "gradmatch-partitioned":
        # Per-class partitions when "gradmatch" would run per class, hashed
        # ones otherwise; out-of-core pools go through
        # ``partition.gradmatch_partitioned_stream`` directly.
        use_labels = (per_class and labels is not None and num_classes > 1
                      and val_target is None)
        return part_lib.gradmatch_partitioned(
            proxies, k, partitions=0 if partitions is None else partitions,
            labels=labels if use_labels else None,
            num_classes=num_classes if use_labels else 0,
            target=val_target, lam=lam, eps=eps, method=omp_method)
    if strategy == "gradmatch-continual":
        # Always pooled, like gradmatch-stream.
        return continual_lib.continual_select(
            proxies, k, target=val_target, capacity=buffer_cap,
            batch=continual_batch, lam=lam, eps=eps)
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
