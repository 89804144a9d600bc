"""Adaptive-selection trainer: the paper's Algorithm 1, end to end, after
``repro/train/trainer.py``.

Runs a strategy of ``core.selection.STRATEGIES`` (+ the -WARM variant) on a
classification dataset with the paper's hyper-parameters (SGD momentum 0.9,
wd 5e-4, cosine annealing, R=20, lambda=0.5, kappa=1/2), on the card unless
the caller passes ``device='cpu'``.

Cost accounting is the reference's: one work unit is one example forward;
training costs 3 units an example, a selection's proxy pass 1 unit a pool
row.  Selection and wall seconds are host clock times around work that ends
in a device sync.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.paper import ClassifierConfig, PaperHParams
from repro_torch.core import selection as sel_lib
from repro_torch.core.gradmatch import SelectionResult
from repro_torch.data.loader import SubsetLoader
from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device
from repro_torch.models.classifier import ClassifierNet
from repro_torch.optim import cosine_annealing, sgd
from repro_torch.train import steps as steps_lib


# Strategies that select over the per-gradient proxy (the reference's
# trainer: repro/train/trainer.py, where "craig-lazy-otf" is not listed).
_PER_GRADIENT = ("gradmatch", "craig", "craig-lazy", "craig-stochastic")


@dataclass
class TrainerConfig:
    strategy: str = "gradmatch-pb"     # see core.selection.STRATEGIES
    budget: float = 0.1                # k / n
    epochs: int = 60
    batch_size: int = 64
    warm_start: bool = False           # -WARM variant
    early_stop_frac: Optional[float] = None  # FULL-EARLYSTOP budget match
    hp: PaperHParams = field(default_factory=PaperHParams)
    is_valid: bool = False             # match validation gradients
    per_class: bool = True
    omp_method: str = "incremental"    # OMP solver for gradmatch strategies
    seed: int = 0
    checkpoint_dir: Optional[str] = None   # not ported (ROADMAP item 10)
    eval_every: int = 5


@dataclass
class TrainReport:
    strategy: str
    budget: float
    final_acc: float
    best_acc: float
    acc_history: list
    work_units: float            # example-equivalents of compute (see above)
    selection_seconds: float
    wall_seconds: float
    selection_rounds: int
    subset_size: int

    @property
    def energy_proxy(self) -> float:
        """J/FLOP-proportional proxy (same ratios as the paper's pyJoules)."""
        return self.work_units


class AdaptiveTrainer:
    def __init__(self, model_cfg: ClassifierConfig, tcfg: TrainerConfig,
                 train: Dataset, val: Dataset, test: Optional[Dataset] = None,
                 device: str | torch.device | None = None):
        if tcfg.checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpointing is not ported to repro_torch yet: ROADMAP.md "
                "queue 1 item 10")
        sel_lib.check_strategy(tcfg.strategy)
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.tcfg = tcfg
        self.train_ds = train.to(self.device)
        self.val_ds = val.to(self.device)
        self.test_ds = (test if test is not None else val).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- selection round ------------------------------------------------------
    def _run_selection(self, model: ClassifierNet,
                       generator: Optional[torch.Generator]
                       ) -> tuple[SelectionResult, float]:
        t0 = time.perf_counter()
        tc = self.tcfg
        proxy_fn = steps_lib.make_proxy_fn(model)
        n = self.train_ds.n
        k = max(int(n * tc.budget), 1)
        val_target = None
        if tc.is_valid:
            _, vbias = proxy_fn(self.val_ds.x, self.val_ds.y)
            val_target = vbias.sum(dim=0)
        pcg, bias = proxy_fn(self.train_ds.x, self.train_ds.y)
        # PB variants, GLISTER and CRAIG on the fly use the bias-gradient
        # proxy (comparable across classes); GRAD-MATCH and the resident
        # CRAIG tiers use the per-gradient proxy (paper §4).
        per_class_ok = not tc.is_valid and tc.per_class
        proxies = pcg if (tc.strategy in _PER_GRADIENT and per_class_ok
                          ) else bias
        sel = sel_lib.select(
            tc.strategy, generator, proxies, k,
            labels=self.train_ds.y, num_classes=self.train_ds.num_classes,
            batch_size=tc.batch_size, lam=tc.hp.lam, eps=tc.hp.eps,
            val_target=val_target, per_class=per_class_ok,
            omp_method=tc.omp_method)
        sel = sel_lib.expand_if_pb(tc.strategy, sel, tc.batch_size, n)
        self._sync()
        return sel, time.perf_counter() - t0

    def init_model(self) -> ClassifierNet:
        """The run's initial model, drawn from ``seed`` (on the CPU, then
        moved to the device)."""
        gen = torch.Generator().manual_seed(self.tcfg.seed)
        return ClassifierNet(self.mcfg, generator=gen).to(self.device)

    # -- main loop --------------------------------------------------------------
    def run(self, model: Optional[ClassifierNet] = None) -> TrainReport:
        """Train ``model`` (default: ``init_model()``) with adaptive
        selection and report."""
        tc = self.tcfg
        hp = tc.hp
        model = self.init_model() if model is None else model.to(self.device)
        n = self.train_ds.n
        frac = 1.0 if tc.strategy == "full" else tc.budget
        steps_per_epoch = max(int(n * frac) // tc.batch_size, 1)
        lr = (cosine_annealing(hp.lr, tc.epochs * steps_per_epoch)
              if hp.cosine_anneal else hp.lr)
        opt = sgd(model.parameters(), lr, momentum=hp.momentum,
                  weight_decay=hp.weight_decay)
        step_fn = steps_lib.make_classifier_step(model, opt)
        eval_fn = steps_lib.make_classifier_eval(model)
        loader = SubsetLoader(self.train_ds.x, self.train_ds.y,
                              tc.batch_size, seed=tc.seed)

        # Schedule: warm start / early stop accounting.
        epochs = tc.epochs
        warm_epochs = 0
        if tc.warm_start and tc.strategy != "full":
            warm_epochs, subset_epochs = sel_lib.warm_start_epochs(
                epochs, tc.budget, hp.kappa)
            epochs = warm_epochs + subset_epochs
        if tc.strategy == "full" and tc.early_stop_frac is not None:
            # FULL-EARLYSTOP: spend the same work units as a subset run.
            epochs = max(int(round(tc.epochs * tc.early_stop_frac)), 1)
        sched = sel_lib.SelectionSchedule(hp.select_every, warm_epochs,
                                          total_epochs=epochs)

        work = 0.0
        sel_seconds = 0.0
        sel_rounds = 0
        acc_hist: list = []
        best = 0.0
        full_sel = (torch.arange(n, device=self.device),
                    torch.full((n,), 1.0 / n, device=self.device),
                    torch.ones((n,), dtype=torch.bool, device=self.device))

        t_wall = time.perf_counter()
        for epoch in range(epochs):
            in_warm = epoch < warm_epochs
            if (tc.strategy != "full" and not in_warm
                    and sched.is_selection_epoch(epoch)):
                gen = torch.Generator(device=self.device).manual_seed(
                    tc.seed * 1_000_003 + epoch)
                sel, dt = self._run_selection(model, gen)
                loader.set_selection(sel.indices, sel.weights, sel.mask)
                sel_seconds += dt
                sel_rounds += 1
                work += n  # one proxy forward over the pool
                if tc.is_valid:
                    work += self.val_ds.n
            elif in_warm or tc.strategy == "full":
                loader.set_selection(*full_sel)

            model.train()
            for batch in loader.epoch_batches():
                step_fn(batch)
                work += 3.0 * batch["x"].shape[0]   # fwd + bwd ~ 3x fwd

            if (epoch + 1) % tc.eval_every == 0 or epoch == epochs - 1:
                m = eval_fn({"x": self.test_ds.x, "y": self.test_ds.y})
                acc = float(m["acc"])
                acc_hist.append((epoch + 1, acc))
                best = max(best, acc)

        self._sync()
        wall = time.perf_counter() - t_wall
        final = acc_hist[-1][1] if acc_hist else 0.0
        return TrainReport(
            strategy=tc.strategy + ("-warm" if tc.warm_start else ""),
            budget=tc.budget, final_acc=final, best_acc=best,
            acc_history=acc_hist, work_units=work,
            selection_seconds=sel_seconds, wall_seconds=wall,
            selection_rounds=sel_rounds, subset_size=loader.subset_size)
