"""Structured synthetic classification data (gaussian mixtures), after
``repro/data/synthetic.py``.

Each class is a mixture of ``modes_per_class`` gaussians in ``dim``
dimensions with means of norm ~``sep`` — class-clustered gradients, the
structure GRAD-MATCH exploits.  The distributions are the reference's; the
numbers are not (a seeded ``torch.Generator`` draws them, on the requested
device).  ``make_imbalanced`` is the paper's robustness protocol (§5).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


class Dataset(NamedTuple):
    x: torch.Tensor       # (n, dim) f32
    y: torch.Tensor       # (n,) int64
    num_classes: int

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def to(self, device: torch.device) -> "Dataset":
        return Dataset(self.x.to(device), self.y.to(device), self.num_classes)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_classification(
    n: int = 4096,
    dim: int = 64,
    num_classes: int = 10,
    modes_per_class: int = 3,
    sep: float = 4.0,
    noise: float = 1.0,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Dataset:
    """``device=None`` means the card; pass ``device='cpu'`` for the CPU."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    means = sep * torch.randn((num_classes, modes_per_class, dim),
                              generator=g, device=dev) / math.sqrt(dim)
    y = torch.randint(0, num_classes, (n,), generator=g, device=dev)
    mode = torch.randint(0, modes_per_class, (n,), generator=g, device=dev)
    x = means[y, mode] + noise * torch.randn((n, dim), generator=g,
                                             device=dev)
    return Dataset(x.float(), y, num_classes)


def split(ds: Dataset, seed: int = 1, val_frac: float = 0.1
          ) -> tuple[Dataset, Dataset]:
    """Seeded shuffled train/val split (the paper's 90/10), on the data's
    device."""
    perm = torch.randperm(ds.n, generator=_generator(seed, ds.x.device),
                          device=ds.x.device)
    n_val = int(ds.n * val_frac)
    vi, ti = perm[:n_val], perm[n_val:]
    return (Dataset(ds.x[ti], ds.y[ti], ds.num_classes),
            Dataset(ds.x[vi], ds.y[vi], ds.num_classes))


def make_imbalanced(
    n: int = 4096,
    dim: int = 64,
    num_classes: int = 10,
    imbalanced_frac: float = 0.3,
    keep_frac: float = 0.1,
    seed: int = 0,
    device: str | torch.device | None = None,
    **kw,
) -> tuple[Dataset, Dataset]:
    """Paper §5 class-imbalance protocol: (imbalanced_train, clean_val).

    The first ``int(num_classes * imbalanced_frac)`` classes keep only
    ``keep_frac`` of their training examples; the validation set stays
    balanced.
    """
    dev = resolve_device(device)
    full = make_classification(n=n, dim=dim, num_classes=num_classes,
                               seed=seed, device=dev, **kw)
    train, val = split(full, seed=seed + 1)
    n_imb = int(num_classes * imbalanced_frac)
    is_imb = train.y < n_imb
    u = torch.rand((train.n,), generator=_generator(seed + 2, dev),
                   device=dev)
    keep = ~is_imb | (u < keep_frac)
    return Dataset(train.x[keep], train.y[keep], num_classes), val
