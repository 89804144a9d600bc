"""Configs for the paper-faithful experiments (a copy of
``repro/configs/paper.py``).

The paper trains LeNet on MNIST and ResNet18 on CIFAR*/ImageNet.  The repro
experiments run the same selection machinery on structured synthetic
classification data with the small classifiers below, keeping every paper
hyper-parameter that matters to the technique: lambda=0.5, R=20,
kappa=1/2, SGD momentum 0.9, weight decay 5e-4, cosine annealing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ClassifierConfig:
    """Small classification net for the paper-repro experiments.

    ``kind='mlp'`` is a LeNet-scale 2-hidden-layer net on flat features;
    ``kind='cnn'`` is a LeNet-style conv net on (H, W, C) images.
    """

    name: str = "paper-mlp"
    kind: str = "mlp"                 # 'mlp' | 'cnn'
    in_dim: int = 64                  # flat feature dim (mlp)
    image_shape: Tuple[int, int, int] = (28, 28, 1)   # (cnn)
    hidden: Tuple[int, ...] = (128, 64)
    num_classes: int = 10
    act: str = "relu"


@dataclass(frozen=True)
class PaperHParams:
    """Paper SS5 experimental setting (Appendix C.2/C.3)."""

    lam: float = 0.5            # OMP regularizer (Fig. 4g: best at 0.5)
    eps: float = 1e-10          # OMP tolerance (paper: 1e-10)
    select_every: int = 20      # R = 20
    kappa: float = 0.5          # warm-start fraction (Fig. 4f: best at 1/2)
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    cosine_anneal: bool = True
    budgets: Tuple[float, ...] = (0.05, 0.10, 0.20, 0.30)


def lenet() -> ClassifierConfig:
    return ClassifierConfig(name="paper-lenet", kind="cnn",
                            image_shape=(28, 28, 1), hidden=(120, 84))


def mlp(in_dim: int = 64, num_classes: int = 10) -> ClassifierConfig:
    return ClassifierConfig(name="paper-mlp", kind="mlp", in_dim=in_dim,
                            num_classes=num_classes)
