"""GRAD-MATCH in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``repro`` (JAX + Pallas) with the same layout: ``kernels/``,
``core/``, ``models/``, ``optim/``, ``data/``, ``train/`` and ``configs/``.
It imports neither JAX nor ``repro``.

Importing the package turns TF32 off for matrix products and cuDNN
convolutions, so that the plain versions, the MLP and the CNN run in full
float32 on the card, as the JAX package does on its reference path.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
