"""Stateless-indexed LM token stream, after ``repro/data/tokens.py``.

Batch ``step`` of shard ``shard`` is a pure function of ``(seed, step,
shard)``: a ``torch.Generator`` on the batch's device is seeded from the
three numbers by ``stream_seed`` (splitmix64 of the seed, then of that
value xor the step, then of that xor the shard), so a restart from any step
draws the same batches with no iterator state: ``state(step)`` is all a
checkpoint holds of it.

Token distribution, as in the reference: Zipf unigram marginals
(``-alpha log rank``) under a sticky latent chain over ``n_latent`` states
(each position keeps the previous latent with probability 0.95, else draws
a fresh one), and latent ``l`` adds 3 to the logits of the vocabulary slice
``[l V / L, (l + 1) V / L)``, so there is learnable structure.  The
reference draws from ``jax.random`` and this stream from a
``torch.Generator``: the construction is the same, the tokens differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.device import resolve_device

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, step: int, shard: int) -> int:
    """The generator seed of batch (seed, step, shard), in [0, 2^63)."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(step) & _MASK64))
    h = _splitmix64(h ^ (int(shard) & _MASK64))
    return h >> 1


def latent_logits(vocab: int, n_latent: int = 16, alpha: float = 1.1,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """(n_latent, vocab) f32 logits: Zipf marginals + 3 on each latent's
    vocabulary slice."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    base = -alpha * torch.log(ranks)
    slice_w = max(vocab // n_latent, 1)
    tok = torch.arange(vocab, device=device)
    in_slice = (tok[None, :] // slice_w) == torch.arange(
        n_latent, device=device)[:, None]
    return base[None, :] + 3.0 * in_slice.float()


def token_batch(seed: int, step: int, shard: int, batch: int, seq_len: int,
                vocab: int, n_latent: int = 16, alpha: float = 1.1,
                device: str | torch.device | None = None) -> dict:
    """One (batch, seq_len + 1) draw -> {'tokens', 'targets'} int32
    (batch, seq_len), on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, step, shard))
    shape = (batch, seq_len + 1)
    stay = torch.rand(shape, generator=gen, device=device) < 0.95
    fresh = torch.randint(0, n_latent, shape, generator=gen, device=device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)

    # Sticky chain: each position takes the fresh draw of the last reset at
    # or before it (position 0 always resets).
    pos = torch.arange(seq_len + 1, device=device).expand(shape)
    reset = ~stay
    reset[:, 0] = True
    last = torch.where(reset, pos, 0).cummax(dim=1).values
    latent = fresh.gather(1, last)                              # (B, S+1)

    # Inverse-CDF draw from the latent's row.  Row l's CDF is shifted to
    # (l, l + 1], so one search over the flattened rows serves every latent.
    probs = torch.softmax(latent_logits(vocab, n_latent, alpha,
                                        device).double(), dim=-1)
    shifted = (probs.cumsum(dim=-1) + torch.arange(
        n_latent, device=device, dtype=torch.float64)[:, None]).reshape(-1)
    idx = torch.searchsorted(shifted, latent + u, right=True)
    toks = torch.clamp(idx - latent * vocab, 0, vocab - 1).to(torch.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclass(frozen=True)
class TokenStream:
    """Config record for a sharded token pipeline; ``batch`` is pure.
    ``device`` (``None``: the card) is where batches are drawn."""

    seed: int
    batch_per_shard: int
    seq_len: int
    vocab: int
    n_shards: int = 1
    device: Optional[torch.device] = field(default=None)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def batch(self, step: int, shard: int = 0) -> dict:
        return token_batch(self.seed, step, shard, self.batch_per_shard,
                           self.seq_len, self.vocab, device=self.device)

    def state(self, step: int) -> dict:
        """Checkpointable pipeline state: the step index (and the seed)."""
        return {"step": step, "seed": self.seed}

    @staticmethod
    def resume(state: dict) -> int:
        return int(state["step"])
