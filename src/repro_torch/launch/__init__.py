"""Entry points of the port: the LM training driver (``train.py``), the
artifact builder (``build_artifacts.py``) and the selection-service
launcher (``serve_selection.py``).

``picks_or_tie`` is the rule both selection launchers' self-checks use to
hold one solution against another."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def picks_or_tie(what: str, got, want, grads: torch.Tensor,
                 target: torch.Tensor, solve_got: Callable,
                 solve_want: Callable,
                 on_parting: Optional[Callable] = None
                 ) -> tuple[bool, Optional[dict]]:
    """Two solutions (indices, weights, mask, err) of one OMP problem:
    equal indices and masks pass as they are; a parting passes only where
    ``on_parting(what, grads, target, got, want, solve_got, solve_want)``
    certifies it as a tie (it raises if it cannot).  Returns (ok, the
    hook's record, or None when the picks are equal or no hook is
    given)."""
    if torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]):
        return True, None
    if on_parting is None:
        return False, None
    return True, on_parting(what, grads, target, got, want, solve_got,
                            solve_want)
