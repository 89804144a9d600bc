"""Per-rank cost of an eager step on a mesh: matrix-product FLOPs, operand
bytes and collectives, and the roofline terms on an NVIDIA H100.  The
counterpart of ``repro/launch/hlo_analysis.py``.

The reference reads these from a compiled, partitioned XLA module: FLOPs
and bytes from ``cost_analysis()``, collectives by parsing the HLO text,
with each while loop's trip count applied to the collectives in its body.
The port runs the step eagerly on DTensors (on the meta device under the
dry-run's fake process group) inside ``CostMode``, a dispatch mode that
lets DTensor lower each operation to the operations on the local shards
and their collectives first, then counts those: the matrix products that
rank 0's shards execute, the bytes each local operation reads and writes,
and each collective's input bytes.  Eager execution counts every loop
trip as it happens, so there is no HLO to parse and no trip count to
apply.

Hardware figures: NVIDIA H100 SXM — 989 TFLOP/s bf16 dense, 3.35 TB/s
HBM3, NVLink 4 at 450 GB/s each way a card.  A 16-wide model axis spans
two nodes of eight cards, whose links are InfiniBand, slower than NVLink:
there the collective term is a lower bound.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM, per card.
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s, each way

def _collective_ops() -> dict:
    """Functional collective op packet -> the reference's collective
    name."""
    out = {}
    for ns in ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd"):
        lib = getattr(torch.ops, ns, None)
        if lib is None:
            continue
        for op, name in (("all_gather_into_tensor", "all-gather"),
                         ("all_gather_into_tensor_coalesced", "all-gather"),
                         ("all_reduce", "all-reduce"),
                         ("all_reduce_coalesced", "all-reduce"),
                         ("reduce_scatter_tensor", "reduce-scatter"),
                         ("reduce_scatter_tensor_coalesced",
                          "reduce-scatter"),
                         ("all_to_all_single", "all-to-all"),
                         ("broadcast", "collective-permute")):
            try:
                out[getattr(lib, op)] = name
            except (AttributeError, RuntimeError):
                pass
    return out


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)         # op -> count
    operand_bytes: dict = field(default_factory=dict)  # op -> total bytes

    @property
    def total_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    def add(self, op: str, nbytes: int, times: int = 1) -> None:
        self.counts[op] = self.counts.get(op, 0) + times
        self.operand_bytes[op] = self.operand_bytes.get(op, 0) + (
            nbytes * times)

    def as_dict(self) -> dict:
        return {"counts": dict(self.counts),
                "operand_bytes": dict(self.operand_bytes),
                "total_bytes": self.total_bytes}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


class CostMode(TorchDispatchMode):
    """Counts, on this rank, the FLOPs of every matrix product (the torch
    flop counter's formulas), the bytes every operation reads and writes,
    and each collective's count and input bytes.  An operation on
    DTensors is handed back to DTensor first (``NotImplemented``), so what
    is counted is what runs on the local shards."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_formulas = FlopCounterMode(display=False).flop_registry
        self._collectives = _collective_ops()
        self.flops = 0
        self.op_bytes = 0
        self.collectives = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if isinstance(out, FakeTensor) or any(
                isinstance(a, FakeTensor) for a in args):
            # DTensor's sharding propagation running the op on fake
            # global-shaped tensors for its output's metadata: not work
            return out
        packet = func._overloadpacket
        name = self._collectives.get(packet)
        if name is not None:
            self.collectives.add(name, _tensor_bytes(args[0]))
            return out
        formula = self._flop_formulas.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        self.op_bytes += (_tensor_bytes(list(args))
                          + _tensor_bytes(list(kwargs.values()))
                          + _tensor_bytes(out))
        return out


def analytic_hbm_bytes(cfg, shape, n_chips: int, tp: int,
                       microbatches: int, fsdp_decode: bool = False
                       ) -> float:
    """First-order per-card HBM traffic of a fused GPU step.

    The eager count (``CostMode.op_bytes``) adds every unfused operation's
    reads and writes, which overstates what fused kernels stream.  This
    model counts what a fused step streams:

      train:   params read (fwd+bwd, per microbatch under FSDP-regather),
               grad write/read (f32), momentum r/w (f32), param write,
               activation carries + per-layer working set (r+w), f32
               logits+CE traffic.
      prefill: params read + activation working set + KV write.
      decode:  params read + FULL KV/state read + one token's activations
               (the classic decode bound).

    The arithmetic is the reference's, term for term.
    """
    dp = n_chips // tp
    kind = shape.kind
    if kind == "train":
        # FSDP: every microbatch re-reads the gathered weights.
        w_reads = 2 * microbatches * cfg.param_count() * 2 / n_chips
        opt = cfg.param_count() * (4 * 2 + 4 + 2) / n_chips  # m rw, g, p
        tokens_chip = shape.tokens / dp
        act = tokens_chip * cfg.d_model * 2 * (
            cfg.n_superblocks * 2        # remat carries w+r
            + len(cfg.layer_pattern) * cfg.n_superblocks * 8)  # layer ws
        logits = tokens_chip * cfg.padded_vocab / tp * (4 + 4)
        return w_reads + opt + act + logits
    if kind == "prefill":
        w = cfg.param_count() * 2 / tp
        tokens_chip = shape.tokens / dp
        act = tokens_chip * cfg.d_model * 2 * (
            len(cfg.layer_pattern) * cfg.n_superblocks * 6)
        kv_write = 2 * tokens_chip * cfg.kv_dim * 2 * sum(
            1 for k in cfg.layer_types_in_order()
            if k in ("attn", "local", "global", "shared_attn", "xattn"))
        return w + act + kv_write
    # decode: weights + the entire KV / state residency, once per token;
    # MoE decode touches only the routed experts, approximated by the
    # active parameters
    w_shard = n_chips if fsdp_decode else tp
    w = cfg.param_count(active_only=True) * 2 / w_shard
    kv = 0
    for k in cfg.layer_types_in_order():
        if k in ("attn", "global", "shared_attn"):
            s_eff = shape.seq_len
        elif k == "local":
            s_eff = min(cfg.sliding_window or shape.seq_len, shape.seq_len)
        else:
            s_eff = 0
        kv += 2 * shape.global_batch * s_eff * cfg.kv_dim * 2
    return w + kv / n_chips


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, n_chips: int) -> dict:
    """The three roofline terms of one card, in seconds, and the dominant
    one.  ``flops``, ``bytes_accessed`` and ``coll_bytes`` are one card's
    (rank 0's shards), so nothing is divided further."""
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_collective = coll_bytes / NVLINK_BW
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_collective), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dom,
        "n_chips": n_chips,
    }
