#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — the paper's Algorithm 1: last-layer proxies,
per-class GRAD-MATCH and GRAD-MATCHPB selection, weighted SGD — and the
CRAIG and GLISTER baselines through their entry points on the card, and
holds every kernel of those paths against its plain PyTorch version.
Phases, one JSON line each:

  1. device   the card's name and power limit;
  2. build    nvcc builds the kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels  each kernel against its plain version at the shapes each path
              gives it and at ragged, tied, ``abs`` and all-masked inputs,
              with its time, its plain version's time, the time of the
              nearest single PyTorch call where there is one, and its bound;
              the batched kernels also against B launches of the single
              ones (the same bits) and timed beside them; a kernel with
              two routes (``lastlayer_grad``, ``bound_max``,
              ``corr_argmax``: the same bits; ``fl_gain_argmax_otf``: the
              tensor cores and the FFMA tiles, each against an f64 scan
              at the CRAIG paths' shapes; ``sqdist``: the mirrored tensor
              cores or their full grid and the FFMA tiles, each against an
              f64 sqdist, ``sqdist(a, a)`` symmetric bit for bit) on each,
              timed; the one-operation floor of the timing (an empty kernel,
              a one-element ``torch.sum``);
  4. trainer  ``mlp()`` at full width on 45 000 rows: per-class GRAD-MATCH
              (budget 0.1, 2 epochs, R = 1) on the batched engine
              (``corr_batched``, ``corr_argmax_batched``), then one
              GRAD-MATCHPB selection (``corr``, ``corr_argmax``).  The
              launch counts are set to 0 before each path and read after
              it: every kernel of a path must launch on it;
  5. solve    the per-class solve and the GRAD-MATCHPB solve, each with the
              kernels and with the plain versions, both on the card, on the
              same proxies: ``err`` must agree; then the batched per-class
              solve against the former loop of ten single solves at a
              budget of 1 280, both timed:
              each class's picks equal, weights and ``err`` to rtol 1e-4 /
              atol 1e-5, or parted only at a tie the two engines' f32
              state difference can flip (``agree``);
  6. trace    ``torch.profiler`` traces of the first rounds at the main
              path's shape, of one class's single solve and of the batched
              solve of all ten: the card's busy share and the host time and
              launches inside the NNLS loop against the rest of the round;
     sessions anytime sessions on the main path's proxies and on a seeded
              (16 384, 256) pool: chained extensions and trajectory rows
              equal direct starts bit for bit, the session picks what
              ``omp_select`` picks, prefixes slice;
     batched  ``omp_select_batched`` for 32 targets with their own masks,
              64 rounds on the (45 000, 65) proxies (path ``batched``),
              each row against its single solve;
  7. craig    the same data and widths through CRAIG and GLISTER, each path
              with its launch counts read on its own: ``craig-lazy`` trained
              end to end (per-gradient proxies (45 000, 65), so the
              similarity is rebuilt on the fly), one ``craig-lazy-otf``,
              ``craig-stochastic``, ``craig-pb`` and ``glister`` selection,
              and lazy CRAIG over a resident similarity built by
              ``sqdist`` (``craig-resident``, the mirrored tensor cores).
              Then, on the card: the resident and the on-the-fly lazy
              selections with the kernels and with the plain
              versions (same 4 500 picks, ``err`` to rtol 1e-5), and the
              dense oracle against the resident lazy greedy at k = 256;
  8. stream   streaming GRAD-MATCH (``gradmatch-stream``) at the same data
              and widths: trained end to end through ``AdaptiveTrainer``
              (bias proxies extracted a chunk of 1 024 at a time, buffer
              256, 256 MiB cache, budget 0.05, one selection: R = 2), the
              selection's first 1 024 picks held index-exact against
              in-memory pooled OMP on the proxies and target the streaming
              pass saw; then one
              pooled per-gradient selection (45 000, 65) at k 1 024 with
              the kernels, with the plain versions, and
              with the plain versions scoring at the pool's shape, each
              beside in-memory pooled GRAD-MATCH in the same arithmetic
              (index-exact with the kernels and at the pool's shape); the
              trainer's first selection again, 128 rounds, with half the
              arena's bytes (LRU eviction, rounds certified by the cached
              chunks' bound and the sketch of the others, loader passes);
              and fetched proxy rows bit-equal to the scanned ones;
  9. lm       the LM training driver (``repro_torch.launch.train.main``) at
              its defaults but 40 steps on gemma-2b at full width and depth
              (2 506 172 416 parameters, bf16, GRAD-MATCHPB over a window
              of 16 micro-batches of 4 x 128 tokens every 20 steps): every
              selection proxy through the tensor-core ``hidden_grad_tc``
              (32 launches, none of the FFMA ``hidden_grad``), OMP through
              ``corr`` and ``corr_argmax``.  Then both head kernels against
              the plain version on a real candidate's logits, targets and
              tied embedding (the same bits on two calls) and on ragged
              f32 and bf16 heads, one selection with the kernels and one
              with the plain versions on the same parameters (the same
              picks), the kernels', the plain version's and two cuBLAS
              yardsticks' times, and a step's parts timed between syncs
              and traced;
 10. partition (after ``stream``, before ``lm`` in the run) partitioned
              selection and the one-card paths of ``core/distributed.py``,
              each path's launch counts read on its own:
              ``gradmatch-partitioned`` trained end to end, one selection
              at budget 0.02 over 10 epochs (R = 10; bias proxies, ten
              class partitions solved as one batched solve, the certified
              merge over the union):
              its union ``gradmatch_per_class``'s set, the merged picks
              inside it, the last selection again with the plain versions
              (the same picks, or a parting ``agree`` certifies, in a
              class's solve or the merge); ``partitioned-hash`` and
              ``-contiguous`` (P 4, k 512, per-gradient proxies) against
              ``use_pmap=True`` partition by partition, P = 1 against the
              single solver (k 128); ``partitioned-stream`` (chunks of 1 024)
              against in-memory contiguous partitioning, partition by
              partition, then the merge; ``sharded-pb`` (the rank-parallel
              GRAD-MATCHPB and OMP on (703, 10), with no group and with a
              one-rank NCCL group) against ``omp_select``; ``fl-pmap`` (the
              sharded gain scan, k 64) against lazy CRAIG on the fly;
 11. resilience (after ``partition``) checkpoints, kill and resume, and
              continual selection, each path's launch counts read on its
              own, snapshots in a temporary directory (its free space
              checked first) removed at the end: the ``stream`` phase's
              partial-cache selection with a snapshot every 8 rounds (equal
              to the run without), killed by a dying stream after at least
              two snapshots and resumed (``corr``, ``bound_max``,
              ``lastlayer_grad``); the ``trainer`` phase's run with a
              snapshot every epoch, its epoch-2 snapshot deleted and run
              again (equal to the trainer phase's run); the trainer's
              per-gradient proxies in 110 batches of 128 through a
              continual buffer of 1 024 rows at k 64 (40 batches), killed
              after batch 20 and restored (``corr``, ``corr_argmax``), against a fresh
              ``omp_select`` (``agree``), and the downdate of the last pick
              against a re-solve at k 512 over 2 048 x 64; the LM driver on
              gemma-2b at full width cut to 2 layers, 40 steps with a
              snapshot every 20, the last deleted and run again; the
              stochastic rung (k 225) over the resumed arena and over the
              (45 000, 65) proxies, kernels against plain versions; the
              continual and stochastic paths' ``corr`` and ``corr_argmax``
              against their plain versions on the paths' own data.  Each
              resumed run is bit-equal to its never-killed run; the
              snapshots' seconds and sizes are printed;
 12. serve    (after ``resilience``) selection serving and the artifact
              fast path on the trainer's per-gradient proxies (45 000, 65),
              each path's launch counts read on its own: ``build_artifacts``
              at k_max 512 and its self-check (slices at k 1 / 256 / 512
              bit-equal to the live session, ``omp_select``'s picks or a
              tie ``agree`` certifies); ``SelectionService(artifact_store=)``
              answering at those k from the artifact, bit-equal to the live
              session, at least 20x faster than a live submit and drain;
              each disk fault on a copy of the store falling through to the
              live bits, quarantined as the reference quarantines; ten
              class-target requests from two tenants as one batched solve
              padded to B 16, each against its ``omp_select`` and against
              the same group on the plain versions; an extension 128 -> 192
              against a one-shot 192; ``craig-lazy`` (on the fly),
              ``glister``, ``random``, ``gradmatch-partitioned``, gradmatch
              on the chunked pool (chunks of 1 024) and ``craig-lazy`` on
              serve_selection's 4 096 x 64 pool (a resident similarity),
              each bit-equal to a direct call of its engine;
              ``serve_selection.main(["--smoke"])`` and ``["--load"]``; a
              stream session (16 batches of 128 into 1 024 rows, k 64)
              killed after batch 8 and resumed, bit-equal to the stream
              never killed;

 13. lm_serve (after ``lm``) the LM served on the ``lm`` phase's gemma-2b
              (full width and depth, bf16): ``launch/serve.main`` at its
              defaults (8 requests in batches of 4, prompt 32, 16 tokens),
              twice, its tokens a second; teacher-forced decode (prefill,
              ``_seat``, one token at a time) against the train-mode
              forward at the same positions, within 2e-2 of the largest
              |logit|: prompt 32 -> 48, and 2 032 -> 2 048 where every
              decode step flash-decodes the 2 048-slot caches; each greedy
              token of ``serve.generate`` equal to the forward's argmax
              unless its top-2 gap is under that limit; gemma2-9b at full
              width cut to one (local, global) super-block, batch 2, prompt
              5 104 -> 5 120 (past the 4 096 window and not a multiple of
              it: the ring wraps, the global layer flash-decodes; the flash
              threshold set to 5 120 so that the prompt prefills dense);
              gemma-2b at f32 cut to 2 layers within 1e-5.  The launch
              counts are read around the phase: none of its paths reaches
              a kernel;
 14. lm_optim (after ``lm_serve``) gemma-2b at full width cut to 2 layers,
              4 x 128 tokens a step: three AdamW steps (clip 1.0 under
              ``exponential_decay``), the updates and slots of three leaves
              held against an f64 recomputation from the step's gradients
              and slots; two EF-TopK compressed SGD steps at a fraction of
              0.01, each reference leaf (block leaves stacked over the
              super-blocks) with ``dense + residual == acc`` bit for bit, k
              entries kept, and the kept set the first k of a stable
              descending sort of |acc|.  No kernel on these paths either;
 15. lm_moe   (after ``lm_optim``) the LM driver (40 steps) on
              qwen3-moe-30b-a3b at its published widths (128 experts,
              top-8, expert d_ff 768, vocab 151 936) cut to 4 layers:
              ``hidden_grad_tc`` 32 launches on the untied head, none of
              the FFMA kernel, ``corr`` / ``corr_argmax``; the head kernel
              against its plain version on a real candidate (1e-4 of max
              |out|, the same bits twice), timed against its bound; one
              selection with the kernels and one with the plain versions
              (the same picks); two weighted SGD steps from the same start
              repeated, the same bits in the losses and every parameter;
              the share of layer 0's assignments dropped at capacity.
              Then ``launch/serve.main`` at its defaults on qwen3-moe at
              full width and depth (48 layers, 30.5 B parameters), decode
              against the train-mode forward (batch 4, 32 -> 48, capacity
              opened to E / k) within 2e-2 of max |logit| and each greedy
              token against the forward's argmax, and moonshot-v1-16b-a3b
              at full width cut to 2 layers, the same decode check;
 16. lm_hybrid (after ``lm_moe``) the same driver checks on zamba2-7b at
              its published widths (d 3 584, 112 SSD heads, d_state 64,
              chunk 256, vocab 32 000) cut to its 3 prologue layers and
              one super-block (5 Mamba2 + the shared block), then at full
              depth (81 layers) ``serve.main`` at its defaults and decode
              against the forward at batch 2, 32 -> 48 and 512 -> 528 (two
              SSD chunks; the forward over 528 tokens at chunk 176) within
              5e-2 of max |logit|, every super-block's shared-block cache
              written by decode; at f32, cut as the driver is, within
              1e-5.  The serving paths of both phases reach no kernel;

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power limit,
and the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero; without a card, or without the repo's
``src/`` beside it, it exits 2 and prints no result.

Times: ``ms`` is the median device time of one call, measured with CUDA
events between calls queued behind a sleep kernel, so the host's launch
cost is not in it (the L2 cache stays warm, as in the OMP round loop that
re-reads the same pool).  ``bound_ms`` is the larger of the bytes the call
must move (each input read once, each output written once) over the card's
published memory bandwidth and its operations over the card's published
rate for their type: f32 outside the tensor cores, for ``hidden_grad_tc``
its two bf16 passes at the dense bf16 tensor-core rate, and for
``fl_gain_argmax_otf_tc`` its three TF32 passes at the dense TF32 rate or
its epilogue's f32 operations, whichever take longer, and for ``sqdist``
on the tensor cores its three TF32 passes (one for bf16) over the pairs
the call needs or its bytes, whichever take longer (the f32 bound
beside it).
Where the work depends on the data (a masked argmax, ``bound_max``'s
masked-in rows), the bytes and operations are the ones this run's masks
need.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import asdict, replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published dense peaks (NVIDIA data sheets): memory bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
# Published dense bf16 tensor-core FLOP/s (the data sheets' sparse rates
# halved); the dense TF32 rate is half of it on each of these cards.
BF16_PEAKS = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100": 989e12,
              "H200": 989e12}

# The main path's size: make_classification(n=50 000) split 90/10 gives the
# 45 000 training rows of CIFAR-10's train set; budget 0.1 selects 4 500.
POOL_ROWS = 50_000
ROWS = 45_000
BUDGET = 0.1
K = int(ROWS * BUDGET)
BATCH = 64
PB_ROWS = ROWS // BATCH   # GRAD-MATCHPB's mini-batch proxies: (703, 10)
WIDE = (8192, 512)        # a full-width column cache of the wide regime
TRACE_ROUNDS = 32         # OMP rounds in the profiler trace
PATHS = ("gradmatch", "gradmatch-pb")
# Kernels each trainer path must launch.
TRAINER_NEEDS = {"gradmatch": ("corr_batched", "corr_argmax_batched",
                               "lastlayer_grad"),
                 "gradmatch-pb": ("corr", "corr_argmax", "lastlayer_grad")}
CLASSES = 10
SERVE_B, SERVE_K = 32, 64       # the batched phase: B targets, k rounds
SESSION_POOL = (16384, 256)     # widths 128 / 256 / 384: wide, then narrow
SESSION_KS = {"proxies": (50, 150, 300), "seeded": (100, 200, 300)}
TRAJ_K = {"proxies": 200, "seeded": 300}
# Two engines' states of one problem agree to f32 noise when their
# residuals differ by at most this much of |target|.
STATE_RTOL = 1e-5
STREAM_CHUNK = 1024       # the trainer's chunk; select()'s is 2 048
STREAM_BUF = 256 + 512    # buffer + repair annex rows
PARTIAL_SLOTS = 32        # the partial cache's chunk slots (44 chunks)
PARTIAL_K = 128           # rounds of the partial-cache selection (cut
                          # from 256: one 128-round block)
STREAM_CHECK_K = 1024     # rounds of the streaming vs in-memory checks
STREAM_BUDGET = 0.05      # the trained gradmatch-stream's budget (cut from
STREAM_K = int(ROWS * STREAM_BUDGET)     # 0.1 in PR 25: its selection's
#                                          rounds, 4 500 -> 2 250)
LOOP_K = 1280             # budget of the batched-engine vs loop check
CRAIG_PATHS = ("craig-lazy", "craig-lazy-otf", "craig-stochastic",
               "craig-pb", "glister", "craig-resident")
DENSE_K = 256             # rounds of the dense-oracle check
PART_P = 4                # partitions of the hash, contiguous, stream paths
PART_K = 512              # their budget: 128 rounds a partition
PART_BUDGET = 0.02        # the trained gradmatch-partitioned's budget (cut
PART_TRAIN_K = int(ROWS * PART_BUDGET)   # from 0.1: its merge's rounds),
PART_EPOCHS = 10          # over 10 epochs: the trainer phase's 140 steps
PART_PATHS = ("gradmatch-partitioned", "partitioned-hash",
              "partitioned-contiguous", "partitioned-stream", "sharded-pb",
              "fl-pmap")
FL_PMAP_K = 64            # rounds of the device-sharded CRAIG greedy
RES_BATCH = 128           # continual: rows an admission (the reference's
RES_BATCHES = 40          # benchmark run_continual: 110 batches of 128
RES_CAP = 1024            # into a 1 024-row buffer at k 64; cut to 40)
RES_K = 64
RES_KILL = 20             # the continual run is killed after this batch
DOWN_POOL = (2048, 64)    # the downdate against a fresh solve: pool, k
DOWN_K = 512
DEGRADE_K = 225           # the stochastic rung's budget (cut from K)
RES_LM_LAYERS = 2         # the LM kill and resume: gemma-2b cut to 2 layers
RES_LM_STEPS = 30         # (cut from 40: one snapshot, at RES_LM_EVERY,
RES_LM_EVERY = 20         # where three were written)
SERVE_K_MAX = 512         # build_artifacts' default k_max
SERVE_KS = (1, 256, 512)  # the artifact's slices held against the session
SERVE_HIT_RATIO = 20.0    # an artifact hit against a live submit + drain
SERVE_REQ_K = 128         # serve_selection's default k
SERVE_EXT_K = 192         # and its default extension
SERVE_BUCKET = 16         # ten requests pad to the power-of-two bucket
SERVE_LAUNCHER_POOL = (4096, 64)    # serve_selection's default pool
SERVE_STREAM = (128, 16, 1024, 64)  # stream: batch, batches, capacity, k
SERVE_STREAM_KILL = 8     # the stream session is killed after this batch
SERVE_KERNELS = ("corr", "corr_argmax", "bound_max", "fl_gain_argmax",
                 "fl_gain_argmax_otf_tc", "corr_batched",
                 "corr_argmax_batched")

KERNEL_SOURCES = {
    "corr": ("src/repro_torch/kernels/csrc/corr.cu",
             "src/repro/kernels/corr.py:51"),
    "corr_argmax": ("src/repro_torch/kernels/csrc/corr.cu",
                    "src/repro/kernels/corr.py:234"),
    "lastlayer_grad": ("src/repro_torch/kernels/csrc/lastlayer_grad.cu",
                       "src/repro/kernels/lastlayer_grad.py:60"),
    "fl_gain_argmax": ("src/repro_torch/kernels/csrc/fl_gain.cu",
                       "src/repro/kernels/fl_gain.py:85"),
    "fl_gain_argmax_otf": ("src/repro_torch/kernels/csrc/fl_gain.cu",
                           "src/repro/kernels/fl_gain.py:174"),
    "fl_gain_argmax_otf_tc": ("src/repro_torch/kernels/csrc/fl_gain_tc.cu",
                              "src/repro/kernels/fl_gain.py:174"),
    "sqdist": ("src/repro_torch/kernels/csrc/sqdist_tc.cu",
               "src/repro/kernels/sqdist.py:51"),
    "bound_max": ("src/repro_torch/kernels/csrc/bound_max.cu",
                  "src/repro/kernels/corr.py:138"),
    "hidden_grad": ("src/repro_torch/kernels/csrc/hidden_grad.cu",
                    "src/repro/kernels/lastlayer_grad.py:143"),
    "hidden_grad_tc": ("src/repro_torch/kernels/csrc/hidden_grad_tc.cu",
                       "src/repro/kernels/lastlayer_grad.py:143"),
    "corr_batched": ("src/repro_torch/kernels/csrc/corr_batched.cu",
                     "src/repro/kernels/ops.py:94"),
    "corr_argmax_batched": ("src/repro_torch/kernels/csrc/corr_batched.cu",
                            "src/repro/kernels/ops.py:114"),
}
BATCHED = ("corr_batched", "corr_argmax_batched")
# The path whose shape gives each kernel's top-level numbers.  Per-class
# GRAD-MATCH runs the batched kernels; its PB variant still runs the
# single ones.
MAIN_PATH = {"corr": "gradmatch-pb", "corr_argmax": "gradmatch-pb",
             "corr_batched": "gradmatch", "corr_argmax_batched": "gradmatch",
             "lastlayer_grad": "gradmatch",
             "fl_gain_argmax": "craig-resident",
             "fl_gain_argmax_otf": "craig-lazy",
             "fl_gain_argmax_otf_tc": "craig-lazy", "sqdist": "craig-resident",
             "bound_max": "gradmatch-stream", "hidden_grad": "lm",
             "hidden_grad_tc": "lm"}


# The LM phase: the driver's defaults on gemma-2b at full size.
LM_ARGV = ["--arch", "gemma-2b", "--steps", "40"]   # cut from 100 steps
LM_PARAMS = 2_506_172_416           # gemma-2b's parameters (tied head)
LM_HG_LIMIT = 1e-4                  # hidden_grad vs plain, of max |out|
LM_TRACE_STEPS = 3                  # steps timed part by part
SERVE_LM_GEN = 16                   # launch/serve's --gen-len default
SERVE_LM_PROMPT = 32                # and its --prompt-len
SERVE_LM_BATCH = 4                  # and its --batch
SERVE_LM_BF16_LIMIT = 2e-2          # decode vs forward at bf16, of max |logit|
#                                     (6.8e-3 the largest in a first run)
SERVE_LM_F32_LIMIT = 1e-5           # the same at f32
SERVE_FLASH_PROMPT = 2032           # + 16 = 2 048 slots: flash-decoding
SERVE_G2_PROMPT = 5104              # gemma2-9b: past the 4 096 window, not a
SERVE_G2_BATCH = 2                  # multiple of it; + 16 = 5 120 slots
SERVE_F32_LAYERS = 2                # gemma-2b at f32 cut to 2 layers
OPTIM_BATCH = (4, 128)              # lm_optim: 4 x 128 tokens a step
OPTIM_ADAMW_STEPS = 3
OPTIM_LR = 1e-3                     # exponential_decay(1e-3, 2)
OPTIM_LEAVES = ("embed", "blocks.0.sub0.attn.wq", "blocks.1.sub0.norm2.scale")
OPTIM_FRAC = 0.01                   # EF-TopK's fraction kept
OPTIM_COMPRESSED_STEPS = 2
# lm_moe: qwen3-moe-30b-a3b at its published widths (d 2 048, 128 experts,
# top-8, expert d_ff 768, vocab 151 936), the driver's depth cut to 4
# layers; served at full depth (48 layers); moonshot-v1-16b-a3b at full
# width cut to 2 layers.
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_ARGV = ["--arch", MOE_ARCH, "--steps", "40"]
MOE_TRAIN_LAYERS = 4
MOE_SERVE_LAYERS = 48
MOONSHOT_LAYERS = 2
# lm_hybrid: zamba2-7b at its published widths (d 3 584, d_inner 7 168, 112
# SSD heads, d_state 64, chunk 256, vocab 32 000), the driver's depth cut
# to the 3 prologue layers and one super-block (5 Mamba2 + the shared
# block); served at full depth (81 layers).
HYBRID_ARCH = "zamba2-7b"
HYBRID_ARGV = ["--arch", HYBRID_ARCH, "--steps", "40"]
HYBRID_TRAIN_SUPERBLOCKS = 1
HYBRID_BATCH = 2
HYBRID_LONG_PROMPT = 512            # two SSD chunks of 256
HYBRID_LONG_CHUNK = 176             # the forward's chunk at 528 = 3 x 176
HYBRID_BF16_LIMIT = 5e-2            # the reference's decode test's limit


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peaks(name: str) -> tuple[float, float]:
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name:
            return PEAKS[key]
    raise RuntimeError(f"no published peaks for {name!r}")


def bf16_peak(name: str) -> float:
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name:
            return BF16_PEAKS[key]
    raise RuntimeError(f"no published bf16 peak for {name!r}")


def device_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn()`` over ``reps`` calls queued behind a
    sleep kernel, one event pair per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(50_000_000)       # ~25 ms: the host queues every call
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


def corr_seconds(torch, shapes: dict) -> tuple[float, list]:
    """Device seconds of one path's ``corr`` launches: each (rows, d, dtype)
    the path called it at, timed on random inputs of that shape, times the
    launches at that shape."""
    from repro_torch.kernels import corr as corr_k
    gen = torch.Generator(device="cuda").manual_seed(0)
    total, table = 0.0, []
    for key, c in sorted(shapes.items()):
        name, n, d, dt = key[:4]
        if name != "corr":
            continue
        g = torch.randn((n, d), generator=gen, device="cuda").to(
            getattr(torch, dt))
        r = torch.randn((d,), generator=gen, device="cuda")
        ms = device_ms(torch, lambda: corr_k.corr(g, r))
        total += c * ms / 1e3
        table.append({"shape": [n, d], "dtype": dt, "launches": c, "ms": ms})
    return total, table


def bound_route(torch, shapes: dict) -> str:
    """The route ``bound_max``'s plan gives the one arena a path scanned
    (the arena is a whole allocation: its rows and mask are aligned)."""
    from repro_torch.kernels import corr as corr_k
    arenas = {key[1:4] for key in shapes if key[0] == "bound_max"}
    check(len(arenas) == 1, f"bound_max scanned arenas {arenas}")
    (n, d, dt), = arenas
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return corr_k.bound_max_plan(n, d, 2 if dt == "bfloat16" else 4, 0, 0,
                                 sms).route


def bound_of(card: dict, nbytes: float, nops: float) -> tuple[float, str]:
    """The least time (ms) the card could take for work that moves
    ``nbytes`` and does ``nops`` f32 operations, and which of the two
    sets it."""
    bw, flops = peaks(card["name"])
    by_bytes, by_ops = nbytes / bw * 1e3, nops / flops * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def ran_at(key: tuple) -> tuple[tuple, bool]:
    """A launch-shape key, (kernel, rows, d, dtype[, B, per-problem]), as
    the shape a record is measured at ((rows, d[, B])) and whether the
    batched kernel read a per-problem matrix."""
    _, n, d, _, *batch = key
    return (n, d, *batch[:1]), bool(batch[1:] and batch[1])


def hold_corr(torch, card: dict, g, r) -> dict:
    """``corr`` against its plain version at ``g``'s shape (rtol 1e-5, atol
    1e-6 of max |g_i| |r|) and every route its plan can give the shape
    against the warp kernel's bits; timed on the plan's route and on each
    route beside the plain version and ``torch.mv``; returns the record."""
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ref
    n, d = g.shape
    dt = str(g.dtype).removeprefix("torch.")
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    plan = asdict(corr_k.corr_plan(n, d, g.element_size(), g.data_ptr(),
                                   sms))
    got, want = corr_k.corr(g, r), ref.corr_ref(g, r)
    err = float((got - want).abs().max())
    scale = float(torch.sqrt((g.float() ** 2).sum(1).max() * (r ** 2).sum()))
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6 * max(scale, 1.0)),
          f"corr kernel disagrees at ({n}, {d}) {dt}: max err {err}")
    warps = corr_k.corr(g, r, route="warps")
    route_ms = {}
    for route in ("rows", "wide", "warps"):
        try:
            corr_k.corr_plan(n, d, g.element_size(), g.data_ptr(), sms,
                             route)
        except ValueError:
            continue                # a layout that cannot take the shape
        check(torch.equal(corr_k.corr(g, r, route=route), warps),
              f"corr ({n}, {d}) {dt}: the {route} route is not the warp "
              "kernel's bits")
        route_ms[route] = device_ms(torch, lambda: corr_k.corr(
            g, r, route=route))
    check(torch.equal(got, warps), f"corr ({n}, {d}) {dt}: the plan's "
          f"{plan['route']} route is not the warp kernel's bits")
    ms = device_ms(torch, lambda: corr_k.corr(g, r))
    plain = device_ms(torch, lambda: ref.corr_ref(g, r))
    lib_ms = device_ms(torch, lambda: torch.mv(g, r.to(g.dtype)))
    b, by = bound_of(card, n * d * g.element_size() + 4 * d + 4 * n,
                     2 * n * d)
    emit("kernels", kernel="corr", shape=[n, d], dtype=dt, max_abs_err=err,
         ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b, plan=plan,
         route_ms=route_ms)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib_ms, shape=[n, d], plan=plan,
                route_ms=route_ms)


def check_argmax(torch, c, w, base, mask, absolute, what) -> float:
    """``corr_argmax`` against its plain version: the index equal unless
    the two scores are within 1e-6 of each other, the value to rtol 1e-5;
    returns the value's error."""
    import math

    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ref
    gi, gv = corr_k.corr_argmax(c, w, base, mask, absolute=absolute)
    ri, rv = ref.corr_argmax_ref(c, w, base, mask, absolute=absolute)
    gi, ri, gv, rv = int(gi), int(ri), float(gv), float(rv)
    if gi != ri:
        # Only a true near-tie under another summation order may differ.
        s = base - c.float() @ w
        s = s.abs() if absolute else s
        a, b = float(s[gi]), float(s[ri])
        check(bool(mask[gi]) and abs(a - b) <= 1e-6 * abs(b),
              f"corr_argmax {what}: index {gi} vs {ri}, scores {a} {b}")
    if math.isfinite(rv):
        check(abs(gv - rv) <= 1e-5 * abs(rv) + 1e-6,
              f"corr_argmax {what}: value {gv} vs {rv}")
    else:
        check(gv == rv, f"corr_argmax {what}: value {gv} vs {rv}")
    return abs(gv - rv) if math.isfinite(rv) else 0.0


def hold_corr_argmax(torch, card: dict, c, w, base, mask, absolute,
                     what) -> dict:
    """``corr_argmax`` against its plain version (``check_argmax``), timed
    beside it; returns the record."""
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ref
    err = check_argmax(torch, c, w, base, mask, absolute, what)
    n, p = c.shape
    ms = device_ms(torch, lambda: corr_k.corr_argmax(
        c, w, base, mask, absolute=absolute))
    plain = device_ms(torch, lambda: ref.corr_argmax_ref(
        c, w, base, mask, absolute=absolute))
    # What the mask needs: every mask byte, the row and base of each live
    # row, the vector, and (idx, val).
    live = int(mask.sum())
    b, by = bound_of(card, 4 * p * live + 4 * p + 4 * live + n + 8,
                     2 * p * live)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, shape=[n, p])


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return {"name": name, "smi": smi}


def ptxas_report(log: str, kernel: str) -> dict:
    """``ptxas -v``'s lines for each instantiation of ``kernel`` in the
    build log: registers, stack, spills."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.lib()
    log = (build.BUILD_DIR / "build.log").read_text()
    emit("build", library=str(path.relative_to(ROOT)),
         nvcc_seconds=build.build_seconds,
         load_seconds=time.perf_counter() - t0,
         ptxas_hidden_grad_tc=ptxas_report(log, "hidden_grad_tc_kernel"),
         ptxas_fl_gain_tc=ptxas_report(log, "fl_gain_tc_kernel"),
         ptxas_corr_batched_rows=ptxas_report(log, "row_tiles_kernel"),
         ptxas_corr_wide=ptxas_report(log, "corr_wide_kernel"),
         ptxas_corr_batched_warps=ptxas_report(log, "corr_batched_kernel"),
         ptxas_corr_argmax_batched_warps=ptxas_report(
             log, "corr_argmax_batched_kernel"),
         ptxas_sqdist_tc=ptxas_report(log, "sqdist_tc_kernel"),
         wgmma_serialized=log.count("C7520"))
    # ptxas fences every wgmma of a kernel whose accumulators it must
    # guard on a divergent path (C7520); none of the port's may.
    check("C7520" not in log, "ptxas serialized the wgmmas of a kernel "
          "(C7520 in the build log)")


def device_ops(torch, fn) -> int:
    """Device operations (kernels, memsets, copies) one call of ``fn``
    makes, by ``torch.profiler``; ``fn`` runs once before, untraced.  A
    trace with no device record at all lost its records (every call traced
    here launches), and is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  for e in prof.events())
        if ops:
            break
    return ops


def phase_kernels(torch, np, card: dict) -> dict:
    """Each kernel against its plain version on the card; returns, per
    kernel and per path, the record at the shape that path gives it."""
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import lastlayer_grad as llg_k
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    records = {name: {} for name in KERNEL_SOURCES}

    # The one-operation floor of this timing (device_ms): an empty kernel
    # (torch.cuda._sleep of 0 cycles) and a one-element torch.sum, each a
    # single launch queued behind the sleep kernel.
    one = torch.ones((1,), device=dev)
    emit("floor", empty_kernel_ms=device_ms(
        torch, lambda: torch.cuda._sleep(0)),
         one_element_sum_ms=device_ms(torch, lambda: one.sum()))

    # -- corr: per-class (45 000, 65) and PB (703, 10) f32, wide (8192, 512)
    #    f32 and bf16, ragged, the bf16 streaming arenas, the LM's
    #    candidates (gemma-2b's and qwen3-moe's d 2 048, zamba2's 3 584) ----
    for n, d, dt, paths in ((ROWS, 65, "float32", ("gradmatch",)),
                            (PB_ROWS, 10, "float32",
                             ("gradmatch-pb", "sharded-pb")),
                            (STREAM_BUF, 10, "float32",
                             ("gradmatch-stream",)),
                            (STREAM_BUF, 65, "float32",
                             ("stream-pooled", "partitioned-stream")),
                            # the certified merges' unions
                            (PART_TRAIN_K, 10, "float32",
                             ("gradmatch-partitioned",)),
                            (PART_K, 65, "float32",
                             ("partitioned-hash", "partitioned-contiguous")),
                            (*WIDE, "float32", ()),
                            (*WIDE, "bfloat16", ()),
                            (1000, 700, "float32", ()),
                            (88_064, 10, "bfloat16", ()),
                            (86_016, 65, "bfloat16", ()),
                            (16, 2048, "float32", ()),
                            (16, 3584, "float32", ())):
        g = t(rng.standard_normal((n, d)).astype(np.float32)).to(
            getattr(torch, dt))
        r = t(rng.standard_normal(d).astype(np.float32))
        rec = hold_corr(torch, card, g, r)
        for path in paths:
            records["corr"][path] = dict(rec)

    # -- corr_argmax: narrow (G, -r, 0) and wide (C, w, c0), both abs ------
    labels = t(rng.integers(0, 10, ROWS))
    cases = []
    g = t(rng.standard_normal((ROWS, 65)).astype(np.float32))
    r = t(rng.standard_normal(65).astype(np.float32))
    zeros = torch.zeros((ROWS,), device=dev)
    for absolute in (False, True):
        cases.append(("narrow", g, -r, zeros, labels == 3, absolute,
                      ("gradmatch",) if not absolute else ()))
    gp = t(rng.standard_normal((PB_ROWS, 10)).astype(np.float32))
    rp = t(rng.standard_normal(10).astype(np.float32))
    cases.append(("pb-narrow", gp, -rp,
                  torch.zeros((PB_ROWS,), device=dev),
                  t(rng.random(PB_ROWS) < 0.9), False, ("gradmatch-pb",)))
    cc = t(rng.standard_normal(WIDE).astype(np.float32))
    w = t(rng.standard_normal(WIDE[1]).astype(np.float32) / 16)
    c0 = t(rng.standard_normal(WIDE[0]).astype(np.float32) * 3)
    wmask = t(rng.random(WIDE[0]) < 0.9)
    for absolute in (False, True):
        cases.append(("wide", cc, w, c0, wmask, absolute, ()))
    gr = t(rng.standard_normal((1000, 700)).astype(np.float32))
    cases.append(("ragged", gr, t(rng.standard_normal(700).astype(
        np.float32)), t(rng.standard_normal(1000).astype(np.float32)),
        t(rng.random(1000) < 0.5), True, ()))
    g10 = t(rng.standard_normal((ROWS, 10)).astype(np.float32))
    v10 = t(rng.standard_normal(10).astype(np.float32))
    cases.append(("glister", g10, -v10, zeros, t(rng.random(ROWS) < 0.9),
                  False, ("glister",)))
    # the same shape from a pool view off a 16-byte boundary
    buf = t(rng.standard_normal(ROWS * 10 + 1).astype(np.float32))
    cases.append(("unaligned", buf[1:].view(ROWS, 10), -v10, zeros,
                  t(rng.random(ROWS) < 0.9), False, ()))
    dup = g.clone()
    dup[1::2] = dup[::2]
    every = torch.ones((ROWS,), dtype=torch.bool, device=dev)
    cases.append(("ties", dup, -r, zeros, every, True, ()))
    cases.append(("all-masked", g, -r, zeros,
                  torch.zeros((ROWS,), dtype=torch.bool, device=dev), False,
                  ()))
    # the certified merges, narrow, half the union taken: the class
    # partitions' union of K bias-proxy rows, the P = 4 unions of PART_K
    # per-gradient rows
    mrng = np.random.default_rng(5)
    for n, d, paths in ((PART_TRAIN_K, 10, ("gradmatch-partitioned",)),
                        (PART_K, 65, ("partitioned-hash",
                                      "partitioned-contiguous",
                                      "partitioned-stream"))):
        cases.append((f"merge ({n}, {d})",
                      t(mrng.standard_normal((n, d)).astype(np.float32)),
                      -t(mrng.standard_normal(d).astype(np.float32)),
                      torch.zeros((n,), device=dev), t(mrng.random(n) < 0.5),
                      False, paths))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, c, wv, base, mask, absolute, paths in cases:
        rec = hold_corr_argmax(torch, card, c, wv, base, mask, absolute,
                               what)
        n, p = c.shape
        # Each route the plan can give the shape, against the plan's bit for
        # bit, and timed.
        plan = asdict(corr_k.corr_argmax_plan(n, p, c.data_ptr(), sms))
        want = corr_k.corr_argmax(c, wv, base, mask, absolute=absolute)
        route_ms = {}
        for route in ("rows", "warps"):
            try:
                corr_k.corr_argmax_plan(n, p, c.data_ptr(), sms, route)
            except ValueError:
                continue            # a shape the row tiles do not take
            got = corr_k.corr_argmax(c, wv, base, mask, absolute=absolute,
                                     route=route)
            check(torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]),
                  f"corr_argmax {what}: the {route} route is not the "
                  f"{plan['route']} route's bits")
            route_ms[route] = device_ms(torch, lambda: corr_k.corr_argmax(
                c, wv, base, mask, absolute=absolute, route=route))
        ops = device_ops(torch, lambda: corr_k.corr_argmax(
            c, wv, base, mask, absolute=absolute))
        check(ops == 1, f"corr_argmax {what}: {ops} device operations a "
              "call")
        rec.update(route_ms=route_ms, plan=plan, device_ops=ops)
        emit("kernels", kernel="corr_argmax", case=what, absolute=absolute,
             **rec)
        for path in paths:
            records["corr_argmax"][path] = dict(rec)
    gi, _ = corr_k.corr_argmax(dup, -r, zeros, every, absolute=True)
    check(int(gi) % 2 == 0, "corr_argmax: a tie did not go to the lower row")

    # -- lastlayer_grad: both paths n = 45 000, d_h = 64, C = 10; the stream
    #    path's chunks n = 1 024; a tail tile; C = 37 (the warps only).  Each
    #    route the plan can give the shape, against the other bit for bit.
    for n, dh, nc, ldt, paths in ((ROWS, 64, 10, "int64",
                                   PATHS + CRAIG_PATHS
                                   + ("gradmatch-partitioned",)),
                                  (ROWS, 64, 10, "int32", ()),
                                  (STREAM_CHUNK, 64, 10, "int64",
                                   ("gradmatch-stream",)),
                                  (4097, 65, 10, "int64", ()),
                                  (1001, 84, 37, "int64", ())):
        h = t(np.maximum(rng.standard_normal((n, dh)), 0).astype(np.float32))
        z = t(3 * rng.standard_normal((n, nc)).astype(np.float32))
        y = t(rng.integers(0, nc, n)).to(getattr(torch, ldt))
        resid, hgrad = llg_k.lastlayer_grad(h, z, y)
        rr, rh = ref.lastlayer_grad_ref(h, z, y)
        err = max(float((resid - rr).abs().max()),
                  float((hgrad - rh).abs().max()))
        check(torch.allclose(resid, rr, rtol=1e-5, atol=1e-6)
              and torch.allclose(hgrad, rh, rtol=1e-5, atol=1e-6),
              f"lastlayer_grad disagrees at ({n}, {dh}, {nc}): {err}")
        addrs = [a.data_ptr() for a in (h, z, y, resid, hgrad)]
        plan = asdict(llg_k.lastlayer_plan(n, dh, nc, addrs, sms,
                                           y.element_size()))
        route_ms = {}
        for route in ("tiles", "warps"):
            try:
                llg_k.lastlayer_plan(n, dh, nc, addrs, sms, y.element_size(),
                                     route)
            except ValueError:
                continue            # a shape the tile route does not take
            got = llg_k.lastlayer_grad(h, z, y, route=route)
            check(torch.equal(got[0], resid) and torch.equal(got[1], hgrad),
                  f"lastlayer_grad ({n}, {dh}, {nc}) {ldt}: the {route} "
                  f"route is not the {plan['route']} route's bits")
            route_ms[route] = device_ms(
                torch, lambda: llg_k.lastlayer_grad(h, z, y, route=route))
        ops = device_ops(torch, lambda: llg_k.lastlayer_grad(h, z, y))
        check(ops == 1, f"lastlayer_grad ({n}, {dh}, {nc}): {ops} device "
              "operations a call")
        ms = device_ms(torch, lambda: llg_k.lastlayer_grad(h, z, y))
        plain = device_ms(torch, lambda: ref.lastlayer_grad_ref(h, z, y))
        # The card's floor for this traffic: copies of the same bytes.
        copy_ms = device_ms(torch, lambda: (hgrad.copy_(h),
                                            resid.copy_(z)))
        nbytes = 2 * 4 * n * (dh + nc) + y.element_size() * n
        b, by = bound_of(card, nbytes, n * (4 * nc + dh))
        emit("kernels", kernel="lastlayer_grad", shape=[n, dh, nc],
             labels=ldt, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
             route_ms=route_ms, copy_floor_ms=copy_ms, plan=plan,
             device_ops=ops)
        for path in paths:
            records["lastlayer_grad"][path] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, shape=[n, dh, nc],
                route_ms=route_ms, copy_floor_ms=copy_ms, plan=plan,
                device_ops=ops)
    torch.cuda.synchronize()
    return records


def close(got, want, rtol=1e-4, atol=1e-4):
    """Max abs error and whether |got - want| <= atol + rtol |want|, in row
    blocks (the matrices here are up to 8.1 GB)."""
    err, ok = 0.0, True
    for lo in range(0, got.shape[0], 4096):
        a, b = got[lo:lo + 4096], want[lo:lo + 4096]
        diff = (a - b).abs_()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= atol + rtol * b.abs()).all())
    return err, ok


def check_scan(got, want, what):
    """An FL gain scan against its plain version: gains to rtol/atol 1e-4;
    the index equal unless the two gains are within that tolerance; an
    all-masked input (0, -inf).  Returns the gains' max abs error."""
    import math
    (gg, gi, gv), (wg, wi, wv) = got, want
    err, ok = close(gg[None], wg[None])
    check(ok, f"{what}: gains differ, max abs err {err}")
    gi, wi, gv, wv = int(gi), int(wi), float(gv), float(wv)
    if not math.isfinite(wv):
        check(gi == 0 and gv == wv, f"{what}: all-masked gave ({gi}, {gv})")
        return err
    if gi != wi:
        a, b = float(wg[gi]), float(wg[wi])
        check(abs(a - b) <= 1e-4 + 1e-4 * abs(b),
              f"{what}: index {gi} vs {wi}, gains {a} vs {b}")
    check(abs(gv - wv) <= 1e-4 + 1e-4 * abs(wv),
          f"{what}: value {gv} vs {wv}")
    return err


def hold_fl_gain(torch, card: dict, sim, cover, mask, what) -> dict:
    """``fl_gain_argmax`` against its plain version (``check_scan``) on a
    resident similarity, timed beside it; returns the record."""
    from repro_torch.kernels import fl_gain as fl_k
    from repro_torch.kernels import ref
    n = sim.shape[0]
    err = check_scan(fl_k.fl_gain_argmax(sim, cover, mask),
                     ref.fl_gain_argmax_ref(sim, cover, mask),
                     f"fl_gain_argmax {what}")
    ms = device_ms(torch, lambda: fl_k.fl_gain_argmax(sim, cover, mask))
    plain = device_ms(torch, lambda: ref.fl_gain_argmax_ref(
        sim, cover, mask), reps=10, warmup=2)
    b, by = bound_of(card, 4 * n * n + 13 * n + 8, 3 * n * n)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, shape=[n, n])


def phase_kernels_fl(torch, np, card: dict, records: dict) -> None:
    """``fl_gain_argmax``, ``fl_gain_argmax_otf`` and ``sqdist`` against
    their plain versions on the card, at the shapes the CRAIG paths give
    them and at ragged, tied and all-masked inputs; adds their records."""
    from repro_torch.core import greedy
    from repro_torch.kernels import fl_gain as fl_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import sqdist as sq_k

    dev = torch.device("cuda")
    bw, flops = peaks(card["name"])
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def bound(nbytes, nflops):
        return bound_of(card, nbytes, nflops)

    def record(err, ms, plain, lib, b, by, shape):
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=by, library_ms=lib, shape=shape)

    # -- fl_gain_argmax: the resident (45 000, 45 000) similarity of 65-wide
    #    rows, then ragged n, all masked, a planted tie ---------------------
    for n in (ROWS, 1, 129, 4097):
        g = t(rng.standard_normal((n, 65)).astype(np.float32))
        # Built as the resident path builds it: sqdist(g, g) is bitwise
        # symmetric (the mirrored tensor cores write each pair's one value
        # to both places), so row j is column j.
        sim = greedy.build_sim(g, dist_fn=sq_k.sqdist)
        cover = t(np.abs(rng.standard_normal(n)).astype(np.float32) * 4)
        mask = t(rng.random(n) < 0.7)
        for what, m in (("random", mask),
                        ("all-masked", torch.zeros_like(mask))):
            if what == "all-masked" and n != 4097:
                continue
            got = fl_k.fl_gain_argmax(sim, cover, m)
            want = ref.fl_gain_argmax_ref(sim, cover, m)
            err = check_scan(got, want, f"fl_gain_argmax n={n} {what}")
            emit("kernels", kernel="fl_gain_argmax", shape=[n, n],
                 case=what, max_abs_err=err)
        if n != ROWS:
            continue
        # The lazy engine's block refresh sums similarity rows with torch
        # where the scan kernel sums columns; their relative gap, over every
        # candidate, is what the resident certification margin (1e-6) has
        # to cover.
        gains = got[0]
        rows = torch.cat([(sim[lo:lo + 4096] - cover[None, :]).clamp_min_(
            0.0).sum(1) for lo in range(0, n, 4096)])
        block_gap = float(((rows - gains).abs() / gains.abs()).max())
        plain_gap = float(((want[0] - gains).abs() / gains.abs()).max())
        plain_block_gap = float(((want[0] - rows).abs() / rows.abs()).max())
        ms = device_ms(torch, lambda: fl_k.fl_gain_argmax(sim, cover, mask))
        plain = device_ms(torch, lambda: ref.fl_gain_argmax_ref(
            sim, cover, mask), reps=10, warmup=2)
        b, by = bound(4 * n * n + 13 * n + 8, 3 * n * n)
        records["fl_gain_argmax"]["craig-resident"] = record(
            err, ms, plain, None, b, by, [n, n])
        emit("kernels", kernel="fl_gain_argmax", shape=[n, n], ms=ms,
             plain_ms=plain, bound_ms=b, block_vs_kernel_rel_gap=block_gap,
             plain_vs_kernel_rel_gap=plain_gap,
             plain_vs_block_rel_gap=plain_block_gap)
        check(block_gap < 1e-6, f"fl_gain_argmax: the block refresh's row "
              f"sums and the kernel's column sums differ by {block_gap} "
              "relative, more than the 1e-6 certification margin")
        del sim, got, want, rows, gains
        torch.cuda.empty_cache()
    n = 4097
    sim = torch.ones((n, n), device=dev)
    cover = torch.zeros((n,), device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask[0] = False
    _, gi, gv = fl_k.fl_gain_argmax(sim, cover, mask)
    check(int(gi) == 1 and float(gv) == float(n),
          f"fl_gain_argmax all-tied: ({int(gi)}, {float(gv)}), not (1, {n})")
    sim[:, [3001, 4000]] = 2.0
    _, gi, _ = fl_k.fl_gain_argmax(sim, cover, mask)
    check(int(gi) == 3001, f"fl_gain_argmax planted tie: {int(gi)}, not "
          "3001")
    del sim

    # -- fl_gain_argmax_otf: the two proxies the trainer feeds it, a tenth
    #    of the rows invalid; then ragged n and all masked.  Each call at the
    #    plan's route; at the two paths' shapes both routes, each against an
    #    f64 scan of the same inputs, timed. -----------------------------
    # (No n = 1 case: a lone column's gain is its own diagonal term
    # sqrt(2|g|^2 - 2 g.g), rounding noise of ~sqrt(eps)|g| that the
    # kernels' dots and cuBLAS round differently; the card tests hold it
    # at the reference's on-the-fly tolerance, 1e-3.)
    def gains64(g, sqn, cover, rok, lm, block=2048):
        """The on-the-fly gains of the same f32 inputs, in f64."""
        g64, s64 = g.double(), sqn.double()
        c64, ok = cover.double(), rok.double()
        out = torch.zeros((g.shape[0],), dtype=torch.float64, device=dev)
        for lo in range(0, g.shape[0], block):
            d2 = (s64[lo:lo + block, None] + s64[None, :]
                  - 2.0 * (g64[lo:lo + block] @ g64.T))
            sv = (float(lm) - d2.clamp_min_(0.0).sqrt_()) * ok[lo:lo + block,
                                                                None]
            out += (sv - c64[lo:lo + block, None]).clamp_min_(0.0).sum(0)
        return out

    tf32 = bf16_peak(card["name"]) / 2
    for n, d, path in ((ROWS, 65, "craig-lazy"), (ROWS, 10, "craig-lazy-otf"),
                       (129, 65, None), (4097, 10, None)):
        g = t(rng.standard_normal((n, d)).astype(np.float32))
        lm = greedy.default_l_max(g)
        sqn = (g * g).sum(1)
        cover = t(np.abs(rng.standard_normal(n)).astype(np.float32) * 8)
        rok = t(rng.random(n) > 0.1)
        mask = t(rng.random(n) < 0.7)
        plan = asdict(fl_k.fl_gain_otf_plan(n, d))
        for what, m in (("random", mask),
                        ("all-masked", torch.zeros_like(mask))):
            if what == "all-masked" and n != 4097:
                continue
            got = fl_k.fl_gain_argmax_otf(g, cover, rok, m, lm, sqnorms=sqn)
            want = ref.fl_gain_argmax_otf_ref(g, cover, rok, m, lm,
                                              sqnorms=sqn)
            err = check_scan(got, want, f"fl_gain_argmax_otf ({n}, {d}) "
                             f"{what}")
            emit("kernels", kernel="fl_gain_argmax_otf", shape=[n, d],
                 case=what, max_abs_err=err, route=plan["route"])
        if path is None:
            continue
        # Both routes: the plain version's tolerance, the f64 scan's error
        # over the largest gain (the tensor cores' limit 1e-6, a tenth of
        # the lazy greedy's certification margin), the same bits twice.
        want = ref.fl_gain_argmax_otf_ref(g, cover, rok, mask, lm,
                                          sqnorms=sqn)
        g64 = gains64(g, sqn, cover, rok, lm)
        scale = float(g64.abs().max())
        routes = {}
        for route in ("tc", "ffma"):
            got = fl_k.fl_gain_argmax_otf(g, cover, rok, mask, lm,
                                          sqnorms=sqn, route=route)
            again = fl_k.fl_gain_argmax_otf(g, cover, rok, mask, lm,
                                            sqnorms=sqn, route=route)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"fl_gain_argmax_otf ({n}, {d}) {route}: not the same "
                  "bits twice")
            err = check_scan(got, want, f"fl_gain_argmax_otf ({n}, {d}) "
                             f"{route}")
            routes[route] = dict(
                max_abs_err=err,
                f64_rel_err=float((got[0].double() - g64).abs().max())
                / scale,
                ms=device_ms(torch, lambda: fl_k.fl_gain_argmax_otf(
                    g, cover, rok, mask, lm, sqnorms=sqn, route=route),
                    reps=10, warmup=2))
        check(routes["tc"]["f64_rel_err"] <= 1e-6,
              f"fl_gain_argmax_otf ({n}, {d}): the tensor cores' gains are "
              f"{routes['tc']['f64_rel_err']} of the largest gain off an "
              "f64 scan, more than 1e-6")
        ops = device_ops(torch, lambda: fl_k.fl_gain_argmax_otf(
            g, cover, rok, mask, lm, sqnorms=sqn))
        plain = device_ms(torch, lambda: ref.fl_gain_argmax_otf_ref(
            g, cover, rok, mask, lm, sqnorms=sqn), reps=5, warmup=1)
        nbytes = 4 * n * d + 14 * n + 12
        # The FFMA kernel: the dot products (2 n^2 d) and 8 f32 operations of
        # the epilogue per similarity element, all at the f32 rate (the sqrt
        # is not counted).  The tensor cores: the dots as three TF32 passes
        # over d at the dense TF32 rate (the zero columns past d are the
        # kernel's layout, not work the function needs), or the epilogue's
        # 8 f32 operations an element, whichever takes longer (the two
        # overlap).
        b, by = bound(nbytes, 2 * n * n * d + 8 * n * n)
        ops_tc = 3 * 2 * n * n * d / tf32 * 1e3
        b_tc = max(ops_tc, 8 * n * n / flops * 1e3, nbytes / bw * 1e3)
        records["fl_gain_argmax_otf"][path] = dict(
            record(routes["ffma"]["max_abs_err"], routes["ffma"]["ms"],
                   plain, None, b, by, [n, d]),
            f64_rel_err=routes["ffma"]["f64_rel_err"])
        records["fl_gain_argmax_otf_tc"][path] = dict(
            record(routes["tc"]["max_abs_err"], routes["tc"]["ms"], plain,
                   None, b_tc, "operations", [n, d]),
            f64_rel_err=routes["tc"]["f64_rel_err"], f32_bound_ms=b,
            plan=plan, device_ops=ops)
        emit("kernels", kernel="fl_gain_argmax_otf", shape=[n, d],
             routes=routes, plan=plan, device_ops=ops, plain_ms=plain,
             bound_ms=b_tc, f32_bound_ms=b, bound_by="operations")
        del g64
        torch.cuda.empty_cache()

    # -- sqdist: the resident build of the main path's proxies (f32; a is b,
    #    the mirrored tensor cores), a ragged bf16 case and a small one.
    #    Each call at the plan's route against the plain version; then each
    #    route that takes the shape timed, and its error over an f64 sqdist
    #    of the same inputs (of |a_i|^2 + |b_j|^2, the terms the expanded
    #    form cancels). -------------------------------------------------
    def sq_f64_err(a, bb, got):
        """max |got - exact| / (|a_i|^2 + |b_j|^2) over an f64 sqdist of
        the same inputs, in row blocks."""
        a64, b64 = a.double(), bb.double()
        an64, bn64 = (a64 * a64).sum(1), (b64 * b64).sum(1)
        worst = 0.0
        for lo in range(0, a.shape[0], 4096):
            scale = an64[lo:lo + 4096, None] + bn64[None, :]
            exact = (scale - 2.0 * (a64[lo:lo + 4096] @ b64.T)).clamp_min_(
                0.0)
            worst = max(worst, float(((got[lo:lo + 4096].double() - exact)
                                      .abs_() / scale).max()))
            del scale, exact
        return worst

    for n, m, d, dt in ((ROWS, ROWS, 65, "float32"),
                        (4097, 1000, 130, "bfloat16"),
                        (129, 65, 3, "float32")):
        a = t(rng.standard_normal((n, d)).astype(np.float32)).to(
            getattr(torch, dt))
        bb = a if n == m else t(rng.standard_normal((m, d)).astype(
            np.float32)).to(getattr(torch, dt))
        plan = asdict(sq_k.sqdist_plan(n, m, d, a.element_size(), bb is a))
        got = sq_k.sqdist(a, bb)
        want = ref.sqdist_ref(a, bb)
        err, ok = close(got, want)
        check(ok, f"sqdist ({n}, {m}, {d}) {dt}: max abs err {err}")
        check(float(got.min()) >= 0.0, "sqdist gave a negative distance")
        if bb is a:
            # the resident build's symmetry, which the lazy greedy's block
            # refresh (row sums) and the scan (column sums) rely on
            check(torch.equal(got, got.T), f"sqdist(a, a) ({n}, {d}) is not "
                  "symmetric bit for bit")
        del got, want
        torch.cuda.empty_cache()
        routes = {}
        for route in ((plan["route"], "ffma") if plan["route"] != "ffma"
                      else ("ffma", "tc")):
            got = sq_k.sqdist(a, bb, route=route)
            check(torch.equal(got, sq_k.sqdist(a, bb, route=route)),
                  f"sqdist ({n}, {m}, {d}) {route}: not the same bits twice")
            routes[route] = dict(f64_rel_err=sq_f64_err(a, bb, got))
            del got
            torch.cuda.empty_cache()
            routes[route]["ms"] = device_ms(
                torch, lambda: sq_k.sqdist(a, bb, route=route), reps=10,
                warmup=2)
        ms = routes[plan["route"]]["ms"]
        plain = device_ms(torch, lambda: ref.sqdist_ref(a, bb), reps=5,
                          warmup=1)
        lib = (device_ms(torch, lambda: torch.cdist(a, bb).square(), reps=5,
                         warmup=1) if dt == "float32" else None)
        ops_ = device_ops(torch, lambda: sq_k.sqdist(a, bb))
        nbytes = a.element_size() * (n + (0 if bb is a else m)) * d + 4 * n * m
        b, by = bound(nbytes, 2 * n * m * d + 4 * n * m)
        # The tensor cores: three TF32 passes over d (one for bf16, exact in
        # TF32) at the dense TF32 rate, over the pairs this call needs (each
        # unordered pair once when a is b), or the bytes, whichever take
        # longer.
        pairs = n * (n + 1) // 2 if bb is a else n * m
        passes = 3 if dt == "float32" else 1
        ops_tc = passes * 2 * pairs * d / tf32 * 1e3
        b_tc = max(ops_tc, nbytes / bw * 1e3)
        by_tc = "bytes" if nbytes / bw * 1e3 >= ops_tc else "operations"
        emit("kernels", kernel="sqdist", shape=[n, m, d], dtype=dt,
             max_abs_err=err, plan=plan, routes=routes, ms=ms,
             plain_ms=plain, library_ms=lib, device_ops=ops_,
             bound_ms=b_tc, bound_by=by_tc, f32_bound_ms=b, f32_bound_by=by)
        if n == ROWS:
            records["sqdist"]["craig-resident"] = dict(
                record(err, ms, plain, lib, b_tc, by_tc, [n, m, d]),
                f32_bound_ms=b, plan_route=plan["route"], routes=routes,
                device_ops=ops_)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def arena_rows(torch, d: int, chunk: int) -> int:
    """Rows of the arena a 256 MiB ``ChunkCache`` builds over the main
    path's rows in chunks of ``chunk``: the engine's own layout (the
    reference's growth rule: twice the resident slots at each insertion,
    so 44 chunks of 1 024 end in 86 slots, 22 of 2 048 in 42)."""
    from repro_torch.core import streaming
    cache = streaming.ChunkCache(256 << 20, d)
    zeros = torch.zeros((ROWS, d), device="cuda")
    streaming.streaming_target(streaming.array_chunks(zeros, chunk),
                               cache=cache)
    return cache.cap_rows


def partition_arenas(torch) -> list:
    """The arena validity masks of the streaming partitions' caches
    (PART_P contiguous ranges of the main path's (45 000, 65) rows, chunks
    of STREAM_CHUNK, 256 MiB each), by the engine's own warming pass over
    zeros.  The first partition caches its 11 chunks; each other caches
    only the slice of a chunk it starts with, whose bucket fixes the slot
    size (the reference's layout rule), so the arenas differ."""
    from repro_torch.core import streaming
    zeros = torch.zeros((ROWS, 65), device="cuda")
    chunks = streaming.array_chunks(zeros, STREAM_CHUNK)
    bounds = [ROWS * p // PART_P for p in range(PART_P + 1)]
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        cache = streaming.ChunkCache(256 << 20, 65)
        streaming.streaming_target(
            streaming.subrange_chunks(chunks, lo, hi), cache=cache)
        out.append(cache.ok.clone())
    return out


def hold_bound_max(torch, np, card: dict, rng, n: int, d: int,
                   live, count_ops=True) -> dict:
    """``bound_max`` against its plain version on an (n, d) bf16 arena with
    the mask ``live()`` (rows and residual on a 1/8 grid; see
    ``phase_kernels_stream``), on each route against the other bit for
    bit, one device operation a call (``count_ops``) and the workspace
    zero after it, timed; returns the record."""
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def both_routes(*args, absolute=False):
        """The default call, checked equal to each route's bit for bit."""
        got = corr_k.bound_max(*args, absolute=absolute)
        for route in ("tiles", "rows"):
            other = corr_k.bound_max(*args, absolute=absolute, route=route)
            check(all(torch.equal(a, b) for a, b in zip(got, other)),
                  f"bound_max {tuple(args[0].shape)}: the {route} route "
                  f"gave {other}, the plan's {got}")
        return got

    rows = t(np.round(rng.standard_normal((n, d)) * 8) / 8).to(
        torch.bfloat16)
    r = t((np.round(rng.standard_normal(d) * 8) / 8).astype(np.float32))
    norms = t(np.sqrt((np.asarray(rows.float().cpu()) ** 2).sum(1))
              .astype(np.float32))
    errn = t((np.abs(rng.standard_normal(n)) / 700).astype(np.float32))
    acc = d * 2.0 ** -23 * 1.25
    mask = live()
    err = 0.0
    for absolute in (False, True):
        s_ = rows.float() @ r
        s_ = s_.abs() if absolute else s_
        u = s_ + (errn + acc * norms) * torch.sqrt((r * r).sum())
        um = u[mask]
        tol = 1e-6 * float(um.abs().max())
        srt = torch.sort(um).values
        gaps = srt[1:] - srt[:-1]
        wide = torch.nonzero(gaps > 4 * tol)[:, 0]
        mid_at = int(wide[len(wide) // 2])
        mid = float((srt[mid_at] + srt[mid_at + 1]) / 2)
        for thresh in (float("-inf"), float("inf"), mid):
            th = torch.full((), thresh, device=dev)
            gv, gi, gc = both_routes(rows, norms, errn, r, acc, th, mask,
                                     absolute=absolute)
            wv, wi, wc = ref.bound_max_ref(rows, norms, errn, r, acc, th,
                                           mask, absolute=absolute)
            gv, gi, gc = float(gv), int(gi), int(gc)
            wv, wi, wc = float(wv), int(wi), int(wc)
            what = f"bound_max ({n}, {d}) abs={absolute} thresh={thresh}"
            check(abs(gv - wv) <= tol, f"{what}: value {gv} vs {wv}")
            if gi != wi:
                check(bool(mask[gi]) and abs(float(u[gi]) - float(u[wi]))
                      <= tol, f"{what}: index {gi} vs {wi}")
            check(gc == wc, f"{what}: count {gc} vs {wc}")
            err = max(err, abs(gv - wv))
        check(0 < wc < int(mask.sum()), f"bound_max ({n}, {d}): the "
              f"middle threshold counts {wc} rows")
    none = torch.zeros_like(mask)
    got = both_routes(rows, norms, errn, r, acc, 0.0, none)
    check((float(got[0]), int(got[1]), int(got[2]))
          == (float("-inf"), 0, 0), f"bound_max all masked gave {got}")
    dup = rows.clone()
    dup[1::2] = dup[::2]
    dn, de = norms.clone(), errn.clone()
    dn[1::2], de[1::2] = dn[::2], de[::2]
    every = torch.ones_like(mask)
    gi = int(both_routes(dup, dn, de, r, acc, 0.0, every)[1])
    check(gi % 2 == 0, f"bound_max: a tie went to row {gi}")
    th = torch.full((), mid, device=dev)
    ws_key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)

    def call(route=None):
        return corr_k.bound_max(rows, norms, errn, r, acc, th, mask,
                                absolute=True, route=route)

    ops = None
    if count_ops:
        ops = device_ops(torch, call)
        check(ops == 1, f"bound_max ({n}, {d}): {ops} device operations "
              "a call")
    call()
    torch.cuda.synchronize()
    check(int(corr_k._bound_workspaces[ws_key].abs().sum()) == 0,
          f"bound_max ({n}, {d}): the workspace is not zero after a call")
    plan = asdict(corr_k.bound_max_plan(n, d, 2, rows.data_ptr(),
                                        mask.data_ptr(), sms))
    route_ms = {route: device_ms(torch, lambda: call(route))
                for route in ("tiles", "rows")}
    ms = device_ms(torch, call)
    plain = device_ms(torch, lambda: ref.bound_max_ref(
        rows, norms, errn, r, acc, th, mask, absolute=True))
    # What this mask needs: every row's mask byte; the bf16 row, norms
    # and errn of the masked-in rows only (the kernel returns on a
    # masked-out row before it reads them); the residual, the threshold
    # and the three outputs.  Operations: ||r|| once, then per masked-in
    # row the dot and ~6 for the sidecar term, the compare and the fold.
    m_in = int(mask.sum())
    nbytes = n + (2 * d + 8) * m_in + 4 * d + 4 + 12
    nops = 2 * d + (2 * d + 6) * m_in
    b, by = bound_of(card, nbytes, nops)
    emit("kernels", kernel="bound_max", shape=[n, d], dtype="bfloat16",
         masked_in=m_in, max_abs_err=err, tolerance=tol,
         ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
         route_ms=route_ms, plan=plan, device_ops=ops)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, shape=[n, d],
                route_ms=route_ms, plan=plan, device_ops=ops)


def phase_kernels_stream(torch, np, card: dict, records: dict) -> None:
    """``bound_max`` against its plain version on the card at the two
    arenas of the streaming paths and the four of the streaming
    partitions (``partition_arenas``), with masks shaped like theirs (empty
    slots and taken rows off), ``abs`` off and on, thresholds of -inf, +inf
    and the middle of a gap, an all-masked input and planted ties; on each
    route (the tile route and the row loop) against the other bit for
    bit; one device operation a call, and the stream's workspace zero
    after it; adds its records.

    Rows and residual lie on a 1/8 grid, so every dot product is exact in
    f32 and the kernel and the plain version differ only in the rounding
    of the sidecar term: the value is held to 1e-6 of max |u| (the stated
    tolerance), the index and the count exactly, the threshold being the
    middle of a gap wider than that tolerance."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pool_arena(d, chunk):
        """The streaming paths' arena over the main path's rows, and its
        mask: the arena holds 44 (or 22) chunks in 86 (or 42) slots, the
        rest is empty, and a tenth of the cached rows are taken or
        in-buffer."""
        n = arena_rows(torch, d, chunk)

        def live():
            used = (ROWS // chunk + 1) * chunk
            mask = torch.zeros((n,), dtype=torch.bool, device=dev)
            mask[:used] = t(rng.random(used) > 0.1)
            mask[ROWS:used] = False
            return mask

        return n, live

    def partition_arena(ok):
        """A streaming partition's arena: its cached rows, a tenth taken."""
        return ok.shape[0], lambda: ok & t(rng.random(ok.shape[0]) > 0.1)

    arenas = [(10, *pool_arena(10, STREAM_CHUNK), "gradmatch-stream"),
              (65, *pool_arena(65, 2 * STREAM_CHUNK), "stream-pooled")]
    arenas += [(65, *partition_arena(ok), "partitioned-stream")
               for ok in partition_arenas(torch)]
    by_path = {}
    for d, n, live, path in arenas:
        by_path.setdefault(path, []).append(hold_bound_max(
            torch, np, card, rng, n, d, live))
    # a path that scans several arenas (one a streaming partition) has a
    # record for each
    for path, recs in by_path.items():
        records["bound_max"][path] = recs[0] if len(recs) == 1 else recs
    torch.cuda.synchronize()


def batched_plan_of(torch, mat, b: int, argmax: bool) -> dict:
    """The launch plan the batched wrappers take for ``mat`` and B
    problems."""
    from repro_torch.kernels import corr as corr_k
    n, d = mat.shape[-2:]
    return asdict(corr_k.batched_plan(
        n, d, b, argmax=argmax, per_problem=mat.dim() == 3,
        vec=mat.data_ptr() % 16 == 0 and d % 4 == 0,
        sms=torch.cuda.get_device_properties(mat.device)
        .multi_processor_count))


def hold_corr_batched(torch, card: dict, g, v, count_ops=True) -> dict:
    """``corr_batched`` against B single ``corr`` launches (the same bits)
    and its plain version (rtol 1e-5, atol 1e-6 of the largest |g||v|), one
    device operation a call (``count_ops``), timed beside the plain
    version, ``torch.mm`` and the B single launches; returns the record."""
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ref
    (n, d), b = g.shape, v.shape[0]
    got, want = corr_k.corr_batched(g, v), ref.corr_batched_ref(g, v)
    single = torch.stack([corr_k.corr(g, v[j]) for j in range(b)], 1)
    check(torch.equal(got, single), f"corr_batched ({n}, {d}) B={b}: "
          "not the bits of B single corr launches")
    err = float((got - want).abs().max())
    scale = float(torch.sqrt((g ** 2).sum(1).max() * (v ** 2).sum(1).max()))
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6 * max(scale, 1.0)),
          f"corr_batched ({n}, {d}) B={b}: max err {err}")
    ms = device_ms(torch, lambda: corr_k.corr_batched(g, v))
    plain = device_ms(torch, lambda: ref.corr_batched_ref(g, v))
    lib = device_ms(torch, lambda: torch.mm(g, v.T))
    one = device_ms(torch, lambda: [corr_k.corr(g, v[j]) for j in range(b)])
    ops = None
    if count_ops:
        ops = device_ops(torch, lambda: corr_k.corr_batched(g, v))
        check(ops == 1, f"corr_batched ({n}, {d}) B={b}: {ops} device "
              "operations a call")
    plan = batched_plan_of(torch, g, b, False)
    bd, by = bound_of(card, 4 * (n * d + b * d + n * b), 2 * n * d * b)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bd,
               bound_by=by, library_ms=lib, shape=[n, d, b],
               single_launches_ms=one, plan=plan, device_ops=ops)
    emit("kernels", kernel="corr_batched", **rec)
    return rec


def check_argmax_batched(torch, mat, w, base, mask, absolute, what):
    """``corr_argmax_batched`` against B single ``corr_argmax`` launches on
    the warp route (the same bits) and its plain version (the index equal
    unless the two scores are within 1e-6 of each other, the value to rtol
    1e-5); returns (the values' max error, the indices)."""
    import math

    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ref
    gi, gv = corr_k.corr_argmax_batched(mat, w, base, mask,
                                        absolute=absolute)
    ri, rv = ref.corr_argmax_batched_ref(mat, w, base, mask,
                                         absolute=absolute)
    b = w.shape[0]
    single = [corr_k.corr_argmax(mat if mat.dim() == 2 else mat[j], w[j],
                                 base[:, j].contiguous(),
                                 mask[:, j].contiguous(), absolute=absolute,
                                 route="warps")
              for j in range(b)]
    check(torch.equal(gi, torch.stack([x[0] for x in single]))
          and torch.equal(gv, torch.stack([x[1] for x in single])),
          f"corr_argmax_batched {what}: not the bits of B single "
          "corr_argmax launches")
    err = 0.0
    for j in range(b):
        a, r_ = int(gi[j]), int(ri[j])
        if a != r_:
            m = mat if mat.dim() == 2 else mat[j]
            s_ = base[:, j] - m @ w[j]
            s_ = s_.abs() if absolute else s_
            x, y = float(s_[a]), float(s_[r_])
            check(bool(mask[a, j]) and abs(x - y) <= 1e-6 * abs(y),
                  f"corr_argmax_batched {what} problem {j}: index {a} "
                  f"vs {r_}, scores {x} {y}")
        x, y = float(gv[j]), float(rv[j])
        if math.isfinite(y):
            check(abs(x - y) <= 1e-5 * abs(y) + 1e-6,
                  f"corr_argmax_batched {what} problem {j}: value {x} "
                  f"vs {y}")
            err = max(err, abs(x - y))
        else:
            check(x == y and a == 0, f"corr_argmax_batched {what} "
                  f"problem {j}: all masked gave ({a}, {x})")
    return err, gi


def hold_corr_argmax_batched(torch, card: dict, mat, w, base, mask,
                             absolute, what, count_ops=True
                             ) -> tuple[dict, object]:
    """``check_argmax_batched``, one device operation a call
    (``count_ops``), timed beside the plain version and the B single
    launches; returns (the record, the indices)."""
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ref
    err, gi = check_argmax_batched(torch, mat, w, base, mask, absolute, what)
    b, (nn, p) = w.shape[0], mat.shape[-2:]
    ms = device_ms(torch, lambda: corr_k.corr_argmax_batched(
        mat, w, base, mask, absolute=absolute))
    plain = device_ms(torch, lambda: ref.corr_argmax_batched_ref(
        mat, w, base, mask, absolute=absolute))
    cols = [(base[:, j].contiguous(), mask[:, j].contiguous())
            for j in range(b)]
    one = device_ms(torch, lambda: [corr_k.corr_argmax(
        mat if mat.dim() == 2 else mat[j], w[j], *cols[j],
        absolute=absolute, route="warps") for j in range(b)])
    ops = None
    if count_ops:
        ops = device_ops(torch, lambda: corr_k.corr_argmax_batched(
            mat, w, base, mask, absolute=absolute))
        check(ops == 1, f"corr_argmax_batched {what}: {ops} device "
              "operations a call")
    plan = batched_plan_of(torch, mat, b, True)
    # What this case's masks need: the mask, base and a dot product for
    # live pairs only, the rows of mat that some live pair reads (a shared
    # pool's row once), the vectors, and (idx, val).
    live = int(mask.sum())
    rows_read = int(mask.any(1).sum()) if mat.dim() == 2 else live
    bd, by = bound_of(card, 4 * p * rows_read + 4 * b * p + nn * b
                      + 4 * live + 8 * b, 2 * p * live)
    emit("kernels", kernel="corr_argmax_batched", case=what,
         shape=list(mat.shape) + [b], absolute=absolute, max_abs_err=err,
         ms=ms, plain_ms=plain, single_launches_ms=one, bound_ms=bd,
         bound_by=by, plan=plan, device_ops=ops)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bd,
               bound_by=by, library_ms=None, shape=[nn, p, b],
               single_launches_ms=one, plan=plan, device_ops=ops)
    if mat.dim() == 3:
        rec["per_problem"] = True
    return rec, gi


def phase_kernels_batched(torch, np, card: dict, records: dict) -> None:
    """``corr_batched`` and ``corr_argmax_batched`` against their plain
    versions and against B launches of the single kernels on the card:
    the per-class path's (45 000, 65) pool with B = 10 and one-hot class
    masks, the batched phase's B = 32 with random masks, a per-problem
    (B, n, p) column cache of the wide regime (B = 4 at WIDE), ragged n
    with a d off the 16-byte loads and B = 1 and 3, B = 40 (two chunks),
    planted ties, an all-masked column, a live -inf below masked rows, and
    ``abs``; adds their records.  Each line carries the launch plan (route,
    tile, ring, grid, shared memory) and the device operations one call
    makes (``torch.profiler``; one, or the script fails).  First, the read
    rate of the (45 000, 65) pool in the L2 cache.

    Tolerances: against B single launches the same bits (the kernels sum
    in row_dot's order; the single launches on ``corr_argmax``'s warp
    route, never the row tiles it shares with the batched kernel); against
    the plain version scores to rtol 1e-5 (and an absolute 1e-6 of the
    largest |g||v| for ``corr_batched``), the index equal unless the two
    scores are within 1e-6 of each other."""
    dev = torch.device("cuda")
    bw, _ = peaks(card["name"])
    rng = np.random.default_rng(3)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # The pool the OMP rounds re-read stays in the 50 MB L2 between calls:
    # its read rate there, by one torch.sum over it, beside a sum of one
    # element (the launch floor in this timing).
    pool = t(np.random.default_rng(4).standard_normal((ROWS, 65)).astype(
        np.float32))
    floor = device_ms(torch, lambda: pool[:1, :1].sum())
    whole = device_ms(torch, lambda: pool.sum())
    nbytes = pool.numel() * 4
    emit("kernels", kernel="l2_read", shape=[ROWS, 65], bytes=nbytes,
         sum_ms=whole, floor_ms=floor, bytes_per_s=nbytes / whole * 1e3,
         bytes_per_s_past_floor=nbytes / (whole - floor) * 1e3,
         hbm_bytes_per_s=bw)
    del pool

    # -- corr_batched: c0 of per-class (B = 10) and of the batched phase
    #    (B = 32), the wide regime's new columns (B = 4), ragged, B > 32 --
    for n, d, b, paths in ((ROWS, 65, CLASSES, ("gradmatch",)),
                           (ROWS, 65, SERVE_B, ("batched",)),
                           # the serve phase's ten requests, padded
                           (ROWS, 65, SERVE_BUCKET, ("serve",)),
                           (*WIDE, 4, ()), (1001, 63, 1, ()),
                           (1001, 63, 3, ()), (4097, 12, 40, ()),
                           # the partition solves' c0
                           (ROWS, 10, CLASSES, ("gradmatch-partitioned",)),
                           (ROWS, 65, PART_P, ("partitioned-hash",
                                               "partitioned-contiguous"))):
        g = t(rng.standard_normal((n, d)).astype(np.float32))
        v = t(rng.standard_normal((b, d)).astype(np.float32))
        rec = hold_corr_batched(torch, card, g, v)
        for path in paths:
            records["corr_batched"][path] = dict(rec)

    # -- corr_argmax_batched ------------------------------------------------
    n = ROWS
    labels = rng.integers(0, CLASSES, n)
    g = t(rng.standard_normal((n, 65)).astype(np.float32))
    zeros = {b: torch.zeros((n, b), device=dev)
             for b in (CLASSES, SERVE_B, PART_P, SERVE_BUCKET)}
    # per-class masks: row i is a candidate of its class only, a tenth taken
    onehot = np.eye(CLASSES, dtype=bool)[labels] & (rng.random((n, 1)) > 0.1)
    cases = [  # (what, mat, w, base, mask, absolute, path)
        ("per-class, a tenth taken", g,
         t(-rng.standard_normal((CLASSES, 65)).astype(
            np.float32)), zeros[CLASSES], t(onehot), False, "gradmatch"),
        ("per-class abs", g, t(-rng.standard_normal((CLASSES, 65)).astype(
            np.float32)), zeros[CLASSES], t(onehot), True, None),
        ("batched", g, t(-rng.standard_normal((SERVE_B, 65)).astype(
            np.float32)), zeros[SERVE_B], t(rng.random((n, SERVE_B)) < 0.5),
         False, "batched"),
        # the serve phase's group: no request masks, a tenth taken
        ("serve, padded to 16", g, t(-rng.standard_normal(
            (SERVE_BUCKET, 65)).astype(np.float32)), zeros[SERVE_BUCKET],
         t(rng.random((n, SERVE_BUCKET)) > 0.1), False, "serve"),
    ]
    cc = t(rng.standard_normal((4, *WIDE)).astype(np.float32))
    cases.append(("wide per-problem", cc,
                  t(rng.standard_normal((4, WIDE[1])).astype(np.float32)
                    / 16),
                  t(rng.standard_normal((WIDE[0], 4)).astype(np.float32) * 3),
                  t(rng.random((WIDE[0], 4)) < 0.9), True, None))
    for b in (1, 3):
        cases.append((f"ragged B={b}",
                      t(rng.standard_normal((1001, 63)).astype(np.float32)),
                      t(rng.standard_normal((b, 63)).astype(np.float32)),
                      t(rng.standard_normal((1001, b)).astype(np.float32)),
                      t(rng.random((1001, b)) < 0.5), b == 3, None))
    cases.append(("two chunks B=40",
                  t(rng.standard_normal((4097, 12)).astype(np.float32)),
                  t(rng.standard_normal((40, 12)).astype(np.float32)),
                  t(rng.standard_normal((4097, 40)).astype(np.float32)),
                  t(rng.random((4097, 40)) < 0.5), False, None))
    dup = g.clone()
    dup[1::2] = dup[::2]
    tie_mask = torch.ones((n, CLASSES), dtype=torch.bool, device=dev)
    tie_mask[:, 3] = False                  # one all-masked column
    cases.append(("ties + all-masked", dup, cases[0][2], zeros[CLASSES],
                  tie_mask, True, None))
    # A live score of -inf below masked rows: the lowest row overall wins
    # (a masked one); problem 3 picks its finite live row over a live -inf.
    ninf_base = torch.zeros((n, 4), device=dev)
    ninf_mask = torch.zeros((n, 4), dtype=torch.bool, device=dev)
    ninf_mask[100:, 0] = True
    ninf_base[:, 0] = float("-inf")
    ninf_mask[40, 1] = True
    ninf_base[40, 1] = float("-inf")
    ninf_mask[::5, 2] = True
    ninf_mask[7, 3] = ninf_mask[9, 3] = True
    ninf_base[7, 3] = float("-inf")
    cases.append(("live -inf below masked rows", g,
                  t(rng.standard_normal((4, 65)).astype(np.float32)),
                  ninf_base, ninf_mask, False, None))
    # The partition solves, a tenth taken: the trainer's class partitions
    # on the bias proxies (45 000, 10), and P = 4 hashed (Knuth's hash of
    # the row id) and contiguous partitions on the per-gradient proxies.
    cases.append(("class partitions, bias proxies",
                  t(rng.standard_normal((n, 10)).astype(np.float32)),
                  t(-rng.standard_normal((CLASSES, 10)).astype(np.float32)),
                  zeros[CLASSES], t(onehot), False, "gradmatch-partitioned"))
    ids = np.arange(n, dtype=np.uint64)
    hashed = ((ids * np.uint64(2654435761)) % np.uint64(1 << 32)
              % np.uint64(PART_P)).astype(np.int64)
    for kind, assign in (("hash", hashed),
                         ("contiguous", np.arange(n) * PART_P // n)):
        cases.append((f"{kind} partitions", g,
                      t(-rng.standard_normal((PART_P, 65)).astype(
                          np.float32)), zeros[PART_P],
                      t(np.eye(PART_P, dtype=bool)[assign]
                        & (rng.random((n, 1)) > 0.1)), False,
                      f"partitioned-{kind}"))
    for what, mat, w, base, mask, absolute, path in cases:
        rec, gi = hold_corr_argmax_batched(torch, card, mat, w, base, mask,
                                           absolute, what)
        if what.startswith("ties"):
            live = [j for j in range(CLASSES) if j != 3]
            check(all(int(gi[j]) % 2 == 0 for j in live),
                  "corr_argmax_batched: a tie did not go to the lower row")
        if what.startswith("live -inf"):
            check(gi.tolist() == [0, 0, gi.tolist()[2], 9],
                  f"corr_argmax_batched: -inf rule picked {gi.tolist()}")
        if path:
            records["corr_argmax_batched"][path] = rec
    del cc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_trainer(torch, np) -> dict:
    """The main path's two paths through their entry points, the launch
    counts set to 0 before each and read after it."""
    from repro_torch.configs.paper import PaperHParams, mlp
    from repro_torch.data.synthetic import make_classification, split
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig

    ds = make_classification(n=POOL_ROWS, dim=64, num_classes=10, seed=0)
    train, val = split(ds, seed=1)
    check(train.n == ROWS, f"train split has {train.n} rows")
    cfg = mlp()
    tcfg = TrainerConfig(strategy="gradmatch", budget=BUDGET, epochs=2,
                         batch_size=BATCH, hp=PaperHParams(select_every=1),
                         eval_every=1)
    trainer = AdaptiveTrainer(cfg, tcfg, train, val)
    model = trainer.init_model()
    pb = AdaptiveTrainer(cfg, replace(tcfg, strategy="gradmatch-pb"),
                         train, val)

    counts, shapes, routes = {}, {}, {}
    ops.reset_launch_counts()
    rep = trainer.run(model)
    counts["gradmatch"] = ops.launch_counts()
    shapes["gradmatch"] = ops.launch_shapes()
    routes["gradmatch"] = ops.launch_routes()
    ops.reset_launch_counts()
    sel_pb, pb_seconds = pb._run_selection(model, None)
    counts["gradmatch-pb"] = ops.launch_counts()
    shapes["gradmatch-pb"] = ops.launch_shapes()
    routes["gradmatch-pb"] = ops.launch_routes()

    emit("trainer", strategy="gradmatch", rows=train.n, budget=BUDGET,
         epochs=2, select_every=1, selection_rounds=rep.selection_rounds,
         selection_seconds=rep.selection_seconds,
         wall_seconds=rep.wall_seconds, final_acc=rep.final_acc,
         subset_size=rep.subset_size, pb_selection_seconds=pb_seconds,
         pb_subset_size=int(sel_pb.mask.sum()), launches=counts,
         routes=routes)
    for path, names in TRAINER_NEEDS.items():
        for name in names:
            check(counts[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        # the proxies of all 45 000 rows: the tile route, every launch
        check(routes[path]["lastlayer_grad/tiles"]
              == counts[path]["lastlayer_grad"],
              f"{path}: lastlayer_grad left the tile route: {routes[path]}")
    check(rep.selection_rounds == 2, "expected two selection rounds")
    check(rep.subset_size == K,
          f"per-class selection kept {rep.subset_size} rows, not {K}")
    # 140 SGD steps reach ~0.6 on this mixture; chance is 0.1.
    check(np.isfinite(rep.final_acc) and rep.final_acc > 0.3,
          f"final accuracy {rep.final_acc} is not above 0.3")
    w = sel_pb.weights[sel_pb.mask]
    check(int(sel_pb.mask.sum()) == (K // BATCH) * BATCH,
          f"PB selection kept {int(sel_pb.mask.sum())} rows")
    check(bool(torch.isfinite(w).all()) and abs(float(w.sum()) - 1) < 1e-4,
          "PB selection weights are not finite or do not sum to 1")
    return {"counts": counts, "shapes": shapes, "routes": routes,
            "model": model, "train": train, "val": val, "config": tcfg,
            "report": rep,
            "selection_seconds": {"gradmatch": rep.selection_seconds,
                                  "gradmatch-pb": pb_seconds}}


def residual_of(torch, grads, target, sol):
    """target - G_S^T w of a solution (indices, weights, mask, ...)."""
    idx, w, mask = sol[0], sol[1], sol[2]
    sel = torch.where(mask, idx, 0).long()
    return target - (w * mask) @ grads[sel]


def agree(torch, grads, target, got, want, solve_got, solve_want,
          what: str) -> dict:
    """Two engines' solutions of one OMP problem, (indices, weights, mask,
    err).  Indices and masks must be equal and weights and err within rtol
    1e-4 / atol 1e-5, unless the picks part at a tie at the f32 noise
    floor: at the first round t where they part, both engines are re-run
    for t rounds (``solve_*(t)``), their residuals must agree to
    STATE_RTOL of |target|, and the two picks' score gap under ``want``'s
    residual (in f64) must lie within |g_a - g_b| |r_got - r_want| +
    2^-22 (|g_a| + |g_b|) |target|: the most that the residuals'
    difference, and the f32 rounding of a score built from target-sized
    terms (c0 - C @ w in the wide regime, a residual cancelled from the
    target in the narrow one), can move it.  The state agreed and the tie
    was inside its noise."""
    gi, gw, gm, ge = got
    wi, ww, wm, we = want
    differ = ((gi != wi) | (gm != wm)).nonzero()
    if not len(differ):
        werr = float((gw - ww).abs().max()) if gw.numel() else 0.0
        check(torch.allclose(gw, ww, rtol=1e-4, atol=1e-5),
              f"{what}: weights differ by {werr}")
        check(abs(float(ge) - float(we)) <= 1e-5 + 1e-4 * abs(float(we)),
              f"{what}: err {float(ge)} vs {float(we)}")
        return {"parted_at": None, "max_weight_diff": werr}
    t = int(differ[0, 0])
    r_got = residual_of(torch, grads, target, solve_got(t))
    r_want = residual_of(torch, grads, target, solve_want(t))
    a, b = int(wi[t]), int(gi[t])
    dr = float((r_got - r_want).norm())
    tn = float(target.norm())
    diff = grads[a] - grads[b]
    gap = float(diff.double() @ r_want.double())
    floor = 2.0 ** -22 * float(grads[a].norm() + grads[b].norm()) * tn
    room = float(diff.norm()) * dr + floor
    rec = {"parted_at": t, "picks": [a, b], "state_diff": dr / tn,
           "residual_share": float(r_want.norm()) / tn, "score_gap": gap,
           "gap_bound": room, "rounding_floor": floor}
    check(dr <= STATE_RTOL * tn, f"{what}: the states differ by {dr / tn} "
          f"of |target| at round {t}")
    check(abs(gap) <= room, f"{what}: picks part at round {t} ({a} vs "
          f"{b}) by {gap}, more than the state difference allows ({room})")
    return rec


def per_class_loop(torch, grads, labels, targets, quotas):
    """The per-class selection as the port ran it before the batched
    engine: one ``omp_select`` a class, each truncated to its quota and
    reweighted by one NNLS."""
    from repro_torch.core import omp

    k_cap = int(quotas.max())
    slot = torch.arange(k_cap, device=grads.device)
    out = []
    for c in range(len(quotas)):
        idx, _, mask, _ = omp.omp_select(grads, targets[c], k=k_cap,
                                         valid=labels == c)
        mask = mask & (slot < int(quotas[c]))
        idx = torch.where(mask, idx, -1)
        sel = torch.where(mask, idx, 0).long()
        g_s = grads[sel] * mask[:, None].to(grads.dtype)
        w = omp._nnls_active(g_s @ g_s.T, g_s @ targets[c], mask, 0.5, 50)
        out.append((idx, torch.where(mask, w, 0.0), mask))
    return tuple(torch.cat([o[i] for o in out]) for i in range(3))


def phase_solve(torch, np, model, train) -> None:
    """Per-class GRAD-MATCH and GRAD-MATCHPB, each with the kernels and with
    the plain versions, both on the card, on the same proxies; then the
    per-class selection on the batched engine against the former loop of ten
    single solves."""
    from repro_torch.core import omp
    from repro_torch.core.gradmatch import gradmatch_per_class, gradmatch_pb
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_proxy_fn

    pcg, bias = make_proxy_fn(model)(train.x, train.y)
    solves = {  # path: (candidates, solve)
        "gradmatch": (train.n, lambda: gradmatch_per_class(
            pcg, train.y, CLASSES, K)),
        "gradmatch-pb": (train.n // BATCH, lambda: gradmatch_pb(
            bias, BATCH, K // BATCH)),
    }
    for path, (candidates, solve) in solves.items():
        out = {}
        for mode in ("kernels", "ref"):
            ops.set_backend("ref" if mode == "ref" else None)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sel = solve()
                torch.cuda.synchronize()
                out[mode] = (sel, time.perf_counter() - t0)
            finally:
                ops.set_backend(None)
        (a, ta), (b, tb) = out["kernels"], out["ref"]
        ia = set(a.indices[a.mask].tolist())
        ib = set(b.indices[b.mask].tolist())
        overlap = len(ia & ib) / max(len(ib), 1)
        ea, eb = float(a.err), float(b.err)
        emit("solve", path=path, candidates=candidates, picked=len(ia),
             err_kernels=ea, err_plain=eb, index_overlap=overlap,
             seconds_kernels=ta, seconds_plain=tb)
        check(np.isfinite(ea) and abs(ea - eb) <= 1e-3 * abs(eb),
              f"{path} err with kernels {ea} vs plain {eb}")
        check(bool(torch.isfinite(a.weights).all()),
              f"{path} weights not finite")

    # The batched engine against the loop of ten single solves, kernels on,
    # at a budget of LOOP_K (the loop's ten solves are the slow side).
    y = train.y
    sizes = np.bincount(y.cpu().numpy(), minlength=CLASSES)
    quotas = omp.split_budget(LOOP_K, sizes)
    valids = y[None, :] == torch.arange(CLASSES, device=y.device)[:, None]
    targets = valids.to(pcg.dtype) @ pcg
    k_cap = int(quotas.max())
    times = {}
    for what, fn in (("batched", lambda: omp.omp_select_per_class(
            pcg, y, targets, CLASSES, 0, quotas=quotas)),
                     ("loop", lambda: per_class_loop(torch, pcg, y, targets,
                                                     quotas))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[what] = (res, time.perf_counter() - t0)
    (bi, bw, bm), (li, lw, lm) = times["batched"][0], times["loop"][0]

    def batched_rounds(t):
        return omp._omp_select_batched_incremental(
            pcg, targets, t, 0.5, 1e-10, 50, True, valids, 128,
            single_regime=True)

    classes = []
    for c in range(CLASSES):
        cut = slice(c * k_cap, (c + 1) * k_cap)
        err_b = omp.matching_error(pcg, targets[c], bi[cut], bw[cut],
                                   bm[cut], lam=0.5)
        err_l = omp.matching_error(pcg, targets[c], li[cut], lw[cut],
                                   lm[cut], lam=0.5)
        rec = agree(torch, pcg, targets[c], (bi[cut], bw[cut], bm[cut], err_b),
                    (li[cut], lw[cut], lm[cut], err_l),
                    lambda t: [x[c] for x in batched_rounds(t)],
                    lambda t: omp.omp_select(pcg, targets[c], k=t,
                                             valid=valids[c]),
                    f"per-class batched vs loop, class {c}")
        classes.append({"class": c, "quota": int(quotas[c]), **rec})
    emit("solve", path="gradmatch", what="batched engine vs loop", k=LOOP_K,
         seconds_batched=times["batched"][1], seconds_loop=times["loop"][1],
         classes=classes,
         parted=sum(r["parted_at"] is not None for r in classes))


def trace_rounds(torch, solve, nnls_name: str, problems: int) -> dict:
    """A profiler trace of ``solve()`` (TRACE_ROUNDS OMP rounds), with the
    NNLS function ``omp.<nnls_name>`` wrapped in a ``record_function`` for
    the trace only.  Returns the card's busy share (the union of device
    activity over the solve's span), the host time and the kernel launches
    inside the NNLS loop against the rest of the rounds, the device time
    of the port's own kernels, and the same solve's time untraced (the
    profiler's cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import omp

    solve()
    t0 = time.perf_counter()
    solve()
    untraced_s = time.perf_counter() - t0

    nnls = getattr(omp, nnls_name)

    def traced_nnls(*args, **kwargs):
        with record_function("nnls"):
            return nnls(*args, **kwargs)

    setattr(omp, nnls_name, traced_nnls)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("solve"):
                solve()
    finally:
        setattr(omp, nnls_name, nnls)

    events = prof.events()

    def host_ranges(name):
        return sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.name == name and e.device_type == DeviceType.CPU)

    (lo, hi), = host_ranges("solve")
    nnls_ranges = host_ranges("nnls")
    check(len(nnls_ranges) == TRACE_ROUNDS,
          f"trace holds {len(nnls_ranges)} NNLS calls, not {TRACE_ROUNDS}")
    # Device activity: kernels, memsets and copies.  The two marked ranges
    # are mirrored on the device's timeline as annotations; they are not
    # activity.
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CUDA
                    and e.name not in ("solve", "nnls"))
    busy, end, by_name = 0.0, lo, {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b

    def inside(t):
        return any(a <= t <= b for a, b in nnls_ranges)

    launch_names = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemsetAsync")
    launches = [e.time_range.start for e in events
                if e.name in launch_names and lo <= e.time_range.start <= hi]
    in_nnls = sum(inside(t) for t in launches)
    span = hi - lo
    nnls_host = sum(b - a for a, b in nnls_ranges)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(rounds=TRACE_ROUNDS, problems=problems, span_ms=span / 1e3,
                untraced_ms=untraced_s * 1e3,
                device_busy_share=busy / span if device else None,
                nnls_host_share=nnls_host / span,
                launches_per_round=len(launches) / TRACE_ROUNDS,
                nnls_launches_per_round=in_nnls / TRACE_ROUNDS,
                device_events=len(device),
                device_us=sum(by_name.values()),
                port_kernels_us=sum(us for name, us in by_name.items()
                                    if "repro_torch::" in name),
                top_device_us={name[:100]: us for name, us in top})


def phase_trace(torch, model, train) -> dict:
    """Profiler traces of TRACE_ROUNDS OMP rounds on the main path's
    (45 000, 65) proxies: a TRACE_ROUNDS-round solve of one class (wide
    regime: the trace of the earlier runs), then the first TRACE_ROUNDS
    rounds of the selection as the path runs them (450 rounds a class:
    prefix width 128, narrow regime) in one class's single solve (what the
    former loop ran ten times a round) and in the batched solve of all
    ten classes, the batched NNLS marked."""
    from repro_torch.core import omp
    from repro_torch.train.steps import make_proxy_fn

    pcg, _ = make_proxy_fn(model)(train.x, train.y)
    y = train.y
    n, d = pcg.shape
    valids = y[None, :] == torch.arange(CLASSES, device=y.device)[:, None]
    targets = valids.to(pcg.dtype) @ pcg
    width = 128                 # the first block of a 450-round solve

    def short_solve():
        omp.omp_select(pcg, targets[0], k=TRACE_ROUNDS, valid=valids[0])
        torch.cuda.synchronize()

    def single():
        c0 = omp.ops.corr(pcg, targets[0])
        st = omp._grow_prefix(omp._empty_inc_state(width, n, d, targets[0]),
                              width, keep_cols=width <= d)
        omp._run_session_block(pcg, targets[0], c0, valids[0], st, 0,
                               TRACE_ROUNDS, width <= d, 0.5, 1e-10, 50,
                               False)
        torch.cuda.synchronize()

    def batched():
        c0_t = omp.ops.corr_batched(pcg, targets)
        st = omp._grow_prefix_batched(
            omp._empty_batch_state(width, n, d, targets), width,
            keep_cols=width <= d)
        omp._run_batch_block(pcg, targets, c0_t, valids.T.contiguous(), st,
                             0, TRACE_ROUNDS, width <= d, 0.5, 1e-10, 50,
                             False)
        torch.cuda.synchronize()

    recs = {}
    for what, solve, nnls, problems in (
            ("single class, 32-round solve", short_solve,
             "_nnls_active_cached", 1),
            ("single class, main path", single, "_nnls_active_cached", 1),
            ("batched per-class, main path", batched,
             "_nnls_active_cached_batched", CLASSES)):
        recs[what] = trace_rounds(torch, solve, nnls, problems)
        emit("trace", what=what, **recs[what])
    return recs


def same_bits(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_sessions(torch, np, model, train) -> None:
    """Anytime sessions on the card, on the main path's (45 000, 65)
    proxies (class 0's target and candidates) and on a seeded f32
    SESSION_POOL pool (the pool's sum as target), whose widths 128 / 256 /
    384 cross from wide to narrow: ``start(k1); extend(k2); extend(k3)``
    equals ``start(k3)`` bit for bit, the Gram included; the trajectory's
    row t - 1 equals a fresh ``start(t)`` bit for bit at a few t; a
    session picks what ``omp_select(k3)`` picks (``agree``); the prefix
    result slices the session."""
    from repro_torch.core import omp
    from repro_torch.train.steps import make_proxy_fn

    pcg, _ = make_proxy_fn(model)(train.x, train.y)
    valid0 = train.y == 0
    gen = torch.Generator(device="cuda").manual_seed(16)
    seeded = torch.randn(SESSION_POOL, generator=gen, device="cuda")
    pools = {"proxies": (pcg, pcg[valid0].sum(0), valid0),
             "seeded": (seeded, seeded.sum(0), None)}
    for name, (g, target, valid) in pools.items():
        k1, k2, k3 = SESSION_KS[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = omp.omp_session_start(g, target, k1, valid=valid)
        sess = omp.omp_session_extend(g, sess, k2)
        sess = omp.omp_session_extend(g, sess, k3)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        direct = omp.omp_session_start(g, target, k3, valid=valid)
        check(same_bits(torch, omp.session_result(sess),
                        omp.session_result(direct)),
              f"sessions {name}: start({k1}); extend({k2}); extend({k3}) "
              f"differs from start({k3})")
        check(torch.equal(sess.st.gram, direct.st.gram)
              and torch.equal(sess.st.residual, direct.st.residual),
              f"sessions {name}: the chained Gram or residual differs")
        check(omp.omp_session_extend(g, sess, k3) is sess,
              f"sessions {name}: extend to the same k is not a no-op")
        try:
            omp.omp_session_extend(g, sess, k1)
            check(False, f"sessions {name}: shrinking did not raise")
        except ValueError as exc:
            check("shrink" in str(exc), f"sessions {name}: {exc}")
        pre = omp.session_prefix_result(sess, k2)
        check(torch.equal(pre[0], sess.indices[:k2])
              and torch.equal(pre[1], sess.weights[:k2])
              and torch.equal(pre[2], sess.mask[:k2]) and pre[3] is sess.err,
              f"sessions {name}: the prefix result does not slice")
        try:
            omp.session_prefix_result(sess, k3 + 1)
            check(False, f"sessions {name}: a prefix past k did not raise")
        except ValueError:
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = omp.omp_select(g, target, k=k3, valid=valid)
        torch.cuda.synchronize()
        oneshot_s = time.perf_counter() - t0
        vs_oneshot = agree(
            torch, g, target, omp.session_result(sess), one,
            lambda t: omp.session_result(omp.omp_session_start(
                g, target, t, valid=valid)),
            lambda t: omp.omp_select(g, target, k=t, valid=valid),
            f"sessions {name}: session vs omp_select({k3})")
        # trajectory: every row a fresh start, bit for bit
        kt = TRAJ_K[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tsess, traj = omp.omp_session_trajectory(g, target, kt, valid=valid)
        traj_s = time.perf_counter() - t0
        checked = []
        for t in sorted({1, 64, 128, 129, 256, 257, kt} & set(
                range(1, kt + 1))):
            fresh = omp.omp_session_start(g, target, t, valid=valid)
            ok = (np.array_equal(traj.indices[:t],
                                 fresh.indices.cpu().numpy())
                  and np.array_equal(traj.mask[:t], fresh.mask.cpu().numpy())
                  and np.array_equal(traj.weights_traj[t - 1, :t],
                                     fresh.weights.cpu().numpy())
                  and traj.err_trace[t - 1] == np.float32(fresh.err.item()))
            check(ok, f"sessions {name}: trajectory row {t - 1} is not a "
                  f"fresh start({t})")
            checked.append(t)
        check(np.array_equal(traj.indices, sess.indices[:kt].cpu().numpy()),
              f"sessions {name}: trajectory picks differ from the session's")
        emit("sessions", pool=name, shape=list(g.shape),
             ks=[k1, k2, k3], chain_seconds=chain_s,
             oneshot_seconds=oneshot_s, vs_oneshot=vs_oneshot,
             trajectory_k=kt, trajectory_seconds=traj_s,
             trajectory_rows_checked=checked,
             picked=int(sess.mask.sum()), err=float(sess.err))
    del seeded
    torch.cuda.empty_cache()


def phase_batched(torch, np, model, train) -> dict:
    """``omp_select_batched`` on the card: SERVE_B targets, each the sum
    of the main path's proxies over a seeded random subset of its own
    request mask (as ``tests/test_serve.py`` builds them), SERVE_K rounds
    on the (45 000, 65) pool; each row against the single solve of its
    target (``agree``).  The launch counts are read around the batched
    solve alone (path ``batched``)."""
    from repro_torch.core import omp
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_proxy_fn

    pcg, _ = make_proxy_fn(model)(train.x, train.y)
    n = pcg.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(32)
    valid = torch.rand((SERVE_B, n), generator=gen, device="cuda") < 0.5
    subset = torch.rand((SERVE_B, n), generator=gen, device="cuda") < 0.3
    targets = (valid & subset).to(pcg.dtype) @ pcg
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = omp.omp_select_batched(pcg, targets, k=SERVE_K, valid=valid)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    for name in BATCHED:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "batched path")
    t0 = time.perf_counter()
    singles = [omp.omp_select(pcg, targets[b], k=SERVE_K, valid=valid[b])
               for b in range(SERVE_B)]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    rows = []
    for b in range(SERVE_B):
        rec = agree(torch, pcg, targets[b], tuple(x[b] for x in got),
                    singles[b],
                    lambda t: [x[b] for x in omp.omp_select_batched(
                        pcg, targets, k=t, valid=valid)],
                    lambda t: omp.omp_select(pcg, targets[b], k=t,
                                             valid=valid[b]),
                    f"batched row {b}")
        if rec["parted_at"] is not None:
            rows.append({"row": b, **rec})
        sel = got[0][b][got[2][b]].long()
        check(bool(valid[b][sel].all()), f"batched row {b} picked a row "
              "outside its mask")
    emit("batched", B=SERVE_B, k=SERVE_K, shape=list(pcg.shape),
         seconds_batched=batched_s, seconds_single=single_s,
         launches=counts, parted_rows=rows)
    return {"counts": {"batched": counts}, "shapes": {"batched": shapes},
            "selection_seconds": {"batched": batched_s}}


def phase_craig(torch, np, train, val) -> dict:
    """CRAIG and GLISTER through their entry points at the main path's
    data and widths, each path's launch counts read on its own, then the
    kernels against the plain versions on whole selections."""
    from repro_torch.configs.paper import PaperHParams, mlp
    from repro_torch.core import craig as craig_lib
    from repro_torch.core import greedy
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_proxy_fn
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig

    cfg = mlp()
    tcfg = TrainerConfig(strategy="craig-lazy", budget=BUDGET, epochs=2,
                         batch_size=BATCH, hp=PaperHParams(select_every=1),
                         eval_every=1)
    # The greedy statistics are read by wrapping fl_greedy for this phase.
    stats = []
    fl_greedy = greedy.fl_greedy

    def recording(*args, **kwargs):
        res = fl_greedy(*args, **kwargs)
        stats.append(vars(res.stats))
        return res

    def measure(fn):
        """fn() with the launch counts, greedy stats and peak memory of
        that call alone, and its seconds (host clock, synced)."""
        stats.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, dict(seconds=time.perf_counter() - t0,
                            launches=ops.launch_counts(),
                            routes=ops.launch_routes(),
                            greedy_stats=list(stats),
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    def check_sel(sel, what, size=K):
        w = sel.weights[sel.mask]
        check(int(sel.mask.sum()) == size,
              f"{what} kept {int(sel.mask.sum())} rows, not {size}")
        check(len(set(sel.indices[sel.mask].tolist())) == size,
              f"{what} picked a row twice")
        check(bool(torch.isfinite(w).all()) and abs(float(w.sum()) - 1)
              < 1e-4, f"{what} weights are not finite or do not sum to 1")

    greedy.fl_greedy = recording
    paths, shapes = {}, {}
    try:
        # 1. craig-lazy trained end to end (per-gradient proxies: on the fly)
        trainer = AdaptiveTrainer(cfg, tcfg, train, val)
        model = trainer.init_model()
        sels = []
        run_selection = trainer._run_selection

        def capture(*args):
            sel, dt = run_selection(*args)
            sels.append(sel)
            return sel, dt

        trainer._run_selection = capture
        rep, paths["craig-lazy"] = measure(lambda: trainer.run(model))
        shapes["craig-lazy"] = ops.launch_shapes()
        paths["craig-lazy"].update(
            selection_seconds=rep.selection_seconds,
            selection_rounds=rep.selection_rounds,
            wall_seconds=rep.wall_seconds, final_acc=rep.final_acc,
            subset_size=rep.subset_size)
        check(rep.selection_rounds == 2, "expected two selection rounds")
        check(rep.subset_size == K,
              f"craig-lazy kept {rep.subset_size} rows, not {K}")
        for sel in sels:
            check_sel(sel, "craig-lazy")
        check(np.isfinite(rep.final_acc) and rep.final_acc > 0.2,
              f"craig-lazy final accuracy {rep.final_acc} is not above 0.2")

        # 2.-3. one selection of each other strategy through the trainer:
        # craig-stochastic draws from a generator on the card; craig-pb is
        # the dense oracle over the 703 mini-batch proxies
        for strategy in ("craig-lazy-otf", "craig-stochastic", "craig-pb",
                         "glister"):
            tr = AdaptiveTrainer(cfg, replace(tcfg, strategy=strategy),
                                 train, val)
            gen = torch.Generator(device="cuda").manual_seed(7)
            (sel, _), paths[strategy] = measure(
                lambda: tr._run_selection(model, gen))
            shapes[strategy] = ops.launch_shapes()
            paths[strategy]["selection_seconds"] = paths[strategy]["seconds"]
            check_sel(sel, strategy, (K // BATCH) * BATCH
                      if strategy == "craig-pb" else K)

        # 4. lazy CRAIG over a resident similarity built by sqdist
        pcg, _ = make_proxy_fn(model)(train.x, train.y)
        lm = greedy.default_l_max(pcg)
        resident, paths["craig-resident"] = measure(
            lambda: craig_lib.craig(pcg, K, method="lazy", on_the_fly=False,
                                    dist_fn=ops.sqdist, l_max=lm))
        shapes["craig-resident"] = ops.launch_shapes()
        paths["craig-resident"]["selection_seconds"] = (
            paths["craig-resident"]["seconds"])
        check_sel(resident, "craig-resident")
        for path in CRAIG_PATHS:
            emit("craig", path=path, **paths[path])
        needs = {"craig-lazy": ("fl_gain_argmax_otf_tc", "lastlayer_grad"),
                 "craig-lazy-otf": ("fl_gain_argmax_otf_tc",
                                    "lastlayer_grad"),
                 "craig-stochastic": ("lastlayer_grad",),
                 "craig-pb": ("lastlayer_grad",),
                 "glister": ("corr_argmax", "lastlayer_grad"),
                 "craig-resident": ("sqdist", "fl_gain_argmax")}
        for path, names in needs.items():
            for name in names:
                check(paths[path]["launches"][name] > 0,
                      f"kernel {name} was not launched on the {path} path")
        check(paths["craig-resident"]["launches"]["sqdist"] == 1,
              "the resident path built its similarity more than once")
        check(paths["craig-resident"]["routes"]["sqdist/tc-sym"] == 1,
              f"craig-resident: sqdist left the mirrored tensor cores: "
              f"{paths['craig-resident']['routes']}")
        # The plans' routes: the on-the-fly scans on the tensor cores (the
        # FFMA kernel never), GLISTER's argmax on the row tiles.
        for path in ("craig-lazy", "craig-lazy-otf"):
            check(paths[path]["launches"]["fl_gain_argmax_otf"] == 0,
                  f"the FFMA fl_gain_argmax_otf launched on the {path} path")
        check(paths["glister"]["routes"]["corr_argmax/rows"]
              == paths["glister"]["launches"]["corr_argmax"],
              f"glister: corr_argmax left the row tiles: "
              f"{paths['glister']['routes']}")

        # Kernels against plain versions on whole selections, on the card.
        sim = greedy.build_sim(pcg, l_max=lm, dist_fn=ops.sqdist)

        def both(what, fn):
            out = {}
            for mode in ("kernels", "ref"):
                ops.set_backend("ref" if mode == "ref" else None)
                try:
                    out[mode] = measure(fn)
                finally:
                    ops.set_backend(None)
            (a, ra), (b, rb) = out["kernels"], out["ref"]
            differ = (a.indices != b.indices).nonzero()
            first = int(differ[0, 0]) if len(differ) else None
            emit("craig_compare", what=what, picks=int(a.mask.sum()),
                 first_differing_round=first, err_kernels=float(a.err),
                 err_plain=float(b.err), kernels=ra, plain=rb)
            check(first is None, f"{what}: kernels and plain versions part "
                  f"at round {first}")
            check(abs(float(a.err) - float(b.err))
                  <= 1e-5 * abs(float(b.err)),
                  f"{what}: err {float(a.err)} vs {float(b.err)}")
            return a

        a = both("resident lazy", lambda: craig_lib.craig(
            pcg, K, sim=sim, method="lazy", l_max=lm))
        check(torch.equal(a.indices, resident.indices),
              "the resident path's picks differ from the same selection "
              "on a rebuilt similarity")
        both("on-the-fly lazy", lambda: craig_lib.craig(
            pcg, K, method="lazy", on_the_fly=True, l_max=lm))

        # 5. the dense oracle against the resident lazy greedy
        dense, rd = measure(lambda: greedy.fl_greedy(
            None, DENSE_K, sim=sim, method="dense", l_max=lm))
        lazy, rl = measure(lambda: greedy.fl_greedy(
            None, DENSE_K, sim=sim, method="lazy", l_max=lm))
        differ = (dense.indices != lazy.indices).nonzero()
        first = int(differ[0, 0]) if len(differ) else None
        emit("craig_compare", what=f"dense vs resident lazy, k={DENSE_K}",
             first_differing_round=first, dense=rd, lazy=rl)
        check(first is None, f"dense and lazy part at round {first}")
        del sim
        torch.cuda.empty_cache()
    finally:
        greedy.fl_greedy = fl_greedy
    return {"counts": {p: paths[p]["launches"] for p in CRAIG_PATHS},
            "shapes": shapes,
            "routes": {p: paths[p]["routes"] for p in CRAIG_PATHS},
            "selection_seconds": {p: paths[p]["selection_seconds"]
                                  for p in CRAIG_PATHS}}


def phase_stream(torch, np, train, val) -> dict:
    """Streaming GRAD-MATCH through its entry points at the main path's
    data and widths, each path's launch counts read on its own, then the
    kernels against the plain versions on whole selections, a partial
    cache, and the row fetch's bits."""
    import copy

    from repro_torch.configs.paper import PaperHParams, mlp
    from repro_torch.core import omp
    from repro_torch.core import proxies as proxy_lib
    from repro_torch.core import selection as sel_lib
    from repro_torch.core import streaming
    from repro_torch.data.loader import ChunkedPool
    from repro_torch.kernels import ops, ref
    from repro_torch.train.steps import make_proxy_fn
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig

    def stats_of(sel):
        st = sel.stats
        return dict(passes=st.passes, rounds=st.rounds,
                    certified_rounds=st.certified_rounds,
                    refills=st.refills, repairs=st.repairs,
                    fetched_rows=st.fetched_rows,
                    cache_hit_rate=st.cache_hit_rate,
                    host_syncs_per_round=st.host_syncs / max(st.rounds, 1))

    def check_sel(sel, what, size=K):
        w = sel.weights[sel.mask]
        check(int(sel.mask.sum()) == size,
              f"{what} kept {int(sel.mask.sum())} rows, not {size}")
        check(len(set(sel.indices[sel.mask].tolist())) == size,
              f"{what} picked a row twice")
        check(bool(torch.isfinite(w).all()) and abs(float(w.sum()) - 1)
              < 1e-4, f"{what} weights are not finite or do not sum to 1")

    def first_part(a, b):
        """The first round whose pick differs (None: the same picks)."""
        differ = (a != b).nonzero()
        return int(differ[0, 0]) if len(differ) else None

    # 1. gradmatch-stream trained end to end (bias proxies, chunk 1 024),
    # one selection (R = 2)
    tcfg = TrainerConfig(strategy="gradmatch-stream", budget=STREAM_BUDGET,
                         epochs=2, batch_size=BATCH,
                         hp=PaperHParams(select_every=2), eval_every=1)
    trainer = AdaptiveTrainer(mlp(), tcfg, train, val)
    model = trainer.init_model()
    model0 = copy.deepcopy(model)
    sels = []
    run_selection = trainer._run_selection

    def capture(*args):
        sel, dt = run_selection(*args)
        sels.append((sel, dt))
        return sel, dt

    trainer._run_selection = capture
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = trainer.run(model)
    counts = {"gradmatch-stream": ops.launch_counts()}
    shapes = {"gradmatch-stream": ops.launch_shapes()}
    routes = {"gradmatch-stream": ops.launch_routes()}
    # The selection against in-memory pooled OMP on the rows and the
    # target the streaming pass saw (chunked extraction, summed chunk by
    # chunk; a full-matrix sum may differ in its last bits), cut to its
    # first STREAM_CHECK_K rounds: OMP's picks are a prefix (a solve of k'
    # rounds, k' a multiple of the 128-round block, makes the first k'
    # picks of a longer one).
    proxy0 = make_proxy_fn(model0)
    chunks = proxy_lib.proxy_chunk_stream(
        ChunkedPool(train.x, train.y, STREAM_CHUNK).chunks, proxy0)
    target, _ = streaming.streaming_target(chunks)
    rows = torch.cat([c for c, _ in chunks()])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, _, mask, err_mem = omp.omp_select(rows, target, STREAM_CHECK_K)
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    first = sels[0][0]
    part = first_part(first.indices[:STREAM_CHECK_K], idx)
    emit("stream", path="gradmatch-stream", rows=train.n,
         budget=STREAM_BUDGET,
         epochs=2, select_every=2, selection_rounds=rep.selection_rounds,
         selection_seconds=[dt for _, dt in sels],
         in_memory_k=STREAM_CHECK_K, in_memory_pooled_seconds=mem_s,
         wall_seconds=rep.wall_seconds,
         final_acc=rep.final_acc, subset_size=rep.subset_size,
         select_stats=[stats_of(sel) for sel, _ in sels],
         launches=counts["gradmatch-stream"],
         routes=routes["gradmatch-stream"],
         first_differing_round_vs_in_memory=part,
         err_stream=float(first.err), err_in_memory=float(err_mem),
         first_selection_per_class=torch.bincount(
             train.y[first.indices[first.mask].long()], minlength=10
         ).tolist())
    check(rep.selection_rounds == 1, "expected one selection round")
    check(rep.subset_size == STREAM_K, f"gradmatch-stream kept "
          f"{rep.subset_size}")
    for sel, _ in sels:
        check_sel(sel, "gradmatch-stream", STREAM_K)
    # Pooled selection over the bias proxies does not balance the classes
    # as the per-class solve does: 0.219 after 2 epochs in the first run
    # (chance is 0.1), against 0.514 per class.
    check(np.isfinite(rep.final_acc) and rep.final_acc > 0.15,
          f"gradmatch-stream final accuracy {rep.final_acc} is not above "
          "0.15")
    for name in ("corr", "bound_max", "lastlayer_grad"):
        check(counts["gradmatch-stream"][name] > 0,
              f"kernel {name} was not launched on the gradmatch-stream path")
    # the arena scans: the route the plan gives the arena, every launch
    route = bound_route(torch, shapes["gradmatch-stream"])
    check(routes["gradmatch-stream"][f"bound_max/{route}"]
          == counts["gradmatch-stream"]["bound_max"],
          f"bound_max left the {route} route: {routes['gradmatch-stream']}")
    check(part is None and torch.equal(first.mask[:STREAM_CHECK_K], mask),
          f"streaming and in-memory pooled OMP part at round {part}")

    # 2. one pooled per-gradient selection with the kernels, with the plain
    # versions, and with the plain versions scoring every row at the pool's
    # shape, each beside in-memory pooled GRAD-MATCH in the same arithmetic,
    # cut to STREAM_CHECK_K rounds
    pcg, _ = make_proxy_fn(model)(train.x, train.y)
    corr_ref = ref.corr_ref

    def pool_shaped_corr(grads, residual):
        """The plain scores of f32 rows (n, d), n <= the pool's rows, from
        one product at the pool's shape.  The in-memory solver scores every
        row in one (45 000, 65) product, and cuBLAS picks its order of
        summation by the product's shape: a buffer of 768 rows, a chunk or a
        single row scored on its own can differ from the pool's scores in
        the last bit, and near-tied picks then part."""
        n, d = grads.shape
        if (grads.dtype != torch.float32 or d != pcg.shape[1]
                or n >= pcg.shape[0]):
            return corr_ref(grads, residual)
        full = torch.zeros_like(pcg)
        full[:n] = grads
        return corr_ref(full, residual)[:n]

    def timed(mode, fn, scorer=corr_ref):
        ops.set_backend(mode)
        ref.corr_ref = scorer
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return (out, time.perf_counter() - t0, ops.launch_counts(),
                    ops.launch_shapes(), ops.launch_routes())
        finally:
            ops.set_backend(None)
            ref.corr_ref = corr_ref

    def stream():
        return sel_lib.select("gradmatch-stream", None, pcg, STREAM_CHECK_K)

    def in_memory():
        return sel_lib.select("gradmatch", None, pcg, STREAM_CHECK_K,
                              per_class=False)

    runs = {"kernels": timed(None, stream),
            "plain": timed("ref", stream),
            "plain-pool-shape": timed("ref", stream, pool_shaped_corr)}
    mems = {"kernels": timed(None, in_memory),
            "plain": timed("ref", in_memory)}
    for what, run in runs.items():
        check_sel(run[0], f"stream-pooled {what}", STREAM_CHECK_K)
    counts["stream-pooled"] = runs["kernels"][2]
    shapes["stream-pooled"] = runs["kernels"][3]
    routes["stream-pooled"] = runs["kernels"][4]
    vs_mem = {what: first_part(runs[what][0].indices,
                               mems[mode][0].indices)
              for what, mode in (("kernels", "kernels"), ("plain", "plain"),
                                 ("plain-pool-shape", "plain"))}
    kernels_vs_plain = {
        "stream": first_part(runs["kernels"][0].indices,
                             runs["plain"][0].indices),
        "in_memory": first_part(mems["kernels"][0].indices,
                                mems["plain"][0].indices)}
    err = {what: float(run[0].err) for what, run in runs.items()}
    err_mem = {what: float(run[0].err) for what, run in mems.items()}
    emit("stream", path="stream-pooled", shape=list(pcg.shape),
         k=STREAM_CHECK_K,
         seconds={what: run[1] for what, run in runs.items()},
         in_memory_seconds={what: run[1] for what, run in mems.items()},
         select_stats={what: stats_of(run[0]) for what, run in runs.items()},
         launches={what: run[2] for what, run in runs.items()},
         routes=routes["stream-pooled"],
         first_differing_round_vs_in_memory=vs_mem,
         stats_kernels_equal_plain=(vars(runs["kernels"][0].stats)
                                    == vars(runs["plain"][0].stats)),
         first_differing_round_kernels_vs_plain=kernels_vs_plain,
         err=err, err_in_memory=err_mem)
    for name in ("corr", "bound_max"):
        check(counts["stream-pooled"][name] > 0,
              f"kernel {name} was not launched on the stream-pooled path")
    route = bound_route(torch, shapes["stream-pooled"])
    check(routes["stream-pooled"][f"bound_max/{route}"]
          == counts["stream-pooled"]["bound_max"],
          f"bound_max left the {route} route: {routes['stream-pooled']}")
    # With the kernels every row scores in one fixed order whatever the
    # call's shape, so streaming and in-memory OMP make the same picks.
    # The plain versions score through cuBLAS, whose order of summation
    # follows the product's shape: the plain streaming run parts from the
    # plain in-memory one at a near tie.  Scored at the pool's shape, as the
    # in-memory solver scores, it must make the same picks: that run holds
    # the plain path; the plain run is reported beside it and held to a
    # valid selection whose err is within 1% of the in-memory one.
    for what, mode in (("kernels", "kernels"),
                       ("plain-pool-shape", "plain")):
        check(vs_mem[what] is None and torch.equal(
            runs[what][0].mask, mems[mode][0].mask), f"stream-pooled {what} "
            f"and in-memory pooled GRAD-MATCH part at round {vs_mem[what]}")
        check(abs(err[what] - err_mem[mode]) <= 1e-4 * abs(err_mem[mode]),
              f"stream-pooled {what} err {err[what]} vs in-memory "
              f"{err_mem[mode]}")
    check(np.isfinite(err["plain"]) and abs(err["plain"] - err_mem["plain"])
          <= 1e-2 * abs(err_mem["plain"]), f"stream-pooled plain err "
          f"{err['plain']} vs in-memory {err_mem['plain']}")

    # 3. a partial cache: the trainer's first selection again (the initial
    # model's bias proxies, chunk 1 024, the row fetch) with a cache of
    # PARTIAL_SLOTS slots for its 44 chunks, so every loader pass evicts
    # through the LRU and rounds certify from the cached chunks' bound and
    # the sketch of the uncached ones.  Cut to PARTIAL_K rounds: OMP's picks
    # are a prefix (a solve of k' rounds, k' a multiple of the 128-round
    # block, makes the first k' picks of a longer one).
    fetch0 = proxy_lib.proxy_row_fetch(train.x, train.y, proxy0, STREAM_CHUNK)
    cbytes = PARTIAL_SLOTS * STREAM_CHUNK * streaming.ChunkCache(
        0, target.shape[0]).bytes_per_row
    partial, part_s, part_counts, _, _ = timed(
        None, lambda: streaming.gradmatch_streaming(
            chunks, PARTIAL_K, lam=tcfg.hp.lam, eps=tcfg.hp.eps,
            buffer_size=tcfg.stream_buffer, cache_bytes=cbytes,
            row_fetch=fetch0))
    check_sel(partial, "partial-cache", PARTIAL_K)
    part_at = first_part(partial.indices, first.indices[:PARTIAL_K])
    pst = partial.stats
    emit("stream", path="partial-cache", k=PARTIAL_K, cache_bytes=cbytes,
         slots=PARTIAL_SLOTS, seconds=part_s, select_stats=stats_of(partial),
         cache_hits=pst.cache_hits, cache_misses=pst.cache_misses,
         launches=part_counts, first_differing_round_vs_trainer=part_at)
    check(part_at is None, "the partial-cache selection and the trainer's "
          f"first selection part at round {part_at}")
    check(pst.passes > 1 and pst.certified_rounds > 0 and pst.cache_hits > 0
          and pst.cache_misses > 0, "the partial cache certified no round "
          "from a partly covered arena")
    # Each round consults the bound for the cached chunks, certified or not.
    check(part_counts["bound_max"] >= pst.rounds,
          "the partial cache did not run the bound every round")

    # 4. row fetch: ~300 ids across the chunks, the tail chunk included,
    # bit-equal to the chunked extraction's rows
    proxy_fn = make_proxy_fn(model)
    rng = np.random.default_rng(3)
    ids = np.concatenate([rng.choice(train.n, 290, replace=False),
                          np.arange(train.n - 10, train.n)])
    fetch_bits = {}
    for pick, which in (("bias", 1), ("per_class", 0)):
        scanned = torch.cat([c for c, _ in proxy_lib.proxy_chunk_stream(
            ChunkedPool(train.x, train.y, STREAM_CHUNK).chunks, proxy_fn,
            pick)()])
        fetched = proxy_lib.proxy_row_fetch(
            train.x, train.y, proxy_fn, STREAM_CHUNK, pick)(ids)
        sel = torch.as_tensor(ids, device=scanned.device)
        want = scanned[sel]
        # the reference's fetch: the gathered rows' proxies, for the record
        gathered = proxy_fn(train.x[sel], train.y[sel])[which]
        fetch_bits[pick] = dict(
            equal=bool(torch.equal(fetched, want)),
            gather_max_abs_diff=float((gathered - want).abs().max()))
        check(fetch_bits[pick]["equal"], f"fetched {pick} proxy rows differ "
              "from the scanned ones")
    emit("stream", path="row-fetch", ids=len(ids), chunk=STREAM_CHUNK,
         **fetch_bits)
    return {"counts": counts, "shapes": shapes, "routes": routes,
            "selection_seconds": {"gradmatch-stream": rep.selection_seconds,
                                  "stream-pooled": runs["kernels"][1]},
            # the partial-cache selection, for the resilience phase
            "partial": {"chunks": chunks, "chunk": STREAM_CHUNK,
                        "fetch": fetch0, "target": target,
                        "cache_bytes": cbytes, "result": partial,
                        "seconds": part_s, "lam": tcfg.hp.lam,
                        "eps": tcfg.hp.eps,
                        "buffer_size": tcfg.stream_buffer}}


class Recorder:
    """Record the calls of ``module.name`` while active: (args, kwargs,
    result) each."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def recording(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        setattr(self.module, self.name, recording)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def picks_of(sel) -> set:
    return set(sel.indices[sel.mask].tolist())


def phase_partition(torch, np, train, val) -> dict:
    """Partitioned selection (``core/partition.py``) and the one-card paths
    of ``core/distributed.py`` through their entry points, each path's
    launch counts read on its own."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs.paper import PaperHParams, mlp
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core import greedy, omp, partition, streaming
    from repro_torch.core import selection as sel_lib
    from repro_torch.core.gradmatch import gradmatch, gradmatch_per_class
    from repro_torch.core.proxies import per_batch
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_proxy_fn
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig

    t_phase = time.perf_counter()
    counts, shapes, routes, seconds = {}, {}, {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def measure(path, fn):
        """fn() with its launch counts read on their own, and its seconds
        (host clock, synced)."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out, seconds[path] = timed(fn)
        counts[path] = ops.launch_counts()
        shapes[path] = ops.launch_shapes()
        routes[path] = ops.launch_routes()
        return out

    def check_sel(sel, what, size):
        w = sel.weights[sel.mask]
        check(int(sel.mask.sum()) == size,
              f"{what} kept {int(sel.mask.sum())} rows, not {size}")
        check(len(picks_of(sel)) == size, f"{what} picked a row twice")
        check(bool(torch.isfinite(w).all()) and abs(float(w.sum()) - 1)
              < 1e-4, f"{what} weights are not finite or do not sum to 1")
        st = sel.stats
        check(st.merged == int(sel.mask.sum()) and st.union_size >= st.merged,
              f"{what}: merged {st.merged}, union {st.union_size}, kept "
              f"{int(sel.mask.sum())}")

    def needs(path, names):
        for name in names:
            check(counts[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")

    def same_sel(a, b, what, rtol=1e-5):
        check(torch.equal(a.indices, b.indices) and torch.equal(a.mask,
                                                                b.mask),
              f"{what}: the picks differ")
        check(torch.allclose(a.weights, b.weights, rtol=rtol, atol=1e-7),
              f"{what}: weights differ by "
              f"{float((a.weights - b.weights).abs().max())}")

    # 1. gradmatch-partitioned trained end to end, one selection at budget
    # PART_BUDGET (the merge's host-bound rounds cost ~8 ms each: 4 500 of
    # them at the trainer phase's 0.1 took ~36 s a selection), over
    # PART_EPOCHS epochs (R = PART_EPOCHS: the trainer phase's 140 SGD
    # steps): bias proxies (45 000, 10), one partition a class; the
    # selection's proxies, union and partition solve recorded
    tcfg = TrainerConfig(strategy="gradmatch-partitioned", budget=PART_BUDGET,
                         epochs=PART_EPOCHS, batch_size=BATCH,
                         hp=PaperHParams(select_every=PART_EPOCHS),
                         eval_every=1)
    trainer = AdaptiveTrainer(mlp(), tcfg, train, val)
    model = trainer.init_model()
    with Recorder(sel_lib, "select") as sels, \
            Recorder(partition, "_certified_merge") as merges, \
            Recorder(omp, "omp_select_batched") as solves:
        rep = measure("gradmatch-partitioned", lambda: trainer.run(model))
    seconds["gradmatch-partitioned"] = rep.selection_seconds
    path = "gradmatch-partitioned"
    needs(path, ("corr_batched", "corr_argmax_batched", "corr",
                 "corr_argmax", "lastlayer_grad"))
    check(rep.selection_rounds == 1 and len(sels) == 1,
          "expected one selection round")
    check(rep.subset_size == PART_TRAIN_K,
          f"{path} kept {rep.subset_size} rows")
    check(np.isfinite(rep.final_acc) and rep.final_acc > 0.2,
          f"{path} final accuracy {rep.final_acc} is not above 0.2")
    per_sel = []
    for (args, kw, sel), merge in zip(sels, merges):
        proxies, labels = args[2], kw["labels"]
        check_sel(sel, path, PART_TRAIN_K)
        check(sel.stats.kind == "class" and sel.stats.num_parts == CLASSES,
              f"{path}: {sel.stats.kind} partitions")
        union = set(merge[0][1].tolist())
        pc, pc_s = timed(lambda: gradmatch_per_class(proxies, labels,
                                                     CLASSES, args[3]))
        check(union == picks_of(pc), f"{path}: the union of the partition "
              "picks is not gradmatch_per_class's set")
        check(picks_of(sel) <= union, f"{path}: merged picks off the union")
        per_sel.append(dict(union_size=sel.stats.union_size,
                            merged=sel.stats.merged, err=float(sel.err),
                            per_class_seconds=pc_s))

    # the last selection again with the plain versions: the same picks, or
    # a parting agree() certifies, in the partition solve or the merge
    (args, kw, sel) = sels[-1]
    ops.set_backend("ref")
    try:
        with Recorder(partition, "_certified_merge") as ref_merges, \
                Recorder(omp, "omp_select_batched") as ref_solves:
            plain, plain_s = timed(lambda: sel_lib.select(*args, **kw))
    finally:
        ops.set_backend(None)
    proxies = args[2]
    parted = None
    if not (torch.equal(sel.indices, plain.indices)
            and torch.equal(sel.mask, plain.mask)):
        (s_args, s_kw, got), (_, _, want) = solves[-1], ref_solves[-1]
        pool, targets = s_args[0], s_args[1]
        differ = ((got[0] != want[0]) | (got[2] != want[2])).any(1)
        if bool(differ.any()):
            # a class's partition solve parts: agree() on that problem
            c = int(differ.nonzero()[0, 0])

            def solve_class(t, mode):
                ops.set_backend(mode)
                try:
                    out = omp.omp_select_batched(pool, targets, t, **s_kw)
                finally:
                    ops.set_backend(None)
                return tuple(x[c] for x in out)

            parted = dict(at="partition solve", problem=c, **agree(
                torch, pool, targets[c], tuple(x[c] for x in got),
                tuple(x[c] for x in want), lambda t: solve_class(t, None),
                lambda t: solve_class(t, "ref"), f"{path} class {c}"))
        else:
            # the same union: agree() on the merge problem
            (m_args, m_kw, m_got), (_, _, m_want) = merges[-1], \
                ref_merges[-1]
            rows, gids, target = m_args[0], m_args[1], m_args[2]

            def merge_of(t, mode):
                ops.set_backend(mode)
                try:
                    return partition._certified_merge(rows, gids, target, t,
                                                      *m_args[4:])[:4]
                finally:
                    ops.set_backend(None)

            parted = dict(at="merge", **agree(
                torch, proxies, target, m_got[:4], m_want[:4],
                lambda t: merge_of(t, None), lambda t: merge_of(t, "ref"),
                f"{path} merge"))
    else:
        check(abs(float(sel.err) - float(plain.err))
              <= 1e-5 * abs(float(plain.err)),
              f"{path}: err {float(sel.err)} with the kernels, "
              f"{float(plain.err)} with the plain versions")
    emit("partition", path=path, rows=train.n, budget=PART_BUDGET,
         epochs=PART_EPOCHS, select_every=PART_EPOCHS,
         selection_rounds=rep.selection_rounds,
         selection_seconds=rep.selection_seconds,
         wall_seconds=rep.wall_seconds, final_acc=rep.final_acc,
         subset_size=rep.subset_size, selections=per_sel,
         plain_selection_seconds=plain_s, err_kernels=float(sel.err),
         err_plain=float(plain.err), kernels_vs_plain_parted=parted,
         launches=counts[path], routes=routes[path])

    # 2. P = 4 hashed and contiguous partitions of the per-gradient proxies
    # (45 000, 65) at k PART_K; each against the device-grouped path, and
    # P = 1 against the single solver.  The paths run other arithmetic
    # (one batched solve of P problems against P solves of one; a batched
    # solve against omp_select), so each partition's problem is held by
    # agree(): the same picks, or a parting at the f32 noise floor.  With
    # no parting, the unions and so the merges are the same.
    pcg, bias = make_proxy_fn(model)(train.x, train.y)
    n = pcg.shape[0]

    def rows_of(t, solve, p):
        return tuple(x[p] for x in solve(t))

    def by_partition(what, targets, got, want, solve_got, solve_want):
        """agree() on each partition's problem (global ids); the partings
        it certified."""
        out = []
        for p in range(targets.shape[0]):
            rec = agree(torch, pcg, targets[p], tuple(x[p] for x in got),
                        tuple(x[p] for x in want),
                        lambda t, p=p: rows_of(t, solve_got, p),
                        lambda t, p=p: rows_of(t, solve_want, p),
                        f"{what}, partition {p}")
            if rec["parted_at"] is not None:
                out.append({"partition": p, **rec})
        return out

    def batched_of(call):
        """The default path's partition solve, and its solve at t rounds."""
        args, kw, out = call
        return out, lambda t: omp.omp_select_batched(*args[:2], t, **kw)

    def global_ids(plan, idx):
        """Partition-local ids (-1 unused) to global ids."""
        gid = [np.flatnonzero(plan.assign == p) if plan.assign is not None
               else np.arange(plan.bounds[p], plan.bounds[p + 1])
               for p in range(plan.num_parts)]
        loc = idx.cpu().numpy()
        return torch.as_tensor(np.stack([
            np.where(loc[p] >= 0, g[np.maximum(loc[p], 0)], -1)
            for p, g in enumerate(gid)]).astype(np.int32), device=idx.device)

    mem, parted = {}, {}
    for kind in ("hash", "contiguous"):
        path = f"partitioned-{kind}"
        with Recorder(omp, "omp_select_batched") as solves, \
                Recorder(partition, "_certified_merge") as merges:
            res = measure(path, lambda: partition.gradmatch_partitioned(
                pcg, PART_K, partitions=PART_P, kind=kind))
        needs(path, ("corr_batched", "corr_argmax_batched", "corr",
                     "corr_argmax"))
        check_sel(res, path, PART_K)
        check(res.stats.quotas == (PART_K // PART_P,) * PART_P,
              f"{path}: quotas {res.stats.quotas}")
        want, solve_want = batched_of(solves[0])
        targets = solves[0][0][1]
        plan = partition.make_plan(n, PART_P, kind=kind)
        with Recorder(dist_lib, "pmap_partition_omp") as groups:
            grouped, grouped_s = timed(
                lambda: partition.gradmatch_partitioned(
                    pcg, PART_K, partitions=PART_P, kind=kind,
                    use_pmap=True))
        g_args, g_kw, g_out = groups[0]

        def solve_grouped(t):
            out = dist_lib.pmap_partition_omp(*g_args[:3], t, **g_kw)
            return (global_ids(plan, out[0]), *out[1:])

        parted[kind] = by_partition(
            f"{path}: use_pmap=True vs the default", targets,
            (global_ids(plan, g_out[0]), *g_out[1:]), want, solve_grouped,
            solve_want)
        if not parted[kind]:
            same_sel(grouped, res, f"{path}: use_pmap=True vs the default")
        mem[kind] = (res, want, solve_want, targets, merges[0])
        emit("partition", path=path, shape=list(pcg.shape), k=PART_K,
             partitions=PART_P, selection_seconds=seconds[path],
             use_pmap_seconds=grouped_s, union_size=res.stats.union_size,
             merged=res.stats.merged, err=float(res.err),
             use_pmap_parted=parted[kind], launches=counts[path],
             routes=routes[path])
    # (P = 1 at a partition's budget: its merge is PART_K more rounds)
    k1 = PART_K // PART_P
    single, single_s = timed(lambda: gradmatch(pcg, k1))
    with Recorder(omp, "omp_select_batched") as solves:
        one, one_s = timed(lambda: partition.gradmatch_partitioned(
            pcg, k1, partitions=1))
    want, solve_one = batched_of(solves[0])
    s_target = pcg.sum(dim=0)
    one_parted = agree(
        torch, pcg, s_target, tuple(x[0] for x in want),
        omp.omp_select(pcg, s_target, k1),
        lambda t: rows_of(t, solve_one, 0),
        lambda t: omp.omp_select(pcg, s_target, t),
        "P = 1 vs the single solver")
    if one_parted["parted_at"] is None:
        check(picks_of(one) == picks_of(single),
              "P = 1 does not give the single solver's set")
    emit("partition", what="P = 1 vs the single solver", k=k1,
         single_seconds=single_s, partitioned_seconds=one_s,
         err_single=float(single.err), err_partitioned=float(one.err),
         parted=one_parted)

    # 3. the streaming partitions: contiguous ranges through the streaming
    # engine, chunks of STREAM_CHUNK, against the in-memory contiguous
    # path: each partition's problem by agree() (the stream sums its
    # targets chunk by chunk), then the merged selections
    path = "partitioned-stream"
    with Recorder(streaming, "omp_select_streaming") as engines, \
            Recorder(partition, "_certified_merge") as merges:
        st = measure(path, lambda: partition.gradmatch_partitioned_stream(
            pool=pcg, k=PART_K, partitions=PART_P,
            chunk_size=STREAM_CHUNK))
    needs(path, ("corr", "bound_max", "corr_argmax"))
    check_sel(st, path, PART_K)
    ss = st.stats.stream
    check(ss.rounds == sum(st.stats.quotas) == PART_K,
          f"{path}: {ss.rounds} engine rounds")
    res, want, solve_want, targets, mem_merge = mem["contiguous"]
    lows = [n * p // PART_P for p in range(PART_P)]

    def stream_solves(t):
        outs = [streaming.omp_select_streaming(*a[:2], t, **kw)
                for a, kw, _ in engines]
        return (torch.stack([torch.where(o.mask, o.indices + lo, -1)
                             for o, lo in zip(outs, lows)]),
                *(torch.stack([getattr(o, f) for o in outs])
                  for f in ("weights", "mask", "err")))

    got = (torch.stack([torch.where(o.mask, o.indices + lo, -1)
                        for (_, _, o), lo in zip(engines, lows)]),
           *(torch.stack([getattr(o, f) for _, _, o in engines])
             for f in ("weights", "mask", "err")))
    parted["stream"] = by_partition(f"{path} vs in-memory contiguous",
                                    targets, got, want, stream_solves,
                                    solve_want)
    if not parted["stream"]:
        # the same union, merged against a global target summed another
        # way: agree() on the merge problem
        def merge_at(args):
            return lambda t: partition._certified_merge(
                *args[:3], t, *args[4:])[:4]

        (s_args, _, s_out), (m_args, _, m_out) = merges[0], mem_merge
        rec = agree(torch, pcg, m_args[2], s_out[:4], m_out[:4],
                    merge_at(s_args), merge_at(m_args),
                    f"{path}: the merge vs in-memory contiguous's")
        if rec["parted_at"] is not None:
            parted["stream"].append({"merge": True, **rec})
        else:
            same_sel(st, res, f"{path} vs in-memory contiguous")
    emit("partition", path=path, shape=list(pcg.shape), k=PART_K,
         partitions=PART_P, chunk=STREAM_CHUNK,
         selection_seconds=seconds[path], passes=ss.passes,
         rounds=ss.rounds, certified_rounds=ss.certified_rounds,
         refills=ss.refills, repairs=ss.repairs,
         fetched_rows=ss.fetched_rows, cache_hit_rate=ss.cache_hit_rate,
         host_syncs=ss.host_syncs, parted_from_in_memory=parted["stream"],
         bound_max_arenas=sorted({key[1:3] for key in shapes[path]
                                  if key[0] == "bound_max"}),
         launches=counts[path], routes=routes[path])

    # 4. GRAD-MATCHPB over ranks: no group (a world of one), then a
    # one-rank NCCL group, both against omp_select on the (703, 10) proxies
    path = "sharded-pb"
    kb = K // BATCH
    ex = bias[:PB_ROWS * BATCH]
    pb = per_batch(bias, BATCH)
    tgt = pb.sum(dim=0)
    want = omp.omp_select(pb, tgt, kb)

    def sharded(group):
        return (dist_lib.sharded_gradmatch_pb(ex, BATCH, kb, group=group),
                dist_lib.sharded_omp_select(pb, tgt, kb, group=group))

    def both_groups():
        alone = sharded(None)
        # one rank: NCCL's bootstrap needs no interface but the loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
        try:
            ranks = sharded(dist.group.WORLD)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        return alone, ranks

    alone, ranks = measure(path, both_groups)
    needs(path, ("corr",))
    ww = want[1] * want[2]
    for what, res in (("gradmatch_pb, no group", alone[0]),
                      ("omp_select, no group", alone[1]),
                      ("gradmatch_pb, NCCL", ranks[0]),
                      ("omp_select, NCCL", ranks[1])):
        check(torch.equal(res.indices, want[0])
              and torch.equal(res.mask, want[2]),
              f"{path} {what}: picks differ from omp_select's")
        check(torch.allclose(res.weights * ww.sum(), ww, rtol=1e-3,
                             atol=1e-5), f"{path} {what}: weights differ")
    emit("partition", path=path, shape=list(pb.shape), k=kb,
         selection_seconds=seconds[path], err_omp=float(want[3]),
         err_sharded=[float(r.err) for r in (*alone, *ranks)],
         launches=counts[path])

    # 5. CRAIG's greedy with the gain scan sharded over the local devices
    # (one card) against lazy CRAIG on the fly, on the bias proxies
    path = "fl-pmap"
    lm = greedy.default_l_max(bias)
    pm = measure(path, lambda: dist_lib.fl_greedy_pmap(bias, FL_PMAP_K,
                                                       l_max=lm))
    lazy, lazy_s = timed(lambda: greedy.fl_greedy(
        bias, FL_PMAP_K, method="lazy", on_the_fly=True, l_max=lm))
    check(torch.equal(pm.indices, lazy.indices)
          and torch.equal(pm.mask, lazy.mask),
          f"{path}: the picks differ from lazy CRAIG's")
    emit("partition", path=path, shape=list(bias.shape), k=FL_PMAP_K,
         selection_seconds=seconds[path], lazy_seconds=lazy_s,
         max_gain_diff=float((pm.gains - lazy.gains).abs().max()),
         launches=counts[path])
    emit("partition", what="phase", seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return {"counts": counts, "shapes": shapes, "routes": routes,
            "selection_seconds": seconds}


def disk_bytes(path) -> int:
    """Bytes of the files under ``path``."""
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


class Timed:
    """Time each call of ``module.name`` while active: its seconds and
    ``size(result, args)`` each, in call order."""

    def __init__(self, module, name: str, size):
        self.module, self.name, self.size, self.calls = module, name, size, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            self.calls.append({"seconds": time.perf_counter() - t0,
                               **self.size(out, args)})
            return out

        setattr(self.module, self.name, timed)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_serve(torch, np, tr: dict, records: dict) -> dict:
    """Selection serving and the artifact fast path on the card, at the
    trainer's per-gradient proxies (45 000, 65), each path's launch counts
    read on its own, the store in a temporary directory removed at the end.
    Any failed check raises."""
    import shutil
    import tempfile

    from repro_torch.artifacts import ArtifactStore, artifact_key_for
    from repro_torch.core import craig as craig_lib
    from repro_torch.core import glister as glister_lib
    from repro_torch.core import omp, random_sel, streaming
    from repro_torch.core import partition as part_lib
    from repro_torch.core.gradmatch import _normalize
    from repro_torch.data.loader import ChunkedPool
    from repro_torch.kernels import ops
    from repro_torch.launch import build_artifacts, serve_selection
    from repro_torch.resilience import DISK_FAULT_KINDS, inject_disk_fault
    from repro_torch.serve import SelectionService
    from repro_torch.serve import scheduler as sched_lib
    from repro_torch.train.steps import make_proxy_fn

    t_phase = time.perf_counter()
    counts, shapes, routes, seconds = {}, {}, {}, {}
    absolute = {}           # corr_argmax's abs flags at each caught shape

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def catching(fn, caught):
        """``fn`` (an ``ops`` entry whose kernel's shapes
        ``ops.launch_shapes()`` does not keep: ``corr_argmax`` and the FL
        scans) that also counts each launch it makes by (kernel, rows, d,
        dtype) of its first argument."""
        def call(*args, **kwargs):
            before = ops.launch_counts()
            out = fn(*args, **kwargs)
            m = args[0]
            for kname, c in ops.launch_counts().items():
                if c > before[kname]:
                    key = (kname, *m.shape[-2:],
                           str(m.dtype).removeprefix("torch."))
                    caught[key] = caught.get(key, 0) + c - before[kname]
                    absolute.setdefault(key, set()).add(
                        bool(kwargs.get("absolute", False)))
            return out
        return call

    def measure(path, fn):
        """Run one path with the counts set to 0 before it: its launches,
        their shapes and routes, and its seconds."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        caught = {}
        originals = {name: getattr(ops, name) for name in (
            "corr_argmax", "fl_gain_argmax", "fl_gain_argmax_otf")}
        for name, orig in originals.items():
            setattr(ops, name, catching(orig, caught))
        try:
            out, seconds[path] = timed(fn)
        finally:
            for name, orig in originals.items():
                setattr(ops, name, orig)
        counts[path] = ops.launch_counts()
        shapes[path] = {**ops.launch_shapes(), **caught}
        routes[path] = ops.launch_routes()
        return out

    def needs(path, names):
        for name in names:
            check(counts[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")

    def launches(path, names):
        return {n: counts[path][n] for n in names}

    def certify(what, grads, target, got, want, solve_got, solve_want):
        """The launchers' hook: a parting must be a tie agree() certifies."""
        return agree(torch, grads, target, got, want, solve_got, solve_want,
                     what)

    def bits(a, b, what):
        for x, y, name in zip(a, b, ("indices", "weights", "mask", "err")):
            check(torch.equal(x, y), f"{what}: {name} differ")

    def normalized(sol):
        return (sol[0], _normalize(sol[1], sol[2]), sol[2], sol[3])

    def serve_one(svc, pid, k, **kw):
        t = svc.submit(pid, k, **kw)
        if t.status == "queued":
            svc.drain()
        check(t.status == "done", f"serve: request {kw} k {k} failed: "
              f"{t.error}")
        return t

    pcg, _ = make_proxy_fn(tr["model"])(tr["train"].x, tr["train"].y)
    n, d = pcg.shape
    y = tr["train"].y
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        # 1. artifacts: build_artifacts over the resident pool at its
        # default k_max, its self-check (a slice bit-equal to the session,
        # equal to omp_select's picks or a tie agree() certifies)
        store = ArtifactStore(os.path.join(root, "store"))
        reports = measure("serve-build", lambda: build_artifacts.build_pools(
            store, [pcg], SERVE_K_MAX))
        needs("serve-build", ("corr", "corr_argmax"))
        ok, selfcheck = build_artifacts._selfcheck(
            store, [pcg], reports, 0.5, 1e-10, True, on_parting=certify)
        check(ok and all(r["session_bits"] for r in selfcheck),
              f"build_artifacts self-check failed: {selfcheck}")
        ident = reports[0]["ident"]

        # the service on that store: submits at those k are served from
        # the artifact, bit-equal to the live session.  The self-check held
        # each slice bit-equal to a fresh live session; the hit is held
        # bit-equal to the normalized slice, so to that session's answer.
        svc = SelectionService(artifact_store=store)
        pid = svc.register_pool(pcg)
        entry = svc.registry.get(pid)
        target = entry.target_sum
        art = store.get(artifact_key_for(pcg, target, 0.5, 1e-10, True))
        loads = store.loads
        hits = []
        for k in SERVE_KS:
            hit, hit_s = timed(lambda: svc.submit(pid, k))
            check(hit.status == "done" and hit.degradation == "artifact",
                  f"serve: k {k} was not served from the artifact "
                  f"({hit.degradation})")
            sl = [torch.from_numpy(np.array(a)).to(pcg.device)
                  for a in art.slice(k)]
            bits(hit.result[:4], normalized(sl),
                 f"artifact hit at k {k} against the live session")
            hits.append({"k": k, "hit_ms": hit_s * 1e3,
                         "err": float(hit.result.err)})
        # the live path at k_max: a submit and drain on a service with no
        # store (the same objective), and the hit's speed against it
        live = SelectionService()
        live_pid = live.register_pool(pcg)
        lt, live_s = timed(lambda: serve_one(live, live_pid, SERVE_K_MAX))
        check(lt.degradation == "certified", f"serve: live rung "
              f"{lt.degradation}")
        live_ms = live_s * 1e3
        live_err = float(lt.result.err)
        # the hit at k_max against the live answer (one batched solve of
        # B 1): the same picks with weights and err to rtol 1e-4 / atol
        # 1e-5, or a parting that agree() certifies as a tie
        ones = torch.ones((1, n), dtype=torch.bool, device=pcg.device)
        live_rec = agree(
            torch, pcg, target, tuple(hit.result[:4]), tuple(lt.result[:4]),
            lambda k: omp.session_result(omp.omp_session_start(pcg, target,
                                                               k)),
            lambda k: [x[0] for x in omp.omp_select_batched(
                pcg, target[None], k, valid=ones)],
            f"serve: the artifact hit at k {SERVE_K_MAX} against the live "
            "answer")
        same_picks = live_rec["parted_at"] is None
        hit_ms = []
        for _ in range(5):
            t, s = timed(lambda: svc.submit(pid, SERVE_K_MAX))
            check(t.degradation == "artifact", "serve: a repeat missed")
            hit_ms.append(s * 1e3)
        ratio = live_ms / statistics.median(hit_ms)
        check(ratio >= SERVE_HIT_RATIO, f"serve: an artifact hit is only "
              f"{ratio:.1f}x faster than a live submit-plus-drain")
        check(svc.registry.art_hits == len(SERVE_KS) + 5
              and store.loads == loads + 1,
              "serve: artifact hits not memoized")

        # each disk fault on a copy of the store: the submit falls through
        # to the live path and gives its bits; the manifest quarantined
        # where the reference quarantines it
        lt = serve_one(live, live_pid, SERVE_REQ_K)
        faults = {}
        for kind in DISK_FAULT_KINDS:
            where = os.path.join(root, kind)
            shutil.copytree(store.root, where)
            copy = ArtifactStore(where)
            info = inject_disk_fault(copy, ident, kind, seed=0)
            fsvc = SelectionService(artifact_store=copy)
            t = serve_one(fsvc, fsvc.register_pool(pcg), SERVE_REQ_K)
            check(t.degradation == "certified", f"serve: {kind} served "
                  f"rung {t.degradation}")
            bits(t.result[:4], lt.result[:4], f"serve under {kind}")
            quarantined = os.path.exists(
                os.path.join(copy.quarantine_dir, f"{ident}.json"))
            check(quarantined == (kind != "kill-between-rename")
                  and not os.path.exists(copy.manifest_path(ident))
                  and fsvc.registry.art_quarantined == int(quarantined)
                  and fsvc.registry.art_hits == 0,
                  f"serve: {kind} quarantine {quarantined}, stats "
                  f"{fsvc.registry.stats()}")
            faults[kind] = {**info, "quarantined": quarantined,
                            "rung": t.degradation}
            del fsvc
        emit("serve", part="artifacts", pool=[n, d], k_max=SERVE_K_MAX,
             build_seconds=reports[0]["build_s"], selfcheck=selfcheck,
             hits=hits, hit_ms=hit_ms, live_ms=live_ms, hit_ratio=ratio,
             err_live=live_err, same_picks_as_live=same_picks,
             against_live=live_rec,
             faults=faults, launches=launches("serve-build",
                                              ("corr", "corr_argmax")))
        del svc

        # 2. micro-batching: ten gradmatch requests with the ten class
        # targets from two tenants make one batched solve (B 10 padded to
        # 16); then the same group on the plain versions
        valids = y[None, :] == torch.arange(CLASSES, device=y.device)[:, None]
        targets = valids.to(pcg.dtype) @ pcg

        def group():
            with Recorder(sched_lib, "omp_select_batched") as calls:
                tickets = [live.submit(live_pid, SERVE_REQ_K,
                                       target=targets[c],
                                       tenant=f"tenant-{c % 2}")
                           for c in range(CLASSES)]
                live.drain()
            return tickets, calls

        batches_before = live.scheduler.batches_run
        tickets, calls = measure("serve-batched", group)
        needs("serve-batched", BATCHED)
        check(len(calls) == 1 and tuple(calls[0][0][1].shape)
              == (SERVE_BUCKET, d) and live.scheduler.batches_run
              == batches_before + 1, "serve: the ten requests did not make "
              f"one batched solve of {SERVE_BUCKET}")
        ops.set_backend("ref")
        try:
            plain_tickets, plain_calls = group()
        finally:
            ops.set_backend(None)

        def solved(calls):
            """The group's padded targets, its raw solution, and each
            request's row in it (the fair head leads the group)."""
            padded = calls[0][0][1]
            return padded, calls[0][2], [
                next(r for r in range(CLASSES)
                     if torch.equal(padded[r], targets[c]))
                for c in range(CLASSES)]

        def batched_at(padded, t, mode=None):
            ops.set_backend(mode)
            try:
                return omp.omp_select_batched(pcg, padded, t)
            finally:
                ops.set_backend(None)

        padded, raw, at = solved(calls)
        plain_padded, plain_raw, plain_at = solved(plain_calls)
        rows, plain_rows = [], []
        for c, tk in enumerate(tickets):
            check(tk.status == "done" and tk.batched_with == CLASSES,
                  f"serve: request {c} {tk.status} in a group of "
                  f"{tk.batched_with}")
            r, pr = at[c], plain_at[c]
            mine = tuple(x[r] for x in raw)
            bits(tk.result[:4], normalized(mine), f"serve: request {c}")
            rec = agree(torch, pcg, targets[c], mine,
                        omp.omp_select(pcg, targets[c], SERVE_REQ_K),
                        lambda t, r=r: [x[r] for x in batched_at(padded, t)],
                        lambda t, c=c: omp.omp_select(pcg, targets[c], t),
                        f"serve: request {c} against its omp_select")
            if rec["parted_at"] is not None:
                rows.append({"request": c, **rec})
            rec = agree(torch, pcg, targets[c],
                        tuple(x[pr] for x in plain_raw), mine,
                        lambda t, pr=pr: [x[pr] for x in batched_at(
                            plain_padded, t, "ref")],
                        lambda t, r=r: [x[r] for x in batched_at(padded, t)],
                        f"serve: request {c}, plain versions")
            check(plain_tickets[c].status == "done", "serve: a plain "
                  "request failed")
            if rec["parted_at"] is not None:
                plain_rows.append({"request": c, **rec})

        # an anytime extension 128 -> 192 against a one-shot 192
        def extension():
            sid, _ = live.open_session(live_pid, SERVE_REQ_K)
            return live.extend_session(sid, SERVE_EXT_K), sid
        ext, sid = measure("serve-extension", extension)
        needs("serve-extension", ("corr", "corr_argmax"))
        raw_ext = omp.session_result(live.sessions.get(sid).state)
        bits(ext[:4], normalized(raw_ext), "serve: the extension")
        ext_rec = agree(
            torch, pcg, target, raw_ext,
            omp.omp_select(pcg, target, SERVE_EXT_K),
            lambda t: omp.session_result(omp.omp_session_start(pcg, target,
                                                               t)),
            lambda t: omp.omp_select(pcg, target, t),
            "serve: extension against a one-shot solve")
        emit("serve", part="batched", requests=CLASSES, k=SERVE_REQ_K,
             padded_to=SERVE_BUCKET, seconds=seconds["serve-batched"],
             parted=rows, plain_parted=plain_rows,
             kernels={name: records[name]["serve"] for name in BATCHED},
             extension={"from": SERVE_REQ_K, "to": SERVE_EXT_K,
                        "seconds": seconds["serve-extension"], **ext_rec},
             launches=launches("serve-batched", BATCHED))

        # 3. one request of each other strategy, each against a direct call
        # of the same engine
        singles = {}

        def gen():
            return torch.Generator(device="cuda").manual_seed(0)

        cases = [
            ("craig-lazy", live_pid, ("fl_gain_argmax_otf_tc",),
             lambda: craig_lib.craig(pcg, SERVE_REQ_K, method="lazy",
                                     generator=gen())),
            ("glister", live_pid, ("corr_argmax",),
             lambda: glister_lib.glister(pcg, target, SERVE_REQ_K)),
            ("random", live_pid, (),
             lambda: random_sel.random_select(gen(), n, SERVE_REQ_K)),
            ("gradmatch-partitioned", live_pid, BATCHED + ("corr",
                                                           "corr_argmax"),
             lambda: part_lib.gradmatch_partitioned(pcg, SERVE_REQ_K)),
        ]
        for strategy, p_id, names, direct in cases:
            t = measure(f"serve-{strategy}",
                        lambda: serve_one(live, p_id, SERVE_REQ_K,
                                          strategy=strategy))
            needs(f"serve-{strategy}", names)
            bits(t.result[:4], direct()[:4], f"serve: {strategy}")
            singles[strategy] = {"seconds": seconds[f"serve-{strategy}"],
                                 "launches": launches(f"serve-{strategy}",
                                                      names)}
        # gradmatch on the chunked pool: the streaming engine
        pool = ChunkedPool(pcg, chunk_size=STREAM_CHUNK)
        cpid = live.register_chunked_pool(pool, cache_bytes=256 << 20)
        t = measure("serve-chunked", lambda: serve_one(live, cpid,
                                                       SERVE_REQ_K))
        needs("serve-chunked", ("corr", "bound_max"))
        direct = streaming.gradmatch_streaming(
            streaming.chunked_pool_iter(pool), SERVE_REQ_K,
            cache_bytes=256 << 20, row_fetch=streaming.array_row_fetch(pcg),
            buffer_size=live.scheduler.stream_buffer)
        bits(t.result[:4], direct[:4], "serve: gradmatch on the chunked "
             "pool")
        singles["gradmatch-chunked"] = {
            "seconds": seconds["serve-chunked"],
            "launches": launches("serve-chunked", ("corr", "bound_max")),
            "passes": t.result.stats.passes}
        # craig-lazy on the launcher's 4 096 x 64 pool: a resident sim
        g_l = torch.from_numpy(np.random.default_rng(0).standard_normal(
            SERVE_LAUNCHER_POOL).astype(np.float32)).cuda()
        lpid = live.register_pool(g_l)
        t = measure("serve-craig-resident", lambda: serve_one(
            live, lpid, SERVE_REQ_K, strategy="craig-lazy"))
        needs("serve-craig-resident", ("fl_gain_argmax",))
        bits(t.result[:4], craig_lib.craig(g_l, SERVE_REQ_K, method="lazy",
                                           generator=gen())[:4],
             "serve: craig-lazy on the launcher's pool")
        singles["craig-resident"] = {
            "seconds": seconds["serve-craig-resident"],
            "launches": launches("serve-craig-resident",
                                 ("fl_gain_argmax",))}
        emit("serve", part="strategies", k=SERVE_REQ_K, paths=singles)
        del live

        # 4. the launcher at its defaults: --smoke, then --load
        smoke = measure("serve-launcher-smoke", lambda: serve_selection.main(
            ["--smoke"], on_parting=certify))
        check(smoke["ok"], f"serve_selection --smoke: {smoke['failures']}")
        load = measure("serve-launcher-load", lambda: serve_selection.main(
            ["--load"], on_parting=certify))
        check(load["ok"] and load["violations"] == []
              and load["completed"] > 0, f"serve_selection --load: {load}")
        emit("serve", part="launcher", smoke=smoke,
             load={key: load[key] for key in (
                 "requests", "completed", "shed", "failed", "rejected",
                 "sustained_rps", "p50_ms", "p99_ms", "tenant_p99_ms",
                 "rungs", "fairness_ratio", "faults_injected", "overload",
                 "violations")},
             seconds={"smoke": seconds["serve-launcher-smoke"],
                      "load": seconds["serve-launcher-load"]})

        # 5. a stream session with a snapshot every SERVE_STREAM_KILL
        # batches; killed after batch SERVE_STREAM_KILL (its later snapshot
        # deleted) and reopened on its checkpoint, against the same stream
        # never killed
        b, nb, cap, ks = SERVE_STREAM
        stream_target = pcg.sum(dim=0)
        batches = [(pcg[i * b:(i + 1) * b], np.arange(i * b, (i + 1) * b))
                   for i in range(nb)]
        ssvc = SelectionService()
        where = os.path.join(root, "stream")

        def stream(start=0):
            sid = ssvc.open_stream(d=d, k=ks, target=stream_target,
                                   capacity=cap, checkpoint_dir=where,
                                   checkpoint_every=SERVE_STREAM_KILL)
            for rows_, gids in batches[start:]:
                res = ssvc.push_stream(sid, rows_, gids=gids)
            return sid, res

        (sid_ref, ref), never_s = timed(lambda: measure("serve-stream",
                                                        stream))
        shutil.rmtree(os.path.join(where, f"step_{nb:010d}"))
        (sid_res, res), resumed_s = timed(
            lambda: stream(start=SERVE_STREAM_KILL))
        needs("serve-stream", ("corr", "corr_argmax"))
        m_ref = ssvc.streams.get(sid_ref).maintainer
        m_res = ssvc.streams.get(sid_res).maintainer
        check(res.stats.resumes == 1, "serve: the stream did not resume")
        bits(m_res.slot_result(), m_ref.slot_result(),
             "serve: the resumed stream against the never-killed one")
        bits(res[:4], ref[:4], "serve: the resumed stream's coreset")
        check(torch.equal(m_ref.pool_view()[0], m_res.pool_view()[0])
              and np.array_equal(m_ref._gids, m_res._gids),
              "serve: the resumed stream's pool or gids differ")
        emit("serve", part="stream", batch=b, batches=nb, capacity=cap,
             k=ks, killed_after=SERVE_STREAM_KILL,
             seconds={"never_killed": never_s, "resumed": resumed_s},
             admits=res.stats.admits, evicts=res.stats.evicts,
             replayed_rounds=res.stats.rounds, bit_equal=True,
             launches=launches("serve-stream", ("corr", "corr_argmax")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # every kernel the serving paths reach launched on one of them
    for name in SERVE_KERNELS:
        check(any(c[name] > 0 for c in counts.values()),
              f"kernel {name} was not launched on any serve path")
    emit("serve", what="phase", seconds=time.perf_counter() - t_phase,
         launches={p: {k: v for k, v in c.items() if v} for p, c in
                   counts.items()})
    return {"counts": counts, "shapes": shapes, "routes": routes,
            "selection_seconds": seconds, "absolute": absolute}


def phase_kernels_serve(torch, np, card: dict, records: dict,
                        sv: dict) -> None:
    """Each kernel at every shape a serve path launched it at (``sv``, what
    ``phase_serve`` returns), against its plain version on the card on
    seeded random inputs of that shape, a tenth of the rows taken as in a
    serving request's masks; ``corr_argmax`` at each ``abs`` flag the path
    gave it.  The device operations a call are the kernels phases' check:
    after the serve paths ``torch.profiler`` has been seen to record no
    device operation at all on an H100.  A kernel with no hold here (the on-the-fly FL scans) keeps
    the record an earlier kernels phase made at the same shape, and the
    script fails where there is none.  Adds a record a path and shape."""
    from repro_torch.core import greedy

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    t0 = time.perf_counter()

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    def live(*shape):
        return torch.from_numpy(rng.random(shape) > 0.1).to(dev)

    def hold(name, shape, per_problem, dtype, flags):
        n, d = shape[:2]
        if name == "corr":
            return hold_corr(torch, card, rand(n, d).to(getattr(torch, dtype)),
                             rand(d))
        if name == "corr_argmax":
            recs = []
            for a in sorted(flags):
                recs.append(hold_corr_argmax(
                    torch, card, rand(n, d), rand(d, scale=1 / 16),
                    rand(n, scale=3), live(n), a, f"serve ({n}, {d})"))
                emit("kernels", kernel="corr_argmax", case="serve",
                     absolute=a, **recs[-1])
            return recs[0]
        if name == "corr_batched":
            return hold_corr_batched(torch, card, rand(n, d),
                                     rand(shape[2], d), count_ops=False)
        if name == "corr_argmax_batched":
            b = shape[2]
            mat = rand(b, n, d) if per_problem else rand(n, d)
            return hold_corr_argmax_batched(
                torch, card, mat, rand(b, d, scale=1 / 16),
                rand(n, b, scale=3), live(n, b), False,
                f"serve ({n}, {d}) B={b} per-problem={per_problem}",
                count_ops=False)[0]
        if name == "bound_max":
            return hold_bound_max(torch, np, card, rng, n, d,
                                  lambda: live(n), count_ops=False)
        if name == "fl_gain_argmax":
            # a resident similarity as the registry builds it
            sim = greedy.build_sim(rand(n, SERVE_LAUNCHER_POOL[1]))
            rec = hold_fl_gain(torch, card, sim,
                               rand(n).abs_().mul_(4), live(n),
                               f"serve ({n}, {n})")
            emit("kernels", kernel="fl_gain_argmax", **rec)
            return rec
        earlier = [r for rec in records[name].values()
                   for r in (rec if isinstance(rec, list) else [rec])
                   if tuple(r["shape"]) == shape]
        check(bool(earlier), f"{name} ran at {list(shape)} on a serve path "
              "and no kernels phase measured that shape")
        return earlier[0]

    held = {}
    for path, by_key in sv["shapes"].items():
        ran = {key[0] for key in by_key}
        for name, c in sv["counts"][path].items():
            check(c == 0 or name in ran, f"{name} launched on {path} at "
                  "no shape the serve phase caught")
        recs = {}
        for key in sorted(by_key):
            shape, per_problem = ran_at(key)
            hk = (key[0], shape, per_problem)
            if hk not in held:
                held[hk] = hold(key[0], shape, per_problem, key[3],
                                sv["absolute"].get(key, {False}))
            recs.setdefault(key[0], []).append(held[hk])
        for name, lst in recs.items():
            records[name][path] = lst[0] if len(lst) == 1 else lst
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit("kernels_serve", seconds=time.perf_counter() - t0,
         held=[{"kernel": k, "shape": list(sh), "per_problem": pp}
               for k, sh, pp in held])


def resilience_lm_config():
    """gemma-2b at its published widths, depth cut to RES_LM_LAYERS."""
    from repro_torch.configs import get_config
    return get_config("gemma-2b").replace(n_layers=RES_LM_LAYERS,
                                          n_superblocks=RES_LM_LAYERS)


def phase_resilience(torch, np, tr: dict, stream_parts: dict) -> dict:
    """Checkpoint and resilience, and continual selection, at full width:
    kill and resume of the streaming engine, the trainer, the continual
    buffer and the LM driver (each resumed run bit-equal to a run never
    killed), the continual buffer against a fresh solve, the downdate
    against a re-solve, and the stochastic degradation rung against the
    plain versions.  Each path's launch counts are read on their own;
    snapshots go to a temporary directory removed at the end."""
    import gc
    import shutil
    import tempfile

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs.paper import mlp
    from repro_torch.continual import BufferMaintainer
    from repro_torch.core import omp, streaming
    from repro_torch.core.decremental import omp_downdate
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain
    from repro_torch.launch import train as lm_train
    from repro_torch.models import lm
    from repro_torch.resilience import (FaultPlan, FaultyChunkIterator,
                                        StreamDied, degrade)
    from repro_torch.train.steps import make_proxy_fn
    from repro_torch.train.trainer import AdaptiveTrainer

    t_phase = time.perf_counter()
    dev = next(tr["model"].parameters()).device
    counts = {}

    def measure(path, fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts[path] = ops.launch_counts()
        return out, time.perf_counter() - t0

    def needs(path, names):
        for name in names:
            check(counts[path][name] > 0,
                  f"kernel {name} was not launched on the {path} path")

    def launches(paths, names):
        return {p: {n: counts[p][n] for n in names} for p in paths}

    def same(a, b, what):
        for i, name in enumerate(("indices", "weights", "mask", "err")):
            check(torch.equal(a[i], b[i]), f"{what}: {name} differ")

    def on_disk(out, args):
        return {"step": int(args[1]), "mb": disk_bytes(out) / 1e6}

    def held_corr(g, r, what):
        """``corr`` against its plain version on a path's own data."""
        got, want = corr_k.corr(g, r), plain.corr_ref(g, r)
        err = float((got - want).abs().max())
        scale = float(torch.sqrt((g * g).sum(1).max() * (r * r).sum()))
        check(torch.allclose(got, want, rtol=1e-5,
                             atol=1e-6 * max(scale, 1.0)),
              f"corr disagrees on {what} {list(g.shape)}: {err}")
        return {"shape": list(g.shape), "max_abs_err": err,
                "ms": device_ms(torch, lambda: corr_k.corr(g, r)),
                "plain_ms": device_ms(torch, lambda: plain.corr_ref(g, r))}

    def held_argmax(c, w, mask, what):
        """``corr_argmax`` (narrow: base 0) against its plain version on a
        path's own data; the index may differ only at an f32 tie."""
        base = torch.zeros((c.shape[0],), device=c.device)
        gi, gv = corr_k.corr_argmax(c, w, base, mask)
        ri, rv = plain.corr_argmax_ref(c, w, base, mask)
        gi, ri, gv, rv = int(gi), int(ri), float(gv), float(rv)
        sc = base - c @ w
        check(gi == ri or (bool(mask[gi]) and abs(float(sc[gi] - sc[ri]))
                           <= 1e-6 * abs(float(sc[ri]))),
              f"corr_argmax on {what}: index {gi} vs {ri}")
        check(abs(gv - rv) <= 1e-5 * abs(rv) + 1e-6,
              f"corr_argmax on {what}: value {gv} vs {rv}")
        return {"shape": list(c.shape), "max_abs_err": abs(gv - rv),
                "same_index": gi == ri,
                "ms": device_ms(torch, lambda: corr_k.corr_argmax(
                    c, w, base, mask)),
                "plain_ms": device_ms(torch, lambda: plain.corr_argmax_ref(
                    c, w, base, mask))}

    cfg = resilience_lm_config()
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        # Room for the LM driver's snapshots: keep-3 plus one being
        # written, each the bf16 parameters and their f32 momentum slots.
        model = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
        lm_bytes = sum(p.numel() * (p.element_size() + 4)
                       for p in model.parameters())
        free = shutil.disk_usage(root).free
        emit("resilience", what="disk", dir=root, free_gb=free / 1e9,
             lm_snapshot_gb=lm_bytes / 1e9)
        check(free > 4 * lm_bytes + (1 << 30), f"{root} has {free / 1e9:.1f}"
              f" GB free; the LM snapshots need {4 * lm_bytes / 1e9:.1f} GB")

        # 1. streaming kill and resume: the stream phase's partial-cache
        # selection (the initial model's bias proxies, chunks of 1 024, 32
        # cache slots for 44 chunks, the row fetch, k = PARTIAL_K), whose
        # loader is re-read every pass, killed by a dying stream halfway
        # through its passes and resumed; against the stream phase's run,
        # which wrote no snapshot.
        part = stream_parts
        ref = part["result"]
        stream_kw = dict(lam=part["lam"], eps=part["eps"],
                         buffer_size=part["buffer_size"],
                         row_fetch=part["fetch"])

        def stream_run(it, where, cache=None, **extra):
            kw = dict(stream_kw, cache_bytes=part["cache_bytes"], **extra)
            return streaming.gradmatch_streaming(
                it, PARTIAL_K, cache=cache, checkpoint_dir=None if where
                is None else os.path.join(root, where), **kw)

        n_chunks = -(-tr["train"].n // part["chunk"])
        die = n_chunks * (1 + ref.stats.passes // 2)
        dying = FaultyChunkIterator(part["chunks"],
                                    FaultPlan(die_after_chunks=die))
        t0 = time.perf_counter()
        died = False
        with Timed(streaming, "save_solver_state", on_disk) as saves:
            try:
                stream_run(dying, "killed")
            except StreamDied:
                died = True
        killed_s = time.perf_counter() - t0
        check(died, "stream: the run was not killed")
        check(len(saves) >= 2, f"stream: {len(saves)} snapshots before the "
              "kill")
        kept = sorted(os.listdir(os.path.join(root, "killed")))
        arena = streaming.ChunkCache(part["cache_bytes"],
                                     part["target"].shape[0])
        resumed, resumed_s = measure("stream-resume", lambda: stream_run(
            part["chunks"], "killed", cache=arena))
        same(resumed, ref, "stream: the resumed run against the never-"
             "killed one")
        check(resumed.stats.resumes == 1,
              f"stream: {resumed.stats.resumes} resumes")
        needs("stream-resume", ("corr", "bound_max", "lastlayer_grad"))
        # A never-killed run with snapshots against one without, on the
        # same proxies and budget with the trainer's whole cache (256 MiB:
        # refills and repairs, few passes; the partial cache's loader
        # passes are the resumed pair's above).
        whole = {}
        for where in (None, "whole"):
            whole[where], _ = measure(
                "stream-whole", lambda: streaming.gradmatch_streaming(
                    part["chunks"], PARTIAL_K, cache_bytes=256 << 20,
                    checkpoint_dir=where and os.path.join(root, where),
                    **stream_kw))
        same(whole["whole"], whole[None], "stream: a never-killed run with "
             "checkpoint_dir against one without")
        emit("resilience", part="stream", k=PARTIAL_K, checkpoint_every=8,
             chunks=n_chunks, died_after_chunks=die,
             snapshots_before_death=len(saves),
             snapshot_seconds=[s["seconds"] for s in saves],
             snapshot_mb=[s["mb"] for s in saves], kept_after_death=kept,
             seconds={"killed": killed_s, "resumed": resumed_s,
                      "never_killed": part["seconds"]},
             resumes=resumed.stats.resumes, bit_equal=True,
             whole_cache={"checkpoints": whole["whole"].stats.checkpoints,
                          "passes": whole["whole"].stats.passes,
                          "bit_equal": True},
             launches={"stream-resume": {
                 n: counts["stream-resume"][n]
                 for n in ("corr", "bound_max", "lastlayer_grad")}})

        # 2. trainer kill and resume: the trainer phase's run (per-class
        # GRAD-MATCH, budget 0.1, R = 1, 2 epochs) with a snapshot every
        # epoch, then its epoch-2 snapshot deleted and the run again.
        tcfg = replace(tr["config"], checkpoint_every=1,
                       checkpoint_dir=os.path.join(root, "trainer"))

        def trainer_run():
            trainer = AdaptiveTrainer(mlp(), tcfg, tr["train"], tr["val"])
            model_t = trainer.init_model()
            return trainer.run(model_t), model_t

        (rep1, model1), run1_s = measure("trainer-checkpointed", trainer_run)
        shutil.rmtree(os.path.join(root, "trainer", "step_0000000002"))
        (rep2, model2), run2_s = measure("trainer-resume", trainer_run)
        p0 = dict(tr["model"].named_parameters())
        p1 = dict(model1.named_parameters())
        for name, p in model2.named_parameters():
            check(torch.equal(p, p1[name]),
                  f"trainer: resumed parameter {name} differs")
            check(torch.equal(p1[name], p0[name]), f"trainer: parameter "
                  f"{name} differs from the trainer phase's run")
        check(rep2.selection_rounds == rep1.selection_rounds
              == tr["report"].selection_rounds == 2,
              f"trainer: selection rounds {rep1.selection_rounds} / "
              f"{rep2.selection_rounds}")
        check(rep2.work_units == rep1.work_units == tr["report"].work_units,
              f"trainer: work {rep1.work_units} / {rep2.work_units}")
        needs("trainer-resume", TRAINER_NEEDS["gradmatch"])
        emit("resilience", part="trainer", epochs=2, checkpoint_every=1,
             seconds={"checkpointed": run1_s, "resumed": run2_s},
             selection_rounds=rep2.selection_rounds, work=rep2.work_units,
             final_acc=[rep1.final_acc, rep2.final_acc], bit_equal=True,
             launches=launches(("trainer-checkpointed", "trainer-resume"),
                               TRAINER_NEEDS["gradmatch"]))
        del model1, model2, p1

        # 3. continual selection: the trainer's per-gradient proxies in
        # batches of RES_BATCH through a RES_CAP-row buffer at k RES_K (the
        # reference benchmark's settings, at the port's proxy width); the
        # run killed after batch RES_KILL (its later snapshot deleted) and
        # restored; the result against a fresh solve over the surviving
        # rows.
        pcg, _ = make_proxy_fn(tr["model"])(tr["train"].x, tr["train"].y)
        d = pcg.shape[1]
        target = pcg.sum(dim=0)
        batches = [(pcg[i * RES_BATCH:(i + 1) * RES_BATCH],
                    np.arange(i * RES_BATCH, (i + 1) * RES_BATCH))
                   for i in range(RES_BATCHES)]

        def buffer(**extra):
            return BufferMaintainer(capacity=RES_CAP, d=d, target=target,
                                    k=RES_K, compress=True, seed=0, **extra)

        where = os.path.join(root, "continual")

        def never_killed():
            # a snapshot at batch RES_KILL (and at the last)
            m = buffer(checkpoint_dir=where, checkpoint_every=RES_KILL)
            m.admit(*batches[0])
            mem_first = m.memory_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for rows, gids in batches[1:]:
                m.admit(rows, gids)
            torch.cuda.synchronize()
            return m, mem_first, time.perf_counter() - t0

        (m_ref, mem_first, steady_s), cont_s = measure("continual",
                                                       never_killed)
        # killed after batch RES_KILL: its later snapshot never written
        shutil.rmtree(os.path.join(where, f"step_{RES_BATCHES:010d}"))

        def restored():
            res = BufferMaintainer.restore(where, device=dev)
            check(res is not None and res.batches == RES_KILL,
                  "continual: nothing to restore")
            for rows, gids in batches[RES_KILL:]:
                res.admit(rows, gids)
            return res

        m_res, res_s = measure("continual-resume", restored)
        for path in ("continual", "continual-resume"):
            needs(path, ("corr", "corr_argmax"))
        same(m_res.slot_result(), m_ref.slot_result(),
             "continual: the restored buffer against the never-killed one")
        check(torch.equal(m_ref.pool_view()[0], m_res.pool_view()[0])
              and np.array_equal(m_ref._gids, m_res._gids)
              and np.array_equal(m_ref._trace.win, m_res._trace.win),
              "continual: the restored pool, gids or trace differ")
        pool, ok = m_ref.pool_view()
        vs_fresh = agree(
            torch, pool, target, m_ref.slot_result(),
            omp.omp_select(pool, target, RES_K, valid=ok),
            lambda t: omp.session_result(omp.omp_session_start(
                pool, target, t, valid=ok, block=m_ref.block)),
            lambda t: omp.omp_select(pool, target, t, valid=ok),
            "continual against a fresh omp_select")
        # its two kernels on its own data against the plain versions: the
        # last batch's c0, the narrow scan of the pool view
        cont_kernels = {
            "corr": held_corr(batches[-1][0], target, "continual c0"),
            "corr_argmax": held_argmax(pool, -m_ref._sess.st.residual, ok,
                                       "the continual pool view")}
        mst = m_ref.stats
        emit("resilience", part="continual", capacity=RES_CAP, k=RES_K, d=d,
             batch=RES_BATCH, batches=RES_BATCHES, kill_after=RES_KILL,
             rows_per_s=RES_BATCH * (RES_BATCHES - 1) / steady_s,
             seconds={"never_killed": cont_s, "restored": res_s},
             memory_bytes_first=mem_first,
             memory_bytes_last=m_ref.memory_bytes(), admits=mst.admits,
             evicts=mst.evicts, downdates=mst.downdates,
             resolves=mst.resolves, replayed_rounds=mst.rounds,
             snapshots=m_ref.stats.checkpoints, bit_equal=True,
             vs_fresh=vs_fresh, kernels=cont_kernels,
             launches=launches(("continual", "continual-resume"),
                               ("corr", "corr_argmax")))
        check(m_ref.memory_bytes() == mem_first, "continual: memory grew "
              f"from {mem_first} to {m_ref.memory_bytes()} bytes")
        check(mst.admits == RES_BATCH * RES_BATCHES and mst.evicts > 0,
              f"continual: {mst.admits} admits, {mst.evicts} evicts")

        # the downdate of the last pick against a fresh solve (the
        # reference benchmark's down_k / down_pool)
        rng = np.random.default_rng(1)
        g = torch.from_numpy(rng.standard_normal(DOWN_POOL).astype(
            np.float32)).to(dev)
        gt = g.sum(dim=0)

        def wall(fn, reps):
            out = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
            return statistics.median(out)

        solves = []
        solve_s = wall(lambda: solves.append(omp.omp_session_start(
            g, gt, DOWN_K)), 2)
        sess = solves[0]
        last = int(sess.indices[DOWN_K - 1])
        omp_downdate(g, sess, last)               # warm up
        down_s = wall(lambda: omp_downdate(g, sess, last), 3)
        down, info = omp_downdate(g, sess, last)
        valid = torch.ones(DOWN_POOL[0], dtype=torch.bool, device=dev)
        valid[last] = False
        check(torch.equal(down.indices, omp.omp_session_start(
            g, gt, DOWN_K - 1, valid=valid).indices),
              "downdate: the picks differ from a fresh solve on the "
              "surviving rows")
        emit("resilience", part="downdate", pool=list(DOWN_POOL), k=DOWN_K,
             downdate_ms=down_s * 1e3, resolve_ms=solve_s * 1e3,
             speedup=solve_s / down_s, replayed=info.replayed,
             reference_gate=5.0)

        # 4. LM driver kill and resume: gemma-2b at full width, depth cut
        # to RES_LM_LAYERS, RES_LM_STEPS steps with a snapshot every
        # RES_LM_EVERY (one, at RES_LM_EVERY: a kill before the next); the
        # run again from it.
        where = os.path.join(root, "lm")
        argv = [*LM_ARGV, "--steps", str(RES_LM_STEPS), "--checkpoint-dir",
                where, "--checkpoint-every", str(RES_LM_EVERY)]
        n_params = sum(p.numel() for p in model.parameters())
        with Timed(ckpt_lib, "_write", on_disk) as writes, \
                Timed(ckpt_lib, "_host_flat", lambda out, args: {
                    "gb": sum(a.nbytes for a in out[0].values()) / 1e9}
                      ) as copies:
            rep1, lm1_s = measure("lm-checkpointed",
                                  lambda: lm_train.main(argv, model=model))
            want = {name: p.detach().clone()
                    for name, p in model.named_parameters()}
            del model
            gc.collect()
            torch.cuda.empty_cache()
            snaps = sorted(os.listdir(where))
            check(snaps == [f"step_{RES_LM_EVERY:010d}"],
                  f"lm: snapshots {snaps}")
            model = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(
                1), dev)
            rep2, lm2_s = measure("lm-resume",
                                  lambda: lm_train.main(argv, model=model))
        for path in ("lm-checkpointed", "lm-resume"):
            needs(path, ("hidden_grad_tc", "corr", "corr_argmax"))
        check(rep2["start_step"] == RES_LM_EVERY,
              f"lm: resumed at step {rep2['start_step']}")
        check(rep2["losses"] == rep1["losses"][RES_LM_EVERY:],
              "lm: the resumed steps' losses differ")
        for name, p in model.named_parameters():
            check(torch.equal(p, want[name]), f"lm: resumed parameter "
                  f"{name} differs")
        emit("resilience", part="lm", arch="gemma-2b", params=n_params,
             layers=RES_LM_LAYERS, steps=RES_LM_STEPS,
             checkpoint_every=RES_LM_EVERY, resumed_at=rep2["start_step"],
             seconds={"checkpointed": lm1_s, "resumed": lm2_s},
             snapshots=writes, host_copies=copies,
             losses_resumed=rep2["losses"], bit_equal=True,
             launches=launches(("lm-checkpointed", "lm-resume"),
                               ("hidden_grad_tc", "corr", "corr_argmax")))
        del model, want
        gc.collect()
        torch.cuda.empty_cache()

        # 5. degradation: the stochastic rung over the resumed streaming
        # run's warm arena and over the (45 000, 65) proxies, at DEGRADE_K,
        # with the kernels and with the plain versions.
        gids_a = arena.gids.cpu().numpy()
        live_a = np.flatnonzero((gids_a >= 0) & arena.ok.cpu().numpy())
        cases = {
            "fallback": (lambda: degrade.stochastic_fallback(
                arena, part["target"], DEGRADE_K), part["target"],
                arena.rows, live_a, gids_a),
            "pool": (lambda: degrade.stochastic_pool_select(
                pcg, target, DEGRADE_K), target, pcg,
                np.arange(pcg.shape[0]), np.arange(pcg.shape[0]))}
        degraded = {}
        for what, (fn, tgt, src, cand, ids_of) in cases.items():
            got, got_s = measure(f"degrade-{what}", fn)
            needs(f"degrade-{what}", ("corr", "corr_argmax"))
            ops.set_backend("ref")
            try:
                want_sel, want_s = measure(f"degrade-{what}-plain", fn)
            finally:
                ops.set_backend(None)
            picks = got.indices[got.mask].tolist()
            check(len(set(picks)) == DEGRADE_K
                  and set(picks) <= set(ids_of[cand].tolist()),
                  f"degrade {what}: the picks are not {DEGRADE_K} live rows")
            # the rung's sample, and both solutions in its local ids
            pick = degrade._sample(cand, DEGRADE_K, 0, 4, 256)
            rows = src[torch.as_tensor(pick, device=dev)].float()
            local_of = {int(g): i for i, g in enumerate(ids_of[pick])}

            def local(s):
                return (torch.tensor([local_of.get(int(i), -1)
                                      for i in s.indices.tolist()],
                                     dtype=torch.int32, device=dev),
                        s.weights, s.mask, s.err)

            def solve(t, mode, rows=rows, tgt=tgt):
                ops.set_backend(mode)
                try:
                    return omp.omp_select(rows, tgt, t)
                finally:
                    ops.set_backend(None)

            rec = agree(torch, rows, tgt, local(got), local(want_sel),
                        lambda t: solve(t, None), lambda t: solve(t, "ref"),
                        f"degrade {what}, kernels against plain")
            kern = {"corr": held_corr(rows, tgt, f"degrade {what}"),
                    "corr_argmax": held_argmax(
                        rows, -tgt, torch.ones((rows.shape[0],),
                                               dtype=torch.bool, device=dev),
                        f"degrade {what}")}
            degraded[what] = {"seconds": got_s, "plain_seconds": want_s,
                              "sample": len(pick), "err": float(got.err),
                              **rec, "kernels": kern, "launches": {
                                  n: counts[f"degrade-{what}"][n]
                                  for n in ("corr", "corr_argmax")}}
        emit("resilience", part="degrade", k=DEGRADE_K, **degraded)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("resilience", what="phase", seconds=time.perf_counter() - t_phase)


def lm_step_parts(torch, cfg, model, stream, args, proxy_fn) -> dict:
    """Median seconds of the LM loop's parts (drawing a micro-batch, the
    weighted loss's forward, its backward, the SGD update, one candidate's
    selection proxy), each between two syncs, and a profiler trace of one
    step and one proxy pass: the card's busy share of that span and the
    device time of its busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import lm
    from repro_torch.optim import sgd

    opt = sgd(model.parameters(), args.lr, momentum=0.9)
    mb = args.micro_batch
    times = {k: [] for k in ("batch", "forward", "backward", "optimizer",
                             "proxy")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        return out

    def one_step(i):
        batch = timed("batch", lambda: dict(stream.batch(0, i % args.window)))
        batch["weights"] = torch.full((mb,), 1.0 / mb, device=stream.device)
        opt.zero_grad(set_to_none=True)
        loss, _ = timed("forward", lambda: lm.lm_loss(cfg, model, batch))
        timed("backward", loss.backward)
        timed("optimizer", opt.step)
        timed("proxy", lambda: proxy_fn(batch))

    for i in range(LM_TRACE_STEPS + 1):
        one_step(i)
    med = {f"{k}_s": statistics.median(v[1:]) for k, v in times.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("span"):
            one_step(0)
    events = prof.events()
    (lo, hi), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "span" and e.device_type == DeviceType.CPU]
    # Device activity: kernels, memsets and copies.  User annotations
    # (the span, the optimizer's step) are mirrored on the device's
    # timeline; they are not activity.
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and e.name != "span"
                    and not e.name.startswith("Optimizer."))
    busy, end, by_name = 0.0, lo, {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    del opt
    return dict(steps=LM_TRACE_STEPS, **med,
                traced_span_ms=(hi - lo) / 1e3,
                device_busy_share=busy / (hi - lo) if device else None,
                device_us=sum(by_name.values()),
                hidden_grad_us=sum(us for name, us in by_name.items()
                                   if "hidden_grad" in name),
                top_device_us={name[:90]: us for name, us in top})


def lm_select_and_omp(torch, card: dict, records: dict, phase: str,
                      path: str, proxy_fn, stream, args,
                      last_round: int) -> None:
    """One selection with the kernels and one with the plain versions on
    the last window's candidates (the same picks, weights to rtol 1e-4 /
    atol 1e-5); then ``corr`` and ``corr_argmax`` against their plain
    versions at the shapes the path gave them, timed: the records of
    ``path``."""
    from repro_torch.core import gradmatch as gm_lib
    from repro_torch.kernels import corr as corr_k
    from repro_torch.kernels import ops, ref

    dev = stream.device
    bw, flops = peaks(card["name"])
    k_batches = max(int(args.window * args.budget), 1)
    sels = {}
    for mode in ("kernels", "plain"):
        ops.set_backend("ref" if mode == "plain" else None)
        try:
            px = torch.stack([proxy_fn(stream.batch(last_round, s)).mean(0)
                              for s in range(args.window)])
            sels[mode] = (px, gm_lib.gradmatch(px, k_batches, lam=args.lam))
        finally:
            ops.set_backend(None)
    (pk, sk), (pp, sp) = sels["kernels"], sels["plain"]
    ik, ip = sk.indices[sk.mask].tolist(), sp.indices[sp.mask].tolist()
    wk, wp = sk.weights[sk.mask], sp.weights[sp.mask]
    proxy_err = float((pk - pp).abs().max()) / float(pp.abs().max())
    same = ik == ip
    emit(phase, path=f"{path}-select", candidates=args.window, k=k_batches,
         picks_kernels=ik, picks_plain=ip, weights_kernels=wk.tolist(),
         weights_plain=wp.tolist(), err_kernels=float(sk.err),
         err_plain=float(sp.err), proxy_rel_err=proxy_err)
    check(same, f"{path} selection: kernels picked {ik}, plain versions "
          f"{ip}")
    check(torch.allclose(wk, wp, rtol=1e-4, atol=1e-5),
          f"{path} selection weights {wk.tolist()} vs {wp.tolist()}")

    # corr and corr_argmax at the shapes the path gave them: c0 and each
    # new column over the (window, d_model) proxies, the argmax over the
    # (window, k) column cache of the wide regime.

    def record(name, fn, pfn, shape, nbytes, nops, err, lib=None):
        by_b, by_o = nbytes / bw * 1e3, nops / flops * 1e3
        records[name][path] = dict(
            max_abs_err=err, ms=device_ms(torch, fn),
            plain_ms=device_ms(torch, pfn),
            library_ms=None if lib is None else device_ms(torch, lib),
            bound_ms=max(by_b, by_o),
            bound_by="bytes" if by_b >= by_o else "operations", shape=shape)
        emit("kernels", kernel=name, path=path, **records[name][path])

    r = pk.sum(0)
    got_c, want_c = corr_k.corr(pk, r), ref.corr_ref(pk, r)
    err_c = float((got_c - want_c).abs().max())
    check(err_c <= 1e-5 * float(want_c.abs().max()), f"corr on the {path} "
          f"proxies: max err {err_c}")
    record("corr", lambda: corr_k.corr(pk, r), lambda: ref.corr_ref(pk, r),
           list(pk.shape), 4 * pk.numel() + 4 * pk.shape[1]
           + 4 * pk.shape[0], 2 * pk.numel(), err_c,
           lib=lambda: torch.mv(pk, r))
    cc = torch.randn((args.window, k_batches), device=dev)
    cw = torch.randn((k_batches,), device=dev)
    base = torch.randn((args.window,), device=dev)
    avail = torch.ones((args.window,), dtype=torch.bool, device=dev)
    gi, gv = corr_k.corr_argmax(cc, cw, base, avail)
    ri, rv = ref.corr_argmax_ref(cc, cw, base, avail)
    check(int(gi) == int(ri) and abs(float(gv) - float(rv))
          <= 1e-5 * abs(float(rv)) + 1e-6, f"corr_argmax on the {path} "
          f"column cache: ({int(gi)}, {float(gv)}) vs ({int(ri)}, "
          f"{float(rv)})")
    record("corr_argmax", lambda: corr_k.corr_argmax(cc, cw, base, avail),
           lambda: ref.corr_argmax_ref(cc, cw, base, avail), list(cc.shape),
           4 * cc.numel() + 4 * k_batches + 5 * args.window + 8,
           2 * cc.numel(), abs(float(gv) - float(rv)))


def phase_lm(torch, np, card: dict, records: dict) -> dict:
    """The LM training driver at its defaults but 40 steps on gemma-2b
    (full width and depth), the launch counts set to 0 just before
    ``main`` and read just after; then, on the trained parameters, the
    head kernels against the plain version on a real candidate, one
    selection with the kernels and one with the plain versions, and the
    timings.  Adds the records of ``hidden_grad_tc``, ``hidden_grad``
    (the FFMA kernel at the path's shape, which the path no longer
    launches) and of ``corr`` / ``corr_argmax`` at the path's shapes."""
    import gc

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import lastlayer_grad as llg_k
    from repro_torch.kernels import ref
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train.steps import make_lm_proxy_step

    args = train.build_argparser().parse_args(LM_ARGV)
    dev = torch.device(args.device or "cuda")
    bw, flops = peaks(card["name"])

    # 1. the driver, through main; the model seam holds the very model
    # main would build from --seed, so the checks below see its weights.
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    drv = lm_driver(torch, np, "lm", "lm", cfg, LM_ARGV)
    model, rep = drv["model"], drv["rep"]
    counts, shapes = drv["run"]["counts"], drv["run"]["shapes"]
    del drv
    check(rep["params"] == LM_PARAMS, f"{args.arch} has {rep['params']} "
          f"parameters, not {LM_PARAMS}")

    # 2. hidden_grad against its plain version on a real candidate: the
    # last window's first micro-batch, its logits from the trained model.
    # The path's call goes to the tensor-core kernel; the FFMA kernel's own
    # entry is held to the same limit on the same inputs.
    stream = TokenStream(seed=args.seed, batch_per_shard=args.micro_batch,
                         seq_len=args.seq_len, vocab=cfg.vocab_size,
                         n_shards=args.window, device=dev)
    last_round = (args.steps - 1) // args.select_every
    cand = stream.batch(last_round, 0)
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, model, cand["tokens"])
        logits = lm._head_out(cfg, model, h)
    z = logits.reshape(-1, logits.shape[-1])
    y = cand["targets"].reshape(-1)
    w = lm.head_weight(cfg, model).detach()
    n, v = z.shape
    dh = w.shape[0]
    check(llg_k.takes_tensor_cores(z.dtype, w.dtype, n, v, dh, True,
                                   z.data_ptr(), w.data_ptr()),
          "the lm path's hidden_grad call is not routed to the tensor cores")
    got = llg_k.hidden_grad_fused(z, y, w)
    again = llg_k.hidden_grad_fused(z, y, w)
    want = ref.hidden_grad_ref(z, y, w)
    ffma = llg_k.hidden_grad_ffma(z, y, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_ffma = float((ffma - want).abs().max())
    scale = float(want.abs().max())
    same_bits = bool(torch.equal(got, again))
    # ragged cases: rows, vocabulary and width off every tile and stage;
    # f32 logits, an untied f32 head, int64 labels (the FFMA kernel), and a
    # bf16 head in each layout (the tensor-core kernel)
    ragged = {}
    for key, zdt, wdt, tied, ldt, kernel in (
            ("f32_untied", torch.float32, torch.float32, False, torch.int64,
             "hidden_grad"),
            ("bf16_tied", torch.bfloat16, torch.bfloat16, True, torch.int64,
             "hidden_grad_tc"),
            ("bf16_untied", torch.float32, torch.bfloat16, False,
             torch.int32, "hidden_grad_tc")):
        zr = (torch.randn((300, 1000), device=dev) * 2).to(zdt)
        yr = torch.randint(0, 1000, (300,), device=dev, dtype=ldt)
        wr = torch.randn((1000, 600) if tied else (600, 1000),
                         device=dev) * 0.02
        wr = (wr.T if tied else wr).to(wdt)
        before = dict(llg_k.launches)
        rg, rw = llg_k.hidden_grad_fused(zr, yr, wr), ref.hidden_grad_ref(
            zr, yr, wr)
        check(llg_k.launches[kernel] == before[kernel] + 1,
              f"the ragged {key} case did not go to {kernel}")
        ragged[key] = float((rg - rw).abs().max()) / float(rw.abs().max())

    # 3. timings at the path's shape: the tensor-core kernel, the FFMA
    # kernel (kept for the inputs TMA cannot take), the plain version, and
    # two library yardsticks the port never calls, since no single torch
    # call computes the whole function: cuBLAS's f32 product of the
    # residual alone (materialized, W widened beforehand), and its bf16
    # product of the residual's hi half (one pass, which misses the limit).
    ms = device_ms(torch, lambda: llg_k.hidden_grad_fused(z, y, w), reps=10,
                   warmup=2)
    ms_ffma = device_ms(torch, lambda: llg_k.hidden_grad_ffma(z, y, w),
                        reps=10, warmup=2)
    plain = device_ms(torch, lambda: ref.hidden_grad_ref(z, y, w), reps=10,
                      warmup=2)
    resid = torch.softmax(z.float(), dim=-1)
    resid[torch.arange(n, device=dev), y.long()] -= 1.0
    wt32 = w.T.float().contiguous()
    lib_ms = device_ms(torch, lambda: torch.mm(resid, wt32), reps=10,
                       warmup=2)
    hi = resid.to(torch.bfloat16)
    embed = w.T                     # (V, d_h), contiguous: no copy
    lib_bf16_ms = device_ms(torch, lambda: torch.mm(hi, embed), reps=10,
                            warmup=2)
    del resid, wt32, hi
    nbytes = n * v * z.element_size() + v * dh * w.element_size() + (
        4 * n * dh + y.element_size() * n)
    by_bytes = nbytes / bw * 1e3
    # f32 operations on the CUDA cores (the FFMA kernel's work), and the
    # tensor-core kernel's two bf16 passes at the bf16 dense rate
    bound_f32 = max(by_bytes, 2 * n * v * dh / flops * 1e3)
    bound_tc = max(by_bytes, 2 * 2 * n * v * dh / bf16_peak(card["name"])
                   * 1e3)
    by = "bytes" if by_bytes >= bound_tc else "operations"
    by_f32 = "bytes" if by_bytes >= bound_f32 else "operations"
    emit("kernels", kernel="hidden_grad_tc", shape=[n, v, dh],
         dtype="bfloat16", layout="embed.T (tied head)", max_abs_err=err,
         max_abs_out=scale, rel_err=err / scale, limit=LM_HG_LIMIT,
         same_bits=same_bits, ragged_rel_err=ragged, ms=ms,
         ms_ffma=ms_ffma, rel_err_ffma=err_ffma / scale, plain_ms=plain,
         library_ms=lib_ms, library_bf16_hi_ms=lib_bf16_ms,
         bound_ms=bound_tc, bound_by=by, bound_f32_ms=bound_f32)
    check(err <= LM_HG_LIMIT * scale, f"hidden_grad vs plain at ({n}, {v}, "
          f"{dh}): max err {err}, max |out| {scale}")
    check(err_ffma <= LM_HG_LIMIT * scale, f"the FFMA hidden_grad vs plain "
          f"at ({n}, {v}, {dh}): max err {err_ffma}, max |out| {scale}")
    for key, rel in ragged.items():
        check(rel <= LM_HG_LIMIT, f"hidden_grad vs plain at (300, 1000, "
              f"600), {key}: relative err {rel}")
    check(same_bits, "hidden_grad gave other bits on a second call")
    records["hidden_grad_tc"]["lm"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_tc,
        bound_by=by, library_ms=lib_ms, shape=[n, v, dh],
        bound_f32_ms=bound_f32, library_bf16_hi_ms=lib_bf16_ms)
    records["hidden_grad"]["lm"] = dict(
        max_abs_err=err_ffma, ms=ms_ffma, plain_ms=plain,
        bound_ms=bound_f32, bound_by=by_f32, library_ms=lib_ms,
        shape=[n, v, dh], bound_tc_ms=bound_tc,
        library_bf16_hi_ms=lib_bf16_ms)

    # 4. one selection with the kernels and one with the plain versions on
    # the trained parameters: the last window's candidates; corr and
    # corr_argmax at the path's shapes.
    proxy_fn = make_lm_proxy_step(cfg, model)
    lm_select_and_omp(torch, card, records, "lm", "lm", proxy_fn, stream,
                      args, last_round)
    # 5. where a step's time goes: each part of the driver's loop timed
    # between syncs over LM_TRACE_STEPS steps after one warm-up step
    # (medians), then one step and one candidate's proxy pass under
    # torch.profiler: the card's busy share and its busiest kernels.
    del z, logits, got, again, want, ffma
    parts = lm_step_parts(torch, cfg, model, stream, args, proxy_fn)
    emit("lm", path="lm-trace", **parts)
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "shapes": shapes,
            "selection_seconds": {"lm": rep["selection_s"]}, "model": model}


def teacher_forced(torch, cfg, model, tok, s0: int, fwd_cfg=None,
                   state_check=None):
    """Prefill ``tok[:, :s0]``, seat it into ``tok.shape[1]`` slots and
    decode the rest of ``tok`` a token at a time; and the train-mode
    forward over all of ``tok`` (under ``fwd_cfg`` where given: another
    SSD chunk, for a length the config's chunk does not divide).  Returns
    both packages' logits over the real vocabulary at positions s0 - 1 ..
    S - 1, f32, (B, S - s0 + 1, V) each; ``state_check`` sees the decode
    state after the last step."""
    from repro_torch.launch.serve import _seat
    from repro_torch.models import lm

    b, s = tok.shape
    v = cfg.vocab_size
    with torch.no_grad():
        logits, pstate = lm.prefill_step(cfg, model, tok[:, :s0])
        state = _seat(lm.init_decode_state(cfg, b, s, tok.device), pstate)
        del pstate
        dec = [logits[:, :v].float()]
        for t in range(s0, s):
            logits, state = lm.decode_step(cfg, model, state,
                                           tok[:, t:t + 1], t)
            dec.append(logits[:, :v].float())
        if state_check is not None:
            state_check(state)
        del state
        fcfg = fwd_cfg or cfg
        h, _, _ = lm.forward(fcfg, model, tok)
        fwd = lm.mask_padded_logits(fcfg, lm._head_out(fcfg, model,
                                                       h[:, s0 - 1:]))
    return torch.stack(dec, dim=1), fwd[..., :v].float()


class RouteRecorder:
    """While active, records the top-k expert ids of every
    ``moe._route`` call, in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.calls = moe, moe._route, []

        def recording(cfg, w, x):
            out = self.route(cfg, w, x)
            self.calls.append(out[0].detach())
            return out

        moe._route = recording
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


class RouteReplayer:
    """While active, ``moe._route`` sends each token to the experts that
    ``plan`` gives (an (G, T, k) id tensor a call, in call order), with
    weights from its own router's probabilities at those ids,
    renormalized as ``_route`` does; the aux loss is ``_route``'s own."""

    def __init__(self, plan):
        self.plan = iter(plan)

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route

        def replaying(cfg, w, x):
            _, _, aux = self.route(cfg, w, x)
            ids = next(self.plan)
            top_w = torch.softmax(x.float() @ w, dim=-1).gather(-1, ids)
            top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                            1e-9)
            return ids, top_w.to(x.dtype), aux

        moe._route = replaying
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def moe_layers(cfg) -> int:
    from repro_torch.configs.base import ATTN_LIKE
    return sum(k in ATTN_LIKE for k in cfg.layer_types_in_order())


def routes_parted(torch, cfg, calls, b: int, s0: int, s: int):
    """From the routes of a prefill of ``s0`` tokens, ``s - s0`` decode
    steps and a train-mode forward over ``s`` tokens (one call a MoE layer
    each), the (B, S) mask of the positions whose sequence was routed
    otherwise by decode than by the forward (another expert set for some
    token at or before that position, in some layer: its hidden states
    then part by more than rounding) and the count of such (layer, token)
    partings."""
    layers = moe_layers(cfg)
    steps = s - s0
    check(len(calls) == layers * (2 + steps), f"{len(calls)} route calls, "
          f"not {layers * (2 + steps)}")
    pre, dec, fwd = (calls[:layers], calls[layers:-layers],
                     calls[-layers:])
    parted = torch.zeros((b, s), dtype=torch.bool, device=fwd[0].device)
    n = 0
    for li in range(layers):
        ids = torch.cat([pre[li]] + [dec[i * layers + li].reshape(b, 1, -1)
                                     for i in range(steps)], dim=1)
        diff = (ids.sort(-1).values != fwd[li].sort(-1).values).any(-1)
        n += int(diff.sum())
        parted |= diff
    return parted.cumsum(1) > 0, n


def decode_vs_forward(torch, cfg, model, tok, s0: int, limit: float,
                      what: str, phase: str = "lm_serve", fwd_cfg=None,
                      state_check=None) -> dict:
    """``teacher_forced``'s two sets of logits: the largest difference
    relative to the forward's largest |logit|, held to ``limit``.

    For a MoE config the rounding of a bf16 run can flip a router's near
    tie, and the token then goes to another expert: a discrete step, not
    rounding.  So decode runs twice.  Routed by its own router, the rows
    whose sequence it routed as the forward did (no (layer, token) parted
    at or before the row) are held to ``limit``, and the partings, the
    rows they reach and the error over all rows are reported.  Then
    routed to the forward's experts (``RouteReplayer``; the weights from
    its own probabilities), every row is held to ``limit``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouteRecorder() as rec:
        dec, fwd = teacher_forced(torch, cfg, model, tok, s0, fwd_cfg,
                                  state_check)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    scale = float(fwd.abs().max())
    row_err = (dec - fwd).abs().amax(-1) / scale           # (B, S - s0 + 1)
    held = torch.ones_like(row_err, dtype=torch.bool)
    extra = {}
    if cfg.uses_moe:
        b, s = tok.shape
        layers = moe_layers(cfg)
        parted, n = routes_parted(torch, cfg, rec.calls, b, s0, s)
        held = ~parted[:, s0 - 1:]
        fwd_ids = rec.calls[-layers:]                       # (B, S, k) each
        plan = ([r[:, :s0] for r in fwd_ids]
                + [r[:, t][None] for t in range(s0, s) for r in fwd_ids]
                + fwd_ids)
        with RouteReplayer(plan):
            dec_r, fwd_r = teacher_forced(torch, cfg, model, tok, s0)
        check(torch.equal(fwd_r, fwd), f"{what}: the forward on its own "
              "routes gave other logits")
        err_r = float((dec_r - fwd).abs().max()) / scale
        extra = dict(route_partings=n, routed_tokens=layers * b * s,
                     rows=held.numel(),
                     rows_routed_otherwise=int((~held).sum()),
                     rel_err_all_rows=float(row_err.max()),
                     rel_err_forward_routes=err_r,
                     argmax_equal_forward_routes=float(
                         (dec_r.argmax(-1) == fwd.argmax(-1)).float()
                         .mean()))
        del dec_r, fwd_r
    err = float(row_err[held].max()) if bool(held.any()) else 0.0
    finite = bool(torch.isfinite(dec).all())
    out = dict(what=what, batch=tok.shape[0], prompt=s0, s_max=tok.shape[1],
               dtype=cfg.param_dtype, layers=cfg.n_layers, rel_err=err,
               limit=limit, max_abs_logit=scale,
               argmax_equal=float((dec.argmax(-1) == fwd.argmax(-1)).float()
                                  .mean()), **extra, seconds=seconds)
    emit(phase, **out)
    check(finite, f"{what}: decode logits not finite")
    check(err <= limit, f"{what}: decode vs forward {err} of max |logit| "
          f"(limit {limit})")
    if cfg.uses_moe:
        check(extra["rel_err_forward_routes"] <= limit, f"{what}: decode "
              f"on the forward's routes vs forward "
              f"{extra['rel_err_forward_routes']} of max |logit| (limit "
              f"{limit})")
    return out


def decode_vs_f32(torch, cfg, model, cfg32, model32, tok, s0: int,
                  limit: float, what: str, phase: str, chunk: int,
                  state_check=None) -> dict:
    """bf16 decode against the bf16 forward (``teacher_forced``, the
    forward at SSD chunk ``chunk``), and both against the forward of the
    same weights at f32 (``model32``).  Rounding makes the two bf16 runs
    part by more with depth (zamba2: 1.5e-2 of max |logit| at 9 layers,
    6.4e-2 at 81; at f32 4.7e-6 and 1.7e-5; ``tools/lm_decode_probe.py
    --depth`` on an NVIDIA H100 80GB HBM3 at 700 W).  So decode is held to
    be as close to the f32 forward as the bf16 forward is: within
    ``limit`` of max |logit|, or 1.25x the forward's own distance where
    that is wider.  Its distance from the bf16 forward is reported beside
    ``limit``."""
    from repro_torch.models import lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fcfg = cfg.replace(ssm=replace(cfg.ssm, chunk=chunk))
    dec, fwd = teacher_forced(torch, cfg, model, tok, s0, fcfg, state_check)
    c32 = cfg32.replace(ssm=replace(cfg32.ssm, chunk=chunk))
    with torch.no_grad():
        h, _, _ = lm.forward(c32, model32, tok)
        true = lm._head_out(c32, model32, h[:, s0 - 1:])[
            ..., :cfg.vocab_size]
    torch.cuda.synchronize()
    scale = float(true.abs().max())
    err_dec = float((dec - true).abs().max()) / scale
    err_fwd = float((fwd - true).abs().max()) / scale
    bound = max(limit, 1.25 * err_fwd)
    out = dict(what=what, batch=tok.shape[0], prompt=s0, s_max=tok.shape[1],
               layers=cfg.n_layers, forward_chunk=chunk,
               rel_err=float((dec - fwd).abs().max()) / float(
                   fwd.abs().max()), limit=limit,
               decode_vs_f32=err_dec, forward_vs_f32=err_fwd,
               decode_bound=bound, max_abs_logit_f32=scale,
               argmax_equal=float((dec.argmax(-1) == fwd.argmax(-1)).float()
                                  .mean()),
               seconds=time.perf_counter() - t0)
    emit(phase, **out)
    check(bool(torch.isfinite(dec).all()), f"{what}: decode logits not "
          "finite")
    check(err_dec <= bound, f"{what}: decode {err_dec} of max |logit| from "
          f"the f32 forward, the bf16 forward {err_fwd} (bound {bound})")
    return out


def greedy_vs_forward(torch, cfg, model, prompts, limit: float,
                      phase: str) -> None:
    """Each greedy token of ``serve.generate`` against the forward's argmax
    on the prompt and the tokens fed back, unless its top-2 gap is under
    ``limit`` of the largest |logit| (or, for a MoE config, its sequence
    was routed otherwise, as ``decode_vs_forward`` sets apart)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    plen = prompts.shape[1]
    with RouteRecorder() as rec:
        out = serve.generate(cfg, model, prompts, SERVE_LM_GEN)
        with torch.no_grad():
            seq = torch.cat([prompts, out[:, :SERVE_LM_GEN]], dim=1)
            h, _, _ = lm.forward(cfg, model, seq)
            fwd = lm.mask_padded_logits(cfg, lm._head_out(
                cfg, model, h[:, plen - 1:])).float()
    top2 = fwd.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / float(fwd.abs().max())
    differ = fwd.argmax(-1) != out.long()
    held = torch.ones_like(differ)
    if cfg.uses_moe:     # as in decode_vs_forward
        parted, _ = routes_parted(torch, cfg, rec.calls, seq.shape[0], plen,
                                  seq.shape[1])
        held = ~parted[:, plen - 1:]
    bad = int((differ & (gap >= limit) & held).sum())
    emit(phase, what="greedy", arch=cfg.name, tokens=out.tolist(),
         differ=int(differ.sum()), differ_over_limit=bad,
         rows_routed_otherwise=int((~held).sum()),
         min_gap=float(gap.min()))
    check(bad == 0, f"{cfg.name}: {bad} greedy tokens part from the "
          "forward's argmax by more than the limit")


def phase_lm_serve(torch, np, card: dict, model) -> dict:
    """Serving the LM on the card: ``launch/serve.main`` at its defaults
    on the ``lm`` phase's gemma-2b (full width and depth), then teacher-
    forced decode against the train-mode forward (bf16 at full depth, the
    flash-decoding path at 2 048 slots, gemma2-9b at full width past its
    window, f32 at full width), and each greedy token against the
    forward's argmax.  The launch counts are set to 0 before the serving
    paths and read after: these paths reach no kernel of the port."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import attention, lm

    dev = next(model.parameters()).device
    cfg = model.cfg
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    flash_calls = []
    flash = attention._decode_attend_blockwise

    def counted(*a, **kw):
        flash_calls.append(a[2].shape[1])
        return flash(*a, **kw)

    attention._decode_attend_blockwise = counted
    try:
        # 1. the launcher at its defaults, twice (the first call pays the
        # card's first launches of these shapes)
        reps = [serve.main([], model=model) for _ in range(2)]
        emit("lm_serve", what="serve.main", arch=cfg.name, smi=card["smi"],
             reports=reps, tok_per_s=[r["tok_per_s"] for r in reps])
        for r in reps:
            check(r["requests"] == 8 and r["tokens"] == 8 * SERVE_LM_GEN,
                  f"serve.main served {r}")

        gen = torch.Generator(device=dev).manual_seed(0)
        s_tot = SERVE_LM_PROMPT + SERVE_LM_GEN
        res = {}

        # 2. teacher-forced decode against the forward, bf16, full depth
        tok = torch.randint(0, cfg.vocab_size, (SERVE_LM_BATCH, s_tot),
                            generator=gen, device=dev, dtype=torch.int32)
        res["bf16"] = decode_vs_forward(torch, cfg, model, tok,
                                        SERVE_LM_PROMPT, SERVE_LM_BF16_LIMIT,
                                        "gemma-2b bf16")

        # 3. each greedy token against the forward's argmax
        greedy_vs_forward(torch, cfg, model, tok[:, :SERVE_LM_PROMPT],
                          SERVE_LM_BF16_LIMIT, "lm_serve")

        # 4. flash-decoding: a 2 032-token prompt, 2 048 slots
        n_flash = len(flash_calls)
        tok = torch.randint(0, cfg.vocab_size, (SERVE_G2_BATCH,
                                                SERVE_FLASH_PROMPT
                                                + SERVE_LM_GEN),
                            generator=gen, device=dev, dtype=torch.int32)
        res["flash"] = decode_vs_forward(torch, cfg, model, tok,
                                         SERVE_FLASH_PROMPT,
                                         SERVE_LM_BF16_LIMIT,
                                         "gemma-2b bf16 flash-decoding")
        want = SERVE_LM_GEN * cfg.n_layers
        check(len(flash_calls) - n_flash == want, f"flash-decoding ran "
              f"{len(flash_calls) - n_flash} times, not {want}")
        del tok
        gc.collect()
        torch.cuda.empty_cache()

        # 5. gemma2-9b at full width, one (local, global) super-block: the
        # ring wraps inside the window, the global layer flash-decodes.
        # The threshold is the cache length, so the 5 104-token prompt
        # prefills dense (the blockwise prefill needs a multiple of
        # flash_block_q) and the 5 120-slot cache flash-decodes.
        s_g2 = SERVE_G2_PROMPT + SERVE_LM_GEN
        g2cfg = get_config("gemma2-9b").replace(n_layers=2, n_superblocks=1,
                                                flash_threshold=s_g2)
        g2 = lm.init_lm(g2cfg, torch.Generator(device=dev).manual_seed(0),
                        dev)
        tok = torch.randint(0, g2cfg.vocab_size, (SERVE_G2_BATCH, s_g2),
                            generator=gen, device=dev, dtype=torch.int32)
        n_flash = len(flash_calls)
        res["gemma2"] = decode_vs_forward(torch, g2cfg, g2, tok,
                                          SERVE_G2_PROMPT,
                                          SERVE_LM_BF16_LIMIT,
                                          "gemma2-9b bf16, 1 super-block")
        check(len(flash_calls) - n_flash == SERVE_LM_GEN and set(
            flash_calls[n_flash:]) == {s_g2}, "gemma2-9b's global layer "
              "did not flash-decode its 5 120-slot cache at every step")
        del g2, tok
        gc.collect()
        torch.cuda.empty_cache()

        # 6. f32 at full width, 2 layers
        f32cfg = get_config("gemma-2b").replace(
            n_layers=SERVE_F32_LAYERS, n_superblocks=SERVE_F32_LAYERS,
            param_dtype="float32")
        f32 = lm.init_lm(f32cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
        tok = torch.randint(0, f32cfg.vocab_size, (SERVE_LM_BATCH, s_tot),
                            generator=gen, device=dev, dtype=torch.int32)
        res["f32"] = decode_vs_forward(torch, f32cfg, f32, tok,
                                       SERVE_LM_PROMPT, SERVE_LM_F32_LIMIT,
                                       "gemma-2b f32, 2 layers")
        del f32, tok
    finally:
        attention._decode_attend_blockwise = flash
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    emit("lm_serve", what="phase", launches=counts,
         flash_decode_calls=len(flash_calls),
         seconds=time.perf_counter() - t_phase)
    check(not any(counts.values()), f"the serving paths launched {counts}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_lm_optim(torch, np) -> dict:
    """The LM training options at gemma-2b's full width, cut to 2 layers,
    4 x 128 tokens a step: AdamW (clip 1.0, ``exponential_decay``), each
    update of three leaves held against an f64 recomputation from the
    step's gradients and slots; then EF-TopK compressed SGD, each leaf's
    compression held to its definition.  The launch counts are set to 0
    before and read after: these paths reach no kernel of the port."""
    import gc

    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw, exponential_decay, sgd
    from repro_torch.train import compression as comp
    from repro_torch.train.steps import (init_compression_state,
                                         lm_train_step_fn, make_lm_train_step,
                                         reference_leaves)

    dev = torch.device("cuda")
    cfg = resilience_lm_config()
    t_phase = time.perf_counter()
    stream = TokenStream(seed=0, batch_per_shard=OPTIM_BATCH[0],
                         seq_len=OPTIM_BATCH[1], vocab=cfg.vocab_size,
                         n_shards=1, device=dev)
    ops.reset_launch_counts()

    def batch(step):
        b = dict(stream.batch(step))
        b["weights"] = torch.full((OPTIM_BATCH[0],), 1.0 / OPTIM_BATCH[0],
                                  device=dev)
        return b

    # 1. AdamW under exponential decay, clip 1.0
    model = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    named = dict(model.named_parameters())
    sched = exponential_decay(OPTIM_LR, 2)
    opt = adamw(model.parameters(), sched)
    g0 = opt.param_groups[0]
    b1, b2, eps, wd = g0["b1"], g0["b2"], g0["eps"], g0["weight_decay"]
    step_fn = lm_train_step_fn(cfg, model, opt)
    adam = []
    for t in range(OPTIM_ADAMW_STEPS):
        before = {}
        for name in OPTIM_LEAVES:
            p = named[name]
            st = opt.state[p]
            zero = torch.zeros(p.shape, dtype=torch.float64, device=dev)
            before[name] = (p.detach().double(),
                            st["m"].double() if "m" in st else zero,
                            st["v"].double() if "v" in st else zero)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(batch(t))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        norm = float(torch.sqrt(sum(p.grad.double().square().sum()
                                    for p in named.values())))
        scale = min(1.0, 1.0 / max(norm, 1e-12))
        lr_t, n = sched(t), t + 1
        errs = {}
        for name in OPTIM_LEAVES:
            p = named[name]
            p0, m0, v0 = before[name]
            g = p.grad.double() * scale
            m = b1 * m0 + (1 - b1) * g
            v = b2 * v0 + (1 - b2) * g.square()
            d = (m / (1 - b1 ** n)) / (torch.sqrt(v / (1 - b2 ** n)) + eps)
            upd = -lr_t * (d + wd * p0)
            want = p0 + upd
            # two roundings (the update, then the sum), each at most half
            # an ulp: 2^-8 of a bf16 value
            room = (2.0 ** -7 if p.dtype == torch.bfloat16 else 1e-5) * (
                want.abs() + upd.abs())
            miss = ((p.detach().double() - want).abs() / room).max()
            st = opt.state[p]
            errs[name] = dict(
                dtype=str(p.dtype).split(".")[1],
                param_over_room=float(miss),
                m_rel=float((st["m"].double() - m).abs().max()
                            / m.abs().max()),
                v_rel=float((st["v"].double() - v).abs().max()
                            / v.abs().max()))
        adam.append(dict(step=t, loss=float(metrics["loss"]),
                         grad_norm=norm, clip_scale=scale, lr=lr_t,
                         seconds=seconds, leaves=errs))
        emit("lm_optim", what="adamw", **adam[-1])
        check(np.isfinite(adam[-1]["loss"]), "an AdamW step's loss is not "
              "finite")
        for name, e in errs.items():
            check(e["param_over_room"] <= 1.0, f"AdamW step {t}, {name}: "
                  f"{e['param_over_room']} of its rounding room off f64")
            check(e["m_rel"] <= 1e-5 and e["v_rel"] <= 1e-5,
                  f"AdamW step {t}, {name}: slots off f64 by {e}")
    del opt, step_fn, before, model, named
    gc.collect()
    torch.cuda.empty_cache()

    # 2. EF-TopK compressed SGD
    model = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    named = dict(model.named_parameters())
    leaves = reference_leaves(named)
    opt = sgd(model.parameters(), OPTIM_LR)
    step_fn = make_lm_train_step(cfg, model, opt, compress_frac=OPTIM_FRAC)
    cs = init_compression_state(model)
    compressed = []
    for t in range(OPTIM_COMPRESSED_STEPS):
        r_old = {k: r.clone() for k, r in cs.residual.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, cs = step_fn(batch(OPTIM_ADAMW_STEPS + t), cs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        bad = []
        kept = 0
        for key, names in leaves.items():
            g = torch.stack([named[n].grad for n in names]) if (
                key.startswith("blocks.")) else named[names[0]].grad
            acc = g.float() + r_old[key]
            dense, _, _ = comp.topk_sparsify(acc, OPTIM_FRAC)
            k = max(int(acc.numel() * OPTIM_FRAC), 1)
            resid = cs.residual[key]
            # the first k of a stable descending sort of |acc|, against
            # the support of what the step kept
            first = torch.sort(acc.abs().reshape(-1), descending=True,
                               stable=True).indices[:k]
            support = (dense != 0).reshape(-1).nonzero().squeeze(1)
            ok = (torch.equal(acc - dense, resid)
                  and torch.equal(dense + resid, acc)
                  and support.numel() == k
                  and torch.equal(support, torch.sort(first).values))
            kept += k
            if not ok:
                bad.append(key)
            del g, acc, dense, first, support
        compressed.append(dict(step=t, loss=float(metrics["loss"]),
                               leaves=len(leaves), kept=kept,
                               seconds=seconds, failed=bad))
        emit("lm_optim", what="ef-topk", frac=OPTIM_FRAC, **compressed[-1])
        check(not bad, f"EF-TopK step {t}: leaves {bad} break dense + "
              "residual == acc, nnz == k or the stable top-k set")
        check(np.isfinite(compressed[-1]["loss"]), "a compressed step's "
              "loss is not finite")
    counts = ops.launch_counts()
    del model, named, opt, step_fn, cs, r_old
    gc.collect()
    torch.cuda.empty_cache()
    emit("lm_optim", what="phase", launches=counts,
         seconds=time.perf_counter() - t_phase)
    check(not any(counts.values()), f"the optimizer paths launched {counts}")
    return {"adamw": adam, "ef-topk": compressed}


def opened(cfg):
    """``cfg`` with the MoE capacity opened for decode against the forward:
    capacity factor E / k, so a group's capacity is its token count and no
    assignment can be dropped in the train-mode forward (the reference's
    own test opens it to 8.0, which does that only where E / k <= 8; at
    qwen3-moe's 128 / 8 a 48-token sequence keeps 24 an expert)."""
    m = cfg.moe
    return cfg.replace(moe=replace(m, capacity_factor=m.n_experts / m.top_k))


def lm_driver(torch, np, phase: str, path: str, cfg, argv) -> dict:
    """``launch/train.main(argv)`` on a fresh ``lm.init_lm(cfg)`` through
    the ``model`` seam, the launch counts set to 0 just before and read
    just after: finite losses, ``hidden_grad_tc`` once a candidate and
    selection, the FFMA ``hidden_grad`` never, ``corr`` and
    ``corr_argmax`` launched, each selection's weights summing to 1."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import lm

    args = train.build_argparser().parse_args(argv)
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    resident_before = torch.cuda.memory_allocated()
    model = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = train.main(argv, model=model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    n_sel = -(-args.steps // args.select_every)
    emit(phase, path=path, arch=cfg.name, layers=cfg.n_layers,
         params=rep["params"], steps=rep["steps"],
         micro_batch=args.micro_batch, seq_len=args.seq_len,
         window=args.window, selections=n_sel, wall_seconds=rep["wall_s"],
         selection_seconds=rep["selection_s"], main_seconds=seconds,
         loss_first=rep["loss_first"], loss_last=rep["loss_last"],
         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         resident_before_gb=resident_before / 1e9, launches=counts,
         picks=rep["selections"])
    check(all(np.isfinite(rep["losses"])), f"a {cfg.name} step's loss is "
          "not finite")
    check(counts["hidden_grad_tc"] == args.window * n_sel,
          f"{path}: hidden_grad_tc launched {counts['hidden_grad_tc']} "
          f"times, not {args.window * n_sel}")
    check(counts["hidden_grad"] == 0, f"the FFMA hidden_grad launched "
          f"{counts['hidden_grad']} times on the {path} path")
    for name in ("corr", "corr_argmax"):
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              f"{path} path")
    for sel in rep["selections"]:
        check(len(sel["indices"]) > 0 and abs(sum(sel["weights"]) - 1)
              < 1e-4, f"selection {sel} is empty or its weights do not sum "
              "to 1")
    return {"model": model, "args": args, "rep": rep,
            "run": {"counts": {path: counts}, "shapes": {path: shapes},
                    "selection_seconds": {path: rep["selection_s"]}}}


def hold_untied_head(torch, card: dict, records: dict, phase: str,
                     path: str, cfg, model, cand) -> dict:
    """``hidden_grad_tc`` on a real candidate of an untied head (W =
    ``lm_head`` (d, V), contiguous): the path's route, against the plain
    version within ``LM_HG_LIMIT`` of max |out|, the same bits twice,
    timed beside the plain version and cuBLAS's f32 product of the
    materialised residual; the record of ``path``."""
    from repro_torch.kernels import lastlayer_grad as llg_k
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    bw, _ = peaks(card["name"])
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, model, cand["tokens"])
        logits = lm._head_out(cfg, model, h)
    del h
    z = logits.reshape(-1, logits.shape[-1])
    y = cand["targets"].reshape(-1)
    w = lm.head_weight(cfg, model).detach()
    n, v = z.shape
    dh = w.shape[0]
    check(not cfg.tie_embeddings and w.is_contiguous(),
          f"{cfg.name}'s head is not an untied contiguous (d, V) matrix")
    check(llg_k.takes_tensor_cores(z.dtype, w.dtype, n, v, dh, False,
                                   z.data_ptr(), w.data_ptr()),
          f"the {path} path's hidden_grad call is not routed to the tensor "
          "cores")
    before = dict(llg_k.launches)
    got = llg_k.hidden_grad_fused(z, y, w)
    again = llg_k.hidden_grad_fused(z, y, w)
    check(llg_k.launches["hidden_grad_tc"] == before["hidden_grad_tc"] + 2
          and llg_k.launches["hidden_grad"] == before["hidden_grad"],
          f"the {path} head did not go to hidden_grad_tc")
    want = ref.hidden_grad_ref(z, y, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    same_bits = bool(torch.equal(got, again))
    del got, again, want
    ms = device_ms(torch, lambda: llg_k.hidden_grad_fused(z, y, w), reps=10,
                   warmup=2)
    plain = device_ms(torch, lambda: ref.hidden_grad_ref(z, y, w), reps=10,
                      warmup=2)
    resid = torch.softmax(z.float(), dim=-1)
    resid[torch.arange(n, device=z.device), y.long()] -= 1.0
    wt32 = w.T.float().contiguous()
    lib_ms = device_ms(torch, lambda: torch.mm(resid, wt32), reps=10,
                       warmup=2)
    del resid, wt32
    nbytes = n * v * z.element_size() + v * dh * w.element_size() + (
        4 * n * dh + y.element_size() * n)
    by_bytes = nbytes / bw * 1e3
    bound = max(by_bytes, 2 * 2 * n * v * dh / bf16_peak(card["name"])
                * 1e3)
    by = "bytes" if by_bytes >= bound else "operations"
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
               bound_by=by, library_ms=lib_ms, shape=[n, v, dh])
    emit("kernels", kernel="hidden_grad_tc", path=path, dtype="bfloat16",
         layout="lm_head (untied head)", max_abs_out=scale,
         rel_err=err / scale, limit=LM_HG_LIMIT, same_bits=same_bits,
         **{k: rec[k] for k in rec if k != "max_abs_err"}, max_abs_err=err)
    check(err <= LM_HG_LIMIT * scale, f"hidden_grad_tc vs plain at ({n}, "
          f"{v}, {dh}): max err {err}, max |out| {scale}")
    check(same_bits, f"hidden_grad_tc gave other bits on a second call at "
          f"({n}, {v}, {dh})")
    records["hidden_grad_tc"][path] = rec
    return rec


def weighted_steps_repeat(torch, cfg, model, batch, lr: float) -> dict:
    """Two weighted SGD steps (momentum 0.9, remat as configured) on
    ``batch`` from the model's parameters, run twice from the same start:
    the losses and every parameter must come out with the same bits.  The
    parameters are put back afterwards."""
    from repro_torch.optim import sgd
    from repro_torch.train.steps import lm_train_step_fn

    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    first, differ, losses = None, [], []
    for run in range(2):
        with torch.no_grad():
            for p, s0 in zip(params, start):
                p.copy_(s0)
        opt = sgd(params, lr, momentum=0.9)
        step = lm_train_step_fn(cfg, model, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_losses = [float(step(batch)["loss"]) for _ in range(2)]
        torch.cuda.synchronize()
        losses.append(dict(losses=run_losses,
                           seconds=time.perf_counter() - t0))
        if first is None:
            first = [p.detach().clone() for p in params]
        else:
            differ = [i for i, (p, q) in enumerate(zip(params, first))
                      if not torch.equal(p, q)]
        del opt, step
    with torch.no_grad():
        for p, s0 in zip(params, start):
            p.copy_(s0)
    same = not differ and losses[0]["losses"] == losses[1]["losses"]
    del start, first
    return dict(runs=losses, parameters=len(params),
                parameters_differing=len(differ), same_bits=same)


def capacity_drops(torch, cfg, model, tokens) -> dict:
    """The share of (token, slot) assignments dropped at capacity in layer
    0 on ``tokens``: that layer's MoE input caught during a train-mode
    forward, routed and dispatched again (``_route``,
    ``_dispatch_indices``)."""
    import torch.nn.functional as F

    from repro_torch.models import lm, moe

    seen = []
    apply = moe.moe_apply

    def first_input(c, p, x, group="seq"):
        if not seen:
            seen.append(x.detach())
        return apply(c, p, x, group=group)

    moe.moe_apply = first_input
    try:
        with torch.no_grad():
            lm.forward(cfg, model, tokens)
    finally:
        moe.moe_apply = apply
    x = seen[0]
    g, t, _ = x.shape
    m = cfg.moe
    cap = moe.capacity_of(cfg, t)
    router = model["blocks"][0]["sub0"]["mlp"]["router"]
    with torch.no_grad():
        ids, w, _ = moe._route(cfg, router, x)
    kept = sum(int((moe._dispatch_indices(ids[i], w[i], m.n_experts, cap)[0]
                    < t).sum()) for i in range(g))
    total = g * t * m.top_k
    load = F.one_hot(ids, m.n_experts).sum(dim=(1, 2))        # (G, E)
    return dict(layer=0, groups=g, group_tokens=t, capacity=cap,
                assignments=total, dropped=total - kept,
                dropped_share=(total - kept) / total,
                max_expert_load=int(load.max()),
                experts_unused=int((load == 0).sum()))


def phase_lm_moe(torch, np, card: dict, records: dict) -> dict:
    """MoE through the port's LM entry points on the card.  The driver
    (``train.main``, ``MOE_ARGV``) on qwen3-moe-30b-a3b at its published
    widths cut to ``MOE_TRAIN_LAYERS`` layers; ``hidden_grad_tc`` on a real
    candidate of its untied head; one selection with the kernels and one
    with the plain versions, ``corr`` / ``corr_argmax`` at the path's
    shapes; two weighted steps repeated bit for bit; the capacity drops of
    layer 0.  Then ``serve.main`` at its defaults on qwen3-moe at full
    width and depth, teacher-forced decode against the train-mode forward
    (capacity opened, ``opened``) with each greedy token against
    the forward's argmax (at bf16 the rows whose sequence decode routed
    otherwise are set apart: ``decode_vs_forward``), the same at f32 cut
    as the driver is (within 1e-5), and moonshot-v1-16b-a3b at full width
    cut to ``MOONSHOT_LAYERS`` layers, the bf16 decode check.  The
    serving paths reach no kernel of the port: their launch counts must
    stay 0."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.common import count_params
    from repro_torch.train.steps import make_lm_proxy_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config(MOE_ARCH)
    cfg = full.replace(n_layers=MOE_TRAIN_LAYERS,
                       n_superblocks=MOE_TRAIN_LAYERS)
    drv = lm_driver(torch, np, "lm_moe", "lm_moe", cfg, MOE_ARGV)
    model, args = drv["model"], drv["args"]
    stream = TokenStream(seed=args.seed, batch_per_shard=args.micro_batch,
                         seq_len=args.seq_len, vocab=cfg.vocab_size,
                         n_shards=args.window, device=dev)
    last_round = (args.steps - 1) // args.select_every
    cand = stream.batch(last_round, 0)
    head = hold_untied_head(torch, card, records, "lm_moe", "lm_moe", cfg,
                            model, cand)
    lm_select_and_omp(torch, card, records, "lm_moe", "lm_moe",
                      make_lm_proxy_step(cfg, model), stream, args,
                      last_round)
    batch = dict(cand)
    batch["weights"] = torch.full((args.micro_batch,),
                                  1.0 / args.micro_batch, device=dev)
    det = weighted_steps_repeat(torch, cfg, model, batch, args.lr)
    drops = capacity_drops(torch, cfg, model, cand["tokens"])
    emit("lm_moe", what="determinism", **det)
    emit("lm_moe", what="capacity", arch=cfg.name, **drops)
    check(det["same_bits"], f"two weighted MoE steps from the same start "
          f"gave other bits: {det}")
    run = drv["run"]
    del model, drv, batch, cand, stream
    gc.collect()
    torch.cuda.empty_cache()

    # serving: qwen3-moe at full width and depth
    ops.reset_launch_counts()
    scfg = full.replace(n_layers=MOE_SERVE_LAYERS,
                        n_superblocks=MOE_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(scfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(model)
    r = serve.main(["--arch", MOE_ARCH], model=model)
    emit("lm_moe", what="serve.main", arch=scfg.name, layers=scfg.n_layers,
         params=n_params, init_seconds=init_s, smi=card["smi"], report=r,
         tok_per_s=r["tok_per_s"],
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(r["requests"] == 8 and r["tokens"] == 8 * SERVE_LM_GEN,
          f"serve.main served {r}")
    ocfg = opened(scfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    s_tot = SERVE_LM_PROMPT + SERVE_LM_GEN
    tok = torch.randint(0, scfg.vocab_size, (SERVE_LM_BATCH, s_tot),
                        generator=gen, device=dev, dtype=torch.int32)
    res = {"qwen3": decode_vs_forward(
        torch, ocfg, model, tok, SERVE_LM_PROMPT, SERVE_LM_BF16_LIMIT,
        f"{MOE_ARCH} bf16, {scfg.n_layers} layers, capacity factor "
        f"{ocfg.moe.capacity_factor}", phase="lm_moe")}
    greedy_vs_forward(torch, ocfg, model, tok[:, :SERVE_LM_PROMPT],
                      SERVE_LM_BF16_LIMIT, "lm_moe")
    res["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, tok
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at full width, cut as the driver is
    fcfg = opened(cfg.replace(param_dtype="float32"))
    model = lm.init_lm(fcfg, torch.Generator(device=dev).manual_seed(0), dev)
    tok = torch.randint(0, fcfg.vocab_size, (SERVE_LM_BATCH, s_tot),
                        generator=gen, device=dev, dtype=torch.int32)
    res["f32"] = decode_vs_forward(
        torch, fcfg, model, tok, SERVE_LM_PROMPT, SERVE_LM_F32_LIMIT,
        f"{MOE_ARCH} f32, {fcfg.n_layers} layers", phase="lm_moe")
    del model, tok
    gc.collect()
    torch.cuda.empty_cache()

    # moonshot: 64 experts, top-6, two shared experts; 2 layers
    mcfg = opened(get_config("moonshot-v1-16b-a3b").replace(
        n_layers=MOONSHOT_LAYERS, n_superblocks=MOONSHOT_LAYERS))
    model = lm.init_lm(mcfg, torch.Generator(device=dev).manual_seed(0), dev)
    tok = torch.randint(0, mcfg.vocab_size, (SERVE_LM_BATCH, s_tot),
                        generator=gen, device=dev, dtype=torch.int32)
    res["moonshot"] = decode_vs_forward(
        torch, mcfg, model, tok, SERVE_LM_PROMPT, SERVE_LM_BF16_LIMIT,
        f"moonshot-v1-16b-a3b bf16, {MOONSHOT_LAYERS} layers, capacity "
        f"factor {mcfg.moe.capacity_factor:.3f}", phase="lm_moe")
    del model, tok
    counts = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    emit("lm_moe", what="phase", serve_launches=counts,
         seconds=time.perf_counter() - t_phase)
    check(not any(counts.values()), f"the MoE serving paths launched "
          f"{counts}")
    return {**run, "head": head, "decode": res}


def phase_lm_hybrid(torch, np, card: dict, records: dict) -> dict:
    """The Mamba2 hybrid through the port's LM entry points on the card.
    The driver (``train.main``, ``HYBRID_ARGV``) on zamba2-7b at its
    published widths cut to its 3 prologue layers and
    ``HYBRID_TRAIN_SUPERBLOCKS`` super-block; ``hidden_grad_tc`` on a real
    candidate of its untied head; one selection with the kernels and one
    with the plain versions, ``corr`` / ``corr_argmax`` at the path's
    shapes; two weighted steps repeated bit for bit.  Then at full depth
    (81 layers) ``serve.main`` at its defaults and teacher-forced decode
    against the train-mode forward at batch ``HYBRID_BATCH``, 32 -> 48 and
    512 -> 528 (two SSD chunks in the prefill; the forward over 528 tokens
    takes chunks of ``HYBRID_LONG_CHUNK``), each held against the f32
    forward of the same weights (``decode_vs_f32``), with each
    super-block's shared block cache written by decode; and at f32, cut as
    the driver is, 32 -> 48 within 1e-5.  The serving paths reach no
    kernel of the port."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.common import count_params
    from repro_torch.train.steps import make_lm_proxy_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config(HYBRID_ARCH)
    cut = dict(n_superblocks=HYBRID_TRAIN_SUPERBLOCKS,
               n_layers=len(full.prologue)
               + len(full.layer_pattern) * HYBRID_TRAIN_SUPERBLOCKS)
    cfg = full.replace(**cut)
    drv = lm_driver(torch, np, "lm_hybrid", "lm_hybrid", cfg, HYBRID_ARGV)
    model, args = drv["model"], drv["args"]
    stream = TokenStream(seed=args.seed, batch_per_shard=args.micro_batch,
                         seq_len=args.seq_len, vocab=cfg.vocab_size,
                         n_shards=args.window, device=dev)
    last_round = (args.steps - 1) // args.select_every
    cand = stream.batch(last_round, 0)
    head = hold_untied_head(torch, card, records, "lm_hybrid", "lm_hybrid",
                            cfg, model, cand)
    lm_select_and_omp(torch, card, records, "lm_hybrid", "lm_hybrid",
                      make_lm_proxy_step(cfg, model), stream, args,
                      last_round)
    batch = dict(cand)
    batch["weights"] = torch.full((args.micro_batch,),
                                  1.0 / args.micro_batch, device=dev)
    det = weighted_steps_repeat(torch, cfg, model, batch, args.lr)
    emit("lm_hybrid", what="determinism", **det)
    check(det["same_bits"], f"two weighted hybrid steps from the same "
          f"start gave other bits: {det}")
    run = drv["run"]
    del model, drv, batch, cand, stream
    gc.collect()
    torch.cuda.empty_cache()

    # serving at full depth
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(full, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(model)
    r = serve.main(["--arch", HYBRID_ARCH], model=model)
    emit("lm_hybrid", what="serve.main", arch=full.name,
         layers=full.n_layers, params=n_params, init_seconds=init_s,
         smi=card["smi"], report=r, tok_per_s=r["tok_per_s"],
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(r["requests"] == 8 and r["tokens"] == 8 * SERVE_LM_GEN,
          f"serve.main served {r}")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    written = {}

    def shared_caches(s0, s_max):
        def look(state):
            blocks = state["blocks"]
            si = full.layer_pattern.index("shared_attn")
            rows = [float(b[f"sub{si}"]["k"][:, s0:s_max].float().abs()
                          .amax()) for b in blocks]
            ssd = [bool(torch.isfinite(b["sub0"]["ssd"]).all())
                   for b in blocks]
            written[s0] = dict(caches=len(rows),
                               min_max_abs_k=min(rows),
                               ssd_finite=all(ssd))
        return look

    # the same weights at f32: the forward the bf16 runs are held to
    f32_full = full.replace(param_dtype="float32")
    model32 = copy.deepcopy(model).float()
    for s0 in (SERVE_LM_PROMPT, HYBRID_LONG_PROMPT):
        s_tot = s0 + SERVE_LM_GEN
        tok = torch.randint(0, full.vocab_size, (HYBRID_BATCH, s_tot),
                            generator=gen, device=dev, dtype=torch.int32)
        chunk = (HYBRID_LONG_CHUNK if s_tot % min(full.ssm.chunk, s_tot)
                 else full.ssm.chunk)
        res[s0] = decode_vs_f32(
            torch, full, model, f32_full, model32, tok, s0,
            HYBRID_BF16_LIMIT,
            f"{HYBRID_ARCH} bf16, {full.n_layers} layers, {s0} -> {s_tot}",
            "lm_hybrid", chunk, shared_caches(s0, s_tot))
        del tok
    del model32
    emit("lm_hybrid", what="shared caches written by decode", **{
        str(k): v for k, v in written.items()})
    for s0, w in written.items():
        check(w["caches"] == full.n_superblocks and w["min_max_abs_k"] > 0
              and w["ssd_finite"], f"decode from {s0}: the shared block's "
              f"caches were not all written, or a Mamba2 state is not "
              f"finite: {w}")
    gen_tok = torch.randint(0, full.vocab_size,
                            (HYBRID_BATCH, SERVE_LM_PROMPT), generator=gen,
                            device=dev, dtype=torch.int32)
    greedy_vs_forward(torch, full, model, gen_tok, HYBRID_BF16_LIMIT,
                      "lm_hybrid")
    res["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, gen_tok
    gc.collect()
    torch.cuda.empty_cache()

    # f32, cut as the driver is
    f32 = full.replace(param_dtype="float32", **cut)
    model = lm.init_lm(f32, torch.Generator(device=dev).manual_seed(0), dev)
    tok = torch.randint(0, f32.vocab_size,
                        (HYBRID_BATCH, SERVE_LM_PROMPT + SERVE_LM_GEN),
                        generator=gen, device=dev, dtype=torch.int32)
    res["f32"] = decode_vs_forward(
        torch, f32, model, tok, SERVE_LM_PROMPT, SERVE_LM_F32_LIMIT,
        f"{HYBRID_ARCH} f32, {f32.n_layers} layers", phase="lm_hybrid")
    del model, tok
    counts = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    emit("lm_hybrid", what="phase", serve_launches=counts,
         seconds=time.perf_counter() - t_phase)
    check(not any(counts.values()), f"the hybrid serving paths launched "
          f"{counts}")
    return {**run, "head": head, "decode": res}


def kernels_line(torch, records: dict, runs) -> list:
    """The ``kernels`` line from the paths' runs (each a dict of counts,
    shapes, routes and selection seconds): every kernel a path launched,
    at a shape the kernels phases measured; and a ``share`` line a path,
    the share of its selection seconds spent in the kernels."""
    counts = {p: c for r in runs for p, c in r["counts"].items()}
    shapes = {p: c for r in runs for p, c in r["shapes"].items()}
    routes = {p: c for r in runs for p, c in r.get("routes", {}).items()}
    selection_seconds = {p: c for r in runs
                         for p, c in r["selection_seconds"].items()}
    kernels = []
    kernel_s = {path: 0.0 for path in counts}

    def measured(r):
        """What a record was measured at, as ``ran_at`` gives a launch."""
        return (tuple(r["shape"]), r.get("per_problem", False))

    for name, (source, replaces) in KERNEL_SOURCES.items():
        # The top-level numbers are those at MAIN_PATH's shape; "paths"
        # holds each path that launched the kernel, with its launches and
        # the numbers at the shape that path gives it.
        paths = {}
        for path, c in counts.items():
            if c[name] == 0:
                continue
            rec = records[name].get(path)
            check(rec is not None, f"{name} launched on {path} at a shape "
                  "the kernels phase did not measure")
            # a path that runs a kernel at several shapes (the streaming
            # partitions' arenas) has a record for each: the first gives
            # the top-level numbers, "at_shapes" each with its launches
            recs = rec if isinstance(rec, list) else [rec]
            rec = recs[0]
            paths[path] = {"launches": c[name], **rec}
            # this kernel's launches on this path by (shape, per-problem)
            at = {}
            for key, n in shapes[path].items():
                if key[0] == name:
                    at[ran_at(key)] = at.get(ran_at(key), 0) + n
            if len(recs) > 1:
                paths[path]["at_shapes"] = [
                    {"launches": at.get(measured(r), 0), **r} for r in recs]
                check(sum(e["launches"] for e in paths[path]["at_shapes"])
                      == c[name], f"{name} on {path}: launches at measured "
                      f"shapes do not add up to {c[name]}")
            by_route = {k.split("/")[1]: v
                        for k, v in routes.get(path, {}).items()
                        if k.startswith(name + "/")}
            if by_route:
                paths[path]["launches_by_route"] = by_route
            for ran in at:
                # a batched kernel's key adds (B, per-problem matrix): it
                # is measured at its B, on a shared pool unless the record
                # says per-problem
                check(name == "corr"
                      or any(measured(r) == ran for r in recs),
                      f"{name} ran at {list(ran[0])} (per-problem: "
                      f"{ran[1]}) on {path}, measured at "
                      f"{[measured(r) for r in recs]}")
            if name == "corr":
                continue
            if len(recs) > 1:
                kernel_s[path] += sum(e["launches"] * e["ms"] / 1e3
                                      for e in paths[path]["at_shapes"])
            else:
                kernel_s[path] += c[name] * rec["ms"] / 1e3
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(p["launches"]
                                        for p in paths.values()),
                        **records[name][MAIN_PATH[name]], "paths": paths})
    # Share of each path's selection seconds spent in the kernels: launches
    # times each kernel's device time at that path's shape, and for corr,
    # which a path calls at many shapes, the launches at each shape times
    # the time measured at that shape.
    for path in counts:
        corr_s, by_shape = corr_seconds(torch, shapes[path])
        check(sum(e["launches"] for e in by_shape) == counts[path]["corr"],
              f"{path}: corr launches by shape do not add up")
        kernel_s[path] += corr_s
        emit("share", path=path, kernel_seconds=kernel_s[path],
             corr_seconds=corr_s, corr_by_shape=by_shape,
             selection_seconds=selection_seconds[path],
             kernel_share=kernel_s[path] / selection_seconds[path])
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs a card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import repro_torch  # noqa: F401  (turns TF32 off)

    t_start = time.perf_counter()
    phase_s = {}

    def run(name, fn, *args):
        """Run one phase; its wall seconds go into the "done" line."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    card = run("device", phase_device, torch)
    run("build", phase_build)
    records = run("kernels", phase_kernels, torch, np, card)
    run("kernels_fl", phase_kernels_fl, torch, np, card, records)
    run("kernels_stream", phase_kernels_stream, torch, np, card, records)
    run("kernels_batched", phase_kernels_batched, torch, np, card, records)
    tr = run("trainer", phase_trainer, torch, np)
    model, train = tr["model"], tr["train"]
    run("solve", phase_solve, torch, np, model, train)
    run("trace", phase_trace, torch, model, train)
    run("sessions", phase_sessions, torch, np, model, train)
    ba = run("batched", phase_batched, torch, np, model, train)
    cr = run("craig", phase_craig, torch, np, train, tr["val"])
    st = run("stream", phase_stream, torch, np, train, tr["val"])
    pa = run("partition", phase_partition, torch, np, train, tr["val"])
    run("resilience", phase_resilience, torch, np, tr, st["partial"])
    sv = run("serve", phase_serve, torch, np, tr, records)
    run("kernels_serve", phase_kernels_serve, torch, np, card, records, sv)
    lm_ = run("lm", phase_lm, torch, np, card, records)
    run("lm_serve", phase_lm_serve, torch, np, card, lm_.pop("model"))
    run("lm_optim", phase_lm_optim, torch, np)
    mo = run("lm_moe", phase_lm_moe, torch, np, card, records)
    hy = run("lm_hybrid", phase_lm_hybrid, torch, np, card, records)
    runs = (tr, ba, cr, st, pa, sv, lm_, mo, hy)
    kernels = run("kernels_line", kernels_line, torch, records, runs)
    emit("done", seconds=time.perf_counter() - t_start, phases=phase_s)
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
