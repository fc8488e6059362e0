#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # full size: n = 2**24, m = 2**20
    python3 chip_smoke.py --ooc-shift 0   # the streamed cells at full depth too
    python3 chip_smoke.py --shift 2    # n and m divided by 2**2 (a quick run)
    python3 chip_smoke.py --shift 4    # phase 3 at full size, cells in little time
    python3 chip_smoke.py --host-shift 0  # the host cells at full size too
    python3 chip_smoke.py --wide-shift 0  # the wide cell at n = 2**24, m = 2**20
    python3 chip_smoke.py --mutable-shift 0  # the mutable cell at n = 2**24, m = 2**20
    python3 chip_smoke.py --serve-shift 0    # the serve cell's 8192 / 2048 / 1024 requests
    python3 chip_smoke.py --multi-shift 0    # the multi cell at n = 2**24, m = 2**20
    python3 chip_smoke.py --shift 4 --multi-shift 0 --profile multi   # its engines profiled
    python3 chip_smoke.py --lm-shift 0       # the lm cell's corpus at 2**20 pairs
    python3 chip_smoke.py --profile train    # one train step of the train cell profiled

Phases, each printing its own lines:

  1. env      torch / CUDA versions, the card, its name and power limit;
  2. build    nvcc-builds the leaf-scan kernels from src/repro_torch/kernels/
              csrc (build seconds, registers / spills per instance);
  3. kernel   the CUDA leaf scan against its plain torch version on the
              card: the reference's kernel sweep, one case per narrow
              width, pad rows, exact ties (lattice, also at the main-path
              width at k = 10, 18 and 74), heaps in shared memory and in
              the output rows (k = 40, 129, 300), the wide kernel (d = 30,
              130, 300, and 520 in chunks of features; lattices bit for
              bit), every list placement of both kernels bit-identical,
              the indexed form,
              and the main-path shape (W=4096 units, TQ=128, L_pad=4096,
              d=10 unpadded as the main path passes it, k=10), timed beside
              the plain version and beside torch.baddbmm + torch.topk; the
              fp32 k = 18 and k = 74 (the refining pass) heap instances
              timed; then the kernel reading uint8 and float16
              codes (the budgeted store) at the main-path shape at k = 18
              (the overfetched k of a k = 10 query), k = 10 and k = 74,
              each timed beside its plain version and beside a torch
              dequantize + baddbmm + topk, uint8 at d = 130, k = 150 (the
              wide kernel), and integer-lattice codes with dead rows (tie
              order bit for bit, dead rows last; also at the main-path
              width at k = 18 and 74); the indexed form with a 256-slot
              tile (two launches of 128); the wide kernel timed at W=4096,
              TQ=128, L_pad=4096: fp32 d = 130 at k = 10 and 74, fp32 d = 30
              at k = 16 (the wide cell's list) and 74, uint8 d = 30 at
              k = 18, each beside its plain version and the library; the
              narrow kernel at the lm cell's keys (fp32 d = 16, k = 16) at
              that shape, timed likewise; then KNNIndex
              at k = 150 and at d = 130 against knn_brute, and
              IndexSpec(tile_q=256) equal to tile_q=128 on chunked and
              host;
  4. main     KNNIndex.build(points).query(q, 10) with no spec: n points,
              m queries, d=10, from a seeded clustered Gaussian mixture;
              the plan must be the chunked engine with N=1, the kernel must
              have launched, and 1024 queries must match knn_brute;
  5. ooc      the first n / 2**ooc_shift points (--ooc-shift, default 4:
              a smaller depth of the same mixture) under memory_budget =
              slab_bytes // 3 with precision pinned to fp32 (planner rule
              5): N >= 2 chunks streamed, exact against knn_brute (and the
              same answers as main with --ooc-shift 0);
  6. quant    main's points under memory_budget = slab_bytes // 3, the
              precision left to the planner (rule 4): int8 codes, N = 1,
              resident bytes within the budget, the kernel reading the
              codes, 1024 queries against knn_brute, every query against
              main (rows whose distances differ settled by knn_brute: the
              quantized answer must be the exact one);
  7. quant_ooc  ooc's points under memory_budget = slab_bytes // 12: int8
              codes streamed in N >= 2 chunks, the same answers as ooc;
  8. stream   IndexSpec(engine="streaming"), query_stream(q, 10) over the
              first 2**16 queries: every row delivered once, rows equal
              main's, times to the first and to the last completion;
  9. fp16     precision pinned to fp16 on n / 4 points and m / 4 queries:
              the kernel reading float16 codes end to end;
 10. jit      IndexSpec(engine="jit") on main's points and queries: warm
              runs one eager round and captures the round as a CUDA graph,
              the query replays it; answers equal main's up to ties (rows
              whose distances differ settled by knn_brute, both exact);
              rounds beside main's, graph replays, launches (rounds x 1:
              the wrapper counts only the eager round and the capture);
 11. dual     the dual-tree ops on n = 2**20 points of a 64-blob 3-d
              catalogue in the unit cube (planner default height): radius
              and gaussian kde for 2**16 queries, pair_count over the
              benchmark's edges scaled by (50000 / n)^(1/3), the same
              pair_count streamed in chunks (memory_budget = slab_bytes //
              3, histograms equal); radius and kde on 1024 queries against
              radius_brute / kde_brute over all points, pair_count on the
              first n / 2**4 points against pair_count_brute; each op
              prints the pairs its rounding band sent to the direct form;
 12. host     IndexSpec(engine="host") (the paper's Algorithm 1: host
              queues, leaf buffers, work plans) on the first n / 2**host_shift
              points and m / 2**host_shift queries of main's data
              (--host-shift, default 4; 0: main's data whole): every scan the
              CUDA kernel (launches = chunk rounds), answers equal to main's
              (or ooc's, on the same points) with fp32_rows_missed = 0;
 13. host_ooc the same under memory_budget = slab_bytes // 3, fp32 (N = 7,
              the paper's out-of-core setting), answers equal to host's;
 14. kdtree   the paper's CPU baseline on the host cell's points, 2**14
              queries, timed beside host and chunked on the same rows;
              answers equal to host's;
 15. persist  main's index and the quant index saved to a temporary
              directory and loaded again: save_s, load_s and bytes on disk
              beside build_s; 2**16 queries answered bit for bit as before
              the save;
 16. wide     KNNIndex.build(points).query(q, 10) with no spec on main's
              mixture at d = 30 (the top of the paper's range), n / 2**wide_shift
              points and m / 2**wide_shift queries (--wide-shift, default 2:
              n = 2**22, m = 2**18): the plan must be chunked, fp32, N = 1,
              every launch the wide kernel's (by variant name), 1024 queries
              against knn_brute with fp32_rows_missed = 0;
 17. mutable  (after stream) KNNIndex.build(3n/4 points, IndexSpec(mutable=True,
              merge_async=True, persist_dir=...)) on main's mixture at
              n / 2**mutable_shift (--mutable-shift, default 3: n = 2**21),
              the rest inserted in 16 batches, n / 128 ids deleted in 4
              batches, a query while merges are pending, drain(), m /
              2**mutable_shift queries (1024 against knn_brute over the live
              points, fp32_rows_missed = 0, the tree shards launching the
              kernel, refined and brute rows printed), then save(), one more
              batch, load replaying its WAL record, answers bit for bit;
 18. serve    KNNServer (max_batch 1024) over the stream cell's index, the
              estimate seeded from the stream cell's seconds per round:
              a burst of 8192 >> serve_shift requests (--serve-shift,
              default 3), every answer main's row; 2048 >> serve_shift
              paced requests with 50 ms deadlines (completed, purged, shed);
              1024 >> serve_shift at the same rate with a deadline of twice
              the burst's seconds per batch (sla: the requests complete);
              1024 requests through a server fronting the mutable index,
              answers equal to its query;
 19. drills   the reference's degraded-serving drill on the card (12288
              points, d = 5, devices=(cuda:0,) * 4): a shard-bearing slot
              lost under a KNNServer, then one serve.launch and one
              serve.stream fault; every ticket exact against knn_brute.
 20. multi    (after wide) the paper's multi-device querying on
              devices=(cuda:0,) * 4 (and on every card where there are more):
              main's mixture at n / 2**multi_shift points and m / 2**multi_shift
              queries (--multi-shift, default 4: n = 2**20, m = 2**16); no
              spec (the plan must be forest: a tree per slot over n / 4
              points, each slot's round one CUDA graph), then sharded (the
              paper's query chunks, one chunked tree per slot) and ring
              (resident shards, query blocks rotated, every scan the
              leaf-scan kernel) pinned, then chunked on one slot: build,
              warm, query, each slot's seconds, the query's launches by
              variant (counts set to 0 after the warm; the forest's are its
              graph replays, none eager), 1024 rows against knn_brute
              (fp32_rows_missed = 0), answers equal to chunked's up to ties.
 21. lm       kNN-LM serving with Qwen1.5-0.5B at full width (24
              layers, d_model 1024, vocab 151936; random weights from the
              seed; fp32 parameters, bf16 compute) on cuda:0: a corpus of
              512 >> lm_shift sequences of 2048 tokens (--lm-shift, default
              1: 2**19 pairs, TokenPipeline) embedded into a KNNLM datastore
              (proj_dim 16, k 10, lam 0.25; the plan must be chunked and
              its queries the narrow kernel); the keys of 32 >> lm_shift
              held-out sequences queried, 1024 rows against knn_brute
              (fp32_rows_missed = 0); next_token_probs on 256 >> lm_shift held-out
              sequences (rows sum to 1 within 1e-3; at lam = 0, on 16 of
              them, equal to the softmax of prefill's logits within 1e-6); a mutable store
              built on 3/4 of the corpus and extended in 4 batches (plan
              dynamic, exact, save_datastore / load_datastore answering bit
              for bit); serve() over a streaming store of a quarter of the
              corpus, 64 >> lm_shift rows equal to the direct path's (both stores take
              the keys the first build embedded); ServeEngine (8
              slots, max_len 2048) decoding 16 requests of 64 greedy tokens
              (tokens/s), every token within 1e-3 of the largest logit of a
              batched replay through decode_step, and prefill of each first
              round's prompt against the replay (bf16: any logit within
              0.03, the mean within 0.003; every card run read 0).
 22. train    Qwen1.5-0.5B at full width trained (random weights from the
              seed, fp32 parameters, bf16 compute, remat "full") on
              TokenPipeline(151936, 1024, 8): 24 steps of AdamW (lr 3e-3,
              warmup 5), the mean loss of the last 4 below the first 4's;
              tokens/s, ms a step, peak memory; a checkpoint at step 16
              (CheckpointManager: save_s, bytes on disk) restored into a
              fresh model's template (restore_s), bit for bit; from it one
              step at grad_accum = 2 against the run's step (loss, grad
              norm, update), steps 16-24 replayed (losses within 1e-3
              relative of the run's; bit for bit is printed), and 2 steps
              twice under use_deterministic_algorithms; two smoke-size fp32
              steps on the card against the CPU (1e-4).  --profile train:
              one more step under torch.profiler.
 23. families (last) the six other configs at full width (mamba2_370m at
              its full depth of 48 layers, the others one cycle of their
              layer pattern): two train steps on 2 x 512 tokens (plus the
              576-token image prefix; audio frames in place of tokens); a
              prefill of 512 tokens and 8 decode steps against a forward
              pass over the 520 tokens, in bf16 (printed) and fp32 (held);
              ms and peak memory for each.
 24. dist     the language model across device slots of cuda:0
              (``ShardedLM``, ``make_sharded_train_step``): Qwen1.5-0.5B at
              full width cut to 4 layers on a 2 x 2 mesh, 6 steps of 8 x
              1024 tokens in each param_mode (tp, zero1, mp_zero1, fsdp)
              against a one-slot run from the same weights (ms a step,
              loss and grad-norm differences, each slot's resident bytes
              of parameters / gradients / optimizer state against the
              specs' count, peak memory); one fp32 fsdp step against one
              slot; tp with int8 error-feedback compression against the
              exact all-reduce; fsdp saved at step 3 and restored on
              2 x 2 (bit for bit against the uninterrupted run), 1 x 4 and
              one slot; moonshot_v1_16b_a3b (one layer) with its 64
              experts over 4 slots: a train step and a forward on 2 x 512
              tokens against one slot, drops; qwen2_7b (2 layers, bf16
              parameters, seq_shard) over 4 slots (kv heads split) and 8
              (heads padded 28 -> 32, the cache split along its length):
              prefill of 2 x 512 tokens and 16 greedy decode steps against
              one slot.
 25. roofline (last) ``repro_torch.roofline`` and the dry run: the card's
              peaks come from ``roofline.HW``; one train step of the train
              cell: ``model_flops`` (spec / refined), the script's own
              count, ``FlopCounterMode`` over the step on the card equal
              to ``count_ops`` over the same step on ``meta``, and the meta
              run's predicted peak within ``ROOFLINE_PEAK_FACTOR`` of
              ``max_memory_allocated`` over a step; the dry runs of
              ``DRYRUN_CELLS`` on 256 meta slots (qwen2_7b train_4k and
              decode_32k, knn_service; started in the background after
              the build phase, CPU only): seconds, dominant term, bytes
              per slot; the knn_service reckoning equal to the ring's
              real launches at the multi cell's size (their units, TQ,
              L_pad, d); ``Calibration.refresh()`` on the card (GB/s, us a
              transfer) and a ``Calibration`` from this run's main and
              kdtree numbers planning the ooc cell's points: the plan's
              reasons cite it, 1024 queries exact against knn_brute.

Phase 3 times the main path's fp32 instance at k = 10 + FP32_OVERFETCH
(the k the fp32 main path runs) beside k = 10, k = 18 and k = 10 +
QUANT_REFINE_OVERFETCH (the refining pass), and the same list at the lm
cell's keys (d = 16, ``narrow<16,16>/reg``); the JSON line's fp32 entry is
that instance, and its ``instances`` give each instance the main path ran
with its launches and, where phase 3 timed it, its times.  main and ooc
must miss no row against brute force (``fp32_rows_missed`` = 0).

Every cell sets the kernel's launch counts to 0 just before its query and
reads them just after; the JSON line gives each cell's counts by variant
name (``launches_by_cell``), under an entry for each kernel and code type:
``leaf_scan`` (narrow, fp32; main's launches; the lm cell's under ``lm``,
``lm_probs``, ``lm_mutable`` and ``lm_serve``), ``leaf_scan_codes`` (narrow,
uint8; quant's), ``leaf_scan_wide`` (wide, fp32; the wide cell's) and
``leaf_scan_lm_keys`` (narrow, fp32 at d = 16; the lm cell's).  A
``[done]`` line gives the script's seconds from the CUDA check on (the
kernels' build included).  Then one JSON line describing the kernels, and
last the device line.  Any failed check raises (non-zero exit); without a
CUDA device the script exits non-zero before printing any result.  Nothing
here imports jax or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))



def hw(key: str) -> float:
    """The card's peak ``key`` from ``repro_torch.roofline.HW`` (H100 SXM
    data sheet, at a 700 W power limit): ``hbm_bw``, ``peak_flops`` (dense
    bf16, the train cell's bound), ``fp32_flops``."""
    if os.path.join(ROOT, "src") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.roofline import HW

    return HW[key]


# (W, TQ, L_pad, d, d_pad, k): the reference kernel sweep
# (tests/test_kernels_knn.py SWEEP)
SWEEP = [
    (1, 8, 64, 3, 8, 1),
    (2, 64, 128, 5, 8, 5),
    (4, 128, 512, 10, 16, 10),
    (3, 32, 256, 15, 16, 7),
    (1, 16, 1024, 7, 8, 10),
    (5, 64, 96, 2, 8, 3),
]
# the main path's rows are the points' own width d: the kernel pads them
MAIN_SHAPE = dict(w=4096, tq=128, l_pad=4096, d=10, k=10)
# the list a quantized store's k = 10 query scans at (k + QUANT_OVERFETCH)
CODE_K = 18
# the list the fp32 main path's k = 10 query scans at (k + FP32_OVERFETCH;
# set in main() from the package)
MAIN_K_EFF = 10
# the list unproven rows of a k = 10 query scan at (k + QUANT_REFINE_OVERFETCH;
# set in main() from the package)
REFINE_K = 74
STREAM_M = 2 ** 16   # queries of the stream cell
KDTREE_M = 2 ** 14   # queries of the kdtree cell
PERSIST_M = 2 ** 16  # queries the persist cell answers before and after
STAMP_ROUNDS = 64    # replayed rounds of the jit cell traced against its stamps
WIDE_D = 130         # the wide kernel's timed rows (d > 16)
WIDE_CELL_D = 30     # the wide cell's rows (the top of the paper's range)
LM_KEY_D = 16        # the lm cell's keys: the kNN-LM's projection (proj_dim)
DUAL_CHECK_SHIFT = 4  # the dual cell's pair_count_brute check on n / 2**4 points
LM_ARCH = "qwen15_0_5b"   # the lm cell's model, at full width
LM_SEQ = 2048        # tokens per sequence of the lm cell's corpus
LM_CORPUS = 512      # corpus sequences (2**20 pairs), >> --lm-shift
LM_QUERY = 32        # held-out sequences whose keys are queried (2**16), >> --lm-shift
LM_PROBS = 256       # held-out sequences through next_token_probs, >> --lm-shift
LM_SERVE = 64        # rows served through KNNServer, >> --lm-shift
LM_REQUESTS, LM_SLOTS, LM_MAX_LEN, LM_NEW_TOKENS = 16, 8, 2048, 64   # decode
TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_ARCH = "qwen15_0_5b"   # the train cell's model, at full width
TRAIN_SEQ, TRAIN_BATCH = 1024, 8   # TokenPipeline(151936, 1024, 8): 8192 tokens a step
TRAIN_STEPS, TRAIN_SAVE_AT, TRAIN_DET_STEPS = 24, 16, 2
TRAIN_LR, TRAIN_WARMUP = 3e-3, 5
TRAIN_REPLAY_RTOL = 1e-3     # the replay's losses against the run's, relative
# grad_accum = 2 against 1 on one batch (bf16 compute): loss and grad norm
# relative, and the parameters' update, ||P_ga2 - P_ga1|| / ||P_ga1 - P_16||
TRAIN_GA_LOSS_RTOL, TRAIN_GA_GNORM_RTOL, TRAIN_GA_UPDATE_RTOL = 1e-2, 1e-1, 0.1
FAMILY_ARCHS = ("olmoe_1b_7b", "moonshot_v1_16b_a3b", "mamba2_370m", "recurrentgemma_9b",
                "llava_next_mistral_7b", "hubert_xlarge")
FAMILY_FULL_DEPTH = "mamba2_370m"   # the others run one cycle of their layer pattern
FAMILY_BATCH, FAMILY_SEQ, FAMILY_DECODE = 2, 512, 8
# decode against a forward pass over the same tokens, computing in fp32, in
# units of max(1, mean |logit|): any logit, and the mean.  In bf16 the
# distance is printed, not held: mamba2's 48 random layers amplify bf16
# roundings to the logits' own scale (the reference's bf16 prefill against
# its forward, which only moves the chunk boundaries: 3.19 on any logit)
FAMILY_F32_MAX, FAMILY_F32_MEAN = 0.1, 0.01
# the dist phase (the LM across device slots, four or eight slots of cuda:0)
DIST_TRAIN_LAYERS = 4          # Qwen1.5-0.5B at full width, cut to 4 layers
DIST_STEPS, DIST_SAVE_AT = 6, 3
DIST_MODES = ("tp", "zero1", "mp_zero1", "fsdp")
DIST_EP_ARCH, DIST_GQA_ARCH = "moonshot_v1_16b_a3b", "qwen2_7b"
DIST_GQA_LAYERS, DIST_SEQ, DIST_BATCH, DIST_DECODE = 2, 512, 2, 16
# against one slot, bf16 compute: the losses (relative) and grad norms
# (relative) of the 6 steps, as the train cell's grad_accum check holds
# them; the compressed run's losses against the exact run's; the slots'
# resident bytes against the specs' count (1 %); the fp32 fsdp step
# against one slot: loss (relative) and the parameters' update
# (||P_mesh - P_one|| / ||P_one - P_0||); decode logits in units of
# max(1, mean |logit|) (bf16; a wrong head, shard or cache slot moves them
# by several units)
DIST_LOSS_RTOL, DIST_GNORM_RTOL, DIST_EF_RTOL, DIST_BYTES_RTOL = 1e-2, 1e-1, 5e-2, 1e-2
DIST_F32_LOSS_RTOL, DIST_F32_UPDATE_RTOL = 1e-4, 1e-2
DIST_LOGIT_MAX = 0.5


# each run_query cell's query seconds, query count and chunk rounds (the
# roofline phase's calibration reads main's), and the kdtree line's paired
# host / chunked q/s
MEASURED = {}
# the dry-run cells the roofline phase reads: (arch, shape), run in the
# background from the end of the build phase
DRYRUN_CELLS = (("qwen2_7b", "train_4k"), ("qwen2_7b", "decode_32k"), ("knn_service", "knn_1M"))
# the roofline phase: the meta run's predicted peak of a train step against
# the card's max_memory_allocated, as measured / predicted within
# [1 / ROOFLINE_PEAK_FACTOR, ROOFLINE_PEAK_FACTOR]
ROOFLINE_PEAK_FACTOR = 1.25


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn`` in ms, with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def scan_bound(w: int, tq: int, lp: int, d: int, k: int, code: str = "f32"):
    """(bound_ms, bound_by) of the leaf scan at W=w, TQ=tq, L_pad=lp, width d,
    list k, slab of ``code``: the larger of the bytes it must move (queries,
    slab, its dequantize metadata and the plan read once, the k-lists
    written once) over the memory rate, and its operations (per (query, row)
    pair d FMAs for q.x, 2d operations, plus 3 to form, clamp and compare
    the distance; dequantize is O(L d) per leaf against O(TQ L d) pairs) over
    the fp32 rate."""
    slab = {"f32": 4 * w * lp * d,
            "f16": 2 * w * lp * d + w * (-(-lp // 8)),
            "u8": w * lp * d + 8 * w * d + w * (-(-lp // 8))}[code]
    bytes_moved = slab + 4 * (w * tq * d + w + w * tq) + 8 * w * tq * k
    ops = w * tq * lp * (2 * d + 3)
    t_bytes, t_ops = bytes_moved / hw("hbm_bw"), ops / hw("fp32_flops")
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def check_scan(torch, q, x, kd, ki, rd, ri, exact_ties=False) -> float:
    """Kernel result vs plain result: distances within TOL, indices
    permutation-aware (the plain distance at every rank is the distance of
    the kernel's index, recomputed in float64).  Returns max |error|."""
    torch.testing.assert_close(kd, rd, **TOL)
    xs = x.double()[torch.arange(x.shape[0], device=x.device)[:, None, None], ki.long()]
    d_of_ki = torch.clamp(
        (q.double() ** 2).sum(-1, keepdim=True)
        - 2 * torch.einsum("wqd,wqkd->wqk", q.double(), xs)
        + (xs ** 2).sum(-1), min=0.0)
    torch.testing.assert_close(d_of_ki, rd.double(), **TOL)
    if exact_ties:
        assert torch.equal(kd, rd) and torch.equal(ki, ri), "tie order differs"
    return float((kd - rd).abs().max())


def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    print(smi, flush=True)
    return smi


def phase_build():
    from repro_torch.kernels import knn_scan

    wall, libs = knn_scan.build_all()
    log("build", seconds=f"{wall:.3f}", libraries=len(libs),
        slowest_nvcc_s=f"{max(lib.build_s for lib in libs):.3f}",
        directory=os.path.relpath(libs[0].path.parent, ROOT))
    for lib in libs:
        name, spill = None, ""
        for line in lib.ptxas_log.splitlines():
            m = re.search(r"leaf_scan_(narrow|wide)_kernel(?:I((?:Li\d+E)+))?", line)
            if "Compiling entry function" in line and m:
                # narrow<DW,KMAX> template instances, and the wide kernel;
                # shared memory is dynamic (choose_variant sizes it per call)
                args = re.findall(r"Li(\d+)E", m.group(2) or "")
                name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line and name:
                print(f"[build] {name}: {line.split(':', 1)[-1].strip()}; {spill}",
                      flush=True)
                name, spill = None, ""
    return libs


def phase_kernel(torch, dev, seed: int) -> dict:
    from repro_torch.kernels import knn_scan
    from repro_torch.kernels.ref import PAD_COORD, leaf_scan_ref

    gen = torch.Generator(device=dev).manual_seed(seed)

    def inputs(w, tq, lp, d, d_pad, pad_rows=0, lattice=False):
        q = torch.zeros((w, tq, d_pad), device=dev)
        x = torch.zeros((w, lp, d_pad), device=dev)
        if lattice:
            q[..., :d] = torch.randint(-2, 3, (w, tq, d), device=dev, generator=gen).float()
            x[..., :d] = torch.randint(-2, 3, (w, lp, d), device=dev, generator=gen).float()
        else:
            q[..., :d] = torch.randn((w, tq, d), device=dev, generator=gen)
            x[..., :d] = torch.randn((w, lp, d), device=dev, generator=gen)
        if pad_rows:
            x[:, lp - pad_rows:, :d] = PAD_COORD
        return q, x

    cases = [(f"sweep{i}", *c, 0, False) for i, c in enumerate(SWEEP)]
    cases += [(f"width{dw}_k10", 2, 128, 300, dw, dw, 10, 0, False)
              for dw in knn_scan.NARROW_WIDTHS]
    cases += [
        ("pad_rows_lt_k", 1, 16, 16, 10, 16, 8, 11, False),   # 5 real rows, k=8
        ("exact_ties", 2, 128, 300, 3, 8, 9, 0, True),
        ("odd_width_d9", 2, 128, 300, 9, 9, 10, 0, False),
        ("smem_heap_k40", 2, 128, 300, 10, 16, 40, 0, False),
        ("smem_heap_k129", 2, 128, 600, 10, 10, 129, 0, False),
        ("out_heap_k300", 2, 128, 600, 10, 10, 300, 0, False),
        ("wide_d130", 2, 128, 300, 130, 130, 10, 0, False),
        ("wide_d300", 2, 128, 300, 300, 300, 10, 0, False),
        ("wide_d300_k300", 1, 128, 320, 300, 300, 300, 37, False),
        ("wide_d30_k16", 2, 128, 1000, 30, 30, 16, 0, False),
        ("wide_d30_k74_pad_rows", 2, 128, 1000, 30, 30, 74, 9, False),
        ("wide_d520_chunked_k16", 1, 128, 300, 520, 520, 16, 0, False),
        ("wide_d520_chunked_k40", 1, 128, 300, 520, 520, 40, 5, False),
        ("lattice_wide_d30_k16", 2, 128, 1000, 30, 30, 16, 0, True),
        ("lattice_wide_d30_k74", 2, 128, 1000, 30, 30, 74, 0, True),
        ("lattice_main_width", 4, 128, 4096, 10, 10, 10, 0, True),
        ("lattice_main_width_k18", 4, 128, 4096, 10, 10, CODE_K, 0, True),
        ("lattice_main_width_k74", 4, 128, 4096, 10, 10, REFINE_K, 0, True),
    ]
    for name, w, tq, lp, d, d_pad, k, pad_rows, lattice in cases:
        q, x = inputs(w, tq, lp, d, d_pad, pad_rows, lattice)
        v = knn_scan.choose_variant(d_pad, k, tq, lp)
        kd, ki = knn_scan.leaf_scan_cuda(q, x, k=k)
        rd, ri = leaf_scan_ref(q, x, k=k)
        torch.cuda.synchronize()
        err = check_scan(torch, q, x, kd, ki, rd, ri, exact_ties=lattice)
        log("kernel", case=name, shape=(w, tq, lp, d_pad), k=k, variant=v.name,
            max_abs_err=err, ok=True)

    # every instance forms the same values: a register list (k=16), the first
    # 16 entries of a heap in shared memory (k=17) and in the output rows
    # (k=300), and the wide kernel's register list and heaps (k = 16, 17, 300)
    # on the rows with a zero 17th column agree bit for bit
    q, x = inputs(2, 128, 1000, 16, 17)
    q16, x16 = q[..., :16].contiguous(), x[..., :16].contiguous()
    base = knn_scan.leaf_scan_cuda(q16, x16, k=16)
    runs = [(knn_scan.choose_variant(16, k, 128, 1000), knn_scan.leaf_scan_cuda(q16, x16, k=k))
            for k in (17, 300)]
    runs += [(knn_scan.choose_variant(17, k, 128, 1000), knn_scan.leaf_scan_cuda(q, x, k=k))
             for k in (16, 17, 300)]
    torch.cuda.synchronize()
    for v, (od, oi) in runs:
        assert torch.equal(od[..., :16], base[0]) and torch.equal(oi[..., :16], base[1]), v.name
    log("kernel", case="instances_agree",
        variants=",".join(["narrow<16,16>/reg"] + [v.name for v, _ in runs]), ok=True)

    # the indexed form the chunk round calls: empty slots, rows past n_units;
    # indices are checked on the gathered tiles (an empty slot scans zeros)
    qpad = torch.randn((5000, 10), device=dev, generator=gen)
    slab = torch.randn((40, 256, 10), device=dev, generator=gen)
    unit_leaf = torch.randint(0, 40, (64,), device=dev, generator=gen).int()
    unit_query = torch.randint(-1, 5000, (64, 128), device=dev, generator=gen).int()
    n_units = torch.tensor(50, dtype=torch.int32, device=dev)
    kd, ki = knn_scan.leaf_scan_units(qpad, slab, unit_leaf, unit_query, n_units, k=10)
    rd, ri = knn_scan.leaf_scan_units_ref(qpad, slab, unit_leaf, unit_query, n_units, k=10)
    torch.cuda.synchronize()
    uq = unit_query[:50]
    q_tiles = torch.where((uq >= 0)[..., None], qpad[uq.clamp(min=0).long()], 0.0)
    err = check_scan(torch, q_tiles, slab[unit_leaf[:50].long()],
                     kd[:50], ki[:50], rd[:50], ri[:50])
    log("kernel", case="indexed_form", rows=64, n_units=50, max_abs_err=err, ok=True)

    # a tile of 256 query slots: two launches of 128, rows side by side
    unit_query = torch.randint(-1, 5000, (64, 256), device=dev, generator=gen).int()
    before = knn_scan.leaf_scan_units.launches
    kd, ki = knn_scan.leaf_scan_units(qpad, slab, unit_leaf, unit_query, n_units, k=10)
    split = knn_scan.leaf_scan_units.launches - before
    rd, ri = knn_scan.leaf_scan_units_ref(qpad, slab, unit_leaf, unit_query, n_units, k=10)
    torch.cuda.synchronize()
    uq = unit_query[:50]
    q_tiles = torch.where((uq >= 0)[..., None], qpad[uq.clamp(min=0).long()], 0.0)
    err = check_scan(torch, q_tiles, slab[unit_leaf[:50].long()],
                     kd[:50], ki[:50], rd[:50], ri[:50])
    assert split == 2, split
    log("kernel", case="indexed_form_tq256", rows=64, launches=split, max_abs_err=err,
        ok=True)

    # main-path shape: time the kernel, its plain version, and the library,
    # at k = 10, at the k the fp32 main path runs (k + FP32_OVERFETCH) and
    # at the refining pass's k
    s = MAIN_SHAPE
    w, tq, lp, d = s["w"], s["tq"], s["l_pad"], s["d"]
    q, x = inputs(w, tq, lp, d, d)
    qpad = q.reshape(w * tq, d).contiguous()
    ul = torch.arange(w, dtype=torch.int32, device=dev)
    uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    nu = torch.tensor(w, dtype=torch.int32, device=dev)
    xn = (x * x).sum(-1)[:, None, :]     # per-slab precompute, outside the timing
    xt = x.transpose(1, 2)
    timed = {}
    cases = {s["k"]: "main_shape", MAIN_K_EFF: "main_shape_k_eff",
             CODE_K: "main_shape_f32_k18", REFINE_K: "main_shape_f32_refine"}
    for k, case in cases.items():
        kd, ki = knn_scan.leaf_scan_units(qpad, x, ul, uq, nu, k=k)
        rd, ri = knn_scan.leaf_scan_units_ref(qpad, x, ul, uq, nu, k=k)
        torch.cuda.synchronize()
        err = check_scan(torch, q, x, kd, ki, rd, ri)
        del kd, ki, rd, ri
        kernel_ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units(qpad, x, ul, uq, nu, k=k),
                            reps=10)
        plain_ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units_ref(
            qpad, x, ul, uq, nu, k=k), reps=3)

        def library():
            d2 = torch.baddbmm(xn, q, xt, alpha=-2.0)
            return torch.topk(d2, k, dim=-1, largest=False)

        library_ms = cuda_ms(torch, library, reps=3)
        bound_ms, bound_by = scan_bound(w, tq, lp, d, k)
        log("kernel", case=case, shape=(w, tq, lp, d), k=k,
            variant=knn_scan.choose_variant(d, k, tq, lp).name,
            max_abs_err=err, kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            gflops=f"{w * tq * lp * (2 * d + 3) / kernel_ms / 1e6:.1f}")
        timed[k] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    del xn, xt
    codes = phase_kernel_codes(torch, dev, gen, q, x, qpad, ul, uq, nu)
    timed = {f"f32_k{k}": t for k, t in timed.items()}
    del q, x, qpad
    torch.cuda.empty_cache()
    return timed, codes, phase_kernel_wide(torch, dev, gen), phase_kernel_lm(torch, dev, gen)


def phase_kernel_lm(torch, dev, gen) -> dict:
    """The narrow kernel at the lm cell's keys (d = LM_KEY_D, the kNN-LM's
    projection) and the list its k = 10 queries scan at (k +
    FP32_OVERFETCH), at the main path's W, TQ and L_pad (the lm cell's
    2**20 keys fill 256 leaves of 4096 rows): against its plain version,
    timed beside it and the library; keyed ``"f32_d16_k16"``."""
    from repro_torch.kernels import knn_scan

    s, d, k = MAIN_SHAPE, LM_KEY_D, MAIN_K_EFF
    w, tq, lp = s["w"], s["tq"], s["l_pad"]
    q = torch.randn((w, tq, d), device=dev, generator=gen)
    x = torch.randn((w, lp, d), device=dev, generator=gen)
    qpad = q.reshape(w * tq, d)
    ul = torch.arange(w, dtype=torch.int32, device=dev)
    uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    nu = torch.tensor(w, dtype=torch.int32, device=dev)
    kd, ki = knn_scan.leaf_scan_units(qpad, x, ul, uq, nu, k=k)
    rd, ri = knn_scan.leaf_scan_units_ref(qpad, x, ul, uq, nu, k=k)
    torch.cuda.synchronize()
    err = check_scan(torch, q, x, kd, ki, rd, ri)
    del kd, ki, rd, ri
    kernel_ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units(qpad, x, ul, uq, nu, k=k),
                        reps=10)
    plain_ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units_ref(qpad, x, ul, uq, nu, k=k),
                       reps=3)
    xn = (x * x).sum(-1)[:, None, :]     # per-slab precompute, outside the timing
    xt = x.transpose(1, 2)

    def library():
        d2 = torch.baddbmm(xn, q, xt, alpha=-2.0)
        return torch.topk(d2, k, dim=-1, largest=False)

    library_ms = cuda_ms(torch, library, reps=3)
    bound_ms, bound_by = scan_bound(w, tq, lp, d, k)
    log("kernel", case=f"lm_shape_d{d}", shape=(w, tq, lp, d), k=k,
        variant=knn_scan.choose_variant(d, k, tq, lp).name,
        max_abs_err=err, kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        gflops=f"{w * tq * lp * (2 * d + 3) / kernel_ms / 1e6:.1f}")
    del q, x, qpad, xn, xt
    torch.cuda.empty_cache()
    return {f"f32_d{d}_k{k}": dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)}


def phase_kernel_wide(torch, dev, gen) -> dict:
    """The wide kernel (rows of d > 16 features) at the main path's W, TQ
    and L_pad: fp32 at d = WIDE_D, k = 10 and the refining pass's k; at
    d = WIDE_CELL_D (the wide cell's rows) fp32 at the k the fp32 path runs
    (k + FP32_OVERFETCH) and the refining pass's k, and uint8 codes of the
    same slab at the quantized path's k; each timed beside its plain
    version and the library; keyed ``"f32_d130_k10"``."""
    from repro_torch.kernels import knn_scan
    from repro_torch.kernels.ref import PAD_COORD

    s = MAIN_SHAPE
    w, tq, lp = s["w"], s["tq"], s["l_pad"]
    ul = torch.arange(w, dtype=torch.int32, device=dev)
    uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    nu = torch.tensor(w, dtype=torch.int32, device=dev)
    out = {}
    rows = [(WIDE_D, "f32", (s["k"], REFINE_K)),
            (WIDE_CELL_D, "f32", (MAIN_K_EFF, REFINE_K)),
            (WIDE_CELL_D, "u8", (CODE_K,))]
    for d, code, ks in rows:
        q = torch.randn((w, tq, d), device=dev, generator=gen)
        x32 = torch.randn((w, lp, d), device=dev, generator=gen)
        qpad = q.reshape(w * tq, d)
        if code == "f32":
            slab, meta, x = x32, {}, x32
            dead = None
            xn = (x * x).sum(-1)[:, None, :]   # per-slab precompute, outside the timing
            xt = x.transpose(1, 2)
        else:
            slab, meta, dead = code_slab(torch, dev, gen, code, w, lp, d, x=x32)
            x = knn_scan.dequantize(slab, meta.get("scale"), meta.get("offset"), meta["dead"])
            del x32
        for k in ks:
            kd, ki = knn_scan.leaf_scan_units(qpad, slab, ul, uq, nu, k=k, **meta)
            rd, ri = knn_scan.leaf_scan_units_ref(qpad, slab, ul, uq, nu, k=k, **meta)
            torch.cuda.synchronize()
            # every distance; the indices on the first units (the float64
            # gather of all [W, TQ, k, d] would not fit)
            torch.testing.assert_close(kd, rd, **TOL)
            err = max(float((kd - rd).abs().max()),
                      check_scan(torch, q[:256], x[:256], kd[:256], ki[:256], rd[:256],
                                 ri[:256]))
            del kd, ki, rd, ri
            kernel_ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units(
                qpad, slab, ul, uq, nu, k=k, **meta), reps=3)
            plain_ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units_ref(
                qpad, slab, ul, uq, nu, k=k, **meta), reps=2)

            def library():
                if code == "f32":   # as the narrow rows: baddbmm + topk
                    d2 = torch.baddbmm(xn, q, xt, alpha=-2.0)
                else:   # torch dequantize (as the plain version) + baddbmm + topk
                    xq = slab.float() * meta["scale"][:, None, :] + meta["offset"][:, None, :]
                    xq = torch.where(dead[..., None], PAD_COORD, xq)
                    d2 = torch.baddbmm((xq * xq).sum(-1)[:, None, :], q,
                                       xq.transpose(1, 2), alpha=-2.0)
                return torch.topk(d2, k, dim=-1, largest=False)

            library_ms = cuda_ms(torch, library, reps=2)
            bound_ms, bound_by = scan_bound(w, tq, lp, d, k, code)
            log("kernel", case=f"wide_{code}_d{d}_k{k}", shape=(w, tq, lp, d), k=k,
                variant=knn_scan.choose_variant(d, k, tq, lp, code).name, max_abs_err=err,
                kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                gflops=f"{w * tq * lp * (2 * d + 3) / kernel_ms / 1e6:.1f}")
            out[f"{code}_d{d}_k{k}"] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                                            library_ms=library_ms, bound_ms=bound_ms,
                                            bound_by=bound_by)
        del q, x, qpad, slab, meta, dead
        x32 = xn = xt = None
        torch.cuda.empty_cache()
    return out


def pack_rows(torch, dead):
    """bool[W, L] -> u8[W, ceil(L/8)], row r in bit 7 - r % 8 of byte r // 8
    (np.packbits order, as the store keeps its dead mask)."""
    w, lp = dead.shape
    b = torch.nn.functional.pad(dead.to(torch.uint8), (0, -lp % 8)).reshape(w, -1, 8)
    weights = 2 ** torch.arange(7, -1, -1, device=dead.device)
    return (b * weights).sum(-1).to(torch.uint8)


def code_slab(torch, dev, gen, code, w, lp, d, lattice=False, dead_frac=0.05, x=None):
    """A slab of ``code`` codes ("u8" or "f16") on the card with its
    metadata: the fp32 slab ``x`` coded (u8 by each leaf's per-feature
    range, as core/quantize.py does), random codes, or integer-lattice ones
    (u8 0..4 with scale 1 and offset -2, f16 -2..2), where every dequantized
    value is exact; rows dead at random."""
    meta = {}
    if x is not None and code == "u8":
        lo, hi = x.amin(dim=1), x.amax(dim=1)
        meta["scale"] = (hi - lo) / 255.0
        meta["offset"] = lo
        codes = torch.round((x - lo[:, None, :]) / meta["scale"][:, None, :])
        codes = codes.clamp(0, 255).to(torch.uint8)
    elif x is not None:
        codes = x.half()
    elif lattice:
        lat = torch.randint(0, 5, (w, lp, d), device=dev, generator=gen)
        codes = lat.to(torch.uint8) if code == "u8" else (lat - 2).half()
        if code == "u8":
            meta["scale"] = torch.ones((w, d), device=dev)
            meta["offset"] = torch.full((w, d), -2.0, device=dev)
    elif code == "u8":
        codes = torch.randint(0, 256, (w, lp, d), device=dev, generator=gen).to(torch.uint8)
        meta["scale"] = 0.01 + 0.02 * torch.rand((w, d), device=dev, generator=gen)
        meta["offset"] = 3.0 * torch.randn((w, d), device=dev, generator=gen)
    else:
        codes = torch.randn((w, lp, d), device=dev, generator=gen).half()
    dead = torch.rand((w, lp), device=dev, generator=gen) < dead_frac
    meta["dead"] = pack_rows(torch, dead)
    return codes, meta, dead


def phase_kernel_codes(torch, dev, gen, q, x32, qpad, ul, uq, nu) -> dict:
    """The kernel reading uint8 / float16 codes of the main-shape slab
    ``x32`` against its plain version on the same codes, each instance
    timed; returns the timings keyed ``"u8_k18"``."""
    from repro_torch.kernels import knn_scan
    from repro_torch.kernels.ref import PAD_COORD

    def scan_both(q, codes, meta, k, qpad=None, ul=None, uq=None, nu=None):
        w, tq, d = q.shape
        if qpad is None:
            qpad = q.reshape(w * tq, d).contiguous()
            ul = torch.arange(w, dtype=torch.int32, device=dev)
            uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
            nu = torch.tensor(w, dtype=torch.int32, device=dev)
        kd, ki = knn_scan.leaf_scan_units(qpad, codes, ul, uq, nu, k=k, **meta)
        rd, ri = knn_scan.leaf_scan_units_ref(qpad, codes, ul, uq, nu, k=k, **meta)
        torch.cuda.synchronize()
        return kd, ki, rd, ri

    def dead_last(dead, ki) -> bool:
        sel = dead[torch.arange(dead.shape[0], device=dev)[:, None, None], ki.long()]
        return bool((sel[..., 1:].int() >= sel[..., :-1].int()).all())

    s = MAIN_SHAPE
    w, tq, lp, d = s["w"], s["tq"], s["l_pad"], s["d"]
    out = {}
    for code in ("u8", "f16"):
        codes, meta, dead = code_slab(torch, dev, gen, code, w, lp, d, x=x32)
        x = knn_scan.dequantize(codes, meta.get("scale"), meta.get("offset"), meta["dead"])
        for k in (CODE_K, MAIN_SHAPE["k"], REFINE_K):
            kd, ki, rd, ri = scan_both(q, codes, meta, k, qpad, ul, uq, nu)
            err = check_scan(torch, q, x, kd, ki, rd, ri)
            assert dead_last(dead, ki), "a dead row was ranked before a live one"
            del kd, ki, rd, ri
            v = knn_scan.choose_variant(d, k, tq, lp, code)
            ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units(
                qpad, codes, ul, uq, nu, k=k, **meta), reps=10)
            plain_ms = cuda_ms(torch, lambda: knn_scan.leaf_scan_units_ref(
                qpad, codes, ul, uq, nu, k=k, **meta), reps=3)

            def library():
                # torch dequantize (as the plain version) + baddbmm + topk
                xq = codes.float()
                if "scale" in meta:
                    xq = xq * meta["scale"][:, None, :] + meta["offset"][:, None, :]
                xq = torch.where(dead[..., None], PAD_COORD, xq)
                xn = (xq * xq).sum(-1)[:, None, :]
                d2 = torch.baddbmm(xn, q, xq.transpose(1, 2), alpha=-2.0)
                return torch.topk(d2, k, dim=-1, largest=False)

            library_ms = cuda_ms(torch, library, reps=3)
            bound_ms, bound_by = scan_bound(w, tq, lp, d, k, code)
            log("kernel", case=f"main_shape_{code}_k{k}", variant=v.name, max_abs_err=err,
                kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                bound_by=bound_by, gflops=f"{w * tq * lp * (2 * d + 3) / ms / 1e6:.1f}",
                ok=True)
            out[f"{code}_k{k}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
        del codes, meta, dead, x
        torch.cuda.empty_cache()
    del x32

    # the wide kernel on uint8 codes, its list in shared memory
    q130 = torch.randn((2, 128, 130), device=dev, generator=gen)
    codes, meta, dead = code_slab(torch, dev, gen, "u8", 2, 600, 130)
    kd, ki, rd, ri = scan_both(q130, codes, meta, 150)
    x = knn_scan.dequantize(codes, meta["scale"], meta["offset"], meta["dead"])
    err = check_scan(torch, q130, x, kd, ki, rd, ri)
    assert dead_last(dead, ki)
    log("kernel", case="wide_u8_d130_k150",
        variant=knn_scan.choose_variant(130, 150, 128, 600, "u8").name, max_abs_err=err,
        ok=True)

    # integer lattices with 30 % dead rows: exact values, so the tie order
    # (lowest index, dead rows last in index order) is the plain version's
    for code in ("u8", "f16"):
        for w_, lp_, d_, k_ in ((2, 300, 3, 9), (4, 4096, 10, CODE_K), (4, 4096, 10, REFINE_K)):
            ql = torch.randint(-2, 3, (w_, 128, d_), device=dev, generator=gen).float()
            codes, meta, dead = code_slab(torch, dev, gen, code, w_, lp_, d_, lattice=True,
                                          dead_frac=0.3)
            kd, ki, rd, ri = scan_both(ql, codes, meta, k_)
            assert torch.equal(kd, rd) and torch.equal(ki, ri), f"lattice {code} tie order"
            assert dead_last(dead, ki)
            log("kernel", case=f"lattice_{code}_dead_rows", shape=(w_, 128, lp_, d_), k=k_,
                variant=knn_scan.choose_variant(d_, k_, 128, lp_, code).name, ok=True)
    return out


def phase_facade(torch, dev, seed: int) -> None:
    """KNNIndex on the card with a list longer than 128 and with rows wider
    than 128 features, against knn_brute."""
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core.brute import knn_brute
    from repro_torch.kernels import knn_scan

    rng = np.random.default_rng(seed)
    for d, k in ((10, 150), (130, 10)):
        pts = rng.standard_normal((20000, d), dtype=np.float32)
        q = rng.standard_normal((500, d), dtype=np.float32)
        res = KNNIndex.build(pts, IndexSpec(height=5, devices=(dev,))).query(q, k)
        bd, bi = knn_brute(q, pts, k, device=dev)
        assert res.dists.shape == (500, k)
        np.testing.assert_allclose(res.dists, bd, rtol=1e-5, atol=1e-6)
        log("kernel", case=f"facade_d{d}_k{k}", ids_equal=f"{(res.idx == bi).mean():.6f}",
            ok=True)
    # a tile of 256 query slots answers as one of 128, on chunked and host
    pts = rng.standard_normal((40000, 10), dtype=np.float32)
    q = rng.standard_normal((5000, 10), dtype=np.float32)
    for engine in ("chunked", "host"):
        runs = []
        for tq in (128, 256):
            index = KNNIndex.build(pts, IndexSpec(engine=engine, tile_q=tq, height=5,
                                                  devices=(dev,)))
            knn_scan.reset_launches()
            runs.append((index.query(q, 10), knn_scan.leaf_scan_units.launches))
        (r128, l128), (r256, l256) = runs
        assert np.array_equal(r256.idx, r128.idx) and np.array_equal(r256.dists, r128.dists)
        log("kernel", case=f"facade_{engine}_tile_q256", launches_tq128=l128,
            launches_tq256=l256, answers_equal=True, ok=True)


def mixture(rng, n: int, d: int, centers: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """n points from a clustered Gaussian mixture (seeded)."""
    lab = rng.integers(0, centers.shape[0], size=n)
    pts = rng.standard_normal(size=(n, d), dtype=np.float32)
    pts *= scales[lab, None]
    pts += centers[lab]
    return pts


def main_data(seed: int, shift: int = 0, d: int = 10):
    """The main cell's points (n = 2**(24 - shift)) and queries (m =
    2**(20 - shift)), d = 10, from a seeded 64-component Gaussian mixture
    (the wide cell's: the same mixture at d = 30).
    ``scripts/main_cell_time.py::mixture_data`` makes the same arrays
    (``tests/test_torch_api.py::test_main_cell_time_data_is_chip_smokes``)."""
    n, m = 2 ** (24 - shift), 2 ** (20 - shift)
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(64, d)).astype(np.float32)
    scales = rng.uniform(0.3, 1.5, size=64).astype(np.float32)
    points = mixture(rng, n, d, centers, scales)
    queries = mixture(rng, m, d, centers, scales)
    return points, queries


def check_exact(torch, index_res, points, queries, dev, n_check: int, live=None,
                brute=None):
    """Answers vs the port's knn_brute on the card for ``n_check`` queries:
    distances within rtol 1e-5, ids equal up to ties.  ``live`` (a mask
    over the rows of ``points``, which are the ids) restricts the brute
    force to a mutable index's live points, and every id returned must be
    live; ``brute`` is knn_brute's answer when the caller has it already.
    Returns the number of id positions that differ (each one a tie) and the
    number of rows whose distances are not all within that tolerance (0,
    or it raises)."""
    from repro_torch.core.brute import knn_brute

    ids = np.arange(points.shape[0]) if live is None else np.nonzero(live)[0]
    bd, bi = brute or knn_brute(queries[:n_check], points[ids], 10, device=dev)
    dists, idx = index_res.dists[:n_check], index_res.idx[:n_check]
    missed = int((~np.isclose(dists, bd, rtol=1e-5, atol=1e-6).all(1)).sum())
    np.testing.assert_allclose(dists, bd, rtol=1e-5, atol=1e-6)
    if live is not None:
        assert live[idx].all(), "a deleted or unknown id was returned"
    d_of_idx = np.sqrt(np.sum((queries[:n_check, None, :] - points[idx]) ** 2, -1))
    np.testing.assert_allclose(d_of_idx, bd, rtol=1e-5, atol=1e-6)
    return int((idx != ids[bi]).sum()), missed


def profile_query(torch, phase, index, queries, host_top: int = 0) -> None:
    """Query once more under torch.profiler (``profile_call``)."""
    profile_call(torch, phase, lambda: index.query(queries, 10), host_top)


def profile_call(torch, phase, fn, host_top: int = 0, op_top: int = 0) -> None:
    """Call ``fn`` under torch.profiler: device time by kernel name and the
    device's idle share of the call's wall time; with ``op_top``, the
    ``op_top`` torch ops whose kernels took the most device time (children
    included: ``aten::copy_`` under ``aten::to`` counts for both); with
    ``host_top``, also the host's self time in all and its ``host_top``
    largest ops (torch ops and CUDA runtime calls, every thread's).
    Returns (wall_s, busy_s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # kernel-level events only: an aten op also carries its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    log(phase, profiled_wall_s=f"{wall_s:.3f}", device_busy_s=f"{busy_s:.3f}",
        idle_share=f"{1 - busy_s / wall_s:.3f}")
    for e in events[:15]:
        print(f"[{phase}]   device {e.self_device_time_total / 1e3:10.1f} ms "
              f"{e.count:8d}x {e.key[:90]}", flush=True)
    if op_top:   # the host ops whose kernels took the device's time
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")]
        ops.sort(key=lambda e: e.device_time_total, reverse=True)
        for e in ops[:op_top]:
            print(f"[{phase}]   op {e.device_time_total / 1e3:10.1f} ms {e.count:8d}x "
                  f"{e.key[:90]}", flush=True)
    if host_top:
        host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
        log(phase, host_self_s=f"{sum(e.self_cpu_time_total for e in host) / 1e6:.3f}")
        for e in host[:host_top]:
            print(f"[{phase}]   host {e.self_cpu_time_total / 1e3:10.1f} ms {e.count:8d}x "
                  f"{e.key[:90]}", flush=True)
    return wall_s, busy_s


def launch_counts(knn_scan) -> dict:
    """The leaf-scan wrapper's counts since its last reset: per code type,
    ``by_instance`` per (code type, k) and ``by_variant`` per launch name."""
    w = knn_scan.leaf_scan_units
    return dict(w.launches_by_code, by_instance=dict(w.launches_by_instance),
                by_variant=dict(w.launches_by_variant))


@contextlib.contextmanager
def record_scans(shapes: list):
    """Append each ``kernels/ops.py::leaf_scan_units`` call's (W units, TQ,
    L_pad, d) to ``shapes`` while the block runs: the launch grid, from
    which its operations W TQ L_pad (2d + 3) are reckoned."""
    from repro_torch.kernels import ops as kops

    real = kops.leaf_scan_units

    def spy(q, slab, unit_leaf, unit_query, n_units, **kw):
        shapes.append((unit_leaf.shape[0], unit_query.shape[1], slab.shape[1], slab.shape[2]))
        return real(q, slab, unit_leaf, unit_query, n_units, **kw)

    kops.leaf_scan_units = spy
    try:
        yield
    finally:
        kops.leaf_scan_units = real


def one_card(torch):
    """The devices of a cell that runs on one card: None (the default: every
    visible card, here the one) on a one-card machine, ``(cuda:0,)`` where
    more are visible, over which planner rule 3 would spread the index."""
    return (torch.device("cuda", 0),) if torch.cuda.device_count() > 1 else None


def run_query(torch, phase, points, queries, spec, n_check, dev, profile=False):
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.kernels import knn_scan

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if one_card(torch):
        spec = (spec or IndexSpec()).replace(devices=one_card(torch))
    t0 = time.perf_counter()
    index = KNNIndex.build(points, spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    res = index.query(queries, 10)
    query_s = time.perf_counter() - t0
    by_code = dict(knn_scan.leaf_scan_units.launches_by_code)
    launches = launch_counts(knn_scan)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9   # this build + query
    if index.plan.engine != "kdtree":
        assert index._state._engine.backend == "cuda", index._state._engine.backend
    assert np.isfinite(res.dists).all() and res.dists.shape == (queries.shape[0], 10)
    assert (res.idx >= 0).all()
    ties, missed = check_exact(torch, res, points, queries, dev, n_check)
    st = res.stats
    MEASURED[phase] = dict(query_s=query_s, m=queries.shape[0], chunk_rounds=st.chunk_rounds)
    log(phase, engine=index.plan.engine, n_chunks=index.plan.n_chunks,
        height=index.plan.height, precision=index.plan.precision,
        resident_bytes=index.resident_bytes(),
        build_s=f"{build_s:.3f}", query_s=f"{query_s:.3f}",
        qps=f"{queries.shape[0] / query_s:.1f}", rounds=st.iterations,
        flushes=st.flushes, plan_shapes=st.plan_shapes,
        chunk_rounds=st.chunk_rounds, units=st.units_scanned,
        steady_rounds=st.steady_rounds, tail_rounds=st.tail_rounds,
        compactions=st.compactions, chunk_copies=st.chunk_copies,
        sync_wait_s=f"{st.sync_wait_s:.3f}", steady_s=f"{st.steady_s:.3f}",
        tail_s=f"{st.tail_s:.3f}", refined_rows=st.refined_rows, exact_rows=st.exact_rows,
        kernel_launches=",".join(f"{c}:{n}" for c, n in by_code.items()),
        instances=",".join(f"{c}:{n}" for c, n in launches["by_instance"].items()),
        checked=n_check, tie_swaps=ties,
        **{"fp32_rows_missed" if index.plan.precision == "fp32" else "rows_missed": missed},
        peak_mem_gb=f"{peak_gb:.3f}")
    for r in index.plan.reasons:
        print(f"[{phase}]   plan: {r}", flush=True)
    if profile:
        profile_query(torch, phase, index, queries)
    return index, res, launches, build_s


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shift", type=int, default=0,
                    help="divide n and m by 2**shift (default: full size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ooc-shift", type=int, default=4,
                    help="run the streamed cells (ooc, quant_ooc) on n / 2**ooc_shift "
                         "points (default 4, which keeps the whole script within "
                         "its time limit; 0 runs them at full depth)")
    ap.add_argument("--host-shift", type=int, default=4,
                    help="run the host cells (host, host_ooc, kdtree) on n / "
                         "2**host_shift points and m / 2**host_shift queries (default "
                         "4, the ooc cells' depth; 0: main's data whole)")
    ap.add_argument("--wide-shift", type=int, default=2,
                    help="run the wide cell (d = 30) on n / 2**wide_shift points and "
                         "m / 2**wide_shift queries (default 2: n = 2**22, m = 2**18; "
                         "0: n = 2**24, m = 2**20)")
    ap.add_argument("--mutable-shift", type=int, default=3,
                    help="run the mutable cell on n / 2**mutable_shift points of main's "
                         "mixture (default 3: n = 2**21, built on 3n/4, the rest "
                         "inserted) and m / 2**mutable_shift queries")
    ap.add_argument("--serve-shift", type=int, default=3,
                    help="divide the serve cell's burst (8192), paced (2048) and sla "
                         "(1024) request counts by 2**serve_shift (default 3: 1024, "
                         "256 and 128; at 4 the burst no longer fills the 1024-row "
                         "bucket, its zero pad rows retire last and the cell takes "
                         "longer)")
    ap.add_argument("--multi-shift", type=int, default=4,
                    help="run the multi cell (forest, sharded and ring on four slots "
                         "of the card, chunked on one) on n / 2**multi_shift points and "
                         "m / 2**multi_shift queries (default 4: n = 2**20, m = 2**16, "
                         "which keeps the whole script within its time limit with the "
                         "lm, train and families cells; 2: n = 2**22 as the paper's "
                         "multi-device findings were measured; 0: n = 2**24, m = 2**20)")
    ap.add_argument("--lm-shift", type=int, default=1,
                    help="divide the lm cell's corpus (512 sequences of 2048 tokens: "
                         "2**20 pairs) and query counts (32, 256 and 64 held-out "
                         "sequences) by 2**lm_shift (default 1, which keeps the whole "
                         "script within its time limit with the train and families "
                         "cells; 0: 2**20 pairs)")
    ap.add_argument("--profile", nargs="?", const="main,ooc", default="",
                    help="also run these cells' query once under torch.profiler "
                         "(comma-separated, of main, ooc, quant, quant_ooc, jit, "
                         "host, multi, lm (one embedding pass and a decode run), "
                         "train (one train step); no value: main,ooc)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # cuBLAS reads this at its first call: the train cell's deterministic
    # replays need it (use_deterministic_algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.api import IndexSpec, estimate_slab_bytes
    from repro_torch.core.brute import knn_brute
    from repro_torch.core.toptree import suggest_height

    from repro_torch.core.lazysearch import FP32_OVERFETCH
    from repro_torch.core.quantize import QUANT_REFINE_OVERFETCH

    global MAIN_K_EFF, REFINE_K
    MAIN_K_EFF = 10 + FP32_OVERFETCH
    REFINE_K = 10 + QUANT_REFINE_OVERFETCH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    phase_env(torch)
    phase_build()
    dryruns = start_dryruns()
    profiled = set(filter(None, args.profile.split(",")))
    scan, codes, wide, lm_scan = phase_kernel(torch, dev, args.seed)
    phase_facade(torch, dev, args.seed)

    t0 = time.perf_counter()
    points, queries = main_data(args.seed, args.shift)
    (n, d), m = points.shape, queries.shape[0]
    log("main", n=n, m=m, d=d, k=10, data_s=f"{time.perf_counter() - t0:.3f}")

    cells = {}
    index, res, launches, build_s = run_query(
        torch, "main", points, queries, None, 1024, dev, "main" in profiled)
    assert index.plan.engine == "chunked", index.plan.engine
    assert index.plan.n_chunks == 1, index.plan.n_chunks
    assert launches["f32"] > 0, "the leaf-scan kernel did not run on the main path"
    cells["main"] = launches
    slab_bytes = index.plan.slab_bytes
    cells["persist_main"] = run_persist(torch, "main", index, build_s, queries[:PERSIST_M])
    del index
    torch.cuda.empty_cache()

    def same_answers(phase, other, ref=res, ref_points=points):
        """``other`` against the fp32 answers ``ref`` on every query: a
        differing id must be a tie (the same distance at that rank).  Rows
        whose distances differ are settled by knn_brute: both must be exact
        there (the fp32 path proves its rows, so ``fp32_rows_missed`` must
        be 0)."""
        same = other.idx == ref.idx
        off = np.nonzero(~np.isclose(other.dists, ref.dists, rtol=1e-5, atol=1e-6).all(1))[0]
        ref_missed = 0
        if off.size:
            bd, _ = knn_brute(queries[off], ref_points, 10, device=dev)
            np.testing.assert_allclose(other.dists[off], bd, rtol=1e-5, atol=1e-6)
            ref_missed = int((~np.isclose(ref.dists[off], bd, rtol=1e-5, atol=1e-6).all(1)).sum())
        log(phase, rows_identical=f"{same.all(axis=1).mean():.6f}",
            dists_identical=bool(np.array_equal(other.dists, ref.dists)),
            rows_off=off.size, fp32_rows_missed=ref_missed)
        assert ref_missed == 0, f"{phase}: the fp32 answers missed {ref_missed} rows"

    # the streamed cells run on the first n / 2**ooc_shift points (a smaller
    # depth of the same mixture); they compare with main at full depth, with
    # the fp32 ooc cell otherwise
    ooc_points = points[: n >> args.ooc_shift]
    ooc_slab = estimate_slab_bytes(ooc_points.shape[0], d, suggest_height(ooc_points.shape[0]))
    spec = IndexSpec(precision="fp32", memory_budget=ooc_slab // 3)
    ooc, res2, launches2, _ = run_query(
        torch, "ooc", ooc_points, queries, spec, 1024, dev, "ooc" in profiled)
    assert ooc.plan.n_chunks >= 2, ooc.plan.n_chunks
    assert res2.stats.chunk_copies > 0
    assert launches2["f32"] > 0
    cells["ooc"] = launches2
    ooc_ref = res if args.ooc_shift == 0 else res2
    if args.ooc_shift == 0:
        same_answers("ooc", res2)
    del ooc
    torch.cuda.empty_cache()

    # planner rule 4 under a budget, the precision not pinned: int8, N = 1
    budget = slab_bytes // 3
    quant, res3, launches3, build_s = run_query(
        torch, "quant", points, queries, IndexSpec(memory_budget=budget), 1024, dev,
        "quant" in profiled)
    assert (quant.plan.precision, quant.plan.n_chunks) == ("int8", 1), quant.describe()
    assert quant.resident_bytes() <= budget, (quant.resident_bytes(), budget)
    assert launches3["u8"] > 0 and launches3["f32"] == 0, launches3
    same_answers("quant", res3)
    cells["quant"] = launches3
    cells["persist_quant"] = run_persist(torch, "quant", quant, build_s, queries[:PERSIST_M])
    del quant, res3
    torch.cuda.empty_cache()

    quant_ooc, res4, launches4, _ = run_query(
        torch, "quant_ooc", ooc_points, queries, IndexSpec(memory_budget=ooc_slab // 12),
        1024, dev, "quant_ooc" in profiled)
    assert quant_ooc.plan.precision == "int8" and quant_ooc.plan.n_chunks >= 2, (
        quant_ooc.describe())
    assert res4.stats.chunk_copies > 0 and launches4["u8"] > 0
    same_answers("quant_ooc", res4, ooc_ref, ooc_points)
    # the roofline phase plans the ooc cell's points under a calibration
    cal_cell = dict(points=ooc_points.copy(), queries=queries[:1024].copy(),
                    spec=IndexSpec(precision="fp32", memory_budget=ooc_slab // 3))
    cells["quant_ooc"] = launches4
    del quant_ooc, res4
    torch.cuda.empty_cache()

    cells["stream"], stream_index, round_s = run_stream(
        torch, points, queries[: min(m, STREAM_M)], res, dev)
    cells["mutable"], mutable_index, mut_points, mut_live = run_mutable(
        torch, dev, args.seed, args.shift + args.mutable_shift)
    cells.update(run_serve(torch, stream_index, round_s, queries, res.dists, res.idx,
                           mutable_index, mut_points, mut_live, dev, args.serve_shift))
    del stream_index, mutable_index, mut_points, mut_live
    gc.collect()   # servers and tickets refer to each other: free the indexes now
    torch.cuda.empty_cache()
    cells["drills"] = run_drills(torch, dev)
    cells["fp16"] = run_fp16(torch, points[: n // 4], queries[: m // 4], dev)
    run_jit(torch, points, queries, res, dev, same_answers, "jit" in profiled)

    # the host cells: the paper's Algorithm 1 on main's data, whole or at
    # the ooc cell's depth (whose fp32 answers they must equal)
    hs = args.host_shift
    if hs not in (0, args.ooc_shift):
        raise SystemExit(f"--host-shift must be 0 or --ooc-shift ({args.ooc_shift})")
    host_ref = res if hs == 0 else res2
    cells.update(run_host(torch, points[: n >> hs], queries[: m >> hs], host_ref, dev,
                          same_answers, "host" in profiled))
    del points, queries, res, res2
    torch.cuda.empty_cache()
    run_dual(torch, dev, args.seed, args.shift)
    cells["wide"] = run_wide(torch, dev, args.seed, args.shift + args.wide_shift)
    cells.update(run_multi(torch, dev, args.seed, args.shift + args.multi_shift,
                           "multi" in profiled))
    cells.update(run_lm(torch, dev, args.seed, args.shift + args.lm_shift, "lm" in profiled))
    run_train(torch, dev, args.seed, "train" in profiled)
    run_families(torch, dev, args.seed)
    run_dist(torch, dev, args.seed)
    multi_shift = args.shift + args.multi_shift
    run_roofline(torch, dev, args.seed, dryruns, cal_cell,
                 ring=(cells["multi_slots4_ring"]["shapes"], 2 ** (24 - multi_shift),
                       2 ** (20 - multi_shift), 10, 4))

    def entry(name, kind, code, head_key, cell, timed, width=None):
        """The JSON line's entry for the ``kind`` kernel ("narrow" or
        "wide") reading ``code``: the instance a k = 10 query of ``cell``
        first runs (``head_key``), under ``instances`` every instance
        phase 3 timed or the cell ran, its launches in the cell beside its
        phase-3 times, and under ``launches_by_cell`` each cell's launches
        of this kernel and code type, by variant name.  With ``width``,
        only the narrow instances of rows that wide (their launch counts'
        keys, which name no width, gain it: ``cell`` launches no other)."""
        head = timed[head_key]
        by_instance = cell["by_instance"]
        if width:
            by_instance = {key.replace("_k", f"_d{width}_k", 1): n
                           for key, n in by_instance.items()}
        keys = sorted(set(by_instance) | set(timed))
        prefix = f"{kind}<{width}," if width else f"{kind}<"

        def variants(launches):
            return {v: n for v, n in launches["by_variant"].items()
                    if v.startswith(prefix) and (v.rsplit("/", 1)[-1] if v.rsplit(
                        "/", 1)[-1] in ("u8", "f16") else "f32") == code}

        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/leaf_scan.cu",
            "replaces": "src/repro/kernels/knn_scan.py:213",
            "launches": sum(variants(cell).values()),
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "instances": {key: dict(launches=by_instance.get(key, 0),
                                    **timed.get(key, {})) for key in keys},
            "launches_by_cell": {c: dict(launches=sum(v.values()), variants=v)
                                 for c, v in ((c, variants(n)) for c, n in cells.items())
                                 if v},
        }

    kernels = [entry("leaf_scan", "narrow", "f32", f"f32_k{MAIN_K_EFF}", launches, scan),
               # the same kernel reading uint8 codes (quant cell, k = 10 -> 18)
               entry("leaf_scan_codes", "narrow", "u8", f"u8_k{CODE_K}", launches3, codes),
               # rows of d > 16 (wide cell, d = 30, k = 10 -> 16)
               entry("leaf_scan_wide", "wide", "f32", f"f32_d{WIDE_CELL_D}_k{MAIN_K_EFF}",
                     cells["wide"], wide),
               # the kNN-LM's keys (lm cell, d = 16, k = 10 -> 16)
               entry("leaf_scan_lm_keys", "narrow", "f32", f"f32_d{LM_KEY_D}_k{MAIN_K_EFF}",
                     cells["lm"], lm_scan, width=LM_KEY_D)]
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_stream(torch, points, queries, main_res, dev):
    """query_stream on the streaming engine: every row delivered exactly
    once, equal to main's query() rows up to ties, and the times to the
    first and the last delivery.  Returns the launch counts, the index (the
    serve cell fronts it) and its seconds per round (the serve cell's
    estimate seed)."""
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.kernels import knn_scan

    ms = queries.shape[0]
    index = KNNIndex.build(points, IndexSpec(engine="streaming", devices=one_card(torch)))
    seen = np.zeros(ms, np.int64)
    got_d = np.zeros((ms, 10), np.float32)
    got_i = np.zeros((ms, 10), np.int64)
    at = []

    def on_complete(rows, dists, idx):
        at.append(time.perf_counter())
        seen[rows] += 1
        got_d[rows] = dists
        got_i[rows] = idx

    torch.cuda.synchronize()
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    r = index.query_stream(queries, 10, on_complete=on_complete)
    total_s = time.perf_counter() - t0
    launches = knn_scan.leaf_scan_units.launches_by_code["f32"]
    assert index.plan.engine == "streaming" and launches > 0
    assert (seen == 1).all(), "a row was not delivered exactly once"
    assert np.array_equal(got_i, r.idx) and np.array_equal(got_d, r.dists)
    ref_d, ref_i = main_res.dists[:ms], main_res.idx[:ms]
    same = r.idx == ref_i
    if not same.all():
        np.testing.assert_allclose(r.dists, ref_d, rtol=1e-5, atol=1e-6)
    cell = launch_counts(knn_scan)
    round_s = total_s / max(1, r.stats.iterations)
    log("stream", m=ms, emissions=len(at), early_retired=r.stats.early_retired,
        first_s=f"{at[0] - t0:.3f}", last_s=f"{at[-1] - t0:.3f}",
        query_stream_s=f"{total_s:.3f}", rounds=r.stats.iterations,
        round_s=f"{round_s:.6f}",
        kernel_launches=launches, rows_identical=f"{same.all(axis=1).mean():.6f}",
        ok=True)
    return cell, index, round_s


def run_fp16(torch, points, queries, dev) -> None:
    """precision pinned to fp16: the kernel reading float16 codes end to end."""
    from repro_torch.api import IndexSpec

    index, res, launches, _ = run_query(
        torch, "fp16", points, queries, IndexSpec(engine="chunked", precision="fp16"), 1024,
        dev)
    assert index.plan.precision == "fp16", index.plan.precision
    assert launches["f16"] > 0 and launches["f32"] == 0, launches
    del index
    torch.cuda.empty_cache()
    return launches


def run_jit(torch, points, queries, main_res, dev, same_answers, profile=False) -> None:
    """IndexSpec(engine="jit") on main's points and queries: the round
    captured as a CUDA graph at warm and replayed by the query; answers
    equal main's up to ties (rows whose distances differ settled by
    knn_brute, both exact there).  The leaf-scan wrapper counts its launches
    only at the eager round and at capture: the kernel runs once per round
    executed, so launches are printed as eager rounds + graph replays.

    The round's own counts are checked too: the stamp and tally wrappers
    launch five stamps and one tally at the eager round and at the capture
    and nothing at a replay; the query's counts and phase seconds are
    printed with the live curve of its round log; and the phase seconds of
    the first ``STAMP_ROUNDS`` replayed rounds at the query's own m are held
    against a ``torch.profiler`` trace of them (``stamp.trace_bounds``):
    each no less than its kernels' span between its stamps and no more than
    its stamps' span, to within a microsecond a stamp."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch import tracing
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core.jitsearch import PHASES, lazy_knn_jit
    from repro_torch.kernels import knn_scan, stamp

    m = queries.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = KNNIndex.build(points, IndexSpec(engine="jit", devices=one_card(torch)))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stamp.reset_launches()
    index.warm(m, 10)          # one eager round, then the capture
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert stamp.launches == {"stamp": 10, "tally": 2}, stamp.launches
    (rounds_state,) = index._state.rounds.values()
    eager0, replays0 = rounds_state.eager_rounds, rounds_state.replays
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    res = index.query(queries, 10)
    query_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replays = rounds_state.replays - replays0
    eager = rounds_state.eager_rounds - eager0
    wrapper = knn_scan.leaf_scan_units.launches_by_code["f32"]
    assert stamp.launches == {"stamp": 10, "tally": 2}, stamp.launches
    qs, work = res.stats, rounds_state.last
    (rounds_span,) = [sp for sp in tracing.spans()
                      if sp.name == "query.rounds" and sp.call == qs.call]
    phases_s = sum(sec for _, sec in qs.phase_s)
    assert 0 < phases_s <= rounds_span.seconds, (phases_s, rounds_span.seconds)
    visits = work.log[:, 0]
    live = {}
    for pct in (50, 10, 1):
        under = np.flatnonzero(visits < m * pct / 100)
        live[f"live_under_{pct}pct_at_round"] = int(under[0]) + 1 if under.size else None
    log("jit_counts", leaf_visits=qs.leaf_visits, useful_pairs=qs.useful_pairs,
        units_scanned=qs.units_scanned, scan_pairs=qs.scan_pairs,
        steady_rounds=qs.steady_rounds, iterations=qs.iterations,
        round_fill_pct=100 * qs.leaf_visits / (m * qs.steady_rounds),
        scan_fill_pct=100 * qs.useful_pairs / qs.scan_pairs,
        **{f"{name}_s": sec for name, sec in qs.phase_s}, phases_s=phases_s,
        rounds_span_s=rounds_span.seconds, **live)
    # the fixed point alone (replayed rounds + the device rescoring), without
    # the certificate and the brute force of unproven rows
    st = index._state
    q_dev = torch.from_numpy(queries).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lazy_knn_jit(q_dev, st.tree, k=rounds_state.k, tq=st.tq,
                 first_leaf_heap=st.top.first_leaf_heap, backend=st.backend, cache=st.rounds)
    torch.cuda.synchronize()
    fixed_point_s = time.perf_counter() - t0
    # the stamps against the profiler's trace of the same rounds
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        rounds_state.run(q_dev, max_rounds=STAMP_ROUNDS)
    cuda = torch.autograd.DeviceType.CUDA
    inner, outer = stamp.trace_bounds(
        (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)
    traced = rounds_state.last
    assert inner.shape == (traced.executed, len(PHASES)), (inner.shape, traced.executed)
    step = 1e-6 * traced.executed
    for p, (name, sec) in enumerate(traced.phase_s):
        lo, hi = float(inner[:, p].sum()), float(outer[:, p].sum())
        log("jit_stamps", of=name, rounds=traced.executed, kernels_s=lo, stamped_s=sec,
            stamps_s=hi, inside=lo - step <= sec <= hi + step)
        assert lo - step <= sec <= hi + step and lo > 0, (name, lo, sec, hi)
    del q_dev
    assert index.plan.engine == "jit" and rounds_state.graph is not None
    assert replays > 0 and eager == 0, (replays, eager)
    assert np.isfinite(res.dists).all() and (res.idx >= 0).all()
    assert res.stats.iterations <= replays
    log("jit", build_s=f"{build_s:.3f}", warm_capture_s=f"{warm_s:.3f}",
        query_s=f"{query_s:.3f}", qps=f"{m / query_s:.1f}",
        fixed_point_s=f"{fixed_point_s:.3f}", rounds=res.stats.iterations,
        main_rounds=main_res.stats.iterations, graph_replays=replays,
        kernel_launches=f"{eager + replays} (rounds x 1: eager {eager} + replays {replays}; "
                        f"the wrapper counted {wrapper})",
        sync_every=rounds_state.sync_every, exact_rows=res.stats.exact_rows,
        peak_mem_gb=f"{peak_gb:.3f}")
    same_answers("jit", res)
    if profile:
        profile_query(torch, "jit", index, queries)
    del index
    torch.cuda.empty_cache()


def run_host(torch, points, queries, ref, dev, same_answers, profile=False) -> dict:
    """The host cells on ``points`` / ``queries`` (``ref``: fp32 answers of
    another engine on the same points, for the first rows): ``host``
    (IndexSpec(engine="host")), ``host_ooc`` (the same, fp32, under
    memory_budget = slab_bytes // 3) and ``kdtree`` (the paper's CPU
    baseline, KDTREE_M queries, timed beside host and chunked on the same
    rows).  Every scan of the host loop must be a launch of the CUDA kernel
    (one per chunk round).  Returns each cell's launch counts."""
    from types import SimpleNamespace

    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.kernels import knn_scan

    m = queries.shape[0]
    mine = SimpleNamespace(dists=ref.dists[:m], idx=ref.idx[:m])
    out = {}
    host, res, launches, _ = run_query(torch, "host", points, queries,
                                       IndexSpec(engine="host"), 1024, dev, profile)
    st = res.stats
    assert host.plan.engine == "host" and host.plan.n_chunks == 1, host.describe()
    assert launches["f32"] == st.chunk_rounds > 0, (launches, st.chunk_rounds)
    same_answers("host", res, mine, points)
    out["host"] = launches
    slab = host.plan.slab_bytes
    spec = IndexSpec(engine="host", precision="fp32", memory_budget=slab // 3)
    ooc, res_ooc, launches, _ = run_query(torch, "host_ooc", points, queries, spec, 1024, dev)
    assert ooc.plan.n_chunks >= 2 and res_ooc.stats.chunk_copies > 0, ooc.describe()
    assert launches["f32"] == res_ooc.stats.chunk_rounds > 0, launches
    same_answers("host_ooc", res_ooc, res, points)
    out["host_ooc"] = launches
    del ooc, res_ooc
    torch.cuda.empty_cache()

    # the paper's comparison: classic traversal against the buffered engines
    q = queries[:KDTREE_M]
    t0 = time.perf_counter()
    kdtree = KNNIndex.build(points, IndexSpec(engine="kdtree", devices=(dev,)))
    build_s = time.perf_counter() - t0
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    kd = kdtree.query(q, 10)
    kd_s = time.perf_counter() - t0
    out["kdtree"] = launch_counts(knn_scan)
    assert out["kdtree"]["f32"] == 0 and kdtree.resident_bytes() == 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hq = host.query(q, 10)
    host_s = time.perf_counter() - t0
    del host
    torch.cuda.empty_cache()
    chunked = KNNIndex.build(points, IndexSpec(engine="chunked", devices=one_card(torch)))
    chunked.query(q[:1024], 10)       # first call on this index, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cq = chunked.query(q, 10)
    chunked_s = time.perf_counter() - t0
    del chunked
    torch.cuda.empty_cache()
    np.testing.assert_allclose(kd.dists, hq.dists, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cq.dists, hq.dists, rtol=1e-5, atol=1e-6)
    d_of_idx = np.sqrt(np.sum((q[:, None, :] - points[kd.idx]) ** 2, -1))
    np.testing.assert_allclose(d_of_idx, hq.dists, rtol=1e-5, atol=1e-6)
    MEASURED["kdtree"] = dict(m=q.shape[0], host_s=host_s, chunked_s=chunked_s)
    log("kdtree", n=points.shape[0], m=q.shape[0], build_s=f"{build_s:.3f}",
        query_s=f"{kd_s:.3f}", qps=f"{q.shape[0] / kd_s:.1f}",
        host_query_s=f"{host_s:.3f}", host_qps=f"{q.shape[0] / host_s:.1f}",
        chunked_query_s=f"{chunked_s:.3f}", chunked_qps=f"{q.shape[0] / chunked_s:.1f}",
        speedup_host=f"{kd_s / host_s:.2f}", speedup_chunked=f"{kd_s / chunked_s:.2f}",
        ids_equal_host=f"{(kd.idx == hq.idx).mean():.6f}", answers_equal_host=True)
    return out


def run_persist(torch, phase, index, build_s, queries) -> dict:
    """Save ``index`` to a temporary directory on local disk and load it
    onto the card: save_s, load_s (to a ready index on the card) and bytes
    on disk beside build_s; ``queries`` answered bit for bit as before the
    save.  Returns the launch counts of the loaded index's query."""
    import shutil
    import tempfile

    from repro_torch.api import KNNIndex
    from repro_torch.kernels import knn_scan

    before = index.query(queries, 10)
    root = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        t0 = time.perf_counter()
        index.save(root)
        save_s = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(root) for f in files)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = KNNIndex.load(root, devices=one_card(torch))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        knn_scan.reset_launches()
        after = loaded.query(queries, 10)
        launches = launch_counts(knn_scan)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert np.array_equal(after.idx, before.idx) and np.array_equal(after.dists, before.dists)
    assert loaded.plan.precision == index.plan.precision
    assert sum(launches[c] for c in ("f32", "f16", "u8")) > 0, launches
    log("persist", index=phase, engine=loaded.plan.engine, precision=loaded.plan.precision,
        build_s=f"{build_s:.3f}", save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}",
        bytes_on_disk=on_disk, queries=queries.shape[0], answers_bit_for_bit=True)
    del loaded
    torch.cuda.empty_cache()
    return launches


def run_wide(torch, dev, seed: int, shift: int) -> dict:
    """The wide cell: ``KNNIndex.build(points).query(q, 10)`` with no spec
    on main's mixture at d = WIDE_CELL_D, n = 2**(24 - shift) points and
    m = 2**(20 - shift) queries.  The plan must be chunked, fp32, N = 1, and
    every launch the wide kernel's; 1024 queries against knn_brute with
    fp32_rows_missed = 0 (``run_query``'s check, which logs it).  Returns
    the cell's launch counts."""
    t0 = time.perf_counter()
    points, queries = main_data(seed, shift, d=WIDE_CELL_D)
    log("wide", n=points.shape[0], m=queries.shape[0], d=WIDE_CELL_D, k=10,
        data_s=f"{time.perf_counter() - t0:.3f}")
    index, res, launches, _ = run_query(torch, "wide", points, queries, None, 1024, dev)
    plan = index.plan
    assert (plan.engine, plan.precision, plan.n_chunks) == ("chunked", "fp32", 1), plan
    by_variant = launches["by_variant"]
    assert launches["f32"] > 0 and by_variant, launches
    assert all(v.startswith("wide<") for v in by_variant), by_variant
    log("wide", variants=",".join(f"{v}:{n}" for v, n in by_variant.items()), ok=True)
    del index
    torch.cuda.empty_cache()
    return launches


def run_multi(torch, dev, seed: int, shift: int, profile: bool = False) -> dict:
    """The multi cell: the paper's multi-device querying on device slots,
    main's mixture at d = 10, n = 2**(24 - shift) points, m = 2**(20 -
    shift) queries, k = 10.  On ``devices=(dev,) * 4`` (and, where the
    machine has more than one card, on every visible card): no spec (the
    plan must be ``forest``), then ``sharded`` and ``ring`` pinned; then
    ``chunked`` on one slot on the same data.  Each engine is built,
    warmed for the batch (the forest captures each slot's round) and
    queried, with the launch counts set to 0 after the warm (the forest's
    query launches are its graph replays, each the kernel its warm
    captured); it prints
    build_s, warm_s, query_s, each slot's seconds, launches by variant, peak
    device memory and 1024 rows against knn_brute (fp32_rows_missed = 0),
    and whether the answers equal each other, bit for bit if they do.
    With ``profile``, each engine's query once more under torch.profiler
    (host ops too), and the sharded query once more with the chunk rounds'
    issue lock (``chunked_jit._ISSUE_LOCK``) taken away, timed beside it.
    Returns each engine's launch counts."""

    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core import chunked_jit
    from repro_torch.core.brute import knn_brute
    from repro_torch.kernels import knn_scan

    t0 = time.perf_counter()
    points, queries = main_data(seed, shift)
    m = queries.shape[0]
    log("multi", n=points.shape[0], m=m, d=points.shape[1], k=10,
        data_s=f"{time.perf_counter() - t0:.3f}")
    groups = [("slots4", (dev,) * 4)]
    if torch.cuda.device_count() > 1:
        groups.append((f"cards{torch.cuda.device_count()}",
                       tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))))
    runs = [(f"{g}_{e or 'auto'}", devs, e) for g, devs in groups
            for e in (None, "sharded", "ring")] + [("slot1_chunked", (dev,), "chunked")]
    cells, answers = {}, {}
    brute = knn_brute(queries[:1024], points, 10, device=dev)
    for name, devs, engine in runs:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = KNNIndex.build(points, IndexSpec(engine=engine, devices=devs))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        plan = index.plan
        if engine is None:
            assert plan.engine == "forest" and plan.n_shards == len(devs), index.describe()
            for r in plan.reasons:
                print(f"[multi]   {name} plan: {r}", flush=True)
        state = index._state

        def graph_rounds():
            if plan.engine != "forest":
                return 0, 0
            rs = [r for sh in state.shards for r in sh.rounds.values()]
            return sum(r.eager_rounds for r in rs), sum(r.replays for r in rs)

        knn_scan.reset_launches()
        t0 = time.perf_counter()
        index.warm(m, 10)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_launches = launch_counts(knn_scan)
        eager0, replays0 = graph_rounds()
        knn_scan.reset_launches()   # the query's own launches from here
        shapes = []
        t0 = time.perf_counter()
        with record_scans(shapes):
            res = index.query(queries, 10)
        query_s = time.perf_counter() - t0
        launches = dict(launch_counts(knn_scan), shapes=shapes)
        eager1, replays1 = graph_rounds()
        replays, eager = replays1 - replays0, eager1 - eager0
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        assert np.isfinite(res.dists).all() and (res.idx >= 0).all()
        if plan.engine == "forest":
            # every round of the query is a replay of a slot's graph, which
            # launches the kernel the warm captured (the wrapper counts it
            # at the eager round and at capture only): launches = replays
            assert replays > 0 and eager == 0, (name, replays, eager)
            assert launches["f32"] == 0, (name, launches)
            (variant,) = warm_launches["by_variant"]
            (instance,) = warm_launches["by_instance"]
            launches = dict(launches, f32=replays, by_variant={variant: replays},
                            by_instance={instance: replays})
        assert launches["f32"] > 0, f"{name}: the leaf-scan kernel did not run"
        ties, missed = check_exact(torch, res, points, queries, dev, 1024, brute=brute)
        slot_s = getattr(state, "slot_seconds", {})
        log("multi", run=name, engine=plan.engine, slots=len(devs), n_shards=plan.n_shards,
            height=plan.height, n_chunks=plan.n_chunks, resident_bytes=index.resident_bytes(),
            build_s=f"{build_s:.3f}", warm_s=f"{warm_s:.3f}", query_s=f"{query_s:.3f}",
            qps=f"{m / query_s:.1f}",
            slot_s=",".join(f"{s}:{t:.3f}" for s, t in sorted(slot_s.items())) or "-",
            rounds=res.stats.iterations, exact_rows=res.stats.exact_rows,
            refined_rows=res.stats.refined_rows,
            variants=",".join(f"{v}:{c}" for v, c in launches["by_variant"].items()),
            graph_replays=replays, query_eager_rounds=eager,
            checked=1024, tie_swaps=ties, fp32_rows_missed=missed,
            peak_mem_gb=f"{peak_gb:.3f}")
        assert missed == 0
        if profile:
            profile_query(torch, f"multi_{name}", index, queries, host_top=12)
        if profile and plan.engine == "sharded":
            lock, chunked_jit._ISSUE_LOCK = chunked_jit._ISSUE_LOCK, contextlib.nullcontext()
            try:
                t0 = time.perf_counter()
                index.query(queries, 10)
                log("multi", run=name, issue_lock=False,
                    query_s=f"{time.perf_counter() - t0:.3f}",
                    slot_s=",".join(f"{s}:{t:.3f}"
                                    for s, t in sorted(state.slot_seconds.items())))
            finally:
                chunked_jit._ISSUE_LOCK = lock
        cells[f"multi_{name}"] = launches
        answers[name] = res
        del index, state, res
        gc.collect()
        torch.cuda.empty_cache()
    names = list(answers)
    for i, name in enumerate(names):
        for ref_name in names[i + 1:]:
            res, ref = answers[name], answers[ref_name]
            off = np.nonzero(res.idx != ref.idx)
            # a differing id must be a tie: the same distance at that rank
            np.testing.assert_allclose(res.dists, ref.dists, rtol=1e-5, atol=1e-6)
            d_of = np.sqrt(np.sum((queries[off[0]] - points[res.idx[off]]) ** 2, -1))
            np.testing.assert_allclose(d_of, ref.dists[off], rtol=1e-5, atol=1e-6)
            log("multi", compare=f"{name}~{ref_name}",
                dists_bit_for_bit=bool(np.array_equal(res.dists, ref.dists)),
                ids_identical=bool(np.array_equal(res.idx, ref.idx)),
                id_positions_differing=len(off[0]), answers_equal_up_to_ties=True)
    return cells


def lm_config():
    """The lm cell's model: Qwen1.5-0.5B at full width."""
    from repro_torch.configs import get_config

    return get_config(LM_ARCH)


def run_lm(torch, dev, seed: int, shift: int, profile: bool = False) -> dict:
    """The lm cell: kNN-LM serving with Qwen1.5-0.5B at full width (random
    weights from ``seed``) on ``dev``.  A corpus of 512 >> shift sequences of
    2048 tokens (``TokenPipeline``, 2**20 pairs at shift 0) through
    ``KNNLM(lm, proj_dim=16, k=10, lam=0.25).build_datastore`` (plan chunked,
    the narrow kernel); the 2**16 keys of 32 >> shift held-out sequences
    queried and 1024 rows held against knn_brute; ``next_token_probs`` on
    256 >> shift held-out sequences (rows sum to 1, and at lam = 0 equal to
    the softmax of ``prefill``'s logits); a mutable store built on 3/4 of
    the corpus and extended in 4 batches (plan dynamic, exact, saved and
    loaded bit for bit); ``serve()`` over a streaming store of a quarter of
    the corpus (64 >> shift rows equal the direct path's); the mutable and
    streaming stores take their keys from the first build's embedding of
    the same sequences (``reuse_keys``); ``ServeEngine`` decoding 16
    requests of 64 greedy tokens in 8 slots (max_len 2048), each token
    checked against a batched replay through ``decode_step`` and the
    prefill of a prompt against the replay.  With ``profile``, one
    embedding pass and a decode run of 8 requests under torch.profiler.
    Returns the cells' launch counts: lm (the held-out query), lm_probs,
    lm_mutable, lm_serve."""
    import tempfile

    from repro_torch.api import IndexSpec
    from repro_torch.core.brute import knn_brute
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import knn_scan
    from repro_torch.models import LanguageModel
    from repro_torch.serving import KNNLM, Request, ServeEngine
    from repro_torch.serving.knnlm import EMBED_TOKENS

    cells = {}
    cfg = lm_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_cell = t0 = time.perf_counter()
    lm = LanguageModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    log("lm", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=sum(p.numel() for p in lm.parameters()),
        dtype=cfg.dtype, param_dtype=cfg.param_dtype,
        init_s=f"{time.perf_counter() - t0:.3f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")

    seqs = max(1, LM_CORPUS >> shift)
    t0 = time.perf_counter()
    batch = TokenPipeline(cfg.vocab_size, seq_len=LM_SEQ, global_batch=seqs,
                          seed=seed).global_batch_at(0)
    corpus = np.concatenate([batch["tokens"], batch["labels"][:, -1:]], axis=1)
    held = TokenPipeline(cfg.vocab_size, seq_len=LM_SEQ, global_batch=max(1, LM_PROBS >> shift),
                         seed=seed + 1).global_batch_at(0)["tokens"]
    log("lm", corpus_seqs=seqs, seq_len=LM_SEQ, pairs=seqs * LM_SEQ,
        held_out_seqs=held.shape[0], data_s=f"{time.perf_counter() - t0:.3f}")

    def capture(knn):
        """Record the keys ``knn`` embeds, and the seconds it takes."""
        keys, secs, embed = [], [0.0], knn.embed_contexts

        def recorded(tokens):
            t = time.perf_counter()
            out = embed(tokens)
            secs[0] += time.perf_counter() - t
            keys.append(out)
            return out

        knn.embed_contexts = recorded
        return keys, secs

    def reuse_keys(knn):
        """Give ``knn`` the keys the first build embedded for the corpus
        sequences it embeds, which must be consecutive from the first (the
        same LM, projection and contexts: the embedding is timed once)."""
        cursor = [0]

        def embedded(ctx):
            r0, r1 = cursor[0], cursor[0] + ctx.shape[0]
            assert np.array_equal(ctx, corpus[r0:r1, :-1]), (r0, r1)
            cursor[0] = r1
            return keys[r0 * LM_SEQ: r1 * LM_SEQ]

        knn.embed_contexts = embedded

    # the datastore: every (context -> next token) pair of the corpus
    knn = KNNLM(lm, proj_dim=LM_KEY_D, k=10, lam=0.25, seed=seed)
    keys, embed_s = capture(knn)
    torch.cuda.reset_peak_memory_stats()
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    knn.build_datastore(corpus)
    build_s = time.perf_counter() - t0
    keys = keys[0]
    plan = knn.index.plan
    assert plan.engine == "chunked", knn.index.describe()
    assert knn.index.spec.devices == (dev,) and knn.index.n == keys.shape[0] == seqs * LM_SEQ
    log("lm", datastore_keys=keys.shape[0], key_dim=keys.shape[1],
        keys_bytes=keys.nbytes, engine=plan.engine, height=plan.height,
        n_chunks=plan.n_chunks, embed_s=f"{embed_s[0]:.3f}",
        embed_tokens_per_s=f"{keys.shape[0] / embed_s[0]:.0f}",
        index_build_s=f"{build_s - embed_s[0]:.3f}",
        resident_bytes=knn.index.resident_bytes(),
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")

    # exact retrieval at scale: the held-out sequences' keys
    n_query = max(1, LM_QUERY >> shift)
    t0 = time.perf_counter()
    qkeys = knn.embed_contexts(held[:n_query])
    qembed_s = time.perf_counter() - t0
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    res = knn.index.query(qkeys, k=10)
    query_s = time.perf_counter() - t0
    cells["lm"] = launch_counts(knn_scan)
    variants = cells["lm"]["by_variant"]
    on_card = dev.type == "cuda"
    assert not on_card or variants and all(
        v.startswith(f"narrow<{LM_KEY_D},") for v in variants), variants
    assert res.dists.shape == (qkeys.shape[0], 10) and np.isfinite(res.dists).all()
    ties, missed = check_exact(torch, res, keys, qkeys, dev, min(1024, qkeys.shape[0]))
    log("lm", queries=qkeys.shape[0], embed_s=f"{qembed_s:.3f}", query_s=f"{query_s:.3f}",
        qps=f"{qkeys.shape[0] / query_s:.1f}", rounds=res.stats.iterations,
        refined_rows=res.stats.refined_rows, exact_rows=res.stats.exact_rows,
        variants=",".join(f"{v}:{c}" for v, c in variants.items()),
        checked=min(1024, qkeys.shape[0]), tie_swaps=ties, fp32_rows_missed=missed)
    assert missed == 0
    if profile:   # one embedding pass: EMBED_TOKENS tokens of whole sequences
        profile_call(torch, "lm_embed", lambda: knn.embed_contexts(
            held[: max(1, EMBED_TOKENS // LM_SEQ)]), host_top=12)

    # interpolated next-token distributions
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    p = knn.next_token_probs(held)
    probs_s = time.perf_counter() - t0
    cells["lm_probs"] = launch_counts(knn_scan)
    assert p.shape == (held.shape[0], cfg.vocab_size) and p.dtype == np.float32
    sums = p.sum(axis=1, dtype=np.float64)
    assert np.abs(sums - 1).max() <= 1e-3 and (p >= 0).all(), (sums.min(), sums.max())
    assert not on_card or cells["lm_probs"]["f32"] > 0
    n_lam0 = min(16, held.shape[0])
    knn.lam = 0.0
    p0 = knn.next_token_probs(held[:n_lam0])
    p_lm = []
    for r0 in range(0, n_lam0, 8):
        last, _ = lm.prefill({"tokens": held[r0:r0 + 8]})
        p_lm.append(torch.softmax(last[:, 0, : cfg.vocab_size], -1).cpu().numpy())
    p_lm = np.concatenate(p_lm)
    lam0_err = float(np.abs(p0 - p_lm).max())
    log("lm", probs_rows=p.shape[0], probs_s=f"{probs_s:.3f}",
        rows_per_s=f"{p.shape[0] / probs_s:.1f}",
        sum_err=f"{np.abs(sums - 1).max():.2e}", lam0_rows=n_lam0,
        lam0_max_abs_err_vs_prefill=f"{lam0_err:.2e}",
        launches=cells["lm_probs"]["f32"])
    assert lam0_err <= 1e-6, lam0_err
    del knn, p, p0, p_lm
    gc.collect()
    torch.cuda.empty_cache()

    # a growing datastore: built on 3/4 of the corpus, extended in 4 batches
    split = max(1, seqs * 3 // 4)
    mknn = KNNLM(lm, proj_dim=LM_KEY_D, k=10, lam=0.25, seed=seed, mutable=True)
    reuse_keys(mknn)
    t0 = time.perf_counter()
    mknn.build_datastore(corpus[:split])
    mbuild_s = time.perf_counter() - t0
    assert mknn.index.plan.engine == "dynamic", mknn.index.describe()
    ext_s = []
    for part in np.array_split(corpus[split:], 4):
        if not part.shape[0]:
            continue
        t0 = time.perf_counter()
        ids = mknn.extend_datastore(part)
        ext_s.append(time.perf_counter() - t0)
        assert ids.shape[0] == part.shape[0] * LM_SEQ
    t0 = time.perf_counter()
    mknn.drain_index()
    drain_s = time.perf_counter() - t0
    assert mknn.index.n == keys.shape[0] == mknn.values.shape[0]
    n_check = min(1024, qkeys.shape[0])
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    mres = mknn.index.query(qkeys, k=10)
    mquery_s = time.perf_counter() - t0
    cells["lm_mutable"] = launch_counts(knn_scan)
    mties, mmissed = check_exact(torch, mres, keys, qkeys, dev, n_check)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        version = mknn.save_datastore(tmp)
        save_s = time.perf_counter() - t0
        lknn = KNNLM(lm, proj_dim=LM_KEY_D, k=10, lam=0.25, seed=seed, mutable=True)
        t0 = time.perf_counter()
        lknn.load_datastore(tmp)
        load_s = time.perf_counter() - t0
        lres = lknn.index.query(qkeys, k=10)
    assert np.array_equal(lknn.values, mknn.values)
    assert np.array_equal(lres.dists, mres.dists) and np.array_equal(lres.idx, mres.idx)
    log("lm", mutable_engine=mknn.index.plan.engine, built_on=split * LM_SEQ,
        build_s=f"{mbuild_s:.3f}", embedding="reused",
        extend_s=",".join(f"{s:.3f}" for s in ext_s), drain_s=f"{drain_s:.3f}",
        keys=mknn.index.n, query_s=f"{mquery_s:.3f}",
        launches=cells["lm_mutable"]["f32"], checked=n_check, tie_swaps=mties,
        fp32_rows_missed=mmissed, refined_rows=mres.stats.refined_rows,
        save_version=version, save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}",
        loaded_answers_bit_for_bit=True)
    assert mmissed == 0
    del mknn, lknn, mres, lres
    gc.collect()
    torch.cuda.empty_cache()

    # retrieval through KNNServer: a streaming store of a quarter of the corpus
    sknn = KNNLM(lm, proj_dim=LM_KEY_D, k=10, lam=0.25, seed=seed,
                 index_spec=IndexSpec(engine="streaming"))
    reuse_keys(sknn)
    t0 = time.perf_counter()
    sknn.build_datastore(corpus[: max(1, seqs // 4)])
    sbuild_s = time.perf_counter() - t0
    rows = held[: max(1, LM_SERVE >> shift)]
    p_direct = sknn.next_token_probs(rows)
    server = sknn.serve(max_batch=rows.shape[0], default_deadline_ms=120_000.0)
    try:
        knn_scan.reset_launches()
        t0 = time.perf_counter()
        p_served = sknn.next_token_probs(rows)
        served_s = time.perf_counter() - t0
        cells["lm_serve"] = launch_counts(knn_scan)
        stats = server.stats()
    finally:
        sknn.unserve()
    np.testing.assert_allclose(p_served, p_direct, rtol=1e-5, atol=1e-6)
    assert stats["completed"] == rows.shape[0]
    assert not on_card or cells["lm_serve"]["f32"] > 0 and cells["lm_mutable"]["f32"] > 0
    log("lm", serve_engine=sknn.index.plan.engine, keys=sknn.index.n,
        build_s=f"{sbuild_s:.3f}", embedding="reused", served_rows=rows.shape[0], served_s=f"{served_s:.3f}",
        batches=stats["batches"], close=stats["batches_by_close"],
        launches=cells["lm_serve"]["f32"],
        max_abs_diff_vs_direct=f"{np.abs(p_served - p_direct).max():.2e}")
    del sknn, server, p_direct, p_served
    gc.collect()
    torch.cuda.empty_cache()
    del corpus, keys, qkeys

    # decode: continuous batching, greedy
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=r, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(3, 13))
                                               ).astype(np.int32),
                    max_new_tokens=LM_NEW_TOKENS) for r in range(LM_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(lm, slots=LM_SLOTS, max_len=LM_MAX_LEN, seed=seed)
    for req in reqs:
        eng.submit(req)
    t0 = time.perf_counter()
    done = eng.run()
    decode_s = time.perf_counter() - t0
    new_tokens = sum(len(r.out_tokens) for r in done.values())
    assert sorted(done) == list(range(LM_REQUESTS))
    assert all(len(r.out_tokens) == LM_NEW_TOKENS for r in done.values())
    log("lm", requests=LM_REQUESTS, slots=LM_SLOTS, max_len=LM_MAX_LEN,
        new_tokens=new_tokens, decode_steps=eng.decode_steps, decode_s=f"{decode_s:.3f}",
        tokens_per_s=f"{new_tokens / decode_s:.1f}",
        ms_per_step=f"{decode_s / eng.decode_steps * 1e3:.2f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del eng
    if profile:   # a decode run of one slot group, 16 new tokens each
        eng = ServeEngine(lm, slots=LM_SLOTS, max_len=LM_MAX_LEN, seed=seed)
        for req in reqs[:LM_SLOTS]:
            eng.submit(Request(rid=req.rid, prompt=req.prompt, max_new_tokens=16))
        wall_s, busy_s = profile_call(torch, "lm_decode", eng.run, host_top=12)
        log("lm_decode", decode_steps=eng.decode_steps,
            wall_ms_per_step=f"{wall_s / eng.decode_steps * 1e3:.2f}",
            device_ms_per_step=f"{busy_s / eng.decode_steps * 1e3:.2f}")
        del eng

    # the engine's tokens against a replay of each request's prompt and
    # emitted tokens through decode_step, the requests of each admission
    # round in the slots the engine gave them (round r: rids 8r .. 8r + 7),
    # each row at its own position from 0
    margins, first_logits = [], {}
    for r0 in range(0, LM_REQUESTS, LM_SLOTS):
        group = [done[rid] for rid in range(r0, min(r0 + LM_SLOTS, LM_REQUESTS))]
        streams = [list(map(int, g.prompt)) + g.out_tokens for g in group]
        caches = lm.init_cache(LM_SLOTS, LM_MAX_LEN)
        for t in range(max(len(s) for s in streams) - 1):
            toks = np.zeros((LM_SLOTS, 1), np.int64)
            active = np.zeros((LM_SLOTS,), bool)
            for s, st in enumerate(streams):
                if t < len(st) - 1:
                    toks[s, 0], active[s] = st[t], True
            lg, caches = lm.decode_step({"tokens": toks, "pos": np.full(LM_SLOTS, t),
                                         "active": active}, caches)
            rows = lg[:, 0, : cfg.vocab_size].cpu().numpy()
            for s, g in enumerate(group):
                i = t - (len(g.prompt) - 1)    # the emitted token this step predicts
                if active[s] and i >= 0:
                    margins.append(float(rows[s].max() - rows[s][g.out_tokens[i]]))
                    if i == 0:
                        first_logits[g.rid] = rows[s]
        del caches
    worst = max(margins)
    assert len(margins) == new_tokens
    # prefill of each of the first round's prompts against the replay's
    # logits at its last prompt position.  Every card run has read 0 (the
    # same bf16 roundings); the limits leave room for other GEMM shapes to
    # round otherwise: 0.03 on any logit (a few bf16 steps at the logits'
    # scale, printed), 0.003 on the mean; a wrong position, cache slot or
    # mask moves them by far more
    diffs = []
    for g in (done[rid] for rid in range(min(LM_SLOTS, LM_REQUESTS))):
        last, _ = lm.prefill({"tokens": g.prompt[None]})
        diffs.append(np.abs(last[0, 0, : cfg.vocab_size].cpu().numpy() - first_logits[g.rid]))
    prefill_max = max(float(d.max()) for d in diffs)
    prefill_mean = float(np.mean([d.mean() for d in diffs]))
    logit_scale = float(np.mean([np.abs(first_logits[g]).mean() for g in first_logits]))
    log("lm", replayed_tokens=len(margins), worst_margin=f"{worst:.2e}",
        prefill_vs_replay_max=f"{prefill_max:.3e}", prefill_vs_replay_mean=f"{prefill_mean:.3e}",
        mean_abs_logit=f"{logit_scale:.3f}")
    assert worst <= 1e-3, worst
    assert prefill_max <= 0.03 and prefill_mean <= 0.003, (prefill_max, prefill_mean)
    log("lm", cell_s=f"{time.perf_counter() - t_cell:.1f}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return cells


def train_config():
    """The train cell's model: Qwen1.5-0.5B at full width (remat "full")."""
    from repro_torch.configs import get_config

    return get_config(TRAIN_ARCH)


def family_config(arch: str):
    """The families phase's model: ``arch`` at full width, mamba2_370m at full
    depth, the others one cycle of their layer pattern."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if arch == FAMILY_FULL_DEPTH else cfg.replace(n_layers=cfg.group_size())


def _param_drift(torch, a: dict, b: dict, base: dict = None, skip=("b_k",)) -> float:
    """||a - b|| / ||b - base|| over two state dicts (the norms over every
    tensor; ``base`` None: ||a - b|| / ||b||).  The attention key bias is
    left out: its gradient is 0 in exact arithmetic, so AdamW steps it by
    the sign of rounding noise."""
    num = den = 0.0
    for k, v in b.items():
        if k.rsplit(".", 1)[-1] in skip:
            continue
        num += float((a[k].float() - v.float()).square().sum())
        ref = v.float() if base is None else v.float() - base[k].float()
        den += float(ref.square().sum())
    return (num / max(den, 1e-300)) ** 0.5


def train_step_ops(cfg, lm, seq: int, tokens: int):
    """(bf16 matrix-product operations, fp32 attention operations) of one
    train step, from the shapes: 2 per weight and token in the bf16
    products (the tied embedding is the unembedding's), 4 L S H dh per
    token in the fp32 attention scores and values (the full square the
    port computes); forward, its recompute under remat and the backward's
    two: 4 forwards a step."""
    mm = sum(p.numel() for n, p in lm.named_parameters() if p.dim() >= 2
             and (cfg.tie_embeddings or n != "embed.embedding"))
    return 4 * 2 * mm * tokens, 4 * 4 * cfg.n_layers * seq * cfg.n_heads * cfg.d_head * tokens


def run_train(torch, dev, seed: int, profile: bool = False) -> None:
    """The train cell: Qwen1.5-0.5B at full width (random weights from
    ``seed``, fp32 parameters, bf16 compute, remat "full") trained on
    ``TokenPipeline(151936, 1024, 8)`` (8 x 1024 tokens a step, lr 3e-3,
    warmup 5) for 24 steps, checkpointed at step 16 and restored once into
    a fresh model's template (bit for bit against the live state); from
    the restored state: one step with grad_accum = 2 against the run's
    ga = 1 step, steps 16-24 replayed (losses against the run's), and two
    steps twice under ``torch.use_deterministic_algorithms(warn_only)``
    (the ops it warns of listed); last two smoke-size fp32 steps on the
    card against the same steps on the CPU.  With ``profile``, one more
    step under torch.profiler."""
    import tempfile
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LanguageModel
    from repro_torch.training import CheckpointManager, Hyper, adamw_init, build_train_step
    from repro_torch.training.checkpoint import _flatten

    cfg = train_config()
    h = Hyper(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_cell = time.perf_counter()
    lm = LanguageModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    opt = adamw_init(dict(lm.named_parameters()))
    n_params = sum(p.numel() for p in lm.parameters())
    log("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
        remat=cfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        lr=TRAIN_LR, warmup=TRAIN_WARMUP)

    def run(model, o, t0, t1, ga=1):
        """Steps t0..t1-1: [(loss, seconds, metrics)], each step waited for."""
        fn = build_train_step(model, dataclasses.replace(h, grad_accum=ga))
        out = []
        for t in range(t0, t1):
            torch.cuda.synchronize()
            s = time.perf_counter()
            m = fn(o, pipe.global_batch_at(t), t)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            out.append((loss, time.perf_counter() - s, m))
        return out

    def state(model, o):
        return {"params": model.state_dict(), "opt": o}

    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointManager(tmp, keep=1)
        first = run(lm, opt, 0, TRAIN_SAVE_AT)
        t0 = time.perf_counter()
        ck.save(TRAIN_SAVE_AT, state(lm, opt), extra={"data_step": TRAIN_SAVE_AT}, block=True)
        save_s = time.perf_counter() - t0
        nbytes = ck.nbytes()
        fresh = LanguageModel(cfg, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(seed + 1))
        template = state(fresh, adamw_init(dict(fresh.named_parameters())))
        t0 = time.perf_counter()
        restored, man = ck.restore(template, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        live, got = _flatten(state(lm, opt)), _flatten(restored)
        assert set(live) == set(got) and man["extra"]["data_step"] == TRAIN_SAVE_AT
        bitwise = all(torch.equal(live[k], got[k]) for k in live)
        assert bitwise, "the restored state differs from the saved one"
        first += run(lm, opt, TRAIN_SAVE_AT, TRAIN_SAVE_AT + 1)
        after_ga1 = {k: v.clone() for k, v in lm.state_dict().items()}
        first += run(lm, opt, TRAIN_SAVE_AT + 1, TRAIN_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [x[0] for x in first]
        steady = sorted(x[1] for i, x in enumerate(first) if i)   # step 0 warms up
        step_s = steady[len(steady) // 2]
        gemm, attn = train_step_ops(cfg, lm, TRAIN_SEQ, tokens)
        bound_ms = (gemm / hw("peak_flops") + attn / hw("fp32_flops")) * 1e3
        log("train", tokens_per_step=tokens, first_loss=f"{losses[0]:.4f}",
            last_loss=f"{losses[-1]:.4f}",
            losses=",".join(f"{x:.4f}" for x in losses),
            first_step_s=f"{first[0][1]:.3f}", ms_per_step=f"{step_s * 1e3:.1f}",
            tokens_per_s=f"{tokens / step_s:.0f}",
            tflop_per_step=f"{(gemm + attn) / 1e12:.2f}",
            achieved_tflop_s=f"{(gemm + attn) / step_s / 1e12:.1f}",
            bound_ms=f"{bound_ms:.1f}",
            grad_norm_last=f"{float(first[-1][2]['grad_norm']):.4f}",
            peak_mem_gb=f"{peak_gb:.3f}")
        head, tail = np.mean(losses[:4]), np.mean(losses[-4:])
        assert np.isfinite(losses).all() and tail < head, (head, tail)
        log("train", checkpoint_step=TRAIN_SAVE_AT, save_s=f"{save_s:.3f}",
            bytes_on_disk=nbytes, restore_s=f"{restore_s:.3f}",
            restored_bit_for_bit=bitwise, mean_loss_first4=f"{head:.4f}",
            mean_loss_last4=f"{tail:.4f}")
        if profile:   # one more step (its data step, past the schedule's end)
            fn = build_train_step(lm, h)
            batch = pipe.global_batch_at(TRAIN_STEPS)
            profile_call(torch, "train_profile",
                         lambda: float(fn(opt, batch, TRAIN_STEPS)["loss"]), host_top=12,
                         op_top=20)
        del lm, opt, live
        gc.collect()
        torch.cuda.empty_cache()

        def from_checkpoint():
            """``fresh`` at the restored parameters, and a copy of the
            restored optimizer state (the step updates it in place)."""
            fresh.load_state_dict(restored["params"])
            return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                        else v.clone()) for k, v in restored["opt"].items()}

        # one step from the checkpoint with grad_accum = 2 (rows j::2) against
        # the run's ga = 1 step on the same batch
        (loss2, _, m2), = run(fresh, from_checkpoint(), TRAIN_SAVE_AT, TRAIN_SAVE_AT + 1, ga=2)
        ref = first[TRAIN_SAVE_AT]
        ga_loss = abs(loss2 - ref[0]) / ref[0]
        ga_gnorm = abs(float(m2["grad_norm"]) - float(ref[2]["grad_norm"])) / float(
            ref[2]["grad_norm"])
        ga_drift = _param_drift(torch, fresh.state_dict(), after_ga1, restored["params"])
        log("train", grad_accum=2, loss=f"{loss2:.6f}", ga1_loss=f"{ref[0]:.6f}",
            loss_rel_diff=f"{ga_loss:.2e}", grad_norm_rel_diff=f"{ga_gnorm:.2e}",
            update_rel_diff=f"{ga_drift:.2e}")
        assert ga_loss <= TRAIN_GA_LOSS_RTOL and ga_gnorm <= TRAIN_GA_GNORM_RTOL, (
            ga_loss, ga_gnorm)
        assert ga_drift <= TRAIN_GA_UPDATE_RTOL, ga_drift
        del after_ga1

        # the replay: steps 16-24 in a fresh model from the checkpoint
        replay = run(fresh, from_checkpoint(), TRAIN_SAVE_AT, TRAIN_STEPS)
        diffs = [abs(a[0] - b[0]) / b[0] for a, b in zip(replay, first[TRAIN_SAVE_AT:])]
        exact = all(a[0] == b[0] for a, b in zip(replay, first[TRAIN_SAVE_AT:]))
        log("train", replay_steps=len(replay), replay_losses_bit_for_bit=exact,
            replay_max_rel_diff=f"{max(diffs):.2e}",
            replay_losses=",".join(f"{x[0]:.6f}" for x in replay))
        assert max(diffs) <= TRAIN_REPLAY_RTOL, diffs

        # two steps from the checkpoint twice under deterministic algorithms
        det, caught = [], []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                for _ in range(2):
                    det.append([x[0] for x in run(fresh, from_checkpoint(), TRAIN_SAVE_AT,
                                                  TRAIN_SAVE_AT + TRAIN_DET_STEPS)])
            caught = sorted({str(x.message).split(".")[0][:120] for x in w
                             if "deterministic" in str(x.message)})
        finally:
            torch.use_deterministic_algorithms(False)
        log("train", deterministic_replays_equal=det[0] == det[1],
            deterministic_equal_to_run=det[0] == losses[TRAIN_SAVE_AT:
                                                        TRAIN_SAVE_AT + TRAIN_DET_STEPS],
            nondeterministic_ops=len(caught))
        for msg in caught:
            print(f"[train]   nondeterministic: {msg}", flush=True)
    del fresh, template, restored
    gc.collect()
    torch.cuda.empty_cache()

    # a smoke-size fp32 step on the card against the CPU
    cpu = torch.device("cpu")
    scfg = get_config(TRAIN_ARCH, smoke=True).replace(dtype="float32")
    models = {cpu: LanguageModel(scfg, device=cpu, generator=torch.Generator().manual_seed(seed))}
    models[dev] = LanguageModel(scfg, device=dev)
    models[dev].load_state_dict(models[cpu].state_dict())
    spipe = TokenPipeline(scfg.vocab_size, 64, 4, seed=seed)
    metrics = {}
    for d, model in models.items():
        fn = build_train_step(model, Hyper(lr=1e-2, warmup_steps=1, total_steps=4))
        o = adamw_init(dict(model.named_parameters()))
        metrics[d] = [fn(o, spipe.global_batch_at(t), t) for t in range(2)]
    worst = max(abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-30)
                for ma, mb in zip(metrics[dev], metrics[cpu]) for a, b in [(ma, mb)]
                for k in ("loss", "grad_norm"))
    drift = _param_drift(torch, {k: v.cpu() for k, v in models[dev].state_dict().items()},
                         models[cpu].state_dict())
    log("train", smoke_fp32_steps=2, card_vs_cpu_metric_rel_diff=f"{worst:.2e}",
        card_vs_cpu_param_rel_diff=f"{drift:.2e}")
    assert worst <= 1e-4 and drift <= 1e-4, (worst, drift)
    log("train", cell_s=f"{time.perf_counter() - t_cell:.1f}")


def _family_batch(cfg, rng, s: int, labels: bool = True) -> dict:
    b = {}
    if cfg.frontend != "audio":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (FAMILY_BATCH, s)).astype(np.int64)
    if cfg.frontend == "vision":
        b["frontend_feats"] = rng.normal(
            size=(FAMILY_BATCH, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio":
        b["frontend_feats"] = rng.normal(
            size=(FAMILY_BATCH, s, cfg.frontend_dim)).astype(np.float32)
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size, (FAMILY_BATCH, s)).astype(np.int64)
    return b


def _decode_vs_forward(torch, lm, batch, prefix: int):
    """A prefill of the first FAMILY_SEQ tokens (after ``prefix`` frontend
    positions) and FAMILY_DECODE decode steps, each step's logits against a
    forward pass over all the tokens: (max |diff|, mean |diff|, mean
    |logit|, prefill seconds, seconds a decode step)."""
    from repro_torch.models.transformer import grow_cache

    cfg = lm.cfg
    with torch.no_grad():
        full, _ = lm(batch)
    full = full[:, :, : cfg.vocab_size].float()
    pre = dict(batch, tokens=batch["tokens"][:, :FAMILY_SEQ])
    torch.cuda.synchronize()
    s = time.perf_counter()
    last, caches = lm.prefill(pre)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - s
    caches = grow_cache(caches, cfg, prefix + FAMILY_SEQ + FAMILY_DECODE)
    errs = [(last[:, 0, : cfg.vocab_size] - full[:, prefix + FAMILY_SEQ - 1]).abs()]
    torch.cuda.synchronize()
    s = time.perf_counter()
    for i in range(FAMILY_DECODE):
        p = prefix + FAMILY_SEQ + i
        lg, caches = lm.decode_step(
            {"tokens": batch["tokens"][:, FAMILY_SEQ + i: FAMILY_SEQ + i + 1],
             "pos": np.full(FAMILY_BATCH, p)}, caches)
        errs.append((lg[:, 0, : cfg.vocab_size] - full[:, p]).abs())
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - s) / FAMILY_DECODE
    return (max(float(e.max()) for e in errs), float(np.mean([float(e.mean()) for e in errs])),
            float(full.abs().mean()), prefill_s, decode_s)


def run_families(torch, dev, seed: int) -> None:
    """The families phase: each of the six configs the lm and train cells
    do not run, at full width (``family_config``: mamba2_370m at full depth,
    the others one cycle of their pattern), random weights from ``seed``:
    two train steps on 2 x 512 tokens (llava_next_mistral_7b also takes its
    576-token image prefix, hubert_xlarge 512 frames in place of tokens),
    the second timed; where the config decodes, a prefill of 512 tokens and
    8 decode steps, each step's logits against a forward pass over the same
    520 tokens, in bf16 (printed) and in fp32 (held: ``FAMILY_F32_*``); the
    MoE configs with the capacity raised to n_experts / top_k for this
    check (capacity drops depend on how many tokens are routed together).
    Prints ms and peak memory for each."""
    from repro_torch.models import LanguageModel
    from repro_torch.training import Hyper, adamw_init, build_train_step

    t_phase = time.perf_counter()
    for arch in FAMILY_ARCHS:
        cfg = family_config(arch)
        rng = np.random.default_rng(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_arch = time.perf_counter()
        lm = LanguageModel(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
        opt = adamw_init(dict(lm.named_parameters()))
        fn = build_train_step(lm, Hyper(lr=1e-3, warmup_steps=0, total_steps=10))
        losses, secs = [], []
        for t in range(2):
            batch = _family_batch(cfg, rng, FAMILY_SEQ)
            torch.cuda.synchronize()
            s = time.perf_counter()
            m = fn(opt, batch, t)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - s)
        assert np.isfinite(losses).all(), losses
        fields = dict(arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
                      d_model=cfg.d_model, params=sum(p.numel() for p in lm.parameters()),
                      tokens=FAMILY_BATCH * FAMILY_SEQ, train_ms=f"{secs[1] * 1e3:.1f}",
                      first_step_ms=f"{secs[0] * 1e3:.1f}",
                      loss=",".join(f"{x:.4f}" for x in losses))
        if cfg.n_experts:
            fields.update(moe_drop=f"{float(m['moe_drop']):.4f}",
                          moe_load_balance=f"{float(m['moe_load_balance']):.4f}")
        del opt, fn, m
        peak_train = torch.cuda.max_memory_allocated() / 1e9
        if cfg.supports_decode():
            prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
            batch = _family_batch(cfg, rng, FAMILY_SEQ + FAMILY_DECODE, labels=False)
            for dt in ("bfloat16", "float32"):
                # the same weights (fp32 parameters), computing in dt
                lm.cfg = cfg.replace(dtype=dt)
                if cfg.n_experts:
                    lm.cfg = lm.cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)
                worst, mean, scale, prefill_s, decode_s = _decode_vs_forward(
                    torch, lm, batch, prefix)
                tag = "" if dt == "bfloat16" else "_f32"
                if not tag:
                    fields.update(prefill_ms=f"{prefill_s * 1e3:.1f}",
                                  decode_ms_per_step=f"{decode_s * 1e3:.2f}",
                                  mean_abs_logit=f"{scale:.3f}")
                fields[f"decode_vs_forward_max{tag}"] = f"{worst:.3e}"
                fields[f"decode_vs_forward_mean{tag}"] = f"{mean:.3e}"
                assert np.isfinite(worst), (dt, worst)
                if tag:
                    unit = max(1.0, scale)
                    assert worst <= FAMILY_F32_MAX * unit and mean <= FAMILY_F32_MEAN * unit, (
                        worst, mean)
            lm.cfg = cfg
        fields.update(peak_mem_gb=f"{peak_train:.3f}",
                      decode_peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
                      seconds=f"{time.perf_counter() - t_arch:.1f}")
        log("families", **fields)
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    log("families", phase_s=f"{time.perf_counter() - t_phase:.1f}")


def dist_train_config():
    """The dist phase's training model: Qwen1.5-0.5B at full width, 4 layers."""
    from repro_torch.configs import get_config

    return get_config(TRAIN_ARCH).replace(n_layers=DIST_TRAIN_LAYERS)


def dist_ep_config():
    from repro_torch.configs import get_config

    cfg = get_config(DIST_EP_ARCH)
    return cfg.replace(n_layers=cfg.group_size())


def dist_gqa_config():
    """qwen2_7b at full width, 2 layers, bf16 parameters as the reference
    serves it (``launch/dryrun.py:159``), the residual stream split along
    the sequence."""
    from repro_torch.configs import get_config

    return get_config(DIST_GQA_ARCH).replace(n_layers=DIST_GQA_LAYERS,
                                             param_dtype="bfloat16", seq_shard=True)


def _synced(torch, fn):
    """(fn(), its seconds), the device waited for on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _median_ms(secs) -> float:
    """The median of steps 2.. (the first warms up), in ms."""
    rest = sorted(secs[1:])
    return rest[len(rest) // 2] * 1e3


def _update_drift(torch, a: dict, b: dict, base: dict) -> float:
    """||a - b|| / ||b - base|| over every tensor, the key bias left out
    (its gradient is 0 in exact arithmetic, rounding noise in practice)."""
    return _param_drift(torch, {k: v.float().cpu() for k, v in a.items()},
                        {k: v.float().cpu() for k, v in b.items()},
                        {k: v.float().cpu() for k, v in base.items()})


def run_dist(torch, dev, seed: int) -> None:
    """The dist phase: the language model across slots of one card (see
    the module docstring, phase 24).  Every check raises."""
    import tempfile

    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.mesh import SlotMesh
    from repro_torch.models import LanguageModel
    from repro_torch.training import (
        CheckpointManager,
        Hyper,
        adamw_init,
        build_train_step,
        gather_train_state,
        make_sharded_train_step,
        place_train_state,
        sharded_adamw_init,
        train_state_specs,
        train_state_template,
    )
    from repro_torch.training.step import slot_state_bytes, spec_slot_bytes

    t_phase = time.perf_counter()
    cfg = dist_train_config()
    h = Hyper(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    batches = [pipe.global_batch_at(t) for t in range(DIST_STEPS)]

    def mesh_of(dp, tp):
        return SlotMesh((dev,) * (dp * tp), {"data": dp, "model": tp})

    def fresh(c, tp):
        return LanguageModel(c, tp=tp, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(seed))

    def one_slot(c, n_steps):
        """(losses, grad norms, seconds, final state dict) of the local step."""
        lm = fresh(c, 1)
        opt = adamw_init(dict(lm.named_parameters()), master_fp32=c.param_dtype == "bfloat16")
        fn = build_train_step(lm, h)
        out = [_synced(torch, lambda t=t: fn(opt, batches[t], t)) for t in range(n_steps)]
        sd = {k: v.detach().clone() for k, v in lm.state_dict().items()}
        del lm, opt, fn
        return ([float(m["loss"]) for m, _ in out], [float(m["grad_norm"]) for m, _ in out],
                [s for _, s in out], sd)

    def sharded(c, mesh, mode, comp=None):
        lm = fresh(c, mesh.shape["model"])
        step, specs = make_sharded_train_step(lm, h, mesh, param_mode=mode,
                                              grad_compression=comp)
        slm = lm.shard(specs["dist"], specs["params"])
        opt = sharded_adamw_init(slm, specs["opt"], error_feedback=bool(comp))
        del lm
        return step, specs, slm, opt

    def steps(step, slm, opt, t0, t1):
        out = [_synced(torch, lambda t=t: step(slm, opt, batches[t], t)) for t in range(t0, t1)]
        return [float(m["loss"]) for m, _ in out], [float(m["grad_norm"]) for m, _ in out], \
            [s for _, s in out]

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    log("dist", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=DIST_STEPS, slots="cuda:0 x 4", mesh="data 2 x model 2",
        threads="one (every slot issued in order from the main thread)")
    base = {}
    for dtype in ("float32", "bfloat16"):   # the one-slot runs: fp32 and bf16 parameters
        torch.cuda.reset_peak_memory_stats()
        base[dtype] = one_slot(cfg.replace(param_dtype=dtype), DIST_STEPS)
        log("dist", run="one_slot", param_dtype=dtype, ms_per_step=f"{_median_ms(base[dtype][2]):.1f}",
            losses=",".join(f"{x:.4f}" for x in base[dtype][0]),
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        free()
    start = {k: v.cpu() for k, v in fresh(cfg, 2).state_dict().items()}
    free()
    mesh = mesh_of(2, 2)
    fsdp_final = None
    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointManager(tmp, keep=1)
        for mode in DIST_MODES:
            c = cfg.replace(param_dtype="bfloat16") if mode == "mp_zero1" else cfg
            ref_losses, ref_gn, ref_secs, _ = base[c.param_dtype]
            torch.cuda.reset_peak_memory_stats()
            step, specs, slm, opt = sharded(c, mesh, mode)
            losses, gns, secs = steps(step, slm, opt, 0, DIST_SAVE_AT if mode == "fsdp"
                                      else DIST_STEPS)
            if mode == "fsdp":   # the checkpoint of the elastic restore, mid-run
                saved = gather_train_state(slm, opt, specs["opt"])
                _, save_s = _synced(torch, lambda: ck.save(DIST_SAVE_AT, saved, block=True))
                more = steps(step, slm, opt, DIST_SAVE_AT, DIST_STEPS)
                losses, gns, secs = losses + more[0], gns + more[1], secs + more[2]
                fsdp_final = (losses, {k: v.cpu() for k, v in slm.state_dict().items()})
                del saved
            if mode == "tp":
                tp_losses = losses
            peak = torch.cuda.max_memory_allocated() / 1e9
            dtypes = {n: p.dtype for n, p in slm.params[0].items()}
            held, want = slot_state_bytes(slm, opt), spec_slot_bytes(specs, dtypes, mesh)
            loss_diff = max(abs(a - b) / b for a, b in zip(losses, ref_losses))
            gn_diff = max(abs(a - b) / b for a, b in zip(gns, ref_gn))
            log("dist", mode=mode, param_dtype=c.param_dtype,
                ms_per_step=f"{_median_ms(secs):.1f}", one_slot_ms=f"{_median_ms(ref_secs):.1f}",
                losses=",".join(f"{x:.4f}" for x in losses),
                max_loss_rel_diff=f"{loss_diff:.2e}", max_grad_norm_rel_diff=f"{gn_diff:.2e}",
                slot_param_bytes=held[0]["params"], spec_param_bytes=want[0]["params"],
                slot_grad_bytes=step.grad_bytes[0], spec_grad_bytes=want[0]["grads"],
                slot_opt_bytes=held[0]["opt"], spec_opt_bytes=want[0]["opt"],
                full_fp32_param_bytes=sum(v.numel() * 4 for v in start.values()),
                peak_mem_gb=f"{peak:.3f}")
            for s in range(mesh.size):
                for k, got in (("params", held[s]["params"]), ("opt", held[s]["opt"]),
                               ("grads", step.grad_bytes[s])):
                    assert abs(got - want[s][k]) <= DIST_BYTES_RTOL * want[s][k], (mode, s, k)
            assert np.isfinite(losses).all(), (mode, losses)
            assert loss_diff <= DIST_LOSS_RTOL and gn_diff <= DIST_GNORM_RTOL, (
                mode, loss_diff, gn_diff)
            del step, specs, slm, opt
            free()

        # the same start in fp32: one fsdp step against one slot
        c32 = cfg.replace(dtype="float32")
        lm1 = fresh(c32, 1)
        fn = build_train_step(lm1, h)
        opt1 = adamw_init(dict(lm1.named_parameters()))
        m1 = fn(opt1, batches[0], 0)
        one32 = {k: v.detach().cpu() for k, v in lm1.state_dict().items()}
        del lm1, fn, opt1
        free()
        step, specs, slm, opt = sharded(c32, mesh, "fsdp")
        m2 = step(slm, opt, batches[0], 0)
        f32_loss = abs(float(m2["loss"]) - float(m1["loss"])) / float(m1["loss"])
        f32_drift = _update_drift(torch, slm.state_dict(), one32, start)
        log("dist", run="fsdp_fp32_step", loss=f"{float(m2['loss']):.6f}",
            one_slot_loss=f"{float(m1['loss']):.6f}", loss_rel_diff=f"{f32_loss:.2e}",
            update_rel_diff=f"{f32_drift:.2e}")
        assert f32_loss <= DIST_F32_LOSS_RTOL and f32_drift <= DIST_F32_UPDATE_RTOL, (
            f32_loss, f32_drift)
        del step, specs, slm, opt, one32
        free()

        # int8 error-feedback compression of the data-parallel all-reduce
        step, specs, slm, opt = sharded(cfg, mesh, "tp", comp="ef_int8")
        ef_losses, _, ef_secs = steps(step, slm, opt, 0, DIST_STEPS)
        ef_diff = max(abs(a - b) / b for a, b in zip(ef_losses, tp_losses))
        log("dist", run="tp_ef_int8", losses=",".join(f"{x:.4f}" for x in ef_losses),
            exact_losses=",".join(f"{x:.4f}" for x in tp_losses),
            max_loss_rel_diff=f"{ef_diff:.2e}", ms_per_step=f"{_median_ms(ef_secs):.1f}")
        assert np.isfinite(ef_losses).all() and ef_diff <= DIST_EF_RTOL, ef_diff
        del step, specs, slm, opt
        free()

        # elastic restore of the fsdp checkpoint (step 3): on 2 x 2 fsdp, on
        # 1 x 4 tp and on one slot, 3 more steps each
        uninterrupted, final = fsdp_final
        for (dp, tp), mode in (((2, 2), "fsdp"), ((1, 4), "tp"), ((1, 1), "tp")):
            m2 = mesh_of(dp, tp)
            lm = LanguageModel(cfg, tp=tp, device="meta")
            step, specs = make_sharded_train_step(lm, h, m2, param_mode=mode)
            (tree, _), restore_s = _synced(torch, lambda: ck.restore(
                train_state_template(specs), shardings=(m2, train_state_specs(specs))))
            slm, opt = place_train_state(cfg, specs["dist"], tree, specs)
            del tree
            losses = steps(step, slm, opt, DIST_SAVE_AT, DIST_STEPS)[0]
            got = slm.state_dict()
            bitwise = losses == uninterrupted[DIST_SAVE_AT:] and all(
                torch.equal(v.cpu(), final[k]) for k, v in got.items())
            diff = max(abs(a - b) / b for a, b in zip(losses, uninterrupted[DIST_SAVE_AT:]))
            drift = _update_drift(torch, got, final, start)
            log("dist", run="restore", saved_on="2x2 fsdp", restored_on=f"{dp}x{tp} {mode}",
                save_s=f"{save_s:.3f}", restore_s=f"{restore_s:.3f}",
                bytes_on_disk=ck.nbytes(), losses=",".join(f"{x:.6f}" for x in losses),
                bit_for_bit=bitwise, max_loss_rel_diff=f"{diff:.2e}",
                param_update_rel_diff=f"{drift:.2e}")
            if (dp, tp) == (2, 2):
                assert bitwise, "the same-mesh resume differs from the uninterrupted run"
            assert diff <= DIST_LOSS_RTOL, (dp, tp, diff)
            del step, specs, slm, opt, got
            free()
    del start, final, base
    free()

    run_dist_ep(torch, dev, seed, mesh_of)
    run_dist_gqa(torch, dev, seed, mesh_of)
    log("dist", phase_s=f"{time.perf_counter() - t_phase:.1f}")


def run_dist_ep(torch, dev, seed: int, mesh_of) -> None:
    """Expert parallelism: moonshot_v1_16b_a3b (one layer, full width: 64
    experts, top-6, 2 shared) with its experts over 4 model slots against
    one slot, on 2 x 512 tokens: a forward in fp32 (the drops held equal:
    in bf16 the partial sums' roundings can flip a near-tied routing
    choice) and a train step and a forward in bf16 (timed)."""
    from repro_torch.models import LanguageModel, ShardedLM
    from repro_torch.training import (
        Hyper,
        adamw_init,
        build_train_step,
        make_sharded_train_step,
        sharded_adamw_init,
    )

    cfg = dist_ep_config()
    rng = np.random.default_rng(seed)
    batch = _family_batch(cfg, rng, DIST_SEQ)
    h = Hyper(lr=1e-3, warmup_steps=0, total_steps=10)
    lm = LanguageModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    start = {k: v.detach().to("cpu", copy=True) for k, v in lm.state_dict().items()}
    one = {}
    for dt in ("float32", "bfloat16"):
        lm.cfg = cfg.replace(dtype=dt)
        with torch.no_grad():
            (lg, aux), one[dt + "_fwd_s"] = _synced(torch, lambda: lm(batch))
        one[dt] = (lg[..., : cfg.vocab_size].float().cpu(), float(aux[2]))
        del lg
    lm.cfg = cfg
    opt = adamw_init(dict(lm.named_parameters()))
    fn = build_train_step(lm, h)
    m1, step1_s = _synced(torch, lambda: fn(opt, batch, 0))
    del lm, opt, fn
    gc.collect()
    torch.cuda.empty_cache()

    mesh = mesh_of(1, 4)
    step, specs = make_sharded_train_step(LanguageModel(cfg, tp=4, device="meta"), h, mesh,
                                          param_mode="tp")
    slm = ShardedLM.place(cfg, specs["dist"], start, specs["params"])
    del start
    fields = {}
    for dt in ("float32", "bfloat16"):
        slm.cfg = cfg.replace(dtype=dt)
        with torch.no_grad():
            (lg, aux), fwd_s = _synced(torch, lambda: slm.forward(batch))
        lg = lg[..., : cfg.vocab_size].float().cpu()
        dropped = sum(int(d) for d, _ in slm.moe_counts)
        routed = sum(int(r) for _, r in slm.moe_counts)
        ref_lg, ref_drop = one[dt]
        unit = max(1.0, float(ref_lg.abs().mean()))
        tag = "_f32" if dt == "float32" else ""
        fields.update({f"drop_frac{tag}": f"{float(aux[2]):.4f}",
                       f"one_slot_drop_frac{tag}": f"{ref_drop:.4f}",
                       f"dropped{tag}": f"{dropped}/{routed}",
                       f"global_drop_frac{tag}": f"{dropped / routed:.4f}",
                       f"forward_logit_diff{tag}": f"{float((lg - ref_lg).abs().max()) / unit:.3e}",
                       f"forward_ms{tag}": f"{fwd_s * 1e3:.1f}",
                       f"one_slot_forward_ms{tag}": f"{one[dt + '_fwd_s'] * 1e3:.1f}"})
        if dt == "float32":
            # data = 1: every expert sees the one slot's tokens and capacity,
            # so the dropped assignments are the one slot's (the reference's
            # drop_frac is the mean of the slots' own fractions)
            assert abs(dropped / routed - ref_drop) <= 1e-6, (dropped, routed, ref_drop)
            assert float((lg - ref_lg).abs().max()) <= 1e-3 * unit
        del lg
    slm.cfg = cfg
    opt = sharded_adamw_init(slm, specs["opt"])
    m4, step4_s = _synced(torch, lambda: step(slm, opt, batch, 0))
    loss_diff = abs(float(m4["loss"]) - float(m1["loss"])) / float(m1["loss"])
    log("dist", run="expert_parallel", arch=cfg.name, experts=cfg.n_experts,
        experts_per_slot=cfg.n_experts // 4, top_k=cfg.moe_top_k, mesh="model 4",
        tokens=FAMILY_BATCH * DIST_SEQ, **fields, loss=f"{float(m4['loss']):.4f}",
        one_slot_loss=f"{float(m1['loss']):.4f}", loss_rel_diff=f"{loss_diff:.2e}",
        train_drop_frac=f"{float(m4['moe_drop']):.4f}",
        one_slot_train_drop_frac=f"{float(m1['moe_drop']):.4f}",
        train_step_ms=f"{step4_s * 1e3:.1f}", one_slot_train_step_ms=f"{step1_s * 1e3:.1f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    assert loss_diff <= DIST_LOSS_RTOL, loss_diff
    del slm, opt, step, specs, one
    gc.collect()
    torch.cuda.empty_cache()


def run_dist_gqa(torch, dev, seed: int, mesh_of) -> None:
    """GQA, sequence parallelism and decode: qwen2_7b (2 layers, full
    width, bf16 parameters, seq_shard) on 4 model slots (7 heads and 1 kv
    head a slot, K / V split by head) and on 8 (heads padded 28 -> 32, K /
    V replicated, the cache split along its length): a prefill of 2 x 512
    tokens and 16 greedy decode steps against one slot, both fed the one
    slot's greedy tokens."""
    from repro_torch.models import Dist, LanguageModel
    from repro_torch.models.transformer import grow_cache

    cfg = dist_gqa_config()
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (DIST_BATCH, DIST_SEQ)).astype(np.int64)
    max_len = DIST_SEQ + DIST_DECODE
    for tp in (4, 8):
        one = LanguageModel(cfg, tp=tp, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed))
        mesh = mesh_of(1, tp)
        slm = one.shard(Dist(mesh, ("data",), "model", tp))
        runs = {}
        for name, model in (("one", one), ("mesh", slm)):
            (last, caches), pre_s = _synced(torch, lambda m=model: m.prefill({"tokens": prompt}))
            caches = (grow_cache(caches, cfg, max_len) if name == "one"
                      else model.grow_cache(caches, max_len))
            runs[name] = {"prefill_s": pre_s, "caches": caches, "logits": [last]}
        toks = runs["one"]["logits"][0][:, -1, : cfg.vocab_size].argmax(-1)
        secs = {"one": [], "mesh": []}
        for i in range(DIST_DECODE):
            step = {"tokens": toks[:, None].cpu().numpy(), "pos": np.int64(DIST_SEQ + i)}
            for name, model in (("one", one), ("mesh", slm)):
                (lg, _), sec = _synced(torch, lambda m=model, n=name: m.decode_step(
                    step, runs[n]["caches"]))
                runs[name]["logits"].append(lg)
                secs[name].append(sec)
            toks = runs["one"]["logits"][-1][:, -1, : cfg.vocab_size].argmax(-1)
        # each step's logits, in units of max(1, mean |logit|); the greedy
        # choices: equal, or the mesh's choice within twice that step's
        # largest difference of the one slot's best (a tie within bf16 noise)
        diffs, agree, worst_gap = [], 0, 0.0
        for a, b in zip(runs["mesh"]["logits"], runs["one"]["logits"]):
            a, b = a[:, -1, : cfg.vocab_size].float(), b[:, -1, : cfg.vocab_size].float()
            d = float((a - b).abs().max())
            diffs.append(d / max(1.0, float(b.abs().mean())))
            pick = a.argmax(-1)
            agree += int((pick == b.argmax(-1)).sum())
            gap = float((b.amax(-1) - b.gather(-1, pick[:, None])[:, 0]).max())
            worst_gap = max(worst_gap, gap)
            assert gap <= 2 * d, (gap, d)
        log("dist", run="gqa_decode", arch=cfg.name, layers=cfg.n_layers, mesh=f"model {tp}",
            heads_padded=slm.n_heads, heads_per_slot=slm.n_heads // tp,
            kv_split="heads" if slm.kv_split else "cache length",
            seq_shard=cfg.seq_shard, prompt=f"{DIST_BATCH}x{DIST_SEQ}",
            prefill_logit_diff=f"{diffs[0]:.3e}",
            decode_logit_diff_max=f"{max(diffs[1:]):.3e}",
            decode_logit_diffs=",".join(f"{d:.2e}" for d in diffs[1:]),
            greedy_agreement=f"{agree}/{DIST_BATCH * (DIST_DECODE + 1)}",
            worst_greedy_gap=f"{worst_gap:.3e}",
            prefill_ms=f"{runs['mesh']['prefill_s'] * 1e3:.1f}",
            one_slot_prefill_ms=f"{runs['one']['prefill_s'] * 1e3:.1f}",
            decode_ms_per_step=f"{_median_ms(secs['mesh']):.2f}",
            one_slot_decode_ms_per_step=f"{_median_ms(secs['one']):.2f}",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        assert max(diffs) <= DIST_LOGIT_MAX, diffs
        del one, slm, runs
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the roofline phase
# --------------------------------------------------------------------------
def start_dryruns(out_dir=None):
    """Start ``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_CELLS`` in the background (one process each, on meta slots:
    no card, CPU only), writing under a fresh directory of TMPDIR.  Returns
    ({(arch, shape): (process, json path, log path)}, the directory); the
    processes are killed at exit if still running."""
    import atexit
    import tempfile

    out = out_dir or tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(filter(None, [os.path.join(ROOT, "src"),
                                                        os.environ.get("PYTHONPATH")])))
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        logf = os.path.join(out, f"{arch}__{shape}.log")
        with open(logf, "w") as f:
            pr = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                   "--arch", arch, "--shape", shape, "--out", out],
                                  stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        procs[arch, shape] = (pr, os.path.join(out, f"{arch}__{shape}__single.json"), logf)

    def stop():
        for pr, _, _ in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.wait()

    atexit.register(stop)
    log("roofline", dryrun_cells=",".join(f"{a}x{sh}" for a, sh in DRYRUN_CELLS),
        started_in_background=True, out=out)
    return procs


def run_roofline(torch, dev, seed: int, dryruns, cal_cell, ring) -> None:
    """The roofline phase (``repro_torch.roofline``, ``launch/dryrun.py``,
    the planner's ``Calibration``):

    1. one train step of the train cell (Qwen1.5-0.5B at full width, 8 x
       1024 tokens, one slot): ``model_flops``' spec / refined, the script's
       own count (``train_step_ops``), ``FlopCounterMode``'s count over the
       step on the card, which must equal ``count_ops``' count of the same
       step on ``meta``, and the meta run's predicted peak (arguments + the
       peak live bytes) beside ``max_memory_allocated`` over a step, within
       ``ROOFLINE_PEAK_FACTOR``;
    2. the background dry runs of ``DRYRUN_CELLS`` on 256 meta slots: each
       cell's seconds, dominant term and bytes per slot;
    3. the knn_service reckoning against real launches: at the multi
       cell's size on four slots of the card the ring's leaf-scan launches
       (``ring`` = their shapes, n, m, d, slots) must sum to the
       operations ``dryrun.knn_ring_launches`` reckons;
    4. ``Calibration.refresh()`` on the card (GB/s, us a transfer), then a
       ``Calibration`` from this run's numbers (round_s = main's query
       seconds / its chunk rounds; engine_qps of chunked and host from the
       kdtree line's paired measurement) plans the ooc cell's points: the
       plan's reasons must cite it, and its answers to 1024 queries must be
       exact against knn_brute."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.api import Calibration, KNNIndex
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import LanguageModel
    from repro_torch.roofline import model_flops
    from repro_torch.roofline.calibrate import count_ops
    from repro_torch.training import Hyper, adamw_init, build_train_step

    t_phase = time.perf_counter()
    meta = torch.device("meta")
    cfg = train_config()
    tokens = TRAIN_SEQ * TRAIN_BATCH
    mf = model_flops(cfg, ShapeSpec("train_cell", "train", TRAIN_SEQ, TRAIN_BATCH))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    h = Hyper(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)

    # the step on meta: FLOPs, bytes, predicted peak
    t0 = time.perf_counter()
    lm = LanguageModel(cfg, device=meta)
    opt = adamw_init(dict(lm.named_parameters()))
    batch = {k: torch.as_tensor(v).to(meta) for k, v in pipe.global_batch_at(0).items()}
    step = build_train_step(lm, h)
    c = count_ops(lambda: step(opt, batch, 0))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    args_b = nbytes(lm.parameters()) + nbytes(
        t for v in opt.values() for t in (v.values() if isinstance(v, dict) else [v])) + nbytes(
        batch.values())
    predicted = args_b + c.temp_bytes
    meta_s = time.perf_counter() - t0
    gemm, attn = train_step_ops(cfg, lm, TRAIN_SEQ, tokens)
    del lm, opt, batch, step

    # the same step on the card
    torch.cuda.synchronize()
    lm = LanguageModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    opt = adamw_init(dict(lm.named_parameters()))
    step = build_train_step(lm, h)
    with FlopCounterMode(display=False) as fc:
        float(step(opt, pipe.global_batch_at(0), 0)["loss"])
    card_flops = fc.get_total_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    float(step(opt, pipe.global_batch_at(1), 1)["loss"])
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated()
    del lm, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    ratio = measured / predicted
    log("roofline", train_step=cfg.name, tokens=tokens,
        model_flops_spec=f"{mf['spec']:.6e}", model_flops_refined=f"{mf['refined']:.6e}",
        script_count=f"{gemm + attn:.6e}", script_gemm=f"{gemm:.6e}", script_attn=f"{attn:.6e}",
        flop_counter_card=card_flops, count_meta=int(c.flops),
        flops_equal=card_flops == int(c.flops), bytes_meta=f"{c.bytes:.6e}",
        predicted_peak_gb=f"{predicted / 1e9:.3f}", argument_gb=f"{args_b / 1e9:.3f}",
        temp_gb=f"{c.temp_bytes / 1e9:.3f}", measured_peak_gb=f"{measured / 1e9:.3f}",
        measured_over_predicted=f"{ratio:.4f}", factor=ROOFLINE_PEAK_FACTOR,
        meta_ops=c.ops, meta_memo_hits=c.memo_hits, meta_s=f"{meta_s:.2f}")
    assert card_flops == int(c.flops), (card_flops, c.flops)
    assert 1 / ROOFLINE_PEAK_FACTOR <= ratio <= ROOFLINE_PEAK_FACTOR, (measured, predicted)

    # the dry-run cells (started after the build phase)
    for (arch, shape), (pr, path, logf) in dryruns.items():
        rc = pr.wait(timeout=600)
        assert rc == 0, open(logf).read()[-3000:]
        with open(path) as f:
            res = json.load(f)
        assert res["supported"] and res["chips"] == 256, res
        mem, rf = res["memory"], res["roofline"]
        per_slot = res["costs"].get("bytes_per_device", res["costs"]["bytes_total"] / 256)
        log("roofline", dryrun=f"{arch}x{shape}", slots=res["chips"],
            seconds=f"{res['elapsed_s']:.1f}", dominant=res["dominant"],
            compute_s=f"{rf['compute_s']:.6g}", memory_s=f"{rf['memory_s']:.6g}",
            collective_s=f"{rf['collective_s']:.6g}",
            bytes_accessed_per_slot=f"{per_slot:.6e}",
            argument_bytes_per_slot=mem["argument_bytes"], temp_bytes_per_slot=mem["temp_bytes"],
            peak_bytes_per_slot=mem["peak_bytes"], fits_80g=mem["fits_80g"],
            useful_ratio=f"{res['useful_ratio']:.4f}")
        assert all(np.isfinite(rf[k]) and rf[k] >= 0
                   for k in ("compute_s", "memory_s", "collective_s"))

    # the knn_service reckoning against the ring's real launches
    shapes, n, m, d, p = ring
    launched = sum(w * tq * lp * (2 * dd + 3) for w, tq, lp, dd in shapes)
    reckoned = sum(dr.leaf_scan_work(*x, k=1)[0] for x in dr.knn_ring_launches(n, m, d, p))
    log("roofline", knn_ring_n=n, knn_ring_m=m, slots=p, launches=len(shapes),
        launched_ops=launched, reckoned_ops=int(reckoned), equal=launched == reckoned)
    assert launched == reckoned and launched > 0, (launched, reckoned)

    # the planner's Calibration: refresh on the card, then this run's own
    fresh = Calibration.refresh(device=dev)
    log("roofline", calibration_refresh_gbps=f"{fresh.h2d_gbps:.3f}",
        us_per_transfer=f"{fresh.h2d_latency_s * 1e6:.1f}", source=fresh.source)
    main, kd = MEASURED["main"], MEASURED["kdtree"]
    cal = Calibration(h2d_gbps=fresh.h2d_gbps, h2d_latency_s=fresh.h2d_latency_s,
                      round_s=main["query_s"] / max(1, main["chunk_rounds"]),
                      engine_qps={"chunked": kd["m"] / kd["chunked_s"],
                                  "host": kd["m"] / kd["host_s"]},
                      age_s=0.0, source="chip_smoke this run (main, kdtree)")
    spec = cal_cell["spec"].replace(calibration=cal)
    if one_card(torch):
        spec = spec.replace(devices=one_card(torch))
    points, queries = cal_cell["points"], cal_cell["queries"]
    index = KNNIndex.build(points, spec)
    for r in index.plan.reasons:
        print(f"[roofline]   plan: {r}", flush=True)
    cites = [r for r in index.plan.reasons if cal.source in r]
    res = index.query(queries, 10)
    ties, missed = check_exact(torch, res, points, queries, dev, queries.shape[0])
    log("roofline", calibrated_plan=index.plan.engine, n_chunks=index.plan.n_chunks,
        starvation_deadline=index.plan.starvation_deadline, calibrated=index.plan.calibrated,
        round_ms=f"{cal.round_s * 1e3:.3f}",
        engine_qps=",".join(f"{e}:{q:.1f}" for e, q in cal.engine_qps.items()),
        reasons_citing=len(cites), checked=queries.shape[0], tie_swaps=ties,
        fp32_rows_missed=missed)
    assert index.plan.calibrated and cites, index.plan.reasons
    assert missed == 0
    del index
    torch.cuda.empty_cache()
    log("roofline", cell_s=f"{time.perf_counter() - t_phase:.1f}")


def run_mutable(torch, dev, seed: int, shift: int):
    """The mutable cell on main's mixture at d = 10, n = 2**(24 - shift)
    points (ids = rows): ``KNNIndex.build(first 3n/4, IndexSpec(mutable=True,
    merge_async=True, k_hint=10, persist_dir=...))``, the rest inserted in 16
    batches, n / 128 seeded ids deleted in 4 batches after every 4th insert
    (half of each from the 4 newest batches, whose merges are pending),
    n / 256 queries while a merge is pending, ``drain()``, then m = 2**(20 -
    shift) queries at k = 10 with 1024 rows checked against knn_brute over
    the live points (fp32_rows_missed = 0) and the tree shards' launches;
    then ``save()``, one more batch, ``load`` replaying its WAL record, and
    n / 256 queries answered bit for bit by the live and the loaded index.
    Returns the query's launch counts, the live index, its points and
    live mask."""
    import shutil
    import tempfile

    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.kernels import knn_scan

    t0 = time.perf_counter()
    points, queries = main_data(seed, shift)
    n, m = points.shape[0], queries.shape[0]
    n0, nb = 3 * n // 4, (n // 4) // 16
    n_del = n // 128
    extra = main_data(seed + 1, shift + 4)[0][: nb]   # the batch after the save
    log("mutable", n=n, m=m, d=points.shape[1], k=10, build_points=n0, insert_batches=16,
        batch=nb, deletes=n_del, data_s=f"{time.perf_counter() - t0:.3f}")
    rng = np.random.default_rng(seed + 7)
    live = np.zeros(n + nb, bool)
    root = tempfile.mkdtemp(prefix="chip_smoke_mutable_")
    try:
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = KNNIndex.build(points[:n0], IndexSpec(mutable=True, merge_async=True,
                                                      k_hint=10, persist_dir=root,
                                                      devices=(dev,)))
        if on_card:
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        assert index.plan.engine == "dynamic" and index.plan.merge_async, index.describe()
        live[:n0] = True
        st = index._state
        insert_s, delete_s, pending_at_delete = [], [], []
        inflight = None
        q_small = queries[: n // 256]
        for b in range(16):
            lo = n0 + b * nb
            t0 = time.perf_counter()
            ids = index.insert(points[lo:lo + nb])
            insert_s.append(time.perf_counter() - t0)
            assert ids[0] == lo and ids[-1] == lo + nb - 1
            live[lo:lo + nb] = True
            if b % 4 == 3:
                recent = np.nonzero(live[max(0, lo - 3 * nb):lo + nb])[0] + max(0, lo - 3 * nb)
                older = np.nonzero(live[: max(0, lo - 3 * nb)])[0]
                per = n_del // 4
                dels = np.concatenate([rng.choice(recent, per // 2, replace=False),
                                       rng.choice(older, per - per // 2, replace=False)])
                pending_at_delete.append(st.pending_merges)
                t0 = time.perf_counter()
                assert index.delete(dels) == dels.size
                delete_s.append(time.perf_counter() - t0)
                live[dels] = False
            if b == 14 and inflight is None:
                # a query while the carry merges of the last inserts run
                pending = st.pending_merges
                t0 = time.perf_counter()
                r = index.query(q_small, 10)
                _, missed = check_exact(torch, r, points, q_small, dev, 256, live)
                inflight = dict(pending_merges=pending, seconds=time.perf_counter() - t0,
                                missed=missed)
        t0 = time.perf_counter()
        index.drain(timeout=600)
        drain_s = time.perf_counter() - t0
        assert index.n == int(live.sum())
        knn_scan.reset_launches()
        t0 = time.perf_counter()
        res = index.query(queries, 10)
        query_s = time.perf_counter() - t0
        launches = launch_counts(knn_scan)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9 if on_card else 0.0
        assert np.isfinite(res.dists).all() and res.dists.shape == (m, 10)
        tie_swaps, missed = check_exact(torch, res, points, queries, dev, 1024, live)
        layout = st.shard_layout()
        assert any(kind == "tree" for *_, kind in layout), layout
        assert launches["f32"] > 0 or not on_card, (
            "the tree shards did not launch the leaf-scan kernel")
        ms = st.merge_stats()
        log("mutable", engine=index.plan.engine, build_s=f"{build_s:.3f}",
            insert_median_s=f"{float(np.median(insert_s)):.3f}",
            insert_max_s=f"{max(insert_s):.3f}",
            delete_s=",".join(f"{t:.3f}" for t in delete_s),
            pending_at_delete=",".join(map(str, pending_at_delete)),
            merges_completed=ms["completed"], merges_scheduled=ms["scheduled"],
            merges_aborted=ms["aborted"], merges_failed=ms["failed"],
            retries=ms["retried"], drain_s=f"{drain_s:.3f}")
        log("mutable", inflight_pending_merges=inflight["pending_merges"],
            inflight_query_s=f"{inflight['seconds']:.3f}",
            inflight_checked=256, inflight_missed=inflight["missed"])
        log("mutable", layout=";".join(f"{c}:{lv}/{tb}:{k}" for c, lv, tb, k in layout),
            placement=";".join(f"{c}:{k}:slot{sl}" for c, k, sl in st.placement()),
            n_live=index.n, query_s=f"{query_s:.3f}", qps=f"{m / query_s:.1f}",
            refined_rows=res.stats.refined_rows, brute_rows=res.stats.exact_rows,
            units=res.stats.units_scanned, checked=1024, tie_swaps=tie_swaps,
            fp32_rows_missed=missed, peak_mem_gb=f"{peak_gb:.3f}",
            kernel_launches=",".join(f"{c}:{v}" for c, v in launches.items()
                                     if c in ("f32", "f16", "u8")),
            variants=",".join(f"{v}:{c}" for v, c in launches["by_variant"].items()))
        for r in index.plan.reasons:
            print(f"[mutable]   plan: {r}", flush=True)

        # snapshot round trip: save, one more batch (a WAL record), load
        t0 = time.perf_counter()
        index.save()
        save_s = time.perf_counter() - t0
        index.insert(extra)
        live[n:] = True
        index.drain(timeout=600)
        t0 = time.perf_counter()
        loaded = KNNIndex.load(root, devices=(dev,))
        loaded.drain(timeout=600)
        load_s = time.perf_counter() - t0
        assert any("replayed 1 WAL record(s)" in r for r in loaded.plan.reasons), (
            loaded.plan.reasons)
        a = index.query(q_small, 10)
        b2 = loaded.query(q_small, 10)
        assert np.array_equal(a.idx, b2.idx) and np.array_equal(a.dists, b2.dists)
        log("mutable", save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}",
            replayed_records=1, loaded_n=loaded.n, queries=q_small.shape[0],
            answers_bit_for_bit=True)
        del loaded
    finally:
        shutil.rmtree(root, ignore_errors=True)
    all_points = np.concatenate([points, extra])
    return launches, index, all_points, live


def run_serve(torch, stream_index, round_s, queries, ref_d, ref_i, mutable_index,
              mutable_points, mutable_live, dev, serve_shift: int = 0) -> dict:
    """The serve cell: ``KNNServer`` (max_batch 1024) over the stream cell's
    index, its estimate seeded from the stream cell's seconds per round on
    this card.  Burst: 8192 >> serve_shift single-row requests of main's
    queries at once, 60 s deadline (late completions served, not purged:
    every answer must equal main's row); paced: 2048 >> serve_shift
    requests from one thread at half the burst's rate, the default 50 ms
    deadline, purging on; sla: 1024 >> serve_shift requests at that rate,
    the estimate seeded with the burst's seconds per batch and a deadline
    of twice that; mutable: 1024 requests through a server fronting the
    mutable cell's index, answers equal to its ``query``.  Returns each
    part's launch counts."""
    import types

    from repro_torch.kernels import knn_scan
    from repro_torch.serving import DEFAULT_DEADLINE_MS, KNNServer, Overloaded
    from repro_torch.serving.knn_server import _EST_ROUNDS_GUESS

    cal = types.SimpleNamespace(round_s=round_s,
                                source="the stream cell's seconds per round on this card")
    cells = {}

    def lat(tickets):
        ls = np.array([t.info["latency_s"] for t in tickets if "latency_s" in t.info])
        if ls.size == 0:
            return "-", "-"
        return f"{np.percentile(ls, 50):.4f}", f"{np.percentile(ls, 99):.4f}"

    nb = min(8192 >> serve_shift, queries.shape[0])
    srv = KNNServer(stream_index, k=10, max_batch=1024, calibration=cal, purge_expired=False)
    log("serve", seed_round_s=f"{round_s:.6f}", seed_source=cal.source,
        seed_ms=srv.stats()["est_service_ms"][1024], buckets=list(srv.buckets))
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    tickets = srv.submit_many(queries[:nb], deadline_ms=60_000.0)
    got = [t.result(timeout=900) for t in tickets]
    burst_s = time.perf_counter() - t0
    cells["serve_burst"] = launch_counts(knn_scan)
    stats = srv.stats()
    srv.close()
    burst_batches = stats["batches"]
    gd = np.stack([g[0] for g in got])
    gi = np.stack([g[1] for g in got])
    same = gi == ref_i[:nb]
    if not same.all():
        np.testing.assert_allclose(gd, ref_d[:nb], rtol=1e-5, atol=1e-6)
    late = sum(t.info["latency_s"] > 60.0 for t in tickets)
    rate = nb / burst_s
    p50, p99 = lat(tickets)
    log("serve", part="burst", requests=nb, seconds=f"{burst_s:.3f}", requests_per_s=f"{rate:.1f}",
        latency_p50_s=p50, latency_p99_s=p99, batches=stats["batches"],
        by_close=stats["batches_by_close"], completed=stats["completed"], late=late,
        est_after_ms=stats["est_service_ms"], rows_identical=f"{same.all(1).mean():.6f}",
        kernel_launches=cells["serve_burst"]["f32"])

    def paced(srv, n, deadline_ms):
        """n requests of main's queries from this thread at half the burst's
        rate, each ticket left to the server's own closes and purges;
        checks every completed answer against main's row and returns the
        part's fields."""
        gap = 2.0 / rate
        tickets, rows, shed = [], [], 0
        t0 = time.perf_counter()
        for i in range(n):
            wait = t0 + i * gap - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            try:
                tickets.append(srv.submit(queries[i], deadline_ms=deadline_ms))
                rows.append(i)
            except Overloaded:
                shed += 1
        for t in tickets:
            t.exception(timeout=900)   # resolved by the server's own closes
        srv.drain(timeout=900)
        seconds = time.perf_counter() - t0
        stats = srv.stats()
        srv.close()
        done = [t for t in tickets if t.exception(timeout=0) is None]
        for i, t in zip(rows, tickets):
            if t.exception(timeout=0) is not None:
                continue
            d, ix = t.result(timeout=0)
            if not np.array_equal(ix, ref_i[i]):
                np.testing.assert_allclose(d, ref_d[i], rtol=1e-5, atol=1e-6)
        assert stats["outstanding"] == 0 and stats["failed"] == 0, stats
        p50, p99 = lat(done)
        return dict(requests=n, rate_per_s=f"{rate / 2:.1f}", seconds=f"{seconds:.3f}",
                    completed=stats["completed"], purged=stats["purged"],
                    shed=shed + stats["shed"], failed=stats["failed"],
                    batches=stats["batches"], by_close=stats["batches_by_close"],
                    latency_p50_s=p50, latency_p99_s=p99, deadline_ms=deadline_ms,
                    est_after_ms=stats["est_service_ms"])

    # paced: the reference's 50 ms deadline, purging on (an admission and
    # purge check: a batch of this index takes far longer than 50 ms)
    srv = KNNServer(stream_index, k=10, max_batch=1024, calibration=cal)
    knn_scan.reset_launches()
    out = paced(srv, min(2048 >> serve_shift, queries.shape[0]), DEFAULT_DEADLINE_MS)
    cells["serve_paced"] = launch_counts(knn_scan)
    log("serve", part="paced", **out)

    # paced within reach: the same rate, the estimate seeded with the
    # burst's seconds per full batch and a deadline of twice that, so the
    # SLA close and the latency tail are read on requests that complete
    batch_s = burst_s / max(1, burst_batches)
    sla_cal = types.SimpleNamespace(
        round_s=batch_s / _EST_ROUNDS_GUESS,
        source="the burst's seconds per 1024-row batch on this card")
    srv = KNNServer(stream_index, k=10, max_batch=1024, calibration=sla_cal)
    knn_scan.reset_launches()
    out = paced(srv, min(1024 >> serve_shift, queries.shape[0]), 2000.0 * batch_s)
    cells["serve_sla"] = launch_counts(knn_scan)
    log("serve", part="sla", batch_s=f"{batch_s:.3f}", **out)
    assert out["completed"] > 0, "no request of the sla part completed"

    # the server fronting the mutable index (whole-batch delivery)
    nm = 1024
    qm = queries[:nm]
    t0 = time.perf_counter()
    srv = KNNServer(mutable_index, k=10, max_batch=1024, calibration=cal, purge_expired=False)
    warm_s = time.perf_counter() - t0
    knn_scan.reset_launches()
    t0 = time.perf_counter()
    tickets = srv.submit_many(qm, deadline_ms=60_000.0)
    got = [t.result(timeout=900) for t in tickets]
    serve_s = time.perf_counter() - t0
    cells["serve_mutable"] = launch_counts(knn_scan)
    stats = srv.stats()
    srv.close()
    direct = mutable_index.query(qm, 10)
    gd = np.stack([g[0] for g in got])
    gi = np.stack([g[1] for g in got])
    same = gi == direct.idx
    if not same.all():
        np.testing.assert_allclose(gd, direct.dists, rtol=1e-5, atol=1e-6)
    _, missed = check_exact(torch, types.SimpleNamespace(dists=gd, idx=gi), mutable_points,
                            qm, dev, 256, mutable_live)
    p50, p99 = lat(tickets)
    log("serve", part="mutable", engine=mutable_index.engine_name, requests=nm,
        warm_s=f"{warm_s:.3f}", seconds=f"{serve_s:.3f}", batches=stats["batches"],
        by_close=stats["batches_by_close"], latency_p50_s=p50, latency_p99_s=p99,
        rows_identical=f"{same.all(1).mean():.6f}", checked=256, missed=missed,
        kernel_launches=cells["serve_mutable"]["f32"])
    assert cells["serve_mutable"]["f32"] > 0 or dev.type != "cuda"
    return cells


def run_drills(torch, dev) -> dict:
    """The degraded-serving drill of the reference's serving-fault tests on
    the card at their sizes (12288 points, d = 5, buffer_size = 1024) over
    four slots of cuda:0: ``device.scan`` armed sticky on a shard-bearing
    slot under a KNNServer fronting the mutable index, then one
    ``serve.launch`` and one ``serve.stream`` fault.  Every ticket
    resolves, answers exact against knn_brute, the degraded event in
    ``Ticket.info`` and ``server.reasons``.  Returns the launch counts."""
    from repro_torch import faults
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core.brute import knn_brute
    from repro_torch.kernels import knn_scan
    from repro_torch.serving import KNNServer

    rng = np.random.default_rng(0)
    d, k = 5, 5
    pts = rng.normal(size=(12288, d)).astype(np.float32)
    t_start = time.perf_counter()
    knn_scan.reset_launches()
    idx = KNNIndex.build(pts[:8192], IndexSpec(mutable=True, buffer_size=1024, k_hint=k,
                                               devices=(dev,) * 4))
    for lo in range(8192, 12288, 1024):
        idx.insert(pts[lo:lo + 1024])
    idx.drain(timeout=300)
    st = idx._state
    slots = sorted({s.slot for s in st._shards})
    assert len(slots) >= 2, st.placement()
    victim = slots[-1]
    srv = KNNServer(idx, k=k, max_batch=32, default_deadline_ms=10_000.0, start=False,
                    retry_backoff_s=0.0)
    q = rng.normal(size=(16, d)).astype(np.float32)
    bd, _ = knn_brute(q, pts, k, device=dev)
    t0 = srv.submit(q[0])
    srv.pump_once(force=True)
    np.testing.assert_allclose(t0.result(timeout=300)[0], bd[0], rtol=1e-5, atol=1e-6)
    faults.arm("device.scan", device_index=victim, sticky=True)
    try:
        tickets = [srv.submit(row) for row in q]
        srv.pump_once(force=True)
        srv.drain(timeout=300)
    finally:
        faults.reset()
    for r, t in enumerate(tickets):
        dd, _ = t.result(timeout=1)
        np.testing.assert_allclose(dd, bd[r], rtol=1e-5, atol=1e-6)
        ev = t.info.get("degraded")
        assert ev and any("device loss" in e for e in ev), t.info
    assert any("degraded" in r and "device loss" in r for r in srv.reasons)
    assert not any(s.slot == victim for s in st._shards)
    for point in ("serve.launch", "serve.stream"):
        faults.arm(point)
        try:
            ts = [srv.submit(row) for row in q]
            srv.pump_once(force=True)
            srv.drain(timeout=300)
        finally:
            faults.reset()
        for r, t in enumerate(ts):
            np.testing.assert_allclose(t.result(timeout=1)[0], bd[r], rtol=1e-5, atol=1e-6)
    stats = srv.stats()
    srv.close()
    assert stats["outstanding"] == 0 and stats["failed"] == 0 and stats["retries"] == 2
    launches = launch_counts(knn_scan)
    assert launches["f32"] > 0 or dev.type != "cuda"
    log("drills", devices=f"{dev}x4", victim_slot=victim,
        slots_after=",".join(map(str, st._placer.slots)),
        degraded_batches=stats["degraded_batches"], retries=stats["retries"],
        completed=stats["completed"], failed=stats["failed"],
        device_loss=st.merge_stats()["device_loss"], kernel_launches=launches["f32"],
        seconds=f"{time.perf_counter() - t_start:.3f}", ok=True)
    del idx
    return launches


def catalog(rng, n: int) -> np.ndarray:
    """n points from 64 uniform blobs of radius 0.02 in the unit cube, 3-d
    (benchmarks/dualtree_bench.py's catalogue: clustered sources)."""
    centers = rng.uniform(0.0, 1.0, size=(64, 3)).astype(np.float32)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    radial = 0.02 * rng.random(n).astype(np.float32) ** (1.0 / 3)
    return centers[rng.integers(0, len(centers), n)] + u * radial[:, None]


def run_dual(torch, dev, seed: int, shift: int) -> None:
    """The dual-tree ops on a galaxy-like catalogue: n = 2**(20 - shift)
    points (planner default height), radius and gaussian kde for m =
    2**(16 - shift) queries, pair_count over the benchmark's edges scaled
    so each point keeps about the benchmark's neighbour count at 50k; the
    same pair_count on an fp32 build under memory_budget = slab_bytes // 3
    (chunks streamed).  Checks: radius and kde on 1024 queries against
    radius_brute / kde_brute over all points, pair_count on the first
    n / 2**DUAL_CHECK_SHIFT points against pair_count_brute, the streamed and
    resident histograms equal."""
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.core.dualtree import kde_brute, pair_count_brute, radius_brute

    n, m = 2 ** (20 - shift), 2 ** (16 - shift)
    s = (50_000 / n) ** (1 / 3)
    r, h = 0.02 * s, 0.05 * s
    edges = np.array([0.0, 0.0125, 0.025, 0.05, 0.1, 0.2]) * s
    rng = np.random.default_rng(seed)
    pts = catalog(rng, n)
    q = pts[rng.integers(0, n, m)] + np.float32(0.001)

    def build(spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = KNNIndex.build(pts, spec.replace(devices=one_card(torch)))
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    index, build_s = build(IndexSpec(op="pair_count"))
    log("dual", n=n, m=m, d=3, r=f"{r:.6f}", bandwidth=f"{h:.6f}",
        edges=",".join(f"{e:.6f}" for e in edges), engine=index.plan.engine,
        height=index.plan.height, n_chunks=index.plan.n_chunks, build_s=f"{build_s:.3f}")
    rad, radius_s = timed(lambda: index.radius(q, r))
    kde, kde_s = timed(lambda: index.kde(q, h, rtol=1e-2))
    pc, pair_s = timed(lambda: index.pair_count(edges))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for op, res, sec in (("radius", rad, radius_s), ("kde", kde, kde_s),
                         ("pair_count", pc, pair_s)):
        st = res.stats
        log("dual", op=op, seconds=f"{sec:.3f}", leaf_pairs=st.units_scanned,
            batches=st.flushes, chunk_visits=st.chunk_rounds, levels=st.iterations,
            points_paired=st.points_scanned, batch_shapes=st.plan_shapes,
            retested_pairs=st.retested_pairs)
    log("dual", radius_hits=int(rad.indptr[-1]),
        mean_neighbours=f"{rad.indptr[-1] / m:.1f}", kde_error_bound=kde.error_bound,
        hist=",".join(str(int(v)) for v in pc.values), peak_mem_gb=f"{peak_gb:.3f}")

    # radius and kde on 1024 queries against the oracles over all points
    nc = min(1024, m)
    bi, bj, bd = radius_brute(q[:nc], pts, r, tile_q=128, device=dev)
    ip = rad.indptr[: nc + 1]
    assert np.array_equal(ip, bi), "radius row counts differ from radius_brute"
    for i in range(nc):
        got = rad.indices[ip[i]:ip[i + 1]]
        assert set(got.tolist()) == set(bj[bi[i]:bi[i + 1]].tolist()), f"radius row {i}"
    np.testing.assert_array_equal(rad.dists[: ip[-1]], bd)
    exact = kde_brute(q[:nc], pts, h, tile_q=128, device=dev).astype(np.float64)
    err = np.abs(kde.values[:nc].astype(np.float64) - exact)
    assert np.all(err <= 1e-2 * exact + 1e-9 + 1e-5 * np.maximum(exact, 1.0)), err.max()
    log("dual", check="radius_kde_vs_brute", queries=nc,
        kde_max_rel_err=f"{(err / np.maximum(exact, 1e-30)).max():.3e}", ok=True)
    slab_bytes = index.plan.slab_bytes
    del index, rad, kde
    torch.cuda.empty_cache()

    # the same pair_count with the chunks streamed
    streamed, sbuild_s = build(IndexSpec(op="pair_count", precision="fp32",
                                         memory_budget=slab_bytes // 3))
    assert streamed.plan.n_chunks >= 2, streamed.plan.n_chunks
    spc, spair_s = timed(lambda: streamed.pair_count(edges))
    assert np.array_equal(spc.values, pc.values), "streamed and resident histograms differ"
    log("dual", op="pair_count_streamed", n_chunks=streamed.plan.n_chunks,
        build_s=f"{sbuild_s:.3f}", seconds=f"{spair_s:.3f}",
        leaf_pairs=spc.stats.units_scanned, batches=spc.stats.flushes,
        chunk_visits=spc.stats.chunk_rounds, retested_pairs=spc.stats.retested_pairs,
        hist_equal=True)
    del streamed
    torch.cuda.empty_cache()

    # pair_count against the all-pairs oracle on the first n / 2**DUAL_CHECK_SHIFT
    sub = pts[: n >> DUAL_CHECK_SHIFT]
    small = KNNIndex.build(sub, IndexSpec(op="pair_count", devices=one_card(torch)))
    (hist, _), small_s = timed(lambda: small.pair_count(edges))
    ref, brute_s = timed(lambda: pair_count_brute(sub, edges, device=dev))
    assert np.array_equal(hist, ref), (hist, ref)
    log("dual", check="pair_count_vs_brute", n=sub.shape[0], height=small.plan.height,
        dual_s=f"{small_s:.3f}", brute_s=f"{brute_s:.3f}", ok=True)


if __name__ == "__main__":
    sys.exit(main())
