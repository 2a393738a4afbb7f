#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # every phase, on one card
    python3 chip_smoke.py --k5     # build, then time K5 alone
    python3 chip_smoke.py --k2     # build, then time K2 alone (Q = 1..64)
    python3 chip_smoke.py --split  # build, then the main path's topk split
    python3 chip_smoke.py --serve  # build, then phase 8 alone
    python3 chip_smoke.py --lm     # build, then phase 9 alone
    python3 chip_smoke.py --train  # build, then phase 10 alone
    python3 chip_smoke.py --shard  # build, then phase 11 alone
    python3 chip_smoke.py --dist   # build, then phase 12 alone
    python3 chip_smoke.py --serve-dist  # build, then phase 13 alone

Phases, each failing loudly with a nonzero exit:

1. Build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (nvcc, sm_90a) and print the build seconds.
2. Hold each kernel (K1 euclid, K2 ssax_dist, K3 sax_dist, K4 paa, K5
   windowed_euclid) against its plain PyTorch version on the card at
   both paths' shapes (whole series and windows) plus ragged ones;
   time the kernel, the plain version and, where one exists, a single
   PyTorch call computing the same function.  K2 runs one query and
   the path's 8 queries in one batched launch at both sweep shapes,
   every batched row bitwise equal to its one-query launch.  K1's gathered entry runs
   at the verification round shape (T = 960, 240, bf16, 961) and must
   equal its all-pairs entry bitwise; it is timed on the device (a
   CUDA graph, rows from HBM and rows in L2) and as one host-clock
   call.  K5 runs at strides 4 and 1 and at one ``scan_topk`` launch
   (38 rows), each timed launch checked on its first rows; K4 at the
   window shape.
3. Drive the main path through the launcher's ``make_engine`` (the
   sharded engine service on one virtual shard: candidates ordered on
   the card) and ``MatchEngine.topk``: sSAX and SAX exact top-k (k = 1,
   32) over a 1,000,000 x 960 season corpus, tSAX and stSAX over its
   first 65,536 rows, ``verify="auto"``.  Every exact answer must equal
   a K1 brute force bitwise, and its ids a plain-version brute force
   away from near-ties.  A plain ``MatchEngine`` over the same store
   (host argsort) must give the same answer, rounds and rows.
4. Drive the index path through the launcher's ``make_engine``,
   ``SymbolicStore.build_index`` and ``MatchEngine.topk(source="index",
   explain=)`` on phase 3's corpus: the sSAX split-tree index over all
   1,000,000 rows (leaf_fill 64; features through K4, routed in one
   pass; build seconds printed; 86,512 nodes, and 176.0 / 304.6 rows
   verified per query in 2 rounds at k = 1 / 32, as the chunk-by-chunk
   build gave), indexed k = 1 and 32 bitwise equal to phase 3's K1
   brute force and
   to the linear answers (phase 3's and this store's), and traced
   (``explain=True``) indexed and linear calls bitwise equal to their
   untraced calls with the same launches, their traces clean under
   ``check_trace`` and rendered; SAX, tSAX and stSAX indexed over the
   first 65,536 rows, each bitwise equal to its linear answer; then a
   snapshot round trip of a 65,536-row sSAX store with its index (save,
   ``SymbolicStore.open(device="cuda")``, answers bitwise, 2 rows
   appended after reopening are indexed and found).  Every call's K1
   launches equal its rounds and its store fetches: the seed
   verification is one round (one fetch, one gathered K1 launch) and
   each scan round another.  The launcher's engine orders the tree's
   union bounds on the card (``TreeCandidates(device_order=True)``); a
   plain engine's host order must give the same answer, rows and
   rounds at k = 32.
5. Drive the subsequence path through the launcher's building blocks
   (``make_subseq_engine``, ``SubseqEngine.topk`` and ``scan_topk``):
   every z-normalized window (m = 240, stride 4) of a 2,048 x 3,600
   season corpus, 1,722,368 windows, sSAX (k = 1, 8, and 8 with
   exclusion 120), and SAX, tSAX and stSAX (k = 8) over its first 256
   rows (215,296 windows; SAX barely prunes windows).  Every answer must equal a K1 brute force over all
   windows bitwise (the exclusion answer its greedy non-overlap filter),
   the K5 scan must agree away from near-ties, and a chunked window
   encode must equal a one-shot one on the card bitwise.
   Phases 3 and 5 print the split of one warm topk call (sweep, host
   argsort or device order, verification loop) and fail unless every
   call's K1 launches
   equal its verification rounds (one gathered launch per round; on
   whole series every round is also one store fetch) and every sSAX
   sweep made one K2 launch (one batched sweep for all its queries).
6. Drive the window index path through ``WindowView.build_index`` and
   ``SubseqEngine.topk(use_index=True, explain=)`` / ``topk_approx`` on
   phase 5's views: the sSAX split-tree index over all 1,722,368
   windows (leaf_fill 64; build seconds and nodes printed); indexed
   sSAX k = 1, 8 and 8 with exclusion 120, each bitwise equal to phase
   5's linear answer and its K1 brute force, printed beside the linear
   call's windows verified, pruned fraction, rounds and rows read;
   traced (``explain=True``) indexed and linear k = 8 calls bitwise
   equal to their untraced calls with the same launches, clean under
   ``check_trace``, one rendered; the engine's ``MetricsRegistry``
   counters printed; ``topk_approx(k=8)`` at its default collect (error
   bar printed) and at a collect of every window (bitwise exact, error
   bar 0); SAX, tSAX and stSAX window indexes over the first 256 rows,
   indexed k = 8 bitwise equal to linear; then 2 rows appended to the
   sSAX view, routed into the index by ``sync`` and found through it.
   Every call's K1 launches equal its rounds (the seed verification is
   one), no indexed call sweeps the representation, and every linear
   sSAX call makes one K2 launch.
7. Drive the device-resident path (``core.distributed``) on 4 virtual
   shards of the card: ``make_engine_service`` over phase 3's corpus for
   sSAX and SAX with ``verify="device"`` and ``"host"`` at k = 1 and 32
   (the ingest's encode / store append / mirror upload split printed),
   each answer, its rounds, rows and K1 launches equal to phase 3's and
   the K1 brute force, no raw row and no candidate order on the host;
   ingest while serving (3 rows, a tail of 3, then 4,096: answers equal
   the K1 brute force over the grown corpus, appended rows found, an
   epoch pinned between answers as then, each ingest uploading only its
   head-aligned rows); then ``SubseqEngine(mesh=, verify="device")`` on
   phase 5's sSAX view (k = 1, 8, and 8 with exclusion 120, pinned to
   phase 5's rows), bitwise phase 5's answers and rounds, with no
   window row moved to the host and the card's window z-normalization
   equal to the host's bitwise.  Peak device memory printed.
8. Drive the serving path: (a) ``service.MatchSession`` over phase 4's
   indexed 1M sSAX store through ``make_engine_service`` on
   ``make_mesh(4)`` with ``verify="device"``, two replicas over the one
   store, window 2 ms, max batch 64, driven by the launcher's own
   ``launch.serve_match.serve_waves``: 32 client threads x 4 requests
   at k = 8 while a writer ingests 16 chunks of 4,096 rows (the first
   before the wave), every exact answer bitwise equal to
   ``engine.topk(epoch=pin)``; a wave of 32 requests at a 5 ms deadline
   (downgrades carry error bars, sheds are counted); 64 queries alone
   equal to themselves coalesced 2, 4, ..., 64 at a time for sSAX and
   SAX over 1M rows and tSAX and stSAX over 65,536; K1 launches equal
   to the dispatches' summed rounds; QPS, latency quantiles, requests
   per dispatch, tiers, replica placement and peak device memory
   printed; then K2 at a full 64-query dispatch over the store's
   symbols and K1 at 64-query rounds of B = 256 and 4,096 on the
   corpus, each against its plain version.  (b)
   ``profile.SelfJoinEngine`` over phase 5's sSAX windows of the first
   64 rows (53,824 windows): the device stream route on
   ``make_mesh(4)`` with ``verify="device"`` (no row and no candidate
   order on the host; K1 launches == rounds, one K2 launch per chunk),
   then K2 at one 256-window chunk over the view's symbols (the
   kernel's grouped-table branch) and K1 at one round of that chunk
   (256 x 64 windows of m = 240), each against its plain version;
   motif and discord requests through a session; at 16 rows (13,456
   windows) the device, linear host and indexed routes each bitwise
   equal to ``scan_profile`` (K1 over all pairs).  (c) ``windowed_euclid(
   method="fft")`` at K5's scan shape, strides 4 and 1, within
   ``fft_tolerance(240)`` of K5, both timed.
9. Drive the LM path (``repro_torch.models``, ``serving.ServeEngine``):
   (a) each of the ten architectures at ``reduced()`` width in f32,
   the same weights on the card and on the CPU: prefill logits and 8
   greedy decode steps within LM_TOL with equal tokens (a near-tie,
   where the logits' difference decides the argmax, is printed), and
   one ServeEngine wave of 5 mixed-length prompts over 2 slots (the
   common-position path) with equal tokens on both devices (not for
   paligemma and whisper: the engine prefills tokens only).  (b)
   qwen3-0.6b at full width (28 layers, d_model 1024, 16/8 heads of
   128, d_ff 3072, vocab 151,936 padded to 152,064; weights from a
   seed), f32 compute: ServeEngine with 8 slots and max_len 512 serves
   16 requests of 128-token prompts and 32 new tokens, each equal to
   the naive greedy loop (prefill with prefill_pad, then decode_step)
   up to a printed near-tie (the engine's cache is bf16, the loop's
   f32); the loop's decode logits at step j equal ``forward``'s last
   position over the prompt and j tokens within LM_FWD_TOL.  Then the
   config's own bf16 compute, with prefill ms per request, decode ms
   per step at 8 slots, tokens/s and peak device memory printed.  (c)
   ``examples/activation_retrieval.py``'s path at full width: the f32
   model's hidden states over 256 prompts of 64 tokens, 262,144
   channel traces z-normalized and tSAX-encoded (T = 64, W = 16, A_tr =
   A_res = 64, the bank's mean trend strength), exact
   ``MatchEngine.topk`` at k = 1 and 8 for 8 query traces bitwise equal
   to a K1 brute force, pruned fraction printed, K1 launches == rounds;
   K4 at the encode shape and K1 at a round's shape against their plain
   versions.
10. Drive the training path (``repro_torch.train``, ``optim``,
   ``checkpoint``, ``launch/train.py``): (a) each of the ten
   architectures at ``reduced()`` width in f32, one ``make_train_step``
   from the same state on the card and the CPU: loss, grad_norm, the
   moments and the parameters within TRAIN_TOL (``state_errors``), and
   the card's step run twice from one state bitwise equal; a probe of
   which scatter-adds (embedding and gather backwards, the MoE's
   index_put_ / index_add_) are reproducible on the card, printed.  (b)
   qwen3-0.6b at its published widths (596,180,992 parameters from a
   seed), bf16 compute over f32 master weights and f32 moments,
   ``train_loop`` for 30 steps of SyntheticLM batches of 8 x 512 tokens
   under the cosine schedule: the loss must fall (mean of the last 5
   steps below the first 5); step ms (median of warm steps), tokens/s
   and peak device memory printed; then one batch from the trained
   weights with microbatch=2 against 1 within TRAIN_MB_TOL and remat
   off against on bitwise.  (c) ``train_loop`` at reduced width with a
   ``Checkpointer`` and ``FailureInjector(fail_at=(3, 7))``: the final
   state equals the unbroken run's bitwise, and its last checkpoint,
   saved from the card, restores on the CPU to the same bits.  (d)
   ``python -m repro_torch.launch.train --device cuda`` at reduced width
   as a subprocess, with a checkpoint directory and an injected failure:
   exit code 0.
11. Drive sharded training (``sharding``, ``train.step`` with rules,
   ``checkpoint.elastic``, ``launch/dryrun.py``): (a) ``python -m
   torch.distributed.run --standalone --nproc-per-node 1 -m
   repro_torch.launch.train --scale full`` for qwen3-0.6b at its
   published widths as a subprocess (NCCL, a world of one, the sharded
   step on a (1, 1) mesh) with a checkpoint directory: exit 0, and its
   per-step losses equal to an unsharded ``make_train_step(cfg, None,
   ...)`` replay here with the launcher's own RunConfig, optimizer,
   schedule, seed and SyntheticLM batches (bitwise expected; otherwise
   the largest difference is printed and held to TRAIN_TOL); step ms and
   peak memory of both, and phase 10b's where it ran.  (b) In a world of
   one here: the dry-run's per-device state bytes for qwen3-0.6b equal
   the bytes of the shards ``shard_train_state`` places on the card
   (3 x 4 x 596,180,992 B plus the step), the allocation's growth within
   each leaf's rounding to 512 B; the dry-run's FLOPs per step beside
   the step ms.  (c) (a)'s last checkpoint, the launcher's final state,
   bitwise equal to the unsharded replay's final state, and
   ``elastic_restore`` of it onto the card's mesh bitwise equal to the
   same (so to the file); ``reshard_checkpoint`` with a changed model
   axis raises.  (d) olmoe-1b-7b and jamba-1.5-large at
   ``reduced()`` width in f32 with ``moe_groups = 4``: the grouped MoE
   forward and one sharded train step on the card against the CPU within
   TRAIN_TOL, and the grouped forward against the ungrouped at capacity
   factor 64 within SHARD_MOE_TOL.  (e) The dry-run CLI as two
   subprocesses beside (b)-(d) (host work only), on smollm-135m's four
   cells (train_4k, prefill_32k, decode_32k, and long_500k's documented
   skip) and jamba-1.5-large's long_500k, single pod: the counts line,
   0 errors, seconds printed.
12. Drive matching over a ``torch.distributed`` world of cards: (a)
   ``python -m torch.distributed.run --standalone --nproc-per-node 1
   chip_smoke.py --dist-rank`` (NCCL, one rank per card) rebuilds phase
   3's 1M-row corpus and phase 5's sSAX windows from their seeds on
   ``make_mesh(DEV_SHARDS, group=WORLD)`` and makes phase 7's calls:
   sSAX and SAX at k = 1 and 32 with ``verify="device"`` and ``"host"``,
   and the sSAX windows at k = 8.  Each answer, its rounds and rows must
   be bitwise phase 7's (with ``--dist``, the rank's own single-process
   answers), K1 launches equal to rounds on the rank, one K2 launch per
   sSAX sweep; wall, per-rank peak memory and per-round collective time
   (each collective fenced, in a second run of the device calls) are
   printed.  (b) The match launcher at its default size under
   ``torch.distributed.run`` beside one process at the same shard count:
   exit 0, every exact line 8/8, answer hashes equal on every rank and
   to the single process's.  Where ``torch.cuda.device_count() >= 2``,
   both repeat at ``min(count, 4)`` ranks.
13. Drive the matching service over a ``torch.distributed`` world of
   cards: (a) ``python -m torch.distributed.run --standalone
   --nproc-per-node 1 chip_smoke.py --serve-rank`` (NCCL) rebuilds phase
   8a's set-up from its seeds on ``make_mesh(DEV_SHARDS, group=WORLD)``
   (phase 3's 1M x 960 corpus in an sSAX store with
   ``verify="device"``, its index at leaf_fill 64, two replicas) and
   rank 0 serves it through the fronts of a ``service.world.
   WorldChannel`` (the other ranks replay its engine calls): phase 8a's
   waves through ``launch.serve_match.serve_waves`` (wave 1 beside the
   writer's 16 x 4,096 rows, every exact answer bitwise
   ``engine.topk(epoch=pin)``; the deadline wave), then 64 queries at k
   = 8 over the final corpus with every collective fenced, each bitwise
   a K1 brute force; K1 launches equal to the rounds of every engine
   call on rank 0; every rank's op hash and epochs equal rank 0's; QPS,
   latency quantiles, the channel's ops and broadcast seconds,
   collective ms per dispatch and peak memory printed beside phase
   8a's.  (b) The serve launcher at its default size under
   ``torch.distributed.run`` beside one process at the same shard
   count: exit 0, every exact line full, answer hashes equal.  Where
   ``torch.cuda.device_count() >= 2``, both repeat at ``min(count, 4)``
   ranks.
14. Print each path's launch counts (each kernel of a path > 0) and the
   ``{"kernels": [...]}`` line with the launches of all ten paths
   (the training paths launch none of the five kernels; the worlds' are
   rank 0's).
15. Print the card's name and power limit, then the result line.

It imports neither JAX nor the JAX package, needs the repository beside
it, and exits nonzero without printing a result when there is no card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
F32_ISSUE_PER_S = 132 * 128 * 1.98e9   # FP32 lane-instructions, boost clock

N_MAIN = 1_000_000            # corpus rows for sSAX / SAX
N_SMALL = 65_536              # corpus rows for tSAX / stSAX
T, W, L, STRENGTH = 960, 48, 10, 0.7
N_QUERIES, KS, BATCH = 8, (1, 32), 256
SUB_ROWS, SUB_SMALL, SUB_T = 2048, 256, 3600   # subsequence corpus
SUB_M, SUB_STRIDE, SUB_EXCL = 240, 4, 120      # window, hop, exclusion
SUB_CHUNK_ROWS = 38           # rows of one scan_topk launch (2.5e8 B chunk)
SUB_CALLS = {"ssax": ((1, 0), (8, 0), (8, SUB_EXCL)), "sax": ((8, 0),),
             "tsax": ((8, 0),), "stsax": ((8, 0),)}   # (k, exclusion)
LEAF_FILL = 64                # split-tree leaf fill factor of the index path
DEV_SHARDS = 4                # virtual shards of the device-resident path
# the 1M sSAX index as the chunk-by-chunk build gave it: its node
# count, and per k the rows verified per query and the rounds, which the
# one-pass build and the vectorized collect walk must keep
INDEX_HELD = {"nodes": 86_512, 1: ("176.0", 2), 32: ("304.6", 2)}
TOL = {"euclid": 1e-4, "euclid_bf16": 5e-2, "ssax_dist": 1e-4,
       "sax_dist": 1e-5, "paa": 1e-5, "paa_bf16": 2e-2,
       "windowed_euclid": 1e-3}
REPLACES = {
    "euclid": "src/repro/kernels/euclid.py:75",
    "ssax_dist": "src/repro/kernels/ssax_dist.py:58",
    "sax_dist": "src/repro/kernels/sax_dist.py:50",
    "paa": "src/repro/kernels/paa.py:42",
    "windowed_euclid": "src/repro/kernels/windowed_euclid.py:127",
}
MAIN_KERNELS = ("euclid", "ssax_dist", "sax_dist", "paa")
# the serving phase: the service over phase 4's indexed 1M sSAX store
SERVE = dict(clients=32, requests=4, k=8, window_s=0.002, max_batch=64,
             ingest_chunks=16, ingest_rows=4096, deadline_s=0.005)
NEUTRAL_Q, NEUTRAL_SIZES = 64, (1, 2, 4, 8, 16, 32, 64)
NEUTRAL_BATCH = 4096          # verification batch of the sax/tsax/stsax
#                               neutrality engines (SAX verifies ~250k
#                               rows per query: at 256 per round the 127
#                               dispatches would take minutes)
SJ_ROWS, SJ_SCAN_ROWS, SJ_CHUNK = 64, 16, 256  # self-join rows, chunk
SELFJOIN_KERNELS = ("euclid", "ssax_dist", "paa")
# the LM phase: parity of every architecture at reduced width (prefill,
# LM_STEPS greedy decode steps, one engine wave), qwen3-0.6b served at
# full width, and activation retrieval over its hidden states
LM_ARCH, LM_SEED, LM_STEPS = "qwen3-0.6b", 0, 8
LM_TOL = 1e-4                 # card vs CPU logits, f32, reduced width
LM_WAVE = dict(requests=5, slots=2, max_len=64, new=5, lens=(4, 10))
LM_SERVE = dict(slots=8, max_len=512, requests=16, prompt=128, new=32)
LM_BF16_CACHE_TOL = 5e-2      # engine (bf16 cache) vs naive (f32 cache)
LM_FWD_TOL = 1e-3             # decode logits vs forward's, f32 full width
ACT = dict(prompts=256, T=64, W=16, A_tr=64, A_res=64, queries=8,
           ks=(1, 8), batch=64, seed=11)
LM_KERNELS = ("euclid", "paa")
# the training phase: one step of every architecture at reduced width on
# the card and the CPU, qwen3-0.6b trained at full width, replay after
# failures, the launcher
TRAIN_ARCH, TRAIN_SEED = "qwen3-0.6b", 0
TRAIN_SMALL = dict(lr=1e-3)
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "moments": 1e-3,
             "params": 1e-6, "params_any": 1.0}   # see state_errors
TRAIN_FULL = dict(batch=8, seq=512, steps=30, warmup=10, lr=3e-4,
                  warm_skip=2, rc=dict(q_chunk=512, kv_chunk=512,
                                       loss_chunk=256))
TRAIN_MB_TOL = 5e-2           # microbatch=2 vs 1, bf16: relative, in norm
# the sharded-training phase: the launcher under torch.distributed.run at
# qwen3-0.6b's full width (one rank), replayed unsharded; the accounting's
# state bytes against the card's; elastic restore; the grouped MoE; the
# dry-run's CLI on one cell of each mode
SHARD = dict(steps=4, batch=8, seq=512, warm_skip=1, moe_groups=4)
SHARD_MOE = ("olmoe-1b-7b", "jamba-1.5-large-398b")
SHARD_MOE_TOL = dict(rtol=2e-2, atol=2e-3)   # grouped vs ungrouped
# the world phase: phase 7's calls over a torch.distributed world of
# cards, the window call at k = 8; a rank command's time limit
WORLD = dict(window_k=8, timeout=600)
# the service over a world: phase 8a's set-up in a rank, then these
# queries over the final corpus with no writer; a command's time limit
SERVE_WORLD = dict(queries=64, k=8)
SERVE_WORLD_KERNELS = ("euclid", "ssax_dist", "paa")
SHARD_DRYRUN = (("smollm-135m", "all", "3 ok, 1 documented skips, 0 "
                 "errors"),
                ("jamba-1.5-large-398b", "long_500k",
                 "1 ok, 0 documented skips, 0 errors"))


def fail(msg: str):
    print(f"[smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(f"[smoke] {msg}", flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, n: int = 100) -> float:
    """Device time of one ``fn()``: ``n`` calls captured in a CUDA graph,
    the graph replayed between two events, divided by ``n``.  No host
    cost of the calls is in it.  ``fn`` must launch without host work
    that a capture forbids (no synchronisation, no pageable copies)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def k5_shapes(torch, ops, ref, dev):
    """K5 at the scan shape at stride 4 and at stride 1, and at the shape
    of one ``scan_topk`` launch (38 rows at stride 4): device time (CUDA
    events, back to back; the chunk shape from a CUDA graph), time per
    window and bound.  The first 64 rows of each timed launch's output
    (all 38 of the chunk's) are held against the plain version on those
    rows.  Returns the rows, keyed by shape name."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(SUB_ROWS, SUB_T, generator=g, device=dev)
    q = torch.randn(N_QUERIES, SUB_M, generator=g, device=dev)
    q = (q - q.mean(-1, keepdim=True)) / q.std(-1, keepdim=True,
                                               correction=0)
    out = {}
    for name, n_rows, stride in (("stride4", SUB_ROWS, SUB_STRIDE),
                                 ("stride1", SUB_ROWS, 1),
                                 ("chunk38", SUB_CHUNK_ROWS, SUB_STRIDE)):
        xs = x[:n_rows].contiguous()
        s = (SUB_T - SUB_M) // stride + 1
        n_chk = min(n_rows, 64)
        err = check(f"windowed_euclid {name} (first {n_chk} rows)",
                    ops.windowed_euclid(xs, q, stride)[:, :n_chk],
                    ref.windowed_euclid_ref(xs[:n_chk], q, stride),
                    TOL["windowed_euclid"])
        fn = (lambda xs=xs, stride=stride:
              ops.windowed_euclid(xs, q, stride))
        ms = (graph_ms(torch, fn) if n_rows < SUB_ROWS
              else time_ms(torch, fn, 20))
        b = bound_ms(n_rows * SUB_T * 4 + N_QUERIES * SUB_M * 4
                     + N_QUERIES * n_rows * s * 4,
                     2 * SUB_M * N_QUERIES * n_rows * s)
        out[name] = dict(ms=ms, windows=n_rows * s, max_abs_err=err,
                         ns_per_window=ms * 1e6 / (n_rows * s), bound=b,
                         shape=f"Q={N_QUERIES}, ({n_rows}, {SUB_T}), "
                               f"m={SUB_M}, stride {stride}, S={s}")
        say(f"K5 {name} [{out[name]['shape']}]: {ms:.5f} ms, "
            f"{out[name]['ns_per_window']:.5f} ns per window, bound "
            f"{b[0]:.5f} ms ({b[1]})")
    return out


def k2_shapes(torch, ops, ref, randint, randn):
    """K2 at the main path's sweep shape (1,000,000 x (L + W) = 10 + 48)
    and the subsequence path's (1,722,368 windows x (10 + 24)), with
    make_technique's alphabets (16 season, 32 residual symbols): one
    query (``ssax_dist``) and the path's 8 queries in one batched launch
    (``ssax_dist_batch``).  Each is held against the plain version, and
    every batched row bitwise against its one-query launch; then a
    ragged shape.  Times are device times (events, back to back), beside
    the bound as reckoned (symbol bytes once, tables and output, against
    Q x 6 operations per cell) and the issue floor (Q x 5 FP32
    instructions per cell over 132 SMs x 128 lanes at the data sheet's
    1.98 GHz).  Returns the report's row: the main path's 8-query
    launch."""
    n_win = (SUB_T - SUB_M) // SUB_STRIDE + 1
    a_s, a_r, tol, row, err = 16, 32, TOL["ssax_dist"], None, 0.0
    for name, n, w in (("main", N_MAIN, W),
                       ("subseq", SUB_ROWS * n_win, SUB_M // L)):
        seas, res = randint(a_s, (n, L)), randint(a_r, (n, w))
        tabs = (randn(N_QUERIES, L, a_s), randn(N_QUERIES, L, a_s),
                randn(N_QUERIES, w, a_r), randn(N_QUERIES, w, a_r))
        one = [t[0] for t in tabs]
        got = ops.ssax_dist_batch(seas, res, *tabs)
        err = max(err, check(f"ssax_dist {name} Q={N_QUERIES}", got,
                             ref.ssax_dist_batch_ref(seas, res, *tabs), tol))
        err = max(err, check(f"ssax_dist {name} Q=1",
                             ops.ssax_dist(seas, res, *one),
                             ref.ssax_dist_ref(seas, res, *one), tol))
        for q in range(N_QUERIES):
            if not torch.equal(got[q], ops.ssax_dist(
                    seas, res, *(t[q] for t in tabs))):
                fail(f"ssax_dist {name}: batched row {q} differs from its "
                     f"one-query launch")
        routes = {1: (lambda: ops.ssax_dist(seas, res, *one),
                      lambda: ref.ssax_dist_ref(seas, res, *one)),
                  N_QUERIES: (lambda: ops.ssax_dist_batch(seas, res, *tabs),
                              lambda: ref.ssax_dist_batch_ref(seas, res,
                                                              *tabs))}
        for nq, (fn, plain) in routes.items():
            cells = nq * n * L * w
            r = dict(ms=time_ms(torch, fn, 50 if nq == 1 else 20),
                     plain_ms=time_ms(torch, plain, 2, warmup=1),
                     library_ms=None,
                     bound=bound_ms(n * (L + w) * 4 + nq * n * 4
                                    + nq * 2 * (L * a_s + w * a_r) * 4,
                                    6 * cells),
                     floor_ms=5 * cells / F32_ISSUE_PER_S * 1e3,
                     shape=f"{name}: seas ({n}, {L}), res ({n}, {w}) i32, "
                           f"Q={nq}" + (" in one launch" if nq > 1 else ""))
            say(f"kernel ssax_dist [{r['shape']}]: {r['ms']:.5f} ms "
                f"(events, back to back), plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), issue "
                f"floor {r['floor_ms']:.5f} ms (5 FP32 instructions per "
                f"cell)")
            if name == "main" and nq == N_QUERIES:
                row = r
        say(f"ssax_dist {name}: every row of the {N_QUERIES}-query launch == "
            f"its one-query launch, bitwise")
        del seas, res, got
    rag = (randint(a_s, (300, L)), randint(a_r, (300, 17)),
           randn(3, L, a_s), randn(3, L, a_s), randn(3, 17, a_r),
           randn(3, 17, a_r))
    err = max(err, check("ssax_dist ragged", ops.ssax_dist_batch(*rag),
                         ref.ssax_dist_batch_ref(*rag), tol))
    row["max_abs_err"] = err
    return row


def host_ms(torch, fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean host-clock time of ``fn()`` followed by a synchronisation,
    as the verification loop pays it (it reads the result back)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / iters * 1e3


def k1_gathered(torch, ops, ref, dev):
    """K1's gathered entry at the verification round shape (Qa = 8 active
    queries, B = 256 candidates each, U = 2,048 rows) at T = 960 (whole
    series), T = 240 (windows), bf16 and the ragged T = 961.  As on the
    path, the rows are exactly the union of the candidates: the gather
    is a permutation of the U rows split across the queries, so every
    row is read once.  Each is held bitwise to the all-pairs entry on
    the gathered rows and to the plain version within tolerance.  At
    T = 960 f32: device time from a CUDA graph of 100 launches, cycling
    over 8 copies of the rows (63 MB, beyond the 50 MB L2, so each
    launch reads its rows from HBM) and, beside it, on one copy that
    stays in L2 across the replays; the host-clock time of one wrapper
    call (host gather checked and copied, one launch, synchronised)
    beside the per-query route the engine took before (eight gather
    copies, eight all-pairs launches, a stack); and the bound.  Returns
    the kernel row of the report."""
    import numpy as np
    from repro_torch.kernels import euclid as k1
    rng = np.random.default_rng(3)
    U, qa = 2 * 1024, N_QUERIES
    g_np = rng.permutation(U).reshape(qa, BATCH).astype(np.int64)
    g_dev = torch.from_numpy(g_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    err, row = 0.0, None
    for t_len, dtype in ((T, torch.float32), (SUB_M, torch.float32),
                         (T, torch.bfloat16), (961, torch.float32)):
        rows = torch.randn(U, t_len, generator=gen, device=dev).to(dtype)
        q = torch.randn(qa, t_len, generator=gen, device=dev).to(dtype)
        got = ops.euclid_gather(rows, q, g_np)
        per_q = torch.stack([ops.euclid_batch(rows[g_dev[a]].contiguous(),
                                              q[a]) for a in range(qa)])
        name = f"euclid gathered T={t_len} {str(dtype)[6:]}"
        if not torch.equal(got, per_q):
            fail(f"{name}: differs from the all-pairs kernel on the "
                 f"gathered rows")
        tol = TOL["euclid" if dtype == torch.float32 else "euclid_bf16"]
        err = max(err, check(name, got, ref.euclid_gather_ref(rows, q, g_dev),
                             tol))
        if row is not None:
            continue
        out = torch.empty(qa, BATCH, device=dev)
        esize = rows.element_size()
        copies = [rows] + [rows.clone() for _ in range(7)]
        turn = iter(range(1 << 30))

        def from_hbm():
            k1.launch_gather(copies[next(turn) % len(copies)], q, g_dev, out)
        row = dict(
            ms=graph_ms(torch, from_hbm),
            l2_ms=graph_ms(torch, lambda: k1.launch_gather(rows, q, g_dev,
                                                           out)),
            host_ms=host_ms(torch, lambda: ops.euclid_gather(rows, q, g_np)),
            per_query_host_ms=host_ms(torch, lambda: torch.stack(
                [ops.euclid_batch(rows[g_dev[a]], q[a])
                 for a in range(qa)])),
            plain_ms=time_ms(torch, lambda: ref.euclid_gather_ref(
                rows, q, g_dev), 50),
            library_ms=time_ms(torch, lambda: torch.cdist(
                q[:, None, :], rows[g_dev]).square(), 50),
            bound=bound_ms(U * t_len * esize + qa * t_len * esize
                           + qa * BATCH * 8 + qa * BATCH * 4,
                           3 * qa * BATCH * t_len),
            shape=f"gathered, rows ({U}, {t_len}) f32 all read, q ({qa}, "
                  f"{t_len}), gather ({qa}, {BATCH})")
        del copies
        say(f"kernel euclid [{row['shape']}]: device {row['ms']:.5f} ms "
            f"(CUDA graph of 100 over 8 copies of the rows, read from "
            f"HBM), {row['l2_ms']:.5f} ms with the rows in L2 (one copy); "
            f"one wrapper call {row['host_ms']:.5f} ms on the host clock "
            f"against {row['per_query_host_ms']:.5f} ms for the per-query "
            f"route, bound {row['bound'][0]:.6f} ms ({row['bound'][1]}); "
            f"library = cdist on the gathered rows (gather copy included) "
            f"{row['library_ms']:.5f} ms")
    row["max_abs_err"] = err
    say(f"euclid gathered == all pairs on the gathered rows, bitwise, at "
        f"T = {T}, {SUB_M}, {T} bf16 and 961")
    return row


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(name: str, got, want, tol: float) -> float:
    """Max abs error of ``got`` vs ``want``; fails beyond rtol = atol."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        fail(f"{name}: disagrees with its plain version or reference "
             f"(max abs err {float(err.max())}, tolerance {tol})")
    return float(err.max()) if err.numel() else 0.0


def random_makers(torch, dev, seed: int):
    """``randint(hi, shape)`` (int32) and ``randn(*shape)`` on ``dev``
    from one seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    return randint, randn


def k2_scaling(torch, ops, dev):
    """``--k2``: K2's device time at the main path's sweep shape for Q =
    1 to 64 queries in one launch (events, back to back), per query and
    against the issue floor, to show where the time per query goes as
    the symbols' bytes are shared by more queries."""
    randint, randn = random_makers(torch, dev, 2)
    seas, res = randint(16, (N_MAIN, L)), randint(32, (N_MAIN, W))
    for nq in (1, 2, 4, 8, 16, 64):
        tabs = (randn(nq, L, 16), randn(nq, L, 16), randn(nq, W, 32),
                randn(nq, W, 32))
        ms = time_ms(torch, lambda: ops.ssax_dist_batch(seas, res, *tabs),
                     20)
        floor = 5 * nq * N_MAIN * L * W / F32_ISSUE_PER_S * 1e3
        say(f"K2 Q={nq} in one launch at ({N_MAIN}, {L} + {W}): {ms:.5f} "
            f"ms, {ms / nq:.5f} ms per query, issue floor {floor:.5f} ms "
            f"({floor / ms:.0%} of it)")


def kernel_phase(torch, ops, ref, dev):
    """Phase 2: every kernel against its plain version, with times."""
    randint, randn = random_makers(torch, dev, 0)
    rows = {}

    # K4 paa at the encode shape, a ragged shape and bf16
    x = randn(N_MAIN, T)
    err = check("paa", ops.paa_segments(x, W), ref.paa_ref(x, W), TOL["paa"])
    xr = randn(300, 480)
    err = max(err, check("paa ragged", ops.paa_segments(xr, 24),
                         ref.paa_ref(xr, 24), TOL["paa"]))
    xb = randn(4096, T).to(torch.bfloat16)
    err = max(err, check("paa bf16", ops.paa_segments(xb, W),
                         ref.paa_ref(xb, W), TOL["paa_bf16"]))
    rows["paa"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.paa_segments(x, W), 20),
        plain_ms=time_ms(torch, lambda: ref.paa_ref(x, W), 20),
        library_ms=time_ms(torch, lambda: x.view(N_MAIN, W, T // W).mean(-1),
                           20),
        bound=bound_ms(N_MAIN * T * 4 + N_MAIN * W * 4, N_MAIN * T),
        shape=f"x ({N_MAIN}, {T}) f32 -> ({N_MAIN}, {W})")
    del x

    # K3 sax_dist at the sweep shape (one query), ragged and a table
    # beyond shared memory (W=96, A=1024: 384 KB)
    A = 64
    sym, tab = randint(A, (N_MAIN, W)), randn(W, A).square()
    err = check("sax_dist", ops.sax_dist(sym, tab), ref.sax_dist_ref(sym, tab),
                TOL["sax_dist"])
    s2, t2 = randint(32, (300, 16)), randn(16, 32).square()
    err = max(err, check("sax_dist ragged", ops.sax_dist(s2, t2),
                         ref.sax_dist_ref(s2, t2), TOL["sax_dist"]))
    s3, t3 = randint(1024, (65_536, 96)), randn(96, 1024).square()
    err = max(err, check("sax_dist big table", ops.sax_dist(s3, t3),
                         ref.sax_dist_ref(s3, t3), TOL["sax_dist"]))
    rows["sax_dist"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.sax_dist(sym, tab), 50),
        plain_ms=time_ms(torch, lambda: ref.sax_dist_ref(sym, tab), 10),
        library_ms=None,
        bound=bound_ms(N_MAIN * W * 4 + W * A * 4 + N_MAIN * 4, N_MAIN * W),
        shape=f"sym ({N_MAIN}, {W}) i32, table ({W}, {A})")
    del sym

    # K2 ssax_dist at both paths' sweep shapes (one query, and the path's
    # 8 queries in one batched launch) and ragged
    rows["ssax_dist"] = k2_shapes(torch, ops, ref, randint, randn)

    # K1 euclid at the verification shape (one query against one batch),
    # a query batch, a ragged shape and bf16
    xv, qv = randn(BATCH, T), randn(1, T)

    def plain_euclid(x, q):
        return torch.stack([ref.euclid_ref(x, qi) for qi in q])
    err = check("euclid", ops.euclid_batch(xv, qv), plain_euclid(xv, qv),
                TOL["euclid"])
    xq, qq = randn(65_536, T), randn(N_QUERIES, T)
    err = max(err, check("euclid queries", ops.euclid_batch(xq, qq),
                         plain_euclid(xq, qq), TOL["euclid"]))
    xr, qr = randn(37, 961), randn(3, 961)
    err = max(err, check("euclid ragged", ops.euclid_batch(xr, qr),
                         plain_euclid(xr, qr), TOL["euclid"]))
    xb, qb = xq[:4096].to(torch.bfloat16), qq.to(torch.bfloat16)
    err = max(err, check("euclid bf16", ops.euclid_batch(xb, qb),
                         plain_euclid(xb, qb), TOL["euclid_bf16"]))
    single = dict(
        ms=time_ms(torch, lambda: ops.euclid_batch(xv, qv), 200),
        plain_ms=time_ms(torch, lambda: plain_euclid(xv, qv), 200),
        library_ms=time_ms(torch, lambda: torch.cdist(qv, xv) ** 2, 200),
        bound=bound_ms(BATCH * T * 4 + T * 4 + BATCH * 4, 3 * BATCH * T),
        shape=f"all pairs, x ({BATCH}, {T}) f32, q (1, {T})")
    rows["euclid"] = k1_gathered(torch, ops, ref, dev)
    rows["euclid"]["max_abs_err"] = max(err, rows["euclid"]["max_abs_err"])
    say(f"kernel euclid [{single['shape']}]: {single['ms']:.5f} ms (events, "
        f"back to back), plain {single['plain_ms']:.5f} ms, library "
        f"{single['library_ms']:.5f} ms, bound {single['bound'][0]:.6f} ms")

    # K5 windowed_euclid at the reference's test shapes, the scan shape
    # on its first 64 rows (the plain version materializes (Q, N, S, m)),
    # constant rows (every distance is sum q^2; the plain version is not
    # asked, as torch's mean on the card need not return the constant
    # exactly, and znormalize then divides the difference by eps) and
    # rows offset by 1000
    def zq(nq, m):
        q = randn(nq, m)
        return (q - q.mean(-1, keepdim=True)) / q.std(-1, keepdim=True,
                                                      correction=0)
    tol, err = TOL["windowed_euclid"], 0.0
    for nq, n, t, m, st in [(1, 4, 256, 64, 1), (3, 5, 300, 32, 3),
                            (2, 9, 1111, 64, 7), (2, 2, 100, 100, 1),
                            (4, 24, 960, 120, 5)]:
        x, q = randn(n, t), zq(nq, m)
        err = max(err, check(f"windowed_euclid {(nq, n, t, m, st)}",
                             ops.windowed_euclid(x, q, st),
                             ref.windowed_euclid_ref(x, q, st), tol))
    xs, qs = randn(SUB_ROWS, SUB_T), zq(N_QUERIES, SUB_M)
    x64 = xs[:64]
    err = max(err, check("windowed_euclid scan shape",
                         ops.windowed_euclid(x64, qs, SUB_STRIDE),
                         ref.windowed_euclid_ref(x64, qs, SUB_STRIDE), tol))
    xc = torch.full((3, 1000), 2.5, device=dev)
    got = ops.windowed_euclid(xc, qs, SUB_STRIDE)
    err = max(err, check("windowed_euclid constant", got,
                         qs.square().sum(-1)[:, None, None].expand_as(got),
                         tol))
    xo = x64[:16] + 1000.0
    err = max(err, check("windowed_euclid offset",
                         ops.windowed_euclid(xo, qs, SUB_STRIDE),
                         ref.windowed_euclid_ref(xo, qs, SUB_STRIDE), tol))
    n_win = (SUB_T - SUB_M) // SUB_STRIDE + 1
    rows["windowed_euclid"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.windowed_euclid(xs, qs, SUB_STRIDE),
                   20),
        plain_ms=time_ms(torch, lambda: ref.windowed_euclid_ref(
            x64, qs, SUB_STRIDE), 5),
        library_ms=None,
        bound=bound_ms(SUB_ROWS * SUB_T * 4 + N_QUERIES * SUB_M * 4
                       + N_QUERIES * SUB_ROWS * n_win * 4,
                       2 * SUB_M * N_QUERIES * SUB_ROWS * n_win),
        shape=f"x ({SUB_ROWS}, {SUB_T}) f32, q ({N_QUERIES}, {SUB_M}), "
              f"stride {SUB_STRIDE}; plain on the first 64 rows")
    del xs, x64
    for r in k5_shapes(torch, ops, ref, dev).values():
        rows["windowed_euclid"]["max_abs_err"] = max(
            rows["windowed_euclid"]["max_abs_err"], r["max_abs_err"])

    # K1-K4 at the subsequence path's shapes: windows of m = 240 encoded
    # with W = 24 (K4 on one row's 841 windows; K2 and K3 over all
    # 1,722,368 windows with make_technique's alphabets, as above),
    # verified 256 windows at a time against one query (K1) and
    # brute-forced 65,536 windows at a time against all 8 queries
    n_sub, w_sub = SUB_ROWS * n_win, SUB_M // L
    sub = {}
    xw = randn(n_win, SUB_M)
    sub["paa"] = check("paa subseq", ops.paa_segments(xw, w_sub),
                       ref.paa_ref(xw, w_sub), TOL["paa"])
    b = bound_ms(n_win * SUB_M * 4 + n_win * w_sub * 4, n_win * SUB_M)
    say(f"kernel paa [x ({n_win}, {SUB_M}) f32 -> ({n_win}, {w_sub}), one "
        f"window-encode launch]: device "
        f"{graph_ms(torch, lambda: ops.paa_segments(xw, w_sub)):.5f} ms "
        f"(CUDA graph of 100), plain "
        f"{graph_ms(torch, lambda: ref.paa_ref(xw, w_sub)):.5f} ms, library "
        f"{graph_ms(torch, lambda: xw.view(n_win, w_sub, SUB_M // w_sub).mean(-1)):.5f} "
        f"ms, bound {b[0]:.6f} ms ({b[1]})")
    sym, tab = randint(A, (n_sub, w_sub)), randn(w_sub, A).square()
    sub["sax_dist"] = check("sax_dist subseq", ops.sax_dist(sym, tab),
                            ref.sax_dist_ref(sym, tab), TOL["sax_dist"])
    del sym
    xv, qv = randn(BATCH, SUB_M), randn(1, SUB_M)
    sub["euclid"] = check("euclid subseq verify", ops.euclid_batch(xv, qv),
                          plain_euclid(xv, qv), TOL["euclid"])
    xq, qq = randn(65_536, SUB_M), randn(N_QUERIES, SUB_M)
    sub["euclid"] = max(sub["euclid"], check(
        "euclid subseq brute force", ops.euclid_batch(xq, qq),
        plain_euclid(xq, qq), TOL["euclid"]))
    del xq
    for name, e in sub.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    say(f"kernels at the subsequence shapes agree with their plain "
        f"versions: paa ({n_win}, {SUB_M}) -> {w_sub}; sax_dist over "
        f"{n_sub} windows at W={w_sub} (ssax_dist above); euclid ({BATCH}, "
        f"{SUB_M}) x 1 and (65536, {SUB_M}) x {N_QUERIES}; max abs err "
        f"{sub}")
    for name, r in rows.items():
        say(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max abs err "
            f"{r['max_abs_err']:.3g}")
    return rows


def split(torch, np, dev, engines, Q):
    """Where one warm 8-query topk call's wall time goes, for sSAX and
    SAX at k = 32 (host clock), in both candidate orders over the same
    store.  Host order (a plain ``MatchEngine``): the sweep (query
    encode, one K2 launch for all queries or one K3 launch per query,
    bounds to the host), the host's stable argsort of the (Q, N) bounds,
    and the verification loop (fetch, K1, merge) that is the rest.
    Device order (the launcher's sharded engine service, when the tree
    has one): the sweep into the mirrors' natural order, the stable
    device sort, and the verification loop.  The two orders must give
    the same answer, rounds and rows.  Returns {tech: (sweep, order,
    rest) seconds} of the host order."""
    from repro_torch.core.engine import MatchEngine
    from repro_torch.kernels.ops import make_pairwise
    out = {}
    for tech in ("ssax", "sax"):
        engine, k = engines[tech], max(KS)
        plain = MatchEngine(engine.encoder, engine.store, batch_size=BATCH,
                            verify="auto",
                            pairwise=make_pairwise(engine.encoder),
                            device=dev)
        plain.topk(Q, k=k)             # warm: uploads the representation
        sync(torch, dev)
        t0 = time.perf_counter()
        rd = plain.repr_distances(Q)
        t_sweep = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.argsort(rd, axis=1, kind="stable")
        t_sort = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_h = plain.topk(Q, k=k)
        t_all = time.perf_counter() - t0
        out[tech] = (t_sweep, t_sort, t_all - t_sweep - t_sort)
        say(f"breakdown {tech} N={N_MAIN} k={k}, host order: topk "
            f"{t_all:.3f} s = sweep {t_sweep:.3f} s + host argsort "
            f"{t_sort:.3f} s + verification loop "
            f"{t_all - t_sweep - t_sort:.3f} s")
        del plain, rd
        sweep = getattr(engine, "sweep", None)
        if sweep is None:              # an earlier tree: no device order
            continue
        t_dsweep, t_order = device_order_split(torch, dev, sweep, Q)
        t0 = time.perf_counter()
        res_d = engine.topk(Q, k=k)
        t_dall = time.perf_counter() - t0
        say(f"breakdown {tech} N={N_MAIN} k={k}, device order "
            f"({sweep.n_shards} shard): topk {t_dall:.3f} s = sweep "
            f"{t_dsweep:.3f} s + device order {t_order:.3f} s + "
            f"verification loop {t_dall - t_dsweep - t_order:.3f} s")
        if not (same_answer(np, res_h, res_d) and res_h.rounds == res_d.rounds
                and np.array_equal(res_h.raw_accesses, res_d.raw_accesses)):
            fail(f"{tech} k={k}: the device order's answer, rounds or rows "
                 f"differ from the host order's")
    return out


def device_order_split(torch, dev, sweep, Q):
    """Host-clock seconds of a sharded sweep's two steps before
    verification, each fenced: the sweep (query encode and one pass over
    the mirrors into natural id order) and the stable device sort."""
    from repro_torch.core.distributed import _order_stream
    sync(torch, dev)
    t0 = time.perf_counter()
    rep_q, _ = sweep._encode_queries(Q)
    b = sweep._natural_bounds(rep_q)
    sync(torch, dev)
    t_sweep = time.perf_counter() - t0
    t0 = time.perf_counter()
    _order_stream(b, width=b.shape[1])        # ends in a host copy
    return t_sweep, time.perf_counter() - t0


def split_only(torch, np, dev):
    """``--split``: the main path's corpus and its sSAX and SAX engines,
    one warm-up topk each, then :func:`split`.  It calls only entry
    points every slice of the port has, so the same script can time an
    earlier tree's ``src`` beside this one."""
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.launch.match import make_engine
    X = season_corpus(N_MAIN + N_QUERIES, T, L, STRENGTH,
                      per_series_strength=True, seed=1)
    Q, D = X[:N_QUERIES], X[N_QUERIES:]
    engines = {tech: make_engine(tech, D, L=L, strength=STRENGTH,
                                 batch=BATCH, verify="auto", device=dev)
               for tech in ("ssax", "sax")}
    for engine in engines.values():
        engine.topk(Q, k=max(KS))
    split(torch, np, dev, engines, Q)


def main_path(torch, np, dev):
    """Phase 3: the port's main path, then its checks.  Returns the
    kernels' launch counts during the path alone and what the index
    path reuses: the queries, the corpus, the sSAX representation on
    the host, the K1 brute force per technique and the answers."""
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.launch.match import kernel_bruteforce, make_engine

    t0 = time.perf_counter()
    X = season_corpus(N_MAIN + N_QUERIES, T, L, STRENGTH,
                      per_series_strength=True, seed=1)
    Q, D = X[:N_QUERIES], X[N_QUERIES:]
    say(f"corpus {D.shape} f32 ({D.nbytes / 1e9:.2f} GB) + {N_QUERIES} "
        f"queries generated in {time.perf_counter() - t0:.1f} s")

    plan = [("ssax", D), ("sax", D), ("tsax", D[:N_SMALL]),
            ("stsax", D[:N_SMALL])]
    results, engines = {}, {}
    reset_launch_counts()
    for tech, data in plan:
        sync(torch, dev)
        t0 = time.perf_counter()
        engine = engines[tech] = make_engine(
            tech, data, L=L, strength=STRENGTH, batch=BATCH, verify="auto",
            device=dev)
        sync(torch, dev)
        t_enc = time.perf_counter() - t0
        for k in KS:
            engine.store.reset()
            before = launch_counts()
            t0 = time.perf_counter()
            res = engine.topk(Q, k=k)
            wall = time.perf_counter() - t0
            calls = {n: c - before[n] for n, c in launch_counts().items()}
            results[tech, k] = (res, wall, calls)
        say(f"{tech} N={data.shape[0]}: engine built (encode) in "
            f"{t_enc:.2f} s")
    counts = launch_counts()
    say(f"main path launches: {counts}")
    rounds_check("main path", results.values(), exact_fetch=True)
    sweep_check("main path", [c for (tech, _), (_, _, c) in results.items()
                              if tech == "ssax"])

    host_split = split(torch, np, dev, engines, Q)
    rep_ssax = tuple(np.array(a) for a in engines["ssax"].store.rep_view())
    engines.clear()
    brute = {}

    for tech, data in plan:
        n = data.shape[0]
        bf_i, bf_d = brute[tech] = kernel_bruteforce(Q, data, max(KS) + 1,
                                                     dev)
        pl_d = plain_bruteforce(torch, np, ref, Q, data, dev)
        pl_o = np.argsort(pl_d, axis=1, kind="stable")
        for k in KS:
            res, wall, calls = results[tech, k]
            if res.indices.shape != (N_QUERIES, k) or \
                    not np.isfinite(res.distances).all() or \
                    (res.indices < 0).any() or (res.indices >= n).any():
                fail(f"{tech} k={k}: malformed result")
            if not (np.array_equal(res.indices, bf_i[:, :k]) and
                    np.array_equal(res.distances,
                                   bf_d[:, :k].astype(np.float64))):
                fail(f"{tech} k={k}: exact top-k differs from the K1 "
                     f"brute force")
            compared = 0
            for qi in range(N_QUERIES):
                dk, dk1 = pl_d[qi, pl_o[qi, k - 1]], pl_d[qi, pl_o[qi, k]]
                if dk1 - dk <= 1e-5 * dk:
                    continue                  # near-tie at the k boundary
                compared += 1
                if set(res.indices[qi]) != set(pl_o[qi, :k]):
                    fail(f"{tech} k={k} query {qi}: ids differ from the "
                         f"plain brute force")
            acc = res.raw_accesses.mean()
            say(f"{tech} N={n} k={k}: exact == K1 brute force bitwise; ids "
                f"== plain brute force on {compared}/{N_QUERIES} queries "
                f"(others near-tied); raw rows/query {acc:.1f}, pruned "
                f"fraction {res.pruned_fraction.mean():.6f}, "
                f"{res.rounds} rounds, {res.store_fetches} fetches; topk "
                f"wall {wall:.3f} s; "
                f"launches {calls}")
    return counts, dict(Q=Q, D=D, rep_ssax=rep_ssax, brute=brute,
                        results=results, host_split=host_split)


def same_answer(np, a, b) -> bool:
    """Two ``TopKResult``s agree bitwise: ids and distances."""
    return (np.array_equal(a.indices, b.indices)
            and np.array_equal(a.distances, b.distances))


def index_path(torch, np, dev, main):
    """Phase 4: the index path on phase 3's corpus, then its checks.
    Returns the kernels' launch counts during the path alone and the
    indexed 1M sSAX store, which the serving phase serves."""
    import tempfile
    from repro_torch.core.engine import MatchEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import make_engine
    from repro_torch.obs import check_trace, render_trace
    from repro_torch.store import SymbolicStore
    Q, D, brute, linear = main["Q"], main["D"], main["brute"], \
        main["results"]
    reset_launch_counts()

    def build(tech, data, rep=None):
        sync(torch, dev)
        t0 = time.perf_counter()
        engine = make_engine(tech, data, L=L, strength=STRENGTH,
                             batch=BATCH, verify="auto", rep=rep, device=dev)
        t_store = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.store.build_index(leaf_fill=LEAF_FILL)
        sync(torch, dev)
        return engine, t_store, time.perf_counter() - t0

    def call(engine, queries=Q, **kw):
        engine.store.reset()
        before = launch_counts()
        t0 = time.perf_counter()
        res = engine.topk(queries, **kw)
        wall = time.perf_counter() - t0
        return res, wall, {n: c - before[n] for n, c in
                           launch_counts().items()}

    engine, t_store, t_build = build("ssax", D, rep=main["rep_ssax"])
    idx = engine.store.index
    say(f"ssax index over {idx.n} rows: {idx.n_nodes} nodes (leaf_fill "
        f"{LEAF_FILL}) built in {t_build:.2f} s (features through K4 in "
        f"chunks of 8,192 rows, routed into the tree in one pass on the "
        f"host); store from phase 3's representation in {t_store:.2f} s")
    if idx.n_nodes != INDEX_HELD["nodes"]:
        fail(f"ssax index: {idx.n_nodes} nodes, not the "
             f"{INDEX_HELD['nodes']} of the chunk-by-chunk build")
    runs = {}
    for k in KS:
        runs["index", k] = call(engine, k=k, source="index")
        runs["linear", k] = call(engine, k=k)
    for src, source in (("index", "index"), ("linear", None)):
        runs[src + " traced", max(KS)] = call(engine, k=max(KS),
                                              source=source, explain=True)
    # the launcher's engine orders the tree's union bounds on the device
    # (TreeCandidates(device_order=True)); a plain engine over the same
    # store orders them on the host, and must answer the same way with
    # the same rows and rounds
    plain = MatchEngine(engine.encoder, engine.store, batch_size=BATCH,
                        verify="auto", pairwise=make_pairwise(engine.encoder),
                        device=dev)
    host_order = call(plain, k=max(KS), source="index")
    del plain
    all_calls = list(runs.values()) + [host_order]
    (rd_, wd_, _), (rh_, wh_, _) = runs["index", max(KS)], host_order
    if not (same_answer(np, rd_, rh_) and rd_.rounds == rh_.rounds
            and np.array_equal(rd_.raw_accesses, rh_.raw_accesses)):
        fail(f"ssax indexed k={max(KS)}: the device-ordered union differs "
             f"from the host-ordered one in answer, rows or rounds")
    say(f"ssax indexed k={max(KS)}: device-ordered union (TreeCandidates("
        f"device_order=True)) == host-ordered bitwise; rows verified per "
        f"query {rd_.raw_accesses.mean():.1f} vs {rh_.raw_accesses.mean():.1f}"
        f"; rounds {rd_.rounds} vs {rh_.rounds}; topk wall {wd_:.3f} s vs "
        f"{wh_:.3f} s")

    for (name, k), (res, wall, calls) in runs.items():
        bf_i, bf_d = brute["ssax"]
        if not (np.array_equal(res.indices, bf_i[:, :k]) and np.array_equal(
                res.distances, bf_d[:, :k].astype(np.float64))):
            fail(f"ssax {name} k={k}: differs from the K1 brute force")
        if not same_answer(np, res, linear["ssax", k][0]):
            fail(f"ssax {name} k={k}: differs from phase 3's linear answer")
    for src in ("index", "linear"):
        base, traced = runs[src, max(KS)], runs[src + " traced", max(KS)]
        (b, _, bc), (t, _, tc) = base, traced
        if not (same_answer(np, b, t) and bc == tc
                and np.array_equal(b.raw_accesses, t.raw_accesses)
                and (b.rounds, b.store_fetches, b.store_accesses)
                == (t.rounds, t.store_fetches, t.store_accesses)):
            fail(f"ssax {src} k={max(KS)}: the traced call differs from "
                 f"the untraced one ({tc} vs {bc} launches)")
        problems = check_trace(t.trace)
        if problems:
            fail(f"ssax {src} trace: {problems}")
        for line in render_trace(t.trace).splitlines():
            say(f"explain {src}: {line}")
    for k in KS:
        (ri, wi, ci), (rl, wl, cl) = runs["index", k], runs["linear", k]
        if (f"{ri.raw_accesses.mean():.1f}", ri.rounds) != INDEX_HELD[k]:
            fail(f"ssax indexed k={k}: {ri.raw_accesses.mean():.1f} rows "
                 f"verified per query in {ri.rounds} rounds, not "
                 f"{INDEX_HELD[k]}")
        say(f"ssax N={idx.n} k={k}: indexed == linear == K1 brute force "
            f"bitwise; rows verified per query {ri.raw_accesses.mean():.1f}"
            f" indexed vs {rl.raw_accesses.mean():.1f} linear; rounds "
            f"{ri.rounds} vs {rl.rounds}; K1 launches {ci['euclid']} vs "
            f"{cl['euclid']}; topk wall {wi:.3f} s vs {wl:.3f} s; "
            f"launches {ci} vs {cl}")
    for src in ("index", "linear"):
        res, wall, calls = runs[src + " traced", max(KS)]
        tr = res.trace
        say(f"ssax {src} k={max(KS)} traced: topk wall {wall:.3f} s = "
            f"order {tr.span_seconds('order'):.3f} s (of which seed "
            f"{tr.span_seconds('seed'):.3f} s) + verify "
            f"{tr.span_seconds('verify'):.3f} s; equal to its untraced "
            f"call bitwise with the same launches {calls}; check_trace "
            f"clean")
    ssax_store = engine.store        # the serving phase serves it
    del engine

    # the other encoders, indexed over the first N_SMALL rows
    for tech in ("sax", "tsax", "stsax"):
        engine, _, t_build = build(tech, D[:N_SMALL])
        res = call(engine, k=max(KS), source="index")
        lin = call(engine, k=max(KS))
        all_calls += [res, lin]
        if not same_answer(np, res[0], lin[0]):
            fail(f"{tech} N={N_SMALL}: indexed differs from linear")
        if tech != "sax" and not same_answer(np, lin[0],
                                             linear[tech, max(KS)][0]):
            fail(f"{tech} N={N_SMALL}: linear differs from phase 3's")
        say(f"{tech} N={N_SMALL} k={max(KS)}: index of "
            f"{engine.store.index.n_nodes} nodes built in {t_build:.2f} s; "
            f"indexed == linear bitwise; rows verified per query "
            f"{res[0].raw_accesses.mean():.1f} vs "
            f"{lin[0].raw_accesses.mean():.1f}; rounds {res[0].rounds} vs "
            f"{lin[0].rounds}; topk wall {res[1]:.3f} s vs {lin[1]:.3f} s")
        del engine

    # a snapshot of an indexed sSAX store, reopened on the card
    engine, _, _ = build("ssax", D[:N_SMALL])
    store = engine.store
    want = [call(engine, k=max(KS), source=src)
            for src in ("index", None)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = store.save(tmp)
        t_save = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back = SymbolicStore.open(tmp, device=dev)
        t_open = time.perf_counter() - t0
    if back.device != store.device or not np.array_equal(back.data,
                                                          store.data):
        fail("snapshot: reopened raw rows differ")
    for a, b in zip(back.rep_view(), store.rep_view()):
        if not np.array_equal(a, b):
            fail("snapshot: reopened representation differs")
    (ma, xa), (mb, xb) = back.index.to_snapshot(), store.index.to_snapshot()
    if ma != mb or any(not np.array_equal(xa[k], xb[k]) for k in xb):
        fail("snapshot: reopened index differs")
    reopened = MatchEngine(back.encoder, back, batch_size=BATCH,
                           verify=engine.verify_mode,
                           pairwise=make_pairwise(back.encoder), device=dev)
    got = [call(reopened, k=max(KS), source=src) for src in ("index", None)]
    all_calls += want + got
    for (w, _, _), (g, _, _) in zip(want, got):
        if not (same_answer(np, w, g)
                and np.array_equal(w.raw_accesses, g.raw_accesses)):
            fail("snapshot: the reopened store answers differently")
    new_rows = D[N_SMALL:N_SMALL + 2]
    ids = reopened.append(new_rows)
    found = call(reopened, new_rows, k=1, source="index")
    all_calls.append(found)
    found = found[0]
    if back.index.n != back.n or list(found.indices[:, 0]) != list(ids):
        fail(f"snapshot: appended rows {list(ids)} were not indexed and "
             f"found ({list(found.indices[:, 0])})")
    say(f"snapshot of {store.n} ssax rows + index ({store.index.n_nodes} "
        f"nodes): {n_bytes} bytes saved in {t_save:.2f} s, opened on "
        f"{back.device} in {t_open:.2f} s; indexed and linear k={max(KS)} "
        f"answers bitwise equal after reopening; 2 rows appended after "
        f"reopening indexed ({back.index.n} of {back.n}) and found as "
        f"their own nearest neighbours")
    del engine, reopened, back, store

    counts = launch_counts()
    say(f"index path launches: {counts}")
    rounds_check("index path", all_calls, exact_fetch=True)
    sweep_check("index path", [c for (src, _), (_, _, c) in runs.items()
                               if src.startswith("linear")])
    return counts, ssax_store


def subseq_path(torch, np, dev):
    """Phase 5: the subsequence path, then its checks.  Returns the
    kernels' launch counts during the path alone and what the window
    index path reuses: the corpus, the queries, the rows to append, the
    views and engines, the answers and the K1 brute force over every
    window with its order."""
    from repro_torch.data.synthetic import season_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.match import (
        greedy_nonoverlap, make_subseq_engine, subseq_queries,
        window_distances)
    from repro_torch.subseq import WindowView

    t0 = time.perf_counter()
    D = season_dataset(SUB_ROWS, SUB_T, L, STRENGTH,
                       per_series_strength=True, seed=7)
    Q, q_rows, offs = subseq_queries(D, SUB_M, N_QUERIES,
                                     np.random.default_rng(7))
    extra = season_dataset(2, SUB_T, L, STRENGTH, seed=8)
    say(f"subsequence corpus {D.shape} f32 + {N_QUERIES} snippet queries "
        f"(m={SUB_M}) generated in {time.perf_counter() - t0:.1f} s")

    # SAX barely prunes windows (PERF.md section 4): its call runs over the
    # first SUB_SMALL rows, as tSAX and stSAX do
    n_rows = {"ssax": SUB_ROWS, "sax": SUB_SMALL, "tsax": SUB_SMALL,
              "stsax": SUB_SMALL}
    results, scans, views, engines = {}, {}, {}, {}
    reset_launch_counts()
    for tech, n in n_rows.items():
        sync(torch, dev)
        t0 = time.perf_counter()
        view, engine = views[tech], engines[tech] = make_subseq_engine(
            tech, D[:n], m=SUB_M, stride=SUB_STRIDE, L=L, strength=STRENGTH,
            batch=BATCH, verify="auto", device=dev)
        sync(torch, dev)
        t_enc = time.perf_counter() - t0
        for k, excl in SUB_CALLS[tech]:
            view.reset()
            before = launch_counts()
            t0 = time.perf_counter()
            res = engine.topk(Q, k=k, exclusion=excl)
            wall = time.perf_counter() - t0
            calls = {c: v - before[c] for c, v in launch_counts().items()}
            results[tech, k, excl] = (res, wall, calls)
        before = launch_counts()
        t0 = time.perf_counter()
        scan = engine.scan_topk(Q, k=8)
        wall = time.perf_counter() - t0
        scans[tech] = (scan, wall, launch_counts()["windowed_euclid"]
                       - before["windowed_euclid"])
        say(f"{tech} subsequence view: {view.n} windows of {n} rows "
            f"encoded in {t_enc:.2f} s")
    counts = launch_counts()
    say(f"subsequence path launches: {counts}")
    rounds_check("subsequence path", results.values(), exact_fetch=False)
    sweep_check("subsequence path", [
        c for (tech, _, _), (_, _, c) in results.items() if tech == "ssax"])

    # where one sSAX k = 8 call's wall time goes (host clock, after the
    # counted run): the sweep, the host's stable argsort of the (Q,
    # n_windows) bounds, and the verification loop that is the rest
    engine = engines["ssax"]
    zq = engine.normalize_queries(Q)
    sync(torch, dev)
    t0 = time.perf_counter()
    rd = engine.repr_distances(zq)
    t_sweep = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.argsort(rd, axis=1, kind="stable")
    t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.topk(Q, k=8)
    t_all = time.perf_counter() - t0
    say(f"breakdown ssax {rd.shape[1]} windows k=8: topk {t_all:.3f} s = "
        f"sweep {t_sweep:.3f} s + host argsort {t_sort:.3f} s + "
        f"verification loop {t_all - t_sweep - t_sort:.3f} s")

    t0 = time.perf_counter()
    dist = window_distances(D, SUB_M, SUB_STRIDE, zq, dev)
    say(f"K1 brute force over {dist.shape[1]} windows in "
        f"{time.perf_counter() - t0:.1f} s")
    nw = views["ssax"].windows_per_row
    orders = {}
    for (tech, k, excl), (res, wall, calls) in results.items():
        nwin = n_rows[tech] * nw
        d = dist[:, :nwin]
        if nwin not in orders:
            orders[nwin] = np.argsort(d, axis=1, kind="stable")
        order = orders[nwin]
        if res.window_ids.shape != (N_QUERIES, k) or \
                not np.isfinite(res.distances).all() or \
                (res.window_ids < 0).any() or (res.window_ids >= nwin).any():
            fail(f"subseq {tech} k={k}: malformed result")
        want = np.stack([greedy_nonoverlap(order[qi], nw, SUB_STRIDE, k,
                                           excl) if excl else order[qi, :k]
                         for qi in range(N_QUERIES)])
        if not (np.array_equal(res.window_ids, want) and np.array_equal(
                res.distances, np.take_along_axis(d, want, 1).astype(
                    np.float64))):
            fail(f"subseq {tech} k={k} exclusion={excl}: exact top-k "
                 f"differs from the K1 brute force over all windows")
        loc = sum(int(res.rows[qi, 0] == q_rows[qi]
                      and abs(res.starts[qi, 0] - offs[qi]) < SUB_M)
                  for qi in range(N_QUERIES))
        say(f"subseq {tech} {nwin} windows k={k}"
            + (f" exclusion={excl}" if excl else "")
            + f": exact == K1 brute force bitwise; snippet localized "
            f"{loc}/{N_QUERIES}; windows/query verified "
            f"{res.raw_accesses.mean():.1f}, pruned fraction "
            f"{res.pruned_fraction.mean():.6f}, {res.rounds} rounds, rows "
            f"read "
            f"{res.store_accesses}/{n_rows[tech]}, modeled ssd I/O "
            f"{res.io_seconds * 1e3:.3f} ms; topk wall {wall:.3f} s; "
            f"launches {calls}")
    for tech, (scan, wall, n_launch) in scans.items():
        res = results[tech, 8, 0][0]
        d = dist[:, :n_rows[tech] * nw]
        order = orders[d.shape[1]]
        compared = 0
        for qi in range(N_QUERIES):
            dk, dk1 = d[qi, order[qi, 7]], d[qi, order[qi, 8]]
            if dk1 - dk <= 1e-3 * dk:
                continue                      # near-tie at the k boundary
            compared += 1
            if set(scan.window_ids[qi]) != set(res.window_ids[qi]):
                fail(f"subseq {tech} query {qi}: K5 scan ids differ from "
                     f"the exact top-k")
        check(f"subseq {tech} K5 scan distances^2",
              torch.as_tensor(scan.distances ** 2),
              torch.as_tensor(res.distances ** 2), TOL["windowed_euclid"])
        say(f"subseq {tech} K5 scan_topk k=8: ids == exact on {compared}/"
            f"{N_QUERIES} queries (others near-tied), d^2 within 1e-3; "
            f"{n_launch} K5 launches; scan wall {wall:.3f} s; modeled ssd "
            f"I/O {scan.io_seconds * 1e3:.3f} ms")
    # incremental == one-shot window encoding on the card, bitwise
    enc = views["ssax"].encoder
    one = WindowView(enc, D[:10], stride=SUB_STRIDE, device=dev)
    inc = WindowView(enc, stride=SUB_STRIDE, encode_chunk=57, device=dev)
    for lo, hi in ((0, 3), (3, 7), (7, 10)):
        inc.append(D[lo:hi])
    big = [a[:one.n] for a in views["ssax"].rep_view()]
    for a, b, c in zip(inc.rep_view(), one.rep_view(), big):
        if not (np.array_equal(a, b) and np.array_equal(a, c)):
            fail("subseq: chunked window encoding differs from one-shot")
    say(f"subseq incremental == one-shot window reps on the card "
        f"({one.n} windows; chunks of 3/4/3 rows, encode_chunk 57)")
    return counts, dict(D=D, Q=Q, extra=extra, views=views,
                        engines=engines, results=results, dist=dist,
                        orders=orders)


def window_index_path(torch, np, dev, sub):
    """Phase 6: the window index over phase 5's views, then its checks.
    Returns the kernels' launch counts during the path alone."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import greedy_nonoverlap
    from repro_torch.obs import MetricsRegistry, check_trace, render_trace
    from repro_torch.subseq import SubseqEngine
    Q, views, linear = sub["Q"], sub["views"], sub["results"]
    view = views["ssax"]
    nw = view.windows_per_row
    dist = sub["dist"]
    reset_launch_counts()

    def call(engine, queries=Q, approx=False, **kw):
        engine.view.reset()
        before = launch_counts()
        t0 = time.perf_counter()
        res = (engine.topk_approx if approx else engine.topk)(queries, **kw)
        wall = time.perf_counter() - t0
        return res, wall, {n: c - before[n] for n, c in
                           launch_counts().items()}

    def brute(n_rows, k, excl):
        """Phase 5's K1 brute force over the first ``n_rows`` rows'
        windows: the (Q, k) ids (greedy non-overlap with an exclusion)
        and their f32 distances as float64."""
        d = dist[:, :n_rows * nw]
        order = sub["orders"][n_rows * nw]
        want = np.stack([greedy_nonoverlap(order[qi], nw, SUB_STRIDE, k,
                                           excl) if excl else order[qi, :k]
                         for qi in range(N_QUERIES)])
        return want, np.take_along_axis(d, want, 1).astype(np.float64)

    def same(a, b) -> bool:
        return (np.array_equal(a.window_ids, b.window_ids)
                and np.array_equal(a.distances, b.distances))

    sync(torch, dev)
    t0 = time.perf_counter()
    view.build_index(leaf_fill=LEAF_FILL)
    sync(torch, dev)
    t_build = time.perf_counter() - t0
    idx, n_all = view.index, view.n
    if not idx.n == n_all == SUB_ROWS * nw:
        fail(f"window index covers {idx.n} of {n_all} windows")
    say(f"ssax window index over {idx.n} windows: {idx.n_nodes} nodes "
        f"(leaf_fill {LEAF_FILL}) built in {t_build:.2f} s (features "
        f"through K4 one row's {nw} windows at a time, routed into the "
        f"tree in one pass on the host)")
    reg = MetricsRegistry()
    engine = SubseqEngine(view, batch_size=BATCH, verify="auto",
                          pairwise=make_pairwise(view.encoder), metrics=reg)
    k8 = 8
    runs = {("index", k, excl): call(engine, k=k, exclusion=excl,
                                     use_index=True)
            for k, excl in SUB_CALLS["ssax"]}
    for name, use_index in (("index", True), ("linear", False)):
        if (name, k8, 0) not in runs:
            runs[name, k8, 0] = call(engine, k=k8, use_index=use_index)
        runs[name + " traced", k8, 0] = call(engine, k=k8,
                                             use_index=use_index,
                                             explain=True)
    approx = call(engine, approx=True, k=k8)
    full = call(engine, approx=True, k=k8, collect=n_all)
    small = {}
    for tech in ("sax", "tsax", "stsax"):
        v, e = views[tech], sub["engines"][tech]
        t0 = time.perf_counter()
        v.build_index(leaf_fill=LEAF_FILL)
        t_small = time.perf_counter() - t0
        small[tech] = (v.index.n_nodes, t_small,
                       call(e, k=k8, use_index=True),
                       call(e, k=k8, use_index=False))
    # streaming: the rows appended to the sSAX view are routed into the
    # window index by sync and found through it
    t0 = time.perf_counter()
    view.append(sub["extra"])
    t_app = time.perf_counter() - t0
    snippet = sub["extra"][:1, 100:100 + SUB_M]
    found = {name: call(engine, snippet, k=1, use_index=use_index)
             for name, use_index in (("index", True), ("linear", False))}
    counts = launch_counts()
    say(f"window index path launches: {counts}")

    for (name, k, excl), (res, wall, calls) in runs.items():
        want_i, want_d = brute(SUB_ROWS, k, excl)
        if not (np.array_equal(res.window_ids, want_i)
                and np.array_equal(res.distances, want_d)):
            fail(f"window index: ssax {name} k={k} exclusion={excl} "
                 f"differs from the K1 brute force over all windows")
        if not same(res, linear["ssax", k, excl][0]):
            fail(f"window index: ssax {name} k={k} exclusion={excl} "
                 f"differs from phase 5's linear answer")
    for name in ("index", "linear"):
        (b, _, bc), (t, _, tc) = runs[name, k8, 0], runs[name + " traced",
                                                         k8, 0]
        if not (same(b, t) and bc == tc
                and np.array_equal(b.raw_accesses, t.raw_accesses)
                and (b.rounds, b.store_fetches, b.store_accesses)
                == (t.rounds, t.store_fetches, t.store_accesses)):
            fail(f"window index: the traced {name} call differs from the "
                 f"untraced one ({tc} vs {bc} launches)")
        problems = check_trace(t.trace)
        if problems:
            fail(f"window index: {name} trace: {problems}")
        tr = t.trace
        say(f"ssax windows {name} k={k8} traced: topk wall "
            f"{runs[name + ' traced', k8, 0][1]:.3f} s = order "
            f"{tr.span_seconds('order'):.3f} s (of which seed "
            f"{tr.span_seconds('seed'):.3f} s) + verify "
            f"{tr.span_seconds('verify'):.3f} s; equal to its untraced "
            f"call bitwise with the same launches {tc}; check_trace clean")
    for line in render_trace(runs["index traced", k8, 0][0].trace
                             ).splitlines():
        say(f"explain window index: {line}")
    for (name, k, excl), (res, wall, calls) in runs.items():
        if name != "index":
            continue
        lin, lwall, lcalls = linear["ssax", k, excl]
        say(f"ssax {n_all} windows k={k}"
            + (f" exclusion={excl}" if excl else "")
            + f": indexed == phase 5's linear == K1 brute force bitwise; "
            f"windows verified per query {res.raw_accesses.mean():.1f} "
            f"indexed vs {lin.raw_accesses.mean():.1f} linear; pruned "
            f"fraction {res.pruned_fraction.mean():.6f} vs "
            f"{lin.pruned_fraction.mean():.6f}; rounds {res.rounds} vs "
            f"{lin.rounds}; rows read {res.store_accesses} vs "
            f"{lin.store_accesses}; topk wall {wall:.3f} s vs {lwall:.3f} "
            f"s; launches {calls} vs {lcalls}")
    (ra, wa, _), (rf, wf, _) = approx, full
    exact = runs["index", k8, 0][0]
    if not (same(rf, exact) and np.all(rf.error_bar == 0.0)):
        fail("window index: topk_approx at a collect of every window is "
             "not the exact answer with a zero error bar")
    if not (np.all(ra.error_bar >= 0.0) and np.all(
            ra.kth_lb <= exact.distances[:, -1] + 1e-5)):
        fail("window index: the approximate certificate does not bound "
             "the exact k-th distance")
    hits = sum(int(np.array_equal(ra.window_ids[qi], exact.window_ids[qi]))
               for qi in range(N_QUERIES))
    say(f"ssax windows topk_approx k={k8}, collect {max(4 * k8, 32)}: "
        f"error bar mean {ra.error_bar.mean():.6g}, max "
        f"{ra.error_bar.max():.6g} ({int((ra.error_bar == 0).sum())}/"
        f"{N_QUERIES} provably exact); ids == exact on {hits}/{N_QUERIES} "
        f"queries; windows verified per query {ra.raw_accesses.mean():.1f};"
        f" wall {wa:.3f} s. At a collect of {n_all}: bitwise the "
        f"exact answer, error bar 0, wall {wf:.3f} s")
    for tech, (nodes, t_small, (ri, wi, _), (rl, wl, _)) in small.items():
        want_i, want_d = brute(SUB_SMALL, k8, 0)
        if not (same(ri, rl) and np.array_equal(ri.window_ids, want_i)
                and np.array_equal(ri.distances, want_d)):
            fail(f"window index: {tech} indexed k={k8} differs from its "
                 f"linear answer or the K1 brute force")
        if not same(rl, linear[tech, k8, 0][0]):
            fail(f"window index: {tech} linear differs from phase 5's")
        say(f"{tech} window index over {SUB_SMALL * nw} windows: {nodes} "
            f"nodes in {t_small:.2f} s; indexed k={k8} == linear == K1 "
            f"brute force bitwise; windows verified per query "
            f"{ri.raw_accesses.mean():.1f} vs {rl.raw_accesses.mean():.1f};"
            f" rounds {ri.rounds} vs {rl.rounds}; topk wall {wi:.3f} s vs "
            f"{wl:.3f} s")
    if idx.n != view.n:
        fail(f"window index: sync left {view.n - idx.n} appended windows "
             f"out of the index")
    (fi, wfi, _), (fl, wfl, _) = found["index"], found["linear"]
    if not (same(fi, fl) and fi.rows[0, 0] == SUB_ROWS):
        fail(f"window index: a snippet of appended row {SUB_ROWS} was found "
             f"in row {fi.rows[0, 0]} (linear: row {fl.rows[0, 0]})")
    say(f"window index append: 2 rows (+{2 * nw} windows) synced into the "
        f"index in {t_app:.2f} s ({idx.n} windows, {idx.n_nodes} nodes); a "
        f"snippet of row {SUB_ROWS} found there at start {fi.starts[0, 0]} "
        f"(d={fi.distances[0, 0]:.3g}), indexed == linear bitwise; topk "
        f"wall {wfi:.3f} s vs {wfl:.3f} s")
    snap = reg.snapshot()
    say("window index metrics: " + ", ".join(
        f"{k}={v:g}" for k, v in sorted(snap["counters"].items())) + "; "
        + ", ".join(f"{k} n={v['count']}"
                    for k, v in sorted(snap["histograms"].items())))

    indexed = [r for (name, _, _), r in runs.items()
               if name.startswith("index")] + [approx, full, found["index"]]
    indexed += [v[2] for v in small.values()]
    if any(c["ssax_dist"] or c["sax_dist"] for _, _, c in indexed):
        fail("window index: an indexed call swept the representation")
    rounds_check("window index path", [*runs.values(), approx, full,
                                       *found.values(),
                                       *(x for v in small.values()
                                         for x in v[2:])],
                 exact_fetch=False)
    sweep_check("window index path", [
        c for (name, _, _), (_, _, c) in runs.items()
        if name.startswith("linear")] + [found["linear"][2]])
    return counts


def device_path(torch, np, dev, main, sub):
    """Phase 7: the device-resident path — ``make_engine_service`` and
    ``SubseqEngine(mesh=)`` over ``make_mesh(DEV_SHARDS)`` — on phase 3's
    corpus and phase 5's windows, then its checks.  Returns the kernels'
    launch counts during the path alone and its answers, which phase 12
    holds the world's against: ``(tech, verify, k)`` and ``("windows",
    k, exclusion)`` -> (result, calls, wall seconds)."""
    from repro_torch.core.distributed import make_engine_service, make_mesh
    from repro_torch.core.normalize import znormalize
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import (
        greedy_nonoverlap, kernel_bruteforce, launcher_technique)
    from repro_torch.obs import MetricsRegistry
    from repro_torch.store import SymbolicStore
    from repro_torch.subseq import SubseqEngine, znorm_windows
    from repro_torch.data.synthetic import season_corpus
    Q, D, brute, linear = main["Q"], main["D"], main["brute"], \
        main["results"]
    mesh = make_mesh(DEV_SHARDS, dev)
    all_calls, k2_calls, answers = [], [], {}

    def call(engine, queries, **kw):
        engine.store.reset()
        before = launch_counts()
        t0 = time.perf_counter()
        res = engine.topk(queries, **kw)
        wall = time.perf_counter() - t0
        out = (res, wall, {n: c - before[n] for n, c in
                           launch_counts().items()})
        all_calls.append(out)
        return out

    def merged_brute(extra, k):
        """The exact sSAX-corpus answer over D ++ ``extra`` by K1: phase
        3's brute force over D merged with one over ``extra`` by
        (distance, id) — what a frozen store of those rows answers."""
        bi, bd = brute["ssax"]
        ei, ed = kernel_bruteforce(Q, extra, min(k, len(extra)), dev)
        all_i = np.concatenate([bi[:, :k], ei + N_MAIN], axis=1)
        all_d = np.concatenate([bd[:, :k], ed], axis=1)
        sel = np.stack([np.lexsort((all_i[r], all_d[r]))[:k]
                        for r in range(all_i.shape[0])])
        return (np.take_along_axis(all_i, sel, 1),
                np.take_along_axis(all_d, sel, 1).astype(np.float64))

    # the rows ingested while serving, and the frozen answers after each
    # ingest, computed before the path's launches are counted
    extra = season_corpus(4099, T, L, STRENGTH, per_series_strength=True,
                          seed=3)
    frozen = [merged_brute(extra[:hi], max(KS)) for hi in (3, 4099)]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)

    for tech in ("ssax", "sax"):
        enc = launcher_technique(tech, T, L, STRENGTH)
        sym = SymbolicStore(enc, device=dev)
        regs = {v: MetricsRegistry() for v in ("device", "host")}
        engines = {v: make_engine_service(
            enc, None, mesh, store=sym, batch_size=BATCH, verify=v,
            pairwise=make_pairwise(enc), metrics=regs[v])
            for v in ("device", "host")}
        sweep = engines["device"].sweep
        # the ingest's set-up split (ROADMAP P3): encode, store append,
        # mirror upload
        sync(torch, dev)
        t0 = time.perf_counter()
        leaves = sweep._encode_chunk(D)
        sync(torch, dev)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        sym.append(D, rep=leaves)
        t_app = time.perf_counter() - t0
        t0 = time.perf_counter()
        sweep._sync()
        sync(torch, dev)
        t_up = time.perf_counter() - t0
        row_bytes = 4 * T + sum(a.nbytes for a in leaves) // N_MAIN
        if sweep.h2d_bytes != N_MAIN * row_bytes:
            fail(f"{tech}: the first sync uploaded {sweep.h2d_bytes} bytes, "
                 f"not the {N_MAIN * row_bytes} of the rows and their "
                 f"representation")
        say(f"{tech} N={N_MAIN} set-up on {DEV_SHARDS} virtual shards "
            f"(make_engine_service, verify=device): encode (sharded, K4) "
            f"{t_enc:.3f} s + store append {t_app:.3f} s + mirror upload "
            f"(raw + representation, {sweep.h2d_bytes} bytes) {t_up:.3f} s")
        del leaves
        t_sweep, t_order = device_order_split(torch, dev, sweep, Q)
        hs = main["host_split"][tech]
        for verify in ("device", "host"):
            for k in KS:
                res, wall, calls = call(engines[verify], Q, k=k)
                answers[tech, verify, k] = (res, calls, wall)
                if tech == "ssax":
                    k2_calls.append(calls)
                bf_i, bf_d = brute[tech]
                p3, _, p3_calls = linear[tech, k]
                if not (np.array_equal(res.indices, bf_i[:, :k])
                        and np.array_equal(res.distances,
                                           bf_d[:, :k].astype(np.float64))):
                    fail(f"device path {tech} k={k} verify={verify}: "
                         f"differs from the K1 brute force")
                if not (same_answer(np, res, p3) and res.rounds == p3.rounds
                        and np.array_equal(res.raw_accesses, p3.raw_accesses)
                        and calls["euclid"] == p3_calls["euclid"]):
                    fail(f"device path {tech} k={k} verify={verify}: answer, "
                         f"rounds ({res.rounds} vs {p3.rounds}), rows or K1 "
                         f"launches ({calls['euclid']} vs "
                         f"{p3_calls['euclid']}) differ from phase 3's")
                if verify == "device" and res.store_accesses:
                    fail(f"device path {tech} k={k}: {res.store_accesses} "
                         f"rows fetched to the host")
                say(f"device path {tech} N={N_MAIN} k={k} verify={verify}: "
                    f"== phase 3 == K1 brute force bitwise; rounds "
                    f"{res.rounds}, rows/query {res.raw_accesses.mean():.1f},"
                    f" K1 launches {calls['euclid']} (phase 3: "
                    f"{p3_calls['euclid']}); rows to host "
                    f"{res.store_accesses}; topk wall {wall:.3f} s = sweep "
                    f"{t_sweep:.3f} s + device order {t_order:.3f} s + "
                    f"verification {wall - t_sweep - t_order:.3f} s (phase "
                    f"3's host order: sweep {hs[0]:.3f} s + host argsort "
                    f"{hs[1]:.3f} s + verification {hs[2]:.3f} s); "
                    f"launches {calls}")
        for verify, reg in regs.items():
            c = reg.snapshot()["counters"]
            if c.get("match.host_order_bytes") != 0 or (
                    verify == "device" and c.get("match.rows_to_host") != 0):
                fail(f"device path {tech} verify={verify}: transfer "
                     f"counters {c}")
        say(f"device path {tech}: match.host_order_bytes 0 on both routes, "
            f"match.rows_to_host {regs['device'].snapshot()['counters']['match.rows_to_host']:g} "
            f"on the device route; peak device memory so far "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        if tech == "ssax":
            ingest_while_serving(np, engines["device"], Q, extra, frozen,
                                 row_bytes, call)
        del engines, sweep, sym

    # windows: phase 5's sSAX view (phase 6 appended 2 rows to it; the
    # epoch pins phase 5's 2,048 rows), device verification
    view, zQ = sub["views"]["ssax"], sub["Q"]
    nw = view.windows_per_row
    n_e = SUB_ROWS * nw
    w = np.lib.stride_tricks.sliding_window_view(
        sub["D"][:64], SUB_M, axis=1)[:, ::SUB_STRIDE].reshape(-1, SUB_M)
    z_dev = znormalize(torch.as_tensor(np.ascontiguousarray(w)).to(dev))
    if not np.array_equal(z_dev.cpu().numpy(), znorm_windows(w)):
        fail("window z-normalization on the card differs from the host's")
    # why its root is taken in f64: the card's f32 square root is not
    # the CPU's on every input, the f64 one rounded to f32 is
    v = torch.as_tensor(np.random.default_rng(0).random(1 << 20)
                        .astype(np.float32) * 100)
    roots = {name: int((f(v.to(dev)).cpu() != f(v)).sum())
             for name, f in (("f32", torch.sqrt),
                             ("f64", lambda t: torch.sqrt(
                                 t.double()).float()))}
    say(f"window z-normalization of {w.shape[0]} windows on the card == "
        f"the host's znorm_windows bitwise; square roots of {1 << 20} f32 "
        f"values differing between the card and the CPU: f32 sqrt "
        f"{roots['f32']}, f64 sqrt rounded to f32 {roots['f64']}")
    reg = MetricsRegistry()
    eng = SubseqEngine(view, batch_size=BATCH, verify="device", mesh=mesh,
                       pairwise=make_pairwise(view.encoder), metrics=reg)
    view.reset_counters()
    for k, excl in SUB_CALLS["ssax"]:
        hob0 = eng._sweep.host_order_bytes
        before = launch_counts()
        t0 = time.perf_counter()
        res = eng.topk(zQ, k=k, exclusion=excl, use_index=False, epoch=n_e)
        wall = time.perf_counter() - t0
        calls = {n: c - before[n] for n, c in launch_counts().items()}
        all_calls.append((res, wall, calls))
        k2_calls.append(calls)
        answers["windows", k, excl] = (res, calls, wall)
        p5 = sub["results"]["ssax", k, excl][0]
        order = sub["orders"][n_e]
        want = np.stack([greedy_nonoverlap(order[qi], nw, SUB_STRIDE, k,
                                           excl) if excl else order[qi, :k]
                         for qi in range(N_QUERIES)])
        d = sub["dist"][:, :n_e]
        if not (np.array_equal(res.window_ids, want) and np.array_equal(
                res.distances, np.take_along_axis(d, want, 1).astype(
                    np.float64))):
            fail(f"device path windows k={k} exclusion={excl}: differs "
                 f"from the K1 brute force")
        if not (np.array_equal(res.window_ids, p5.window_ids)
                and np.array_equal(res.distances, p5.distances)
                and res.rounds == p5.rounds
                and np.array_equal(res.raw_accesses, p5.raw_accesses)):
            fail(f"device path windows k={k} exclusion={excl}: answer, "
                 f"rounds or windows verified differ from phase 5's")
        hob = eng._sweep.host_order_bytes - hob0
        if not excl and hob:
            fail(f"device path windows k={k}: {hob} bytes of candidate "
                 f"order on the host")
        say(f"device path ssax {n_e} windows k={k}"
            + (f" exclusion={excl}" if excl else "")
            + f": == phase 5 == K1 brute force bitwise; rounds {res.rounds}"
            f" (phase 5: {p5.rounds}), windows/query "
            f"{res.raw_accesses.mean():.1f}, K1 launches {calls['euclid']}; "
            f"host order bytes {hob}; topk wall {wall:.3f} s; launches "
            f"{calls}")
    c = reg.snapshot()["counters"]
    if c.get("subseq.rows_to_host") != 0 or view.accesses != 0:
        fail(f"device path windows: rows moved to the host ({c})")
    say(f"device path windows: subseq.rows_to_host 0, "
        f"subseq.h2d_bytes {c['subseq.h2d_bytes']:g}, "
        f"subseq.host_order_bytes {c['subseq.host_order_bytes']:g} (the "
        f"exclusion call's host matrix); peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del eng
    counts = launch_counts()
    say(f"device path launches: {counts}")
    rounds_check("device path", all_calls, exact_fetch=False)
    sweep_check("device path", k2_calls)
    return counts, answers


def ingest_while_serving(np, engine, Q, extra, frozen, row_bytes, call):
    """Phase 7's ingest: 3 rows of ``extra`` (a tail of 3 at 4 shards),
    then the other 4,096; each answer equals the frozen answer over the
    grown corpus (``frozen``, by K1), the appended rows are their own
    nearest neighbours, an epoch pinned before the second ingest answers
    as then, and each ingest uploads only its head-aligned rows."""
    sweep, k = engine.sweep, max(KS)
    answers, pins = [], []
    for lo, hi in ((0, 3), (3, 4099)):
        h0, t0_tail = sweep.h2d_bytes, sweep.tail_h2d_bytes
        t0 = time.perf_counter()
        ids = engine.ingest(extra[lo:hi])
        t_ing = time.perf_counter() - t0
        pins.append(engine.store.current_epoch())
        res, wall, _ = call(engine, Q, k=k)
        found, _, _ = call(engine, extra[[lo, hi - 1]], k=1)
        n = engine.store.n
        head_rows = (n // DEV_SHARDS) * DEV_SHARDS - \
            ((N_MAIN + lo) // DEV_SHARDS) * DEV_SHARDS
        h2d = sweep.h2d_bytes - h0
        want_i, want_d = frozen[len(answers)]
        if not (np.array_equal(res.indices, want_i)
                and np.array_equal(res.distances, want_d)):
            fail(f"ingest of {hi - lo} rows: the answer differs from the "
                 f"K1 brute force over the {n} rows")
        if list(found.indices[:, 0]) != [ids[0], ids[-1]]:
            fail(f"ingest of {hi - lo} rows: appended rows {ids[0]}, "
                 f"{ids[-1]} found as {list(found.indices[:, 0])}")
        if h2d != head_rows * row_bytes:
            fail(f"ingest of {hi - lo} rows: {h2d} bytes uploaded, not the "
                 f"{head_rows * row_bytes} of its {head_rows} head-aligned "
                 f"rows")
        answers.append(res)
        say(f"ingest {hi - lo} rows -> {n} (head {n // DEV_SHARDS * DEV_SHARDS}"
            f", tail {n % DEV_SHARDS}): ingest {t_ing:.3f} s; h2d "
            f"{h2d} bytes = {head_rows} head-aligned rows x {row_bytes} "
            f"bytes, tail staged {sweep.tail_h2d_bytes - t0_tail} bytes; "
            f"k={k} == K1 brute force over {n} rows bitwise, topk wall "
            f"{wall:.3f} s; appended rows found as their own neighbours")
    pinned, _, _ = call(engine, Q, k=k, epoch=pins[0])
    if not same_answer(np, pinned, answers[0]):
        fail("an epoch pinned before the second ingest answers differently")
    say(f"epoch pinned at {pins[0].n_rows} rows after the second ingest == "
        f"the answer then, bitwise")


class RoundsLog:
    """Logs the verification rounds of every ``topk`` call of some
    engines (the session's tiers, ``topk_approx`` included, all end in
    ``engine.topk``), from any thread, until :meth:`close`."""

    def __init__(self, engines):
        self.rounds = []
        self._engines = list(engines)
        for eng in self._engines:
            def topk(*a, _inner=eng.topk, **kw):
                res = _inner(*a, **kw)
                self.rounds.append(res.rounds)
                return res
            eng.topk = topk

    def close(self) -> int:
        for eng in self._engines:
            del eng.topk
        return sum(self.rounds)


def served(reqs, what: str):
    """Fail unless every request was served: a shed or failed request
    (an engine error resolves its requests with the error) is never
    counted as served."""
    bad = [r for r in reqs if not r.ok]
    if bad:
        fail(f"{what}: {len(bad)} of {len(reqs)} requests not served, "
             f"e.g. {bad[0].shed_reason}: {bad[0].error}")
    return reqs


def k2_on_path(torch, np, ops, ref, enc, rep, queries, dev, name):
    """K2's batched entry at a path's sweep shape, on the path's own
    symbols (``rep``: the store's or view's (N, L) / (N, W) host leaves)
    and queries (encoded and tabled as the sweep does), held against its
    plain version within TOL: the launch whole, the plain version in
    row blocks.  Returns the max abs error."""
    seas, res = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                 for a in rep)
    qs, qr = enc.encode(torch.from_numpy(
        np.ascontiguousarray(queries, np.float32)).to(dev))
    tabs = ops.make_ssax_query_tables(qs, qr, enc.b_seas, enc.b_res)
    got = ops.ssax_dist_batch(seas, res, *tabs)
    err, step = 0.0, 1 << 18
    for lo in range(0, seas.shape[0], step):
        err = max(err, check(f"{name} rows {lo}..", got[:, lo:lo + step],
                             ref.ssax_dist_batch_ref(
                                 seas[lo:lo + step], res[lo:lo + step],
                                 *tabs), TOL["ssax_dist"]))
    say(f"kernel ssax_dist at the {name} shape [seas {tuple(seas.shape)}, "
        f"res {tuple(res.shape)}, Q={len(queries)} in one launch] == plain "
        f"within {TOL['ssax_dist']}, max abs err {err:.3g}")
    return err


def k1_on_path(torch, np, ops, ref, rows_of, n, queries, B, dev, name,
               seed):
    """K1's gathered entry at a verification round's shape: the path's
    ``queries`` all active, each against ``B`` distinct candidates drawn
    from the path's ``n`` rows (``rows_of(ids)`` gives them as the
    verifier sees them), the gathered rows their union; held against its
    plain version within TOL.  Returns the max abs error."""
    rng = np.random.default_rng(seed)
    cand = np.stack([rng.choice(n, B, replace=False) for _ in queries])
    uniq, inv = np.unique(cand.ravel(), return_inverse=True)
    gather = inv.reshape(cand.shape).astype(np.int64)
    rows = torch.from_numpy(np.ascontiguousarray(rows_of(uniq),
                                                 np.float32)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    err = check(name, ops.euclid_gather(rows, q, gather),
                ref.euclid_gather_ref(rows, q, torch.from_numpy(gather)
                                      .to(dev)), TOL["euclid"])
    say(f"kernel euclid gathered at the {name} shape [Qa={len(queries)}, "
        f"B={B}, rows {tuple(rows.shape)}] == plain within {TOL['euclid']}"
        f", max abs err {err:.3g}")
    return err


def service_path(torch, np, ops, ref, dev, D, store):
    """Phase 8a: the service (``service.MatchSession``) over phase 4's
    indexed 1M sSAX store — ``make_engine_service`` on
    ``make_mesh(DEV_SHARDS)`` with ``verify="device"``, two replicas
    over the one store — driven by ``launch.serve_match.serve_waves``
    (concurrent clients while a writer ingests, the oracle at each pin,
    the deadline wave), then the batch-neutrality sessions of all four
    encoders; then its checks, and K2 and K1 at the path's shapes on its
    data.  Returns the kernels' launch counts during the path and the
    kernels' max abs errors at those shapes."""
    import threading
    from repro_torch.core.distributed import make_engine_service, make_mesh
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import launcher_technique
    from repro_torch.launch.serve_match import report, serve_waves
    from repro_torch.obs import MetricsRegistry
    from repro_torch.service import MatchSession
    c = SERVE
    mesh = make_mesh(DEV_SHARDS, dev)
    n_q = c["clients"] * c["requests"]
    X = season_corpus(n_q + c["ingest_chunks"] * c["ingest_rows"], T, L,
                      STRENGTH, per_series_strength=True, seed=12)
    Q, extra = X[:n_q], X[n_q:]
    n0 = store.n

    def service(enc, st, data=None, batch=BATCH, metrics=None):
        return make_engine_service(enc, data, mesh, store=st,
                                   batch_size=batch, verify="device",
                                   pairwise=make_pairwise(enc),
                                   metrics=metrics)

    reg = MetricsRegistry()
    sync(torch, dev)
    t0 = time.perf_counter()
    engines = [service(store.encoder, store, metrics=reg),
               service(store.encoder, store)]
    for eng in engines:              # each replica uploads its mirrors
        eng.topk(Q[:1], k=1)
    sync(torch, dev)
    say(f"service set-up: 2 engine replicas over the one {n0}-row sSAX "
        f"store (index of {store.index.n_nodes} nodes from phase 4), "
        f"{DEV_SHARDS} virtual shards each, verify=device, mirrors "
        f"uploaded in {time.perf_counter() - t0:.2f} s")
    # the other encoders' neutrality engines are set-up too
    neutral = {"ssax": engines[0]}
    for tech, rows in (("sax", D), ("tsax", D[:N_SMALL]),
                       ("stsax", D[:N_SMALL])):
        neutral[tech] = service(launcher_technique(tech, T, L, STRENGTH),
                                None, data=rows, batch=NEUTRAL_BATCH)
        neutral[tech].topk(Q[:1], k=1)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    log = RoundsLog(list(neutral.values()) + engines[1:])
    session = MatchSession(engines[0], replicas=engines[1:], metrics=reg,
                           window_s=c["window_s"], max_batch=c["max_batch"],
                           max_queue=4 * n_q).start()
    cal = session.calibrate(Q[:1], k=c["k"])
    # the first chunk carries the one doubling of the store's host arrays
    # (2 x 1M rows): it goes in before wave 1, so the wave runs beside
    # the ingest's steady chunks.  Request j of each client is admitted
    # once chunk j is in, so the wave's pins span the ingest
    rows_in = c["ingest_rows"]
    ingest_s = []
    chunk_in = [threading.Event() for _ in range(c["ingest_chunks"])]

    def ingest(j):
        t1 = time.perf_counter()
        engines[0].ingest(extra[j * rows_in:(j + 1) * rows_in])
        ingest_s.append(time.perf_counter() - t1)
        chunk_in[j].set()

    def writer(stop):                # all of its chunks, stop or not
        for j in range(1, c["ingest_chunks"]):
            ingest(j)

    ingest(0)
    run = serve_waves(session, engines[0], Q, clients=c["clients"],
                      requests=c["requests"], k=c["k"],
                      deadline_s=c["deadline_s"], writer=writer,
                      gate=lambda i: chunk_in[i % c["requests"]].wait(300),
                      timeout=300.0)
    session.close()
    if run.problems:
        fail("service: " + "; ".join(run.problems))
    pins = {r.epoch.n_rows for r in run.wave1}
    if len(pins) < 2:
        fail(f"service wave 1: every request pinned at {pins}: the wave "
             f"did not span the ingest")

    # batching neutrality: 64 queries, alone and coalesced 2 .. 64 at a
    # time, through sessions of each encoder's engine
    alone, n_batches, t_neutral = {}, {}, {}
    for tech, eng in neutral.items():
        t1 = time.perf_counter()
        qn = Q[:NEUTRAL_Q]
        for b in NEUTRAL_SIZES:
            r = MetricsRegistry()
            sess = MatchSession(eng, metrics=r, window_s=0.05, max_batch=b,
                                max_queue=NEUTRAL_Q)
            reqs = [sess.submit(q, k=c["k"], tier="linear") for q in qn]
            sess.start()
            for req in reqs:
                req.wait(300)
            sess.close()
            served(reqs, f"neutrality {tech} batches of {b}")
            n_batches[tech, b] = r.snapshot()["counters"]["serve.batches"]
            if b == 1:
                alone[tech] = reqs
            for a, req in zip(alone[tech], reqs):
                if not (np.array_equal(a.indices, req.indices)
                        and np.array_equal(a.distances, req.distances)):
                    fail(f"neutrality {tech}: a query coalesced {b} at a "
                         f"time differs from the query alone")
        t_neutral[tech] = time.perf_counter() - t1
    rounds = log.close()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    # -- checks --------------------------------------------------------
    if counts["euclid"] != rounds:
        fail(f"service path: {counts['euclid']} K1 launches in {rounds} "
             f"verification rounds")
    for (tech, b), nb in n_batches.items():
        if nb != NEUTRAL_Q // b:
            fail(f"neutrality {tech}: {nb} dispatches of {b}, not "
                 f"{NEUTRAL_Q // b}")
    if store.n != n0 + len(extra) or store.index.n != store.n:
        fail(f"service ingest: store {store.n} rows, index "
             f"{store.index.n}, expected {n0 + len(extra)}")
    cs = reg.snapshot()["counters"]
    if sum(v for k, v in cs.items() if k.startswith("serve.shed.")) != \
            cs.get("serve.rejected", 0) or cs.get("match.rows_to_host"):
        fail(f"service: shed accounting or rows to host ({cs})")
    say(f"service calibration: " + ", ".join(
        f"{t} {e['wall_s'] * 1e3:.1f} ms" for t, e in cal.items()))
    say(f"service ({c['clients']} clients x {c['requests']} requests, "
        f"k={c['k']}, window {c['window_s'] * 1e3:g} ms, max batch "
        f"{c['max_batch']}; request j of each client admitted once ingest "
        f"chunk j is in):")
    for line in report(run):
        say(f"  {line}")
    say(f"service ingest while serving: {len(ingest_s)} chunks of {rows_in}"
        f" rows -> {store.n} rows (index {store.index.n}), ingest "
        f"{sum(ingest_s):.3f} s (the first, before wave 1, with the "
        f"store's doubling, {ingest_s[0]:.3f} s; the others beside wave 1 "
        f"{min(ingest_s[1:]):.3f}-{max(ingest_s[1:]):.3f} s)")
    say(f"service neutrality: {NEUTRAL_Q} queries alone == coalesced "
        f"{', '.join(map(str, NEUTRAL_SIZES[1:]))} at a time, bitwise, "
        f"for {', '.join(f'{t} N={e.store.n} ({t_neutral[t]:.1f} s)' for t, e in neutral.items())}"
        f" (verification batch {NEUTRAL_BATCH} rows per query per round "
        f"for sax, tsax, stsax; dispatches per size as expected)")
    say(f"service path: K1 launches {counts['euclid']} == verification "
        f"rounds {rounds} over {len(log.rounds)} engine calls (the "
        f"oracle's included); match.rows_to_host "
        f"{cs.get('match.rows_to_host', 0):g}; peak device memory "
        f"{peak:.2f} GB; launches {counts}")

    # K2 and K1 at the path's shapes, on its data: the sweep of a full
    # 64-query dispatch over the store's symbols, and a 64-query
    # verification round at the sSAX engine's batch and the neutrality
    # engines'
    errs = {"ssax_dist": k2_on_path(torch, np, ops, ref, store.encoder,
                                    store.rep_view(), Q[:c["max_batch"]],
                                    dev, "service sweep")}
    errs["euclid"] = max(
        k1_on_path(torch, np, ops, ref, lambda ids: D[ids], len(D),
                   Q[:c["max_batch"]], b, dev, f"service round B={b}",
                   seed=b)
        for b in (BATCH, NEUTRAL_BATCH))
    del session, engines, neutral
    return counts, errs, dict(wave_figures(np, run.wave1, run.wall1_s),
                              peak_gb=peak)


def wave_figures(np, reqs, wall_s: float) -> dict:
    """QPS and latency quantiles (ms) of a served wave."""
    lat = [r.latency_s for r in reqs if r is not None and r.ok]
    return {"qps": len(lat) / max(wall_s, 1e-9),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def selfjoin_path(torch, np, ops, ref, dev, sub_D):
    """Phase 8b: the self-join (``profile.SelfJoinEngine``) over phase
    5's sSAX windows of the first SJ_ROWS rows: the device stream route
    on ``make_mesh(DEV_SHARDS)`` with ``verify="device"`` (the path),
    K2 and K1 at its shapes on its windows, and a ``selfjoin`` request
    through a session; at SJ_SCAN_ROWS rows the device, linear host and
    indexed routes, each bitwise equal to ``scan_profile`` (K1 over all
    pairs).  Returns the kernels' launch counts during the device route
    and the kernels' max abs errors at its shapes."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.techniques import make_technique
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.obs import MetricsRegistry
    from repro_torch.profile import SelfJoinEngine, topk_discords, \
        topk_motifs
    from repro_torch.service import MatchSession
    from repro_torch.subseq import SubseqEngine, WindowView
    enc = make_technique("ssax", T=SUB_M, W=SUB_M // L, L=L,
                         r2_season=STRENGTH)
    mesh = make_mesh(DEV_SHARDS, dev)

    def engine(view, **kw):
        return SelfJoinEngine(view, pairwise=make_pairwise(enc),
                              chunk=SJ_CHUNK, **kw)

    def same(a, b):
        return (np.array_equal(a.distances, b.distances)
                and np.array_equal(a.neighbors, b.neighbors))

    reset_launch_counts()
    reg = MetricsRegistry()
    sync(torch, dev)
    t0 = time.perf_counter()
    view = WindowView(enc, sub_D[:SJ_ROWS], stride=SUB_STRIDE, device=dev)
    dev_eng = engine(view, verify="device", mesh=mesh, metrics=reg)
    prof = dev_eng.profile()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_chunks = -(-prof.n // SJ_CHUNK)
    cs = reg.snapshot()["counters"]
    if prof.source != "stream" or cs["selfjoin.rows_to_host"] or \
            cs["selfjoin.host_order_bytes"]:
        fail(f"self-join device route: source {prof.source}, counters "
             f"{cs}")
    if counts["euclid"] != prof.rounds or counts["ssax_dist"] != n_chunks:
        fail(f"self-join device route: {counts['euclid']} K1 launches in "
             f"{prof.rounds} rounds, {counts['ssax_dist']} K2 launches "
             f"for {n_chunks} chunks")
    if not (np.isfinite(prof.distances).all() and (prof.neighbors >= 0).all()):
        fail("self-join device route: a window has no neighbour")
    say(f"self-join device route over {view.n} windows ({SJ_ROWS} rows, "
        f"m={SUB_M}, stride {SUB_STRIDE}, exclusion {prof.exclusion}): "
        f"{wall:.2f} s with the view's encode; windows verified per query "
        f"{prof.raw_accesses.mean():.1f}, pruned fraction "
        f"{prof.pruned_fraction.mean():.6f}, {prof.rounds} rounds in "
        f"{n_chunks} chunks of {SJ_CHUNK}; rows_to_host 0, "
        f"host_order_bytes 0; launches {counts}")

    # K2 and K1 at the route's shapes, on its windows: one chunk's sweep
    # (SJ_CHUNK query windows, whose tables exceed shared memory) over
    # the view's symbols, and one verification round of the chunk (each
    # query window against the engine's batch of candidate windows)
    zq = dev_eng._query_windows(np.arange(SJ_CHUNK, dtype=np.int64))
    errs = {"ssax_dist": k2_on_path(torch, np, ops, ref, enc,
                                    view.rep_view(), zq, dev,
                                    "self-join chunk sweep"),
            "euclid": k1_on_path(torch, np, ops, ref, dev_eng._query_windows,
                                 view.n, zq, dev_eng._sub.batch_size, dev,
                                 "self-join round", seed=5)}

    # a selfjoin request through a session (served from the profile)
    sess = MatchSession(SubseqEngine(view, verify="device", mesh=mesh,
                                     pairwise=make_pairwise(enc)),
                        selfjoin=dev_eng, window_s=0.01)
    reqs = [sess.submit_selfjoin(kind, k=3) for kind in ("motifs",
                                                          "discords")]
    sess.start()
    for r in reqs:
        r.wait(300)
    sess.close()
    served(reqs, "self-join session")
    if reqs[0].result != topk_motifs(prof, view.locate, 3) or \
            reqs[1].result != topk_discords(prof, view.locate, 3):
        fail("self-join session: motifs or discords differ from the "
             "profile's")
    say(f"self-join session: motifs {reqs[0].result}, discords "
        f"{reqs[1].result} == the profile's (tier "
        f"{reqs[0].tier_served}, epoch {reqs[0].epoch.n_rows} windows)")

    small = WindowView(enc, sub_D[:SJ_SCAN_ROWS], stride=SUB_STRIDE,
                       device=dev)
    t0 = time.perf_counter()
    scan = engine(small, verify="host").scan_profile()
    t_scan = time.perf_counter() - t0
    # the host routes sort a (chunk, n) bound matrix on the host per
    # chunk (O(n^2) host work): at SJ_ROWS rows the linear route took
    # 353 s and the indexed 140 s on an NVIDIA H100, so they run at
    # SJ_SCAN_ROWS rows, beside the device route and the scan
    routes = {"device": engine(small, verify="device", mesh=mesh),
              "linear": engine(small, verify="host")}
    got, secs = {}, {}
    for name, e in routes.items():
        t0 = time.perf_counter()
        got[name] = e.profile()
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small.build_index(leaf_fill=LEAF_FILL)
    got["index"] = engine(small, verify="host").profile()
    secs["index"] = time.perf_counter() - t0
    for name, p in got.items():
        if not same(p, scan):
            fail(f"self-join {small.n} windows: the {name} route differs "
                 f"from scan_profile")
    say(f"self-join {small.n} windows ({SJ_SCAN_ROWS} rows): device, "
        f"linear and indexed routes == scan_profile (K1 over all "
        f"{small.n * small.n} pairs, {t_scan:.2f} s) bitwise; "
        + ", ".join(f"{n} {t:.2f} s" for n, t in secs.items())
        + " (indexed with its build); windows verified per query "
        + ", ".join(f"{n} {p.raw_accesses.mean():.1f}"
                    for n, p in got.items()))
    return counts, errs


def fft_profile(torch, np, ops, dev, sub):
    """Phase 8c: ``windowed_euclid(method="fft")`` against K5 at K5's
    scan shape (phase 5's corpus and queries), strides 4 and 1, within
    ``fft_tolerance(m)``; both timed.  Returns the times, keyed by
    stride."""
    from repro_torch.kernels.fft_dot import fft_tolerance
    from repro_torch.subseq import znorm_windows
    x = torch.as_tensor(sub["D"]).to(dev)
    q = torch.as_tensor(znorm_windows(sub["Q"])).to(dev)
    tol = fft_tolerance(SUB_M)
    out = {}
    for stride in (SUB_STRIDE, 1):
        k5 = ops.windowed_euclid(x, q, stride)
        fft = ops.windowed_euclid(x, q, stride, method="fft")
        err = (fft - k5).abs()
        if fft.shape != k5.shape or not bool(
                (err <= tol["atol"] + tol["rtol"] * k5.abs()).all()):
            fail(f"FFT stride {stride}: beyond fft_tolerance({SUB_M}) of "
                 f"K5 (max abs err {float(err.max())})")
        del k5, fft, err
        ms_fft = time_ms(torch, lambda: ops.windowed_euclid(
            x, q, stride, method="fft"), 10)
        ms_k5 = time_ms(torch, lambda: ops.windowed_euclid(x, q, stride),
                        10)
        out[stride] = (ms_fft, ms_k5)
        say(f"FFT distance profile stride {stride} [Q={N_QUERIES}, "
            f"{tuple(x.shape)}, m={SUB_M}]: within fft_tolerance "
            f"(rtol {tol['rtol']}, atol {tol['atol']:.3f}) of K5; FFT "
            f"{ms_fft:.5f} ms vs K5 {ms_k5:.5f} ms (CUDA events)")
    return out

def serving_path(torch, np, ops, ref, dev, D, store, sub):
    """Phase 8: the service, the self-join and the FFT distance profile.
    Returns the service's and the self-join's launch counts, the
    kernels' max abs errors at their shapes and the FFT times."""
    t0 = time.perf_counter()
    svc, svc_errs, fig = service_path(torch, np, ops, ref, dev, D, store)
    say(f"phase 8a: service exact ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sj, sj_errs = selfjoin_path(torch, np, ops, ref, dev, sub["D"])
    say(f"phase 8b: self-join exact ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    fft = fft_profile(torch, np, ops, dev, sub)
    say(f"phase 8c: FFT profile within its tolerance "
        f"({time.perf_counter() - t0:.1f} s)")
    errs = {n: max(svc_errs.get(n, 0.0), sj_errs.get(n, 0.0))
            for n in {*svc_errs, *sj_errs}}
    return svc, sj, errs, fft, fig


def serve_only(torch, np, ops, ref, dev):
    """``--serve``: phase 8 alone, on the corpora and the indexed 1M sSAX
    store that phases 3 to 5 would have built (made here from the same
    seeds)."""
    from repro_torch.data.synthetic import season_corpus, season_dataset
    from repro_torch.launch.match import make_engine, subseq_queries
    t0 = time.perf_counter()
    D = season_corpus(N_MAIN + N_QUERIES, T, L, STRENGTH,
                      per_series_strength=True, seed=1)[N_QUERIES:]
    engine = make_engine("ssax", D, L=L, strength=STRENGTH, batch=BATCH,
                         verify="auto", device=dev)
    engine.store.build_index(leaf_fill=LEAF_FILL)
    sub_D = season_dataset(SUB_ROWS, SUB_T, L, STRENGTH,
                           per_series_strength=True, seed=7)
    sub = dict(D=sub_D, Q=subseq_queries(sub_D, SUB_M, N_QUERIES,
                                         np.random.default_rng(7))[0])
    say(f"--serve set-up: corpus, indexed sSAX store and window corpus in "
        f"{time.perf_counter() - t0:.1f} s")
    serving_path(torch, np, ops, ref, dev, D, engine.store, sub)


# ---------------------------------------------------------------------------
# Phase 9: the LM serving path and activation retrieval
# ---------------------------------------------------------------------------

def same_or_near_tie(name: str, got_tok, want_tok, got_row, want_row,
                     tol: float) -> bool:
    """Tokens equal: True.  Else a near-tie: the two logit rows agree
    within ``tol`` and the wanted row's top-2 gap is within twice their
    difference, so the difference decides the argmax; printed, False
    (the two sequences part there).  Anything else fails."""
    if got_tok == want_tok:
        return True
    diff = float((got_row.float() - want_row.float()).abs().max())
    top = want_row.float().topk(2).values
    gap = float(top[0] - top[1])
    if diff > tol or gap > 2 * diff:
        fail(f"{name}: token {got_tok} vs {want_tok}, logits differ by "
             f"{diff:.3g} and the top-2 gap is {gap:.3g}: not a near-tie")
    say(f"{name}: near-tie, token {got_tok} vs {want_tok}: top-2 logit gap "
        f"{gap:.3g} within twice the logits' difference {diff:.3g}")
    return False


def lm_inputs(np, cfg, B: int, n: int, seed: int) -> dict:
    """A prompt batch: ``n`` tokens per row, plus the stub frontends'
    prefix embeddings / encoder frames where the config has them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    if cfg.prefix_len:
        b["prefix_embed"] = (0.5 * rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    if cfg.is_enc_dec:
        b["encoder_frames"] = (0.5 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return b


def greedy(torch, model, params, batch, steps: int):
    """Prefill, then ``steps`` greedy decode steps: (tokens (B, steps + 1),
    logits (B, steps + 1, V) on the host)."""
    logits, cache = model.prefill(params, batch)
    toks, rows = [torch.argmax(logits, -1)], [logits.float().cpu()]
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache, toks[-1][:, None])
        toks.append(torch.argmax(logits, -1))
        rows.append(logits.float().cpu())
    return torch.stack([t.cpu() for t in toks], 1), torch.stack(rows, 1)


def engine_wave(np, model, params, cfg, seed: int):
    """One ServeEngine wave of mixed-length prompts (LM_WAVE): the prompt
    lengths and the token lists, in request order."""
    from repro_torch.serving import Request, ServeEngine
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(*LM_WAVE["lens"]))).astype(
            np.int32), max_new_tokens=LM_WAVE["new"])
        for i in range(LM_WAVE["requests"])]
    ServeEngine(model, params, n_slots=LM_WAVE["slots"],
                max_len=LM_WAVE["max_len"]).run(list(reqs))
    return [len(r.prompt) for r in reqs], [r.out_tokens for r in reqs]


def lm_parity(torch, np, dev):
    """Phase 9a: every architecture at ``reduced()`` width, f32, the same
    weights on the card and on the CPU: prefill logits within LM_TOL, 8
    greedy decode steps with equal tokens (up to a printed near-tie), and
    one ServeEngine wave of mixed-length prompts with equal tokens."""
    import dataclasses
    from repro_torch.configs import ARCHITECTURES, get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.transformer import RunConfig, tree_map
    rc = RunConfig(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8,
                   loss_chunk=8, prefill_pad=64)
    for i, arch in enumerate(ARCHITECTURES):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32")
        cpu = build_model(cfg, rc=rc, device="cpu")
        card = build_model(cfg, rc=rc, device=dev)
        p_cpu = cpu.init(i)
        p_card = tree_map(lambda a: a.to(dev), p_cpu)
        batch = lm_inputs(np, cfg, 2, 24 - cfg.prefix_len, seed=i)
        want_tok, want = greedy(torch, cpu, p_cpu, batch, LM_STEPS)
        got_tok, got = greedy(torch, card, p_card, batch, LM_STEPS)
        err = check(f"{arch} prefill logits", got[:, 0], want[:, 0], LM_TOL)
        for b in range(2):
            for j in range(LM_STEPS + 1):
                err = max(err, check(f"{arch} row {b} step {j} logits",
                                     got[b, j], want[b, j], LM_TOL))
                if not same_or_near_tie(f"{arch} row {b} step {j}",
                                        int(got_tok[b, j]),
                                        int(want_tok[b, j]), got[b, j],
                                        want[b, j], LM_TOL):
                    break
        wave = "skipped (the engine prefills tokens only)"
        if not cfg.prefix_len and not cfg.is_enc_dec:
            lens, w_cpu = engine_wave(np, cpu, p_cpu, cfg, seed=100 + i)
            _, w_card = engine_wave(np, card, p_card, cfg, seed=100 + i)
            if w_cpu != w_card:
                fail(f"{arch}: ServeEngine wave tokens differ between the "
                     f"card and the CPU: {w_card} vs {w_cpu}")
            wave = (f"{LM_WAVE['requests']} prompts of {lens} tokens, "
                    f"{sum(map(len, w_cpu))} tokens equal")
        say(f"{arch} reduced: card == CPU, prefill + {LM_STEPS} decode "
            f"logits max abs err {err:.3g} (tol {LM_TOL}); engine wave "
            f"{wave}")


class _LogitsLog:
    """A model whose prefill / decode_step keep each call's logits on the
    host; everything else is the model's."""

    def __init__(self, model):
        self._model = model
        self.prefills, self.steps = [], []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, params, batch):
        logits, cache = self._model.prefill(params, batch)
        self.prefills.append(logits.float().cpu())
        return logits, cache

    def decode_step(self, params, cache, token):
        logits, cache = self._model.decode_step(params, cache, token)
        self.steps.append(logits.float().cpu())
        return logits, cache


def serve_timed(torch, eng, requests, log=None):
    """Run ``requests`` through ``eng``: the wall time of the run and of
    every admission (prefill, splice, first token) and decode step, each
    of which ends in a host copy, so is synchronised.  With ``log`` (the
    engine's model, a ``_LogitsLog``) also each request's logits rows:
    its prefill's, then one per decode step."""
    rows = {r.rid: [] for r in requests}
    times = {"admit": [], "step": []}
    admit, step = eng.admit, eng.step

    def timed_admit(req):
        t0 = time.perf_counter()
        ok = admit(req)
        if ok:
            times["admit"].append(time.perf_counter() - t0)
            if log is not None:
                rows[req.rid].append(log.prefills[-1][0])
        return ok

    def timed_step():
        slots = [r.rid if r is not None else None for r in eng.active]
        if all(rid is None for rid in slots):
            return step()
        t0 = time.perf_counter()
        step()
        times["step"].append(time.perf_counter() - t0)
        if log is not None:
            for s, rid in enumerate(slots):
                if rid is not None:
                    rows[rid].append(log.steps[-1][s])

    eng.admit, eng.step = timed_admit, timed_step
    t0 = time.perf_counter()
    eng.run(list(requests))
    torch.cuda.synchronize()
    times["run"] = time.perf_counter() - t0
    return rows, times


def lm_full_width(torch, np, dev):
    """Phase 9b: qwen3-0.6b at full width, weights from a seed.  f32:
    ServeEngine (8 slots, max_len 512) serves 16 requests of 128-token
    prompts and 32 new tokens; each equals the naive greedy loop
    (prefill with prefill_pad, then decode_step) up to a printed
    near-tie, and the naive loop's logits at step j equal ``forward``'s
    last position over the prompt and the j tokens so far.  Then bf16
    compute (the config's own), timed.  Returns the f32 model and
    weights for phase 9c."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import (
        RunConfig, tree_leaves_with_path, unembed)
    from repro_torch.serving import Request, ServeEngine
    base = get_config(LM_ARCH)
    cfg = dataclasses.replace(base, compute_dtype="float32")
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(LM_SEED)
    sync(torch, dev)
    n_params = sum(v.numel() for _, v in tree_leaves_with_path(params))
    say(f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}): "
        f"{n_params:,} parameters (config count {cfg.param_counts()[0]:,}) "
        f"made from seed {LM_SEED} on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    if n_params != cfg.param_counts()[0]:
        fail(f"{LM_ARCH}: {n_params} parameters, the config counts "
             f"{cfg.param_counts()[0]}")

    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (LM_SERVE["requests"], LM_SERVE["prompt"])
                           ).astype(np.int32)

    def requests():
        return [Request(rid=i, prompt=prompts[i],
                        max_new_tokens=LM_SERVE["new"])
                for i in range(len(prompts))]

    log = _LogitsLog(model)
    eng = ServeEngine(log, params, n_slots=LM_SERVE["slots"],
                      max_len=LM_SERVE["max_len"])
    reqs = requests()
    rows, _ = serve_timed(torch, eng, reqs, log)
    if any(len(r.out_tokens) != LM_SERVE["new"] or r.error for r in reqs):
        fail(f"{LM_ARCH}: a request was not served in full")

    naive = dataclasses.replace(model, rc=RunConfig(
        prefill_pad=LM_SERVE["max_len"]))
    t0 = time.perf_counter()
    compared = ties = 0
    fwd_err = max_diff = 0.0
    head = unembed(params, cfg)
    for r in reqs:
        toks, logits = greedy(torch, naive, params,
                              {"tokens": prompts[r.rid][None]},
                              LM_SERVE["new"] - 1)
        toks = toks[0].tolist()
        for j, (got, want) in enumerate(zip(r.out_tokens, toks)):
            max_diff = max(max_diff, float(
                (rows[r.rid][j] - logits[0, j]).abs().max()))
            compared += 1
            if not same_or_near_tie(f"{LM_ARCH} request {r.rid} token {j}",
                                    got, want, rows[r.rid][j], logits[0, j],
                                    LM_BF16_CACHE_TOL):
                ties += 1
                break
        if r.rid == 0:              # decode logits == forward over the text
            seq = np.concatenate([prompts[0], np.asarray(toks[:-1],
                                                         np.int32)])
            for j in range(1, LM_SERVE["new"]):
                h, _ = naive.hidden_states(
                    params, {"tokens": seq[None, :LM_SERVE["prompt"] + j]})
                full = (h[0, -1] @ head).float().cpu()
                fwd_err = max(fwd_err, check(
                    f"{LM_ARCH} decode step {j} vs forward", logits[0, j],
                    full, LM_FWD_TOL))
    say(f"{LM_ARCH} f32: ServeEngine ({LM_SERVE['slots']} slots, max_len "
        f"{LM_SERVE['max_len']}, bf16 cache) served {len(reqs)} requests x "
        f"{LM_SERVE['new']} tokens; {compared} tokens equal to the naive "
        f"greedy loop (f32 cache), {ties} near-ties (logits differ by at "
        f"most {max_diff:.3g}); request 0's decode logits == forward's "
        f"last position within {LM_FWD_TOL} (max abs err {fwd_err:.3g}); "
        f"naive loops {time.perf_counter() - t0:.1f} s")

    # the config's own bf16 compute, timed (nothing logged)
    bmodel = build_model(base, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    beng = ServeEngine(bmodel, params, n_slots=LM_SERVE["slots"],
                       max_len=LM_SERVE["max_len"])
    breqs = requests()
    _, btimes = serve_timed(torch, beng, breqs)
    peak = torch.cuda.max_memory_allocated(dev)
    for r in breqs:
        if len(r.out_tokens) != LM_SERVE["new"] or not all(
                0 <= t < cfg.padded_vocab for t in r.out_tokens):
            fail(f"{LM_ARCH} bf16: request {r.rid} malformed")
    first = {"tokens": prompts[:2]}
    b_logits, _ = bmodel.prefill(bmodel.compute_params(params), first)
    f_logits, _ = model.prefill(params, first)
    if not bool(b_logits.isfinite().all()):
        fail(f"{LM_ARCH} bf16: non-finite prefill logits")
    bf16_diff = float((b_logits.float() - f_logits).abs().max())
    n_tok = sum(len(r.out_tokens) for r in breqs)
    agree = sum(a == b for r, q in zip(breqs, reqs)
                for a, b in zip(r.out_tokens, q.out_tokens))
    timing = dict(
        prefill_ms=1e3 * float(np.mean(btimes["admit"])),
        decode_ms=1e3 * float(np.mean(btimes["step"])),
        tokens_per_s=n_tok / btimes["run"], peak_gb=peak / 1e9,
        resident_gb=resident / 1e9)
    say(f"{LM_ARCH} bf16 ({card_label()}): prefill {timing['prefill_ms']:.2f}"
        f" ms per request (admit: prefill, splice, first token; "
        f"{LM_SERVE['prompt']}-token prompt), decode "
        f"{timing['decode_ms']:.2f} ms per step at {LM_SERVE['slots']} "
        f"slots, {timing['tokens_per_s']:.1f} tokens/s over the run "
        f"({n_tok} tokens in {btimes['run']:.2f} s), peak device memory "
        f"{timing['peak_gb']:.2f} GB ({timing['resident_gb']:.2f} GB "
        f"allocated when it began: the f32 weights and engine, and what "
        f"earlier phases still hold); "
        f"{agree}/{n_tok} tokens equal to the f32 run's, prefill logits "
        f"within {bf16_diff:.3g} of f32's")
    del beng, bmodel
    return model, params


def activation_retrieval(torch, np, ops, ref, dev, model, params):
    """Phase 9c: ``examples/activation_retrieval.py``'s path on the port at
    full width: the f32 qwen3-0.6b's hidden states over 256 prompts of 64
    tokens, 262,144 per-channel traces z-normalized and tSAX-encoded,
    exact ``MatchEngine.topk`` at k = 1 and 8 for 8 query traces bitwise
    equal to a K1 brute force; K4 at the encode shape and K1 at a round's
    shape against their plain versions.  Returns the path's launch
    counts and the kernels' max abs errors."""
    from repro_torch.core import MatchEngine, TSAX, znormalize
    from repro_torch.core.matching import RawStore
    from repro_torch.core.tsax import trend_strength
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.match import kernel_bruteforce
    P, Tn, d = ACT["prompts"], ACT["T"], model.cfg.d_model
    rng = np.random.default_rng(ACT["seed"])
    toks = rng.integers(0, model.cfg.vocab_size, (P + 1, Tn)).astype(np.int32)

    reset_launch_counts()
    t0 = time.perf_counter()
    traces = []
    for lo in range(0, P + 1, ACT["batch"]):
        h, _ = model.hidden_states(params, {"tokens": toks[lo:lo +
                                                          ACT["batch"]]})
        traces.append(h.transpose(1, 2).reshape(-1, Tn))   # (B*d, T)
    traces = znormalize(torch.cat(traces))
    bank_dev, q_dev = traces[:P * d], traces[P * d:P * d + ACT["queries"]]
    strength = float(trend_strength(bank_dev).mean())
    sync(torch, dev)
    t_bank = time.perf_counter() - t0
    bank, Q = bank_dev.cpu().numpy(), q_dev.cpu().numpy()
    t0 = time.perf_counter()
    enc = TSAX(T=Tn, W=ACT["W"], A_tr=ACT["A_tr"], A_res=ACT["A_res"],
               r2_trend=strength)
    engine = MatchEngine(enc, RawStore.hbm(bank), batch_size=BATCH,
                         verify="kernel", device=dev)
    sync(torch, dev)
    t_enc = time.perf_counter() - t0
    calls = []
    for k in ACT["ks"]:
        before = launch_counts()
        t0 = time.perf_counter()
        res = engine.topk(Q, k=k)
        wall = time.perf_counter() - t0
        calls.append((res, wall, {n: c - before[n] for n, c in
                                  launch_counts().items()}))
    counts = launch_counts()
    say(f"activation retrieval: {bank.shape[0]:,} channel traces of "
        f"length {Tn} from {P} prompts in {t_bank:.2f} s (mean trend "
        f"strength {strength:.3f}); tSAX(W={ACT['W']}, A_tr={ACT['A_tr']}, "
        f"A_res={ACT['A_res']}) engine built in {t_enc:.2f} s; launches "
        f"{counts}")
    rounds_check("activation retrieval", calls, exact_fetch=False)

    bf_i, bf_d = kernel_bruteforce(Q, bank, max(ACT["ks"]), dev)
    for (res, wall, c), k in zip(calls, ACT["ks"]):
        if not (np.array_equal(res.indices, bf_i[:, :k]) and
                np.array_equal(res.distances,
                               bf_d[:, :k].astype(np.float64))):
            fail(f"activation retrieval k={k}: exact top-k differs from "
                 f"the K1 brute force")
        say(f"activation retrieval k={k}: {len(Q)} queries == K1 brute "
            f"force bitwise; pruned fraction "
            f"{res.pruned_fraction.mean():.6f}, raw rows/query "
            f"{res.raw_accesses.mean():.1f}, {res.rounds} rounds; topk wall "
            f"{wall:.3f} s; launches {c}")

    errs = {"paa": check("paa at the activation encode shape",
                         ops.paa_segments(bank_dev, ACT["W"]),
                         ref.paa_ref(bank_dev, ACT["W"]), TOL["paa"])}
    say(f"kernel paa at the activation encode shape [{tuple(bank.shape)} "
        f"-> W={ACT['W']}] == plain within {TOL['paa']}, max abs err "
        f"{errs['paa']:.3g}")
    errs["euclid"] = k1_on_path(torch, np, ops, ref, lambda ids: bank[ids],
                                bank.shape[0], Q, BATCH, dev,
                                "activation retrieval", seed=9)
    return counts, errs


def lm_path(torch, np, ops, ref, dev):
    """Phase 9: parity of every architecture on the card, qwen3-0.6b served
    at full width, and activation retrieval over its hidden states.
    Returns the activation path's launch counts and kernel errors."""
    t0 = time.perf_counter()
    lm_parity(torch, np, dev)
    say(f"phase 9a: ten architectures card == CPU "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    model, params = lm_full_width(torch, np, dev)
    say(f"phase 9b: {LM_ARCH} served at full width "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    counts, errs = activation_retrieval(torch, np, ops, ref, dev, model,
                                        params)
    say(f"phase 9c: activation retrieval exact "
        f"({time.perf_counter() - t0:.1f} s)")
    return counts, errs


# ---------------------------------------------------------------------------
# Phase 10: LM training
# ---------------------------------------------------------------------------

def train_batch(np, data, cfg, step: int) -> dict:
    """``data``'s batch for ``step``, plus the stub frontends' prefix
    embeddings / encoder frames where the config has them."""
    b = data.batch(step)
    B = b["tokens"].shape[0]
    rng = np.random.default_rng(1000 + step)
    if cfg.prefix_len:
        b["prefix_embed"] = (0.5 * rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    if cfg.is_enc_dec:
        b["encoder_frames"] = (0.5 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return b


def leaves_equal(torch, a, b) -> bool:
    from repro_torch.models.transformer import tree_leaves_with_path
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for (_, x), (_, y) in zip(la, lb))


def state_errors(torch, got, want, lr: float) -> dict:
    """Card state against CPU state after one step: the moments' max abs
    error over the leaf's max |want| (the gradients' agreement), the
    parameters' max abs error where the gradient's rms (sqrt v) is above
    1e-3 of the leaf's largest, and everywhere over 2 lr (an update is lr
    x m / (sqrt(v) + 1e-8), which rounding moves by a part of lr only
    where |g| is near 1e-8)."""
    from repro_torch.models.transformer import tree_leaves_with_path
    g = {p: a.cpu().float() for p, a in tree_leaves_with_path(got)}
    w = {p: a.float() for p, a in tree_leaves_with_path(want)}
    err = {"moments": 0.0, "params": 0.0, "params_any": 0.0}
    for path, want_leaf in w.items():
        diff = (g[path] - want_leaf).abs()
        if path.startswith("['opt']"):
            scale = max(float(want_leaf.abs().max()), 1e-30)
            err["moments"] = max(err["moments"], float(diff.max()) / scale)
        elif path.startswith("['params']"):
            rms = w["['opt']['v']" + path[10:]].sqrt()
            steady = rms > 1e-3 * rms.max()
            if bool(steady.any()):
                err["params"] = max(err["params"], float(diff[steady].max()))
            err["params_any"] = max(err["params_any"],
                                    float(diff.max()) / (2 * lr))
    return err


def train_parity(torch, np, dev):
    """Phase 10a: each architecture at ``reduced()`` width in f32, the
    same train state on the card and on the CPU (one seed), one
    ``make_train_step`` each: loss, grad_norm and every updated leaf
    within TRAIN_TOL; then the card's step run again from the same state
    must give the same state bitwise (what phase 10c's replay needs)."""
    import dataclasses
    from repro_torch.configs import ARCHITECTURES, get_config, reduced
    from repro_torch.data import LMDataConfig, SyntheticLM
    from repro_torch.models.transformer import RunConfig, tree_map
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.train import init_train_state, make_train_step
    rc = RunConfig(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8,
                   loss_chunk=8)
    lr = TRAIN_SMALL["lr"]
    worst = {"loss": 0.0, "grad_norm": 0.0, "moments": 0.0, "params": 0.0,
             "params_any": 0.0}
    for i, arch in enumerate(ARCHITECTURES):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32")
        data = SyntheticLM(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=24 - cfg.prefix_len,
            global_batch=2, seed=i))
        batch = train_batch(np, data, cfg, 0)
        step = make_train_step(cfg, None, rc, AdamWConfig(lr=lr),
                               schedule=lambda s: cosine_schedule(
                                   s, warmup=2, total=10))
        cpu = init_train_state(cfg, i, device="cpu")
        cpu = step(cpu, batch)[0]      # a step in: moments nonzero
        card = tree_map(lambda a: a.to(dev), cpu)
        batch = train_batch(np, data, cfg, 1)
        want, want_m = step(cpu, batch)
        got, got_m = step(card, batch)
        again, _ = step(card, batch)
        errs = state_errors(torch, got, want, lr)
        for k in ("loss", "grad_norm"):
            errs[k] = abs(float(got_m[k]) - float(want_m[k])) / \
                abs(float(want_m[k]))
        for k, tol in TRAIN_TOL.items():
            if not errs[k] <= tol:
                fail(f"{arch} train step: card vs CPU {k} error {errs[k]:.3g}"
                     f" above {tol}")
            worst[k] = max(worst[k], errs[k])
        if not leaves_equal(torch, again, got):
            fail(f"{arch} train step: two runs from one state on the card "
                 f"differ")
        say(f"{arch} reduced train step: card == CPU (loss "
            f"{float(got_m['loss']):.5f}, rel err {errs['loss']:.2g}; "
            f"grad_norm rel err {errs['grad_norm']:.2g}; moments "
            f"{errs['moments']:.2g} of the leaf max; params "
            f"{errs['params']:.2g} abs where sqrt(v) > 1e-3 max, "
            f"{errs['params_any']:.2g} x 2 lr anywhere); a second run "
            f"from the same state bitwise equal")
    say(f"phase 10a tolerances {TRAIN_TOL}, worst {worst}")


def determinism_probe(torch, np, dev):
    """Which of the step's scatter-adds are reproducible on the card: the
    backward of an index into the embedding, of F.embedding, of the
    loss's gather, and the MoE's index_put_ / index_add_ (top-2 and
    top-8), each run three times on one input from SyntheticLM's Zipf
    tokens at qwen3-0.6b's vocabulary and width.  Printed, not gated:
    the gate is the whole step's (phase 10a) and the replay's (10c)."""
    import torch.nn.functional as F
    from repro_torch.data import LMDataConfig, SyntheticLM
    V, d, T = 151_936, 1024, 4096
    toks = SyntheticLM(LMDataConfig(vocab_size=V, seq_len=512,
                                    global_batch=8)).batch(0)["tokens"]
    idx = torch.as_tensor(toks.reshape(-1)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = (0.02 * torch.randn(V, d, generator=gen, device=dev)).to(
        torch.bfloat16)
    up = torch.randn(T, d, generator=gen, device=dev)
    logits = torch.randn(T, 4096, generator=gen, device=dev)
    gold = (idx % 4096)[:, None]
    rows = torch.randn(T * 8, d, generator=gen, device=dev)

    def grad_of(fn, x, weight):
        x = x.detach().requires_grad_(True)
        (fn(x).float() * weight).sum().backward()
        return x.grad

    probes = {
        "index backward (w[idx])": lambda: grad_of(
            lambda w: w[idx], table, up),
        "F.embedding backward": lambda: grad_of(
            lambda w: F.embedding(idx, w), table, up),
        "gather backward (loss)": lambda: grad_of(
            lambda x: torch.gather(x, -1, gold), logits, 1.0),
        "index_put_ accumulate (top-2)": lambda: torch.zeros(
            T, d, device=dev).index_put_(
                (torch.arange(T, device=dev).repeat_interleave(2),),
                rows[:2 * T], accumulate=True),
        "index_add_ (top-2)": lambda: torch.zeros(T, d, device=dev).index_add_(
            0, torch.arange(T, device=dev).repeat_interleave(2), rows[:2 * T]),
        "index_add_ (top-8)": lambda: torch.zeros(T, d, device=dev).index_add_(
            0, torch.arange(T, device=dev).repeat_interleave(8), rows),
    }
    out = {}
    for name, fn in probes.items():
        first = fn()
        out[name] = all(torch.equal(first, fn()) for _ in range(2))
    say("determinism on the card (3 runs, bitwise): " + "; ".join(
        f"{n} {'yes' if ok else 'NO'}" for n, ok in out.items()))
    return out


def train_full_width(torch, np, dev):
    """Phase 10b: qwen3-0.6b at its published widths, weights from a seed:
    bf16 compute over f32 master weights and f32 moments, SyntheticLM
    batches of TRAIN_FULL's shape, ``train_loop`` for its steps under the
    cosine schedule; the loss must fall.  Step ms (median of warm steps),
    tokens/s and peak device memory printed.  Then from the trained
    weights and zero moments (so the new m is 0.1 x the clipped
    gradient) one batch with microbatch=2 against microbatch=1, and remat
    off against on."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, SyntheticLM
    from repro_torch.models.transformer import (RunConfig,
                                                tree_leaves_with_path)
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.loop import train_loop
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    state = init_train_state(cfg, TRAIN_SEED, device=dev)
    sync(torch, dev)
    n_params = sum(a.numel() for _, a in
                   tree_leaves_with_path(state["params"]))
    if n_params != cfg.param_counts()[0]:
        fail(f"{TRAIN_ARCH}: {n_params} parameters, the config counts "
             f"{cfg.param_counts()[0]}")
    say(f"phase 10b: {held / 1e9:.2f} GB allocated on the card when it "
        f"began; {TRAIN_ARCH} train state ({n_params:,} parameters, f32 "
        f"master weights, f32 m and v) made from seed {TRAIN_SEED} in "
        f"{time.perf_counter() - t0:.2f} s")
    B, S, n = TRAIN_FULL["batch"], TRAIN_FULL["seq"], TRAIN_FULL["steps"]
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B))
    rc = RunConfig(**TRAIN_FULL["rc"])
    opt = AdamWConfig(lr=TRAIN_FULL["lr"])
    step = make_train_step(cfg, None, rc, opt, schedule=lambda s:
                           cosine_schedule(s, warmup=TRAIN_FULL["warmup"],
                                           total=n))
    times = []
    t0 = time.perf_counter()
    state, hist = train_loop(
        init_state_fn=lambda: state, train_step=step, batch_fn=data.batch,
        n_steps=n, log_every=10,
        metrics_cb=lambda s, m, dt: times.append(dt))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = hist["loss"]
    if len(losses) != n or not all(np.isfinite(losses)):
        fail(f"{TRAIN_ARCH} training: losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        fail(f"{TRAIN_ARCH} training: the loss did not fall (mean of the "
             f"first 5 steps {first:.4f}, of the last 5 {last:.4f})")
    step_s = float(np.median(times[TRAIN_FULL["warm_skip"]:]))
    timing = dict(step_ms=1e3 * step_s, tokens_per_s=B * S / step_s,
                  peak_gb=peak / 1e9, first_step_ms=1e3 * times[0])
    say(f"{TRAIN_ARCH} training ({card_label()}): bf16 compute, f32 master "
        f"weights and moments, batch {B} x {S} tokens, {n} steps in "
        f"{wall:.2f} s; step {timing['step_ms']:.1f} ms (median of steps "
        f"{TRAIN_FULL['warm_skip']}..{n - 1}; step 0 "
        f"{timing['first_step_ms']:.1f} ms), {timing['tokens_per_s']:.0f} "
        f"tokens/s, peak device memory {timing['peak_gb']:.2f} GB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f})")

    timing.update(profile_steps(torch, dev, step, state, data, n, step_s))

    params = state["params"]
    del state
    gc.collect()
    batch = data.batch(n)

    def grads(**over):
        """(loss, grad_norm, {path: m}) of one step from zero moments."""
        st = {"params": params, "opt": adamw_init(params),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        new, m = make_train_step(cfg, None, RunConfig(
            **{**TRAIN_FULL["rc"], **over}), opt)(st, batch)
        moments = dict(tree_leaves_with_path(new["opt"]["m"]))
        return float(m["loss"]), float(m["grad_norm"]), moments

    base = grads()
    t0 = time.perf_counter()
    halves = grads(microbatch=2)
    t_mb = time.perf_counter() - t0
    mb_err = max(float((halves[2][p] - g).norm() / g.norm().clamp_min(1e-30))
                 for p, g in base[2].items())
    loss_err = abs(halves[0] - base[0]) / abs(base[0])
    if not (mb_err <= TRAIN_MB_TOL and loss_err <= TRAIN_MB_TOL):
        fail(f"{TRAIN_ARCH} microbatch=2 vs 1: loss rel err {loss_err:.3g}, "
             f"gradient leaf rel err (norm) {mb_err:.3g} above "
             f"{TRAIN_MB_TOL}")
    del halves
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    flat = grads(remat=False)
    t_flat = time.perf_counter() - t0
    flat_peak = torch.cuda.max_memory_allocated(dev)
    same = flat[0] == base[0] and flat[1] == base[1] and all(
        torch.equal(flat[2][p], g) for p, g in base[2].items())
    if not same:
        fail(f"{TRAIN_ARCH}: remat off differs from remat on (loss "
             f"{flat[0]} vs {base[0]})")
    say(f"{TRAIN_ARCH} one batch from the trained weights: microbatch=2 vs "
        f"1 loss rel err {loss_err:.3g}, gradient rel err (norm, worst "
        f"leaf) {mb_err:.3g} (tol {TRAIN_MB_TOL}; bf16 products at other "
        f"shapes round apart) in {t_mb:.2f} s; remat off == on bitwise "
        f"(loss {base[0]:.6f}, grad_norm {base[1]:.6f}) in {t_flat:.2f} s, "
        f"peak {flat_peak / 1e9:.2f} GB without remat")
    return timing


def profile_steps(torch, dev, step, state, data, n: int, step_s: float,
                  reps: int = 1) -> dict:
    """``reps`` more steps from ``state`` under ``torch.profiler``: the
    card's busy time per step (the kernels' summed self time; one
    stream, so they do not overlap) over the unprofiled median step, and
    the operators that take most of it, printed."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for i in range(reps):
            step(state, data.batch(n + 1 + i))
        sync(torch, dev)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # kernels (and copies) are the device's events; each operator's self
    # device time is that of the kernels it launched itself
    busy = sum(dev_us(e) for e in events
               if e.device_type.name != "CPU") / reps / 1e3
    top = sorted((e for e in events if e.device_type.name == "CPU"),
                 key=dev_us, reverse=True)[:8]
    say(f"{TRAIN_ARCH} step under torch.profiler ({reps} steps): card busy "
        f"{busy:.1f} ms per step = {busy / (1e3 * step_s):.1%} of the "
        f"median step (idle {1 - busy / (1e3 * step_s):.1%}); top: " +
        "; ".join(f"{e.key} {dev_us(e) / reps / 1e3:.1f} ms"
                  for e in top))
    return {"busy_ms": busy}


def train_fault_tolerance(torch, np, dev, root: Path):
    """Phase 10c: ``train_loop`` at reduced width on the card, broken at
    steps 3 and 7 and replayed from a ``Checkpointer`` every 2 steps,
    must end on the unbroken run's state bitwise; its last checkpoint,
    saved from the card, restored on the CPU equals that state."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import Checkpointer, restore_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import LMDataConfig, SyntheticLM
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.loop import FailureInjector, train_loop
    cfg = dataclasses.replace(reduced(get_config(TRAIN_ARCH)),
                              compute_dtype="float32")
    step = make_train_step(
        cfg, None, RunConfig(q_chunk=16, kv_chunk=16, loss_chunk=16),
        AdamWConfig(lr=TRAIN_SMALL["lr"]),
        schedule=lambda s: cosine_schedule(s, warmup=2, total=10))
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4))
    init = lambda: init_train_state(cfg, TRAIN_SEED, device=dev)
    straight, _ = train_loop(init_state_fn=init, train_step=step,
                             batch_fn=data.batch, n_steps=10, log_every=0)
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        broken, hist = train_loop(
            init_state_fn=init, train_step=step, batch_fn=data.batch,
            n_steps=10, checkpointer=Checkpointer(d, every=2),
            failure_injector=FailureInjector(fail_at=(3, 7)), log_every=0)
        if hist["restarts"] != 2 or len(hist["loss"]) != 12:
            fail(f"fault tolerance: {hist['restarts']} restarts, "
                 f"{len(hist['loss'])} steps run")
        if not leaves_equal(torch, broken, straight):
            fail("fault tolerance: the replayed run's state differs from "
                 "the unbroken run's")
        on_cpu, manifest = restore_checkpoint(
            d, init_train_state(cfg, 1, device="cpu"), device="cpu")
        if manifest["step"] != 10 or not leaves_equal(torch, on_cpu,
                                                      broken):
            fail("fault tolerance: the card's last checkpoint restored on "
                 "the CPU differs from the card's state")
    say(f"fault tolerance: {TRAIN_ARCH} reduced, 10 steps broken at 3 and 7,"
        f" {hist['restarts']} restores from LATEST, 12 steps run: final "
        f"state == the unbroken run's bitwise; its step-10 checkpoint "
        f"restored on the CPU == the card's state bitwise")


def train_launcher(root: Path):
    """Phase 10d: ``python -m repro_torch.launch.train --device cuda`` at
    reduced width as a subprocess, with a checkpoint directory and an
    injected failure: exit code 0 and the reference's closing line."""
    import os
    import tempfile
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
               "cuda", "--arch", TRAIN_ARCH, "--steps", "12", "--batch", "2",
               "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "4",
               "--inject-failures", "6"]
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                             text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines or not lines[-1].startswith(
            "final loss") or "restarts=1" not in lines[-1]:
        fail(f"train launcher: exit {out.returncode}\n{out.stdout[-2000:]}"
             f"\n{out.stderr[-2000:]}")
    say(f"train launcher on the card: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; {lines[0]}; {lines[-1]}")


def train_path(torch, np, dev, root: Path):
    """Phase 10: LM training.  Returns phase 10b's timing."""
    t0 = time.perf_counter()
    train_parity(torch, np, dev)
    determinism_probe(torch, np, dev)
    say(f"phase 10a: ten architectures' train steps card == CPU "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    timing = train_full_width(torch, np, dev)
    say(f"phase 10b: {TRAIN_ARCH} trained at full width "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    train_fault_tolerance(torch, np, dev, root)
    say(f"phase 10c: replay after failures exact "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    train_launcher(root)
    say(f"phase 10d: train launcher ({time.perf_counter() - t0:.1f} s)")
    return timing


# ---------------------------------------------------------------------------
# Phase 11: sharded training and its accounting
# ---------------------------------------------------------------------------

def shard_argv(d: Path) -> list:
    """The launcher's arguments for phase 11a: qwen3-0.6b at full width,
    one checkpoint at the end, per-step metrics into ``d``."""
    return ["--scale", "full", "--arch", TRAIN_ARCH, "--device", "cuda",
            "--steps", str(SHARD["steps"]), "--batch", str(SHARD["batch"]),
            "--seq", str(SHARD["seq"]), "--ckpt-dir", str(d / "ckpt"),
            "--ckpt-every", str(10 * SHARD["steps"]), "--metrics-out",
            str(d / "metrics.json")]


def shard_launcher(torch, root: Path, d: Path) -> dict:
    """Phase 11a, first half: the launcher under ``torch.distributed.run``
    with one rank on the card.  Returns its metrics."""
    import gc
    import os
    gc.collect()
    torch.cuda.empty_cache()          # the subprocess needs the card's memory
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
           *shard_argv(d)]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines or not lines[-1].startswith("final loss"):
        fail(f"sharded launcher: exit {out.returncode}\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    with open(d / "metrics.json") as f:
        m = json.load(f)
    if len(m["loss"]) != SHARD["steps"]:
        fail(f"sharded launcher: {len(m['loss'])} losses")
    say(f"sharded launcher (torch.distributed.run, 1 rank, NCCL, (1, 1) "
        f"mesh): exit 0 in {wall:.1f} s; {lines[0]}; {lines[-1]}")
    return m


def shard_replay(torch, np, dev, d: Path, launched: dict, p10) -> dict:
    """Phase 11a, second half: the launcher's run unsharded here, with its
    own RunConfig, optimizer, schedule, seed and batches; the per-step
    losses must equal the launcher's.  Returns the final state."""
    from repro_torch.launch.train import parse, setup
    from repro_torch.train import init_train_state, make_train_step
    run = setup(parse(shard_argv(d)))
    step = make_train_step(run["cfg"], None, run["rc"], run["opt"],
                           schedule=run["schedule"],
                           compression=run["compression"])
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(run["cfg"], run["seed"], device=dev)
    losses, times = [], []
    for i in range(SHARD["steps"]):
        t0 = time.perf_counter()
        state, m = step(state, run["data"].batch(i))
        losses.append(float(m["loss"]))        # syncs with the card
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    got = launched["loss"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, losses))
    if got != losses:
        say(f"sharded vs unsharded losses differ: largest relative "
            f"difference {worst:.3g} (launcher {got}, replay {losses})")
        if not worst <= TRAIN_TOL["loss"]:
            fail(f"sharded launcher's losses {got} vs unsharded {losses}")
    w = SHARD["warm_skip"]
    sh_ms = 1e3 * float(np.median(launched["step_s"][w:]))
    un_ms = 1e3 * float(np.median(times[w:]))
    p10_text = (f"phase 10b {p10['step_ms']:.1f} ms, peak "
                f"{p10['peak_gb']:.2f} GB (q_chunk 512)" if p10 else
                "phase 10b not run in this invocation")
    say(f"{TRAIN_ARCH} {SHARD['batch']} x {SHARD['seq']} tokens, "
        f"{SHARD['steps']} steps ({card_label()}): sharded losses "
        f"{'==' if got == losses else '~='} unsharded "
        f"{'bitwise' if got == losses else f'(worst {worst:.3g})'} "
        f"({losses[0]:.6f} -> {losses[-1]:.6f}); step ms (median of steps "
        f"{w}..{SHARD['steps'] - 1}) sharded {sh_ms:.1f}, unsharded "
        f"{un_ms:.1f}; peak device memory sharded "
        f"{launched['peak_bytes'] / 1e9:.2f} GB, unsharded "
        f"{peak / 1e9:.2f} GB; {p10_text}")
    return {"state": state, "step_ms": sh_ms, "cfg": run["cfg"],
            "rc": run["rc"]}


def shard_accounting(torch, dev, mesh, replay: dict):
    """Phase 11b: the dry-run's per-device state bytes equal the shards
    ``shard_train_state`` places on the card; its FLOPs per step beside
    the step ms."""
    import gc
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import account, state_bytes
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.transformer import tree_leaves_with_path
    from repro_torch.sharding import ShardingRules
    from repro_torch.train import init_train_state
    from repro_torch.train.state import shard_train_state
    cfg = replay["cfg"]
    rules = ShardingRules.for_mesh(mesh)
    want = state_bytes(cfg, rules)
    n = cfg.param_counts()[0]
    if want["params"] + want["opt"] != 3 * 4 * n:
        fail(f"accounting: params + m + v {want} != 3 x 4 x {n}")
    full = init_train_state(cfg, TRAIN_SEED, device="cpu")
    gc.collect()
    sync(torch, dev)
    before = torch.cuda.memory_allocated(dev)
    state = shard_train_state(full, cfg, rules)
    sync(torch, dev)
    grown = torch.cuda.memory_allocated(dev) - before
    leaves = [a.to_local() for _, a in tree_leaves_with_path(state)]
    held = sum(a.untyped_storage().nbytes() for a in leaves)
    rounded = sum(-(-a.untyped_storage().nbytes() // 512) * 512
                  for a in leaves)
    if held != sum(want.values()) or not held <= grown <= rounded:
        fail(f"accounting: predicted {want} ({sum(want.values())} B), "
             f"shards hold {held} B, allocation grew {grown} B (rounded "
             f"leaves {rounded} B)")
    del state, full, leaves
    shape = ShapeSpec("shard", SHARD["seq"], SHARD["batch"], "train")
    acc = account(cfg, shape, ShardingRules.for_mesh(
        MeshSpec(("data", "model"), (1, 1))), replay["rc"])
    flops = acc["flops_per_dev"]
    say(f"accounting, {TRAIN_ARCH} on a (1, 1) mesh: predicted state "
        f"{sum(want.values()):,} B (params {want['params']:,} + m, v "
        f"{want['opt']:,} + step {want['step']}; params + m + v = 3 x 4 x "
        f"{n:,} = {3 * 4 * n:,}) == the shards' storage {held:,} B; "
        f"allocation grew {grown:,} B (<= {rounded:,} with each leaf "
        f"rounded to 512 B); FLOPs per step {flops:.4g} (the matmuls of "
        f"forward, remat recompute and backward), {flops / 1e12 / (replay['step_ms'] / 1e3):.1f} "
        f"TFLOP/s at the sharded step's {replay['step_ms']:.1f} ms; "
        f"collectives {acc['collectives']['count']} (a world of one)")


def shard_elastic(torch, np, mesh, d: Path, replay: dict):
    """Phase 11c: the launcher's last checkpoint (its final state) equals
    the unsharded replay's final state bitwise, leaf by leaf as the file
    holds it; ``elastic_restore`` of it onto the card's mesh equals the
    replay's state bitwise too, so the file; a changed model axis is
    refused.  Either miss fails."""
    from repro_torch.checkpoint.ckpt import BF16_WORD, latest_step
    from repro_torch.checkpoint.elastic import (elastic_restore,
                                                reshard_checkpoint)
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.transformer import tree_leaves_with_path
    from repro_torch.train.state import abstract_train_state
    cfg = replay["cfg"]
    ck = str(d / "ckpt")
    step = latest_step(ck)
    if step != SHARD["steps"]:
        fail(f"elastic: the launcher's last checkpoint is step {step}")
    want = dict(tree_leaves_with_path(replay["state"]))
    npz = d / "ckpt" / f"step_{step:08d}" / "shard_h000.npz"
    with np.load(npz) as z:
        if set(z.files) != set(want):
            fail(f"elastic: the file's leaves {sorted(z.files)[:4]}... vs "
                 f"the state's")
        for path, a in want.items():
            arr, local = z[path], a.cpu()
            if arr.dtype == BF16_WORD:
                arr, local = arr.view(np.int16), local.view(torch.int16)
            if not np.array_equal(local.numpy(), arr):
                fail(f"elastic: the launcher's final {path} differs from "
                     f"the unsharded replay's")
    t0 = time.perf_counter()
    restored, manifest = elastic_restore(ck, cfg, mesh,
                                         abstract_train_state(cfg))
    t_restore = time.perf_counter() - t0
    if manifest["step"] != step:
        fail(f"elastic: restored step {manifest['step']}")
    for path, a in tree_leaves_with_path(restored):
        if not torch.equal(a.to_local(), want[path]):
            fail(f"elastic: the restored {path} differs from the file")
    try:
        reshard_checkpoint(ck, cfg, MeshSpec(("data", "model"), (1, 1)),
                           MeshSpec(("data", "model"), (1, 2)),
                           abstract_train_state(cfg))
        fail("elastic: a changed model axis was not refused")
    except ValueError:
        pass
    say(f"the launcher's step-{step} checkpoint == the unsharded replay's "
        f"final state bitwise; elastic restore of it onto the card's mesh "
        f"in {t_restore:.1f} s == the file bitwise; a changed model axis "
        f"refused (ValueError)")


def shard_moe(torch, np, dev, mesh, cpu_mesh):
    """Phase 11d: the grouped MoE (moe_groups = 4) forward and one sharded
    train step on the card against the CPU, and grouped against
    ungrouped at a generous capacity."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import LMDataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.transformer import RunConfig, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import ShardingRules
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.state import shard_train_state
    rc = RunConfig(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8,
                   loss_chunk=8)
    G = SHARD["moe_groups"]
    lr = TRAIN_SMALL["lr"]
    for i, arch in enumerate(SHARD_MOE):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32")
        data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=24, global_batch=4, seed=i))
        batch = data.batch(0)
        card_rules = ShardingRules.for_mesh(mesh).with_overrides(
            moe_groups=G)
        cpu_rules = ShardingRules.for_mesh(cpu_mesh).with_overrides(
            moe_groups=G)
        params = init_train_state(cfg, i, device="cpu")["params"]
        h_cpu, aux_cpu = build_model(cfg, cpu_rules, rc=rc, device="cpu") \
            .hidden_states(params, batch)
        card_model = build_model(cfg, card_rules, rc=rc, device=dev)
        h_card, aux_card = card_model.hidden_states(
            tree_map(lambda a: a.to(dev), params), batch)
        err = float((h_card.cpu() - h_cpu).abs().max())
        aux_err = max(abs(float(aux_card[k]) - float(aux_cpu[k])) /
                      max(abs(float(aux_cpu[k])), 1e-30) for k in aux_cpu)
        if not (err <= LM_TOL and aux_err <= TRAIN_TOL["loss"] * 10):
            fail(f"{arch} grouped MoE: card vs CPU hidden {err:.3g}, aux "
                 f"{aux_err:.3g}")
        wide = dataclasses.replace(cfg, capacity_factor=64.0)
        h_g, _ = build_model(wide, card_rules, rc=rc, device=dev) \
            .hidden_states(tree_map(lambda a: a.to(dev), params), batch)
        h_u, _ = build_model(wide, None, rc=rc, device=dev) \
            .hidden_states(tree_map(lambda a: a.to(dev), params), batch)
        if not torch.allclose(h_g, h_u, **SHARD_MOE_TOL):
            fail(f"{arch}: grouped vs ungrouped at capacity factor 64 "
                 f"differ ({float((h_g - h_u).abs().max()):.3g})")
        steps = {}
        for name, rules, d_ in (("card", card_rules, dev),
                                ("cpu", cpu_rules, torch.device("cpu"))):
            st = shard_train_state(init_train_state(cfg, i, device="cpu"),
                                   cfg, rules)
            steps[name] = make_train_step(cfg, rules, rc,
                                          AdamWConfig(lr=lr))(st, batch)
        unwrap = lambda t: tree_map(lambda a: a.to_local(), t)
        errs = state_errors(torch, unwrap(steps["card"][0]),
                            unwrap(steps["cpu"][0]), lr)
        for k in ("loss", "grad_norm"):
            want = float(steps["cpu"][1][k])
            errs[k] = abs(float(steps["card"][1][k]) - want) / abs(want)
        for k, tol in TRAIN_TOL.items():
            if not errs[k] <= tol:
                fail(f"{arch} grouped sharded train step: card vs CPU {k} "
                     f"error {errs[k]:.3g} above {tol}")
        say(f"{arch} reduced, moe_groups={G}: grouped forward card == CPU "
            f"(hidden max abs err {err:.2g}, aux rel {aux_err:.2g}); "
            f"grouped == ungrouped at capacity factor 64 within "
            f"{SHARD_MOE_TOL}; one sharded train step card == CPU (loss "
            f"rel err {errs['loss']:.2g}, grad_norm {errs['grad_norm']:.2g},"
            f" moments {errs['moments']:.2g}, params {errs['params']:.2g})")


def start_dryrun(root: Path, d: Path) -> list:
    """Phase 11e, started: the dry-run CLI on one cell of each mode and a
    long_500k cell, single pod, as two subprocesses (host work only) that
    run beside phases 11b-d."""
    import os
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = []
    for arch, shape, want in SHARD_DRYRUN:
        log = open(d / f"dryrun-{arch}.log", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--multi-pod", "single", "--out",
             str(d / f"dryrun-{arch}.json")], cwd=root, env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True)
        runs.append((arch, shape, want, proc, log, time.perf_counter()))
    return runs


def finish_dryrun(runs: list):
    """Phase 11e, awaited: each run's counts line, 0 errors."""
    for arch, shape, want, proc, log, t0 in runs:
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log.seek(0)
        lines = log.read().strip().splitlines()
        log.close()
        if rc or not lines or lines[-1] != f"dry-run complete: {want}":
            fail(f"dry-run {arch} {shape}: exit {rc}\n" +
                 "\n".join(lines[-40:]))
        say(f"dry-run {arch} x {shape} (single pod) in "
            f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                ln for ln in lines if ln.startswith("[")) +
            f"; {lines[-2]}; {lines[-1]}")


def shard_path(torch, np, dev, root: Path, p10=None):
    """Phase 11: sharded training and its accounting.  ``p10`` is phase
    10b's timing where it ran."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        launched = shard_launcher(torch, root, d)
        replay = shard_replay(torch, np, dev, d, launched, p10)
        say(f"phase 11a: sharded launcher == unsharded "
            f"({time.perf_counter() - t0:.1f} s)")
        t_dry = time.perf_counter()
        runs = start_dryrun(root, d)
        done = False
        dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                                rank=0, world_size=1)
        try:
            mesh = make_device_mesh((1, 1), ("data", "model"), device="cuda")
            cpu_mesh = make_device_mesh((1, 1), ("data", "model"),
                                        device="cpu")
            t0 = time.perf_counter()
            shard_accounting(torch, dev, mesh, replay)
            say(f"phase 11b: accounting == the card's shards "
                f"({time.perf_counter() - t0:.1f} s)")
            t0 = time.perf_counter()
            shard_elastic(torch, np, mesh, d, replay)
            del replay
            say(f"phase 11c: elastic restore exact "
                f"({time.perf_counter() - t0:.1f} s)")
            t0 = time.perf_counter()
            shard_moe(torch, np, dev, mesh, cpu_mesh)
            say(f"phase 11d: grouped MoE card == CPU "
                f"({time.perf_counter() - t0:.1f} s)")
            done = True
        finally:
            dist.destroy_process_group()
            if not done:                 # a phase failed: stop the dry-runs
                for run in runs:
                    run[3].kill()
                    run[3].wait()
        t0 = time.perf_counter()
        finish_dryrun(runs)
        say(f"phase 11e: dry-run CLI ({time.perf_counter() - t_dry:.1f} s "
            f"from its start beside phases 11b-d, "
            f"{time.perf_counter() - t0:.1f} s after them)")


# ---------------------------------------------------------------------------
# Phase 12: matching over a torch.distributed world of cards
# ---------------------------------------------------------------------------

def world_calls():
    """Phase 12's calls, in the order every rank makes them: (key, tech,
    verify, k); the window call's key is ("windows", k, 0)."""
    calls = [((tech, v, k), tech, v, k) for tech in ("ssax", "sax")
             for v in ("device", "host") for k in KS]
    return calls + [(("windows", WORLD["window_k"], 0), "ssax", "device",
                     WORLD["window_k"])]


def answer_of(res) -> dict:
    """What phase 12 holds bitwise: ids, distances, rounds, rows."""
    ids = getattr(res, "window_ids", None)
    return {"ids": res.indices if ids is None else ids,
            "distances": res.distances, "rounds": res.rounds,
            "raw_accesses": res.raw_accesses}


def dist_rank(root: Path, out: Path, with_reference: bool):
    """Phase 12's rank code, started by ``torch.distributed.run``: NCCL
    on ``cuda:LOCAL_RANK``; phase 3's corpus and phase 5's sSAX windows
    rebuilt from their seeds on a world mesh of ``DEV_SHARDS`` shards;
    phase 7's calls made on it.  Rank 0 pickles the answers, each call's
    launches and every rank's wall, peak memory and collective time into
    ``out``; ``with_reference`` also answers each call on
    ``make_mesh(DEV_SHARDS)`` of this process alone (the ``--dist`` run
    without phase 7)."""
    import os
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()
    dist.init_process_group("nccl", device_id=dev)
    t0 = time.perf_counter()
    dist.barrier(device_ids=[dev.index])   # the communicator, before timing
    t_comm = time.perf_counter() - t0
    from repro_torch.core.distributed import make_engine_service, make_mesh
    from repro_torch.data.synthetic import season_corpus, season_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import (launcher_technique,
                                          make_subseq_engine, subseq_queries)
    from repro_torch.store import SymbolicStore
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(DEV_SHARDS, dev, group=dist.group.WORLD)
    t0 = time.perf_counter()
    X = season_corpus(N_MAIN + N_QUERIES, T, L, STRENGTH,
                      per_series_strength=True, seed=1)
    Q, D = X[:N_QUERIES], X[N_QUERIES:]
    SD = season_dataset(SUB_ROWS, SUB_T, L, STRENGTH,
                        per_series_strength=True, seed=7)
    SQ, _, _ = subseq_queries(SD, SUB_M, N_QUERIES, np.random.default_rng(7))
    t_data = time.perf_counter() - t0
    meshes = {"world": mesh}
    if with_reference:
        meshes["single"] = make_mesh(DEV_SHARDS, dev)
    answers, launches, walls, coll, setup = {}, {}, {}, {}, {}
    reset_launch_counts()
    for name, m in meshes.items():
        for tech in ("ssax", "sax"):
            enc = launcher_technique(tech, T, L, STRENGTH)
            sym = SymbolicStore(enc, device=dev)
            engines = {v: make_engine_service(
                enc, None, m, store=sym, batch_size=BATCH, verify=v,
                pairwise=make_pairwise(enc)) for v in ("device", "host")}
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            engines["device"].ingest(D)
            for e in engines.values():
                e.sweep._sync()
            torch.cuda.synchronize(dev)
            setup[name, tech] = (time.perf_counter() - t0,
                                 engines["device"].sweep.h2d_bytes)
            for key, t, v, k in world_calls():
                if t != tech or key[0] == "windows":
                    continue
                eng = engines[v]
                eng.store.reset()
                before = launch_counts()
                t0 = time.perf_counter()
                res = eng.topk(Q, k=k)
                walls[name, key] = time.perf_counter() - t0
                launches[name, key] = {c: n - before[c] for c, n in
                                       launch_counts().items()}
                answers[name, key] = answer_of(res)
                if name == "world" and v == "device":
                    # the collectives' own time: the same call again,
                    # each collective fenced on the device
                    m.timed, m.collectives = True, dict.fromkeys(
                        m.collectives, 0)
                    eng.topk(Q, k=k)
                    m.timed = False
                    coll[key] = (dict(m.collectives), res.rounds)
            del engines, sym
        key, tech, v, k = world_calls()[-1]
        t0 = time.perf_counter()
        view, eng = make_subseq_engine(
            tech, SD, m=SUB_M, stride=SUB_STRIDE, L=L, strength=STRENGTH,
            batch=BATCH, verify=v, mesh=m, device=dev)
        torch.cuda.synchronize(dev)
        setup[name, "windows"] = (time.perf_counter() - t0, view.n)
        before = launch_counts()
        t0 = time.perf_counter()
        res = eng.topk(SQ, k=k, use_index=False)
        walls[name, key] = time.perf_counter() - t0
        launches[name, key] = {c: n - before[c] for c, n in
                               launch_counts().items()}
        answers[name, key] = answer_of(res)
        answers[name, key]["host_order"] = eng._sweep.host_order_bytes
        del view, eng
    me = {"wall": time.perf_counter() - t_all, "data": t_data,
          "comm": t_comm,
          "peak": torch.cuda.max_memory_allocated(dev), "rank": rank}
    every = [None] * world
    dist.all_gather_object(every, me)
    if rank == 0:
        with open(out / "world.pkl", "wb") as f:
            pickle.dump({"answers": answers, "launches": launches,
                         "walls": walls, "collectives": coll,
                         "setup": setup, "ranks": every, "world": world,
                         "counts": launch_counts()}, f)
    dist.destroy_process_group()


def run_ranks(torch, root: Path, out: Path, nproc: int, args: list,
              name: str, what: str) -> dict:
    """Start this script with ``args`` (its rank code: ``--dist-rank`` or
    ``--serve-rank`` and ``out``) on ``nproc`` ranks under
    ``torch.distributed.run`` and read what rank 0 pickled into
    ``out / name``."""
    import gc
    import os
    import pickle
    gc.collect()
    torch.cuda.empty_cache()          # the ranks need the card's memory
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), str(root / "chip_smoke.py"),
           *args]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=WORLD["timeout"])
    wall = time.perf_counter() - t0
    if run.returncode or not (out / name).exists():
        fail(f"{what} of {nproc}: exit {run.returncode}\n"
             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    with open(out / name, "rb") as f:
        got = pickle.load(f)
    (out / name).unlink()
    got["command_s"] = wall
    return got


def world_check(np, got: dict, want: dict, nproc: int):
    """Every world answer, with its rounds and rows, bitwise ``want``'s
    (phase 7's, or this rank's single-process ones); K1 launches equal to
    rounds on the rank, one K2 launch per sSAX sweep."""
    for key, *_ in world_calls():
        a, b = got["answers"]["world", key], want[key]
        same = all(np.array_equal(a[f], b[f]) for f in
                   ("ids", "distances", "raw_accesses")) and \
            a["rounds"] == b["rounds"]
        c = got["launches"]["world", key]
        if not same:
            fail(f"world of {nproc}: {key} differs from the single-process "
                 f"answer (rounds {a['rounds']} vs {b['rounds']})")
        if c["euclid"] != a["rounds"] or (key[0] != "sax" and
                                          c["ssax_dist"] != 1):
            fail(f"world of {nproc}: {key} made {c['euclid']} K1 launches "
                 f"in {a['rounds']} rounds and {c['ssax_dist']} K2 "
                 f"launches")
        if key[0] == "windows" and a["host_order"]:
            fail(f"world of {nproc}: {a['host_order']} bytes of window "
                 f"order on the host")


def world_report(got: dict, nproc: int, want_walls: dict, against: str):
    """Phase 12's lines: wall, per-rank peak memory, per-round collective
    time, each call's wall beside the single process's."""
    ranks = got["ranks"]
    say(f"world of {nproc} (NCCL, {card_label()}): command "
        f"{got['command_s']:.1f} s; per rank wall "
        + ", ".join(f"{r['wall']:.1f}" for r in ranks) + " s (corpora "
        + ", ".join(f"{r['data']:.1f}" for r in ranks) + " s, NCCL "
        "communicator " + ", ".join(f"{r['comm']:.2f}" for r in ranks)
        + " s); peak device "
        "memory per rank " + ", ".join(f"{r['peak'] / 1e9:.2f}"
                                       for r in ranks) + " GB")
    for (name, tech), (sec, what) in got["setup"].items():
        if name == "world":
            say(f"world of {nproc}: {tech} set-up {sec:.2f} s "
                + (f"({what} windows)" if tech == "windows" else
                   f"(ingest, mirror upload of rank 0: {what} bytes)"))
    for key, *_ in world_calls():
        a = got["answers"]["world", key]
        c = got["launches"]["world", key]
        line = (f"world of {nproc}: {key} == {against} bitwise; rounds "
                f"{a['rounds']}, K1 launches {c['euclid']}, K2 "
                f"{c['ssax_dist']}, K3 {c['sax_dist']}; topk wall "
                f"{got['walls']['world', key]:.3f} s ({against} "
                f"{want_walls[key]:.3f} s)")
        if key in got["collectives"]:
            cs, rounds = got["collectives"][key]
            line += (f"; collectives {cs['calls']} calls, "
                     f"{cs['bytes']} bytes, {1e3 * cs['seconds']:.3f} ms "
                     f"fenced = {1e3 * cs['seconds'] / rounds:.4f} ms per "
                     f"round")
        say(line)


def launcher_pair(root: Path, nproc: int, module: str) -> tuple:
    """Run launcher ``module`` at its default size on the card under
    ``torch.distributed.run`` on ``nproc`` ranks and, beside it, in one
    process at the same shard count; fail unless both exit 0.  Returns
    each one's stdout lines and the wall seconds."""
    import os
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    base = ["-m", module, "--device", "cuda"]
    cmds = {"world": [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc-per-node", str(nproc),
                      *base, "--distributed"],
            "single": [sys.executable, *base, "--shards-per-rank",
                       str(nproc)]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=root, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    outs = {}
    for k, p in procs.items():
        try:
            outs[k] = p.communicate(timeout=WORLD["timeout"])
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        if p.returncode:
            fail(f"{module} ({k}, {nproc}): exit {p.returncode}\n"
                 f"{outs[k][0][-2000:]}\n{outs[k][1][-3000:]}")
    return ({k: o.splitlines() for k, (o, _) in outs.items()},
            time.perf_counter() - t0)


def answers_agree(lines: dict) -> bool:
    """The world's ``[answers]`` line says every rank agreed, and its
    hash is the single process's."""
    h = {k: [ln for ln in v if ln.startswith("[answers]")]
         for k, v in lines.items()}
    return bool(h["world"] and h["single"]) and \
        h["world"][-1].endswith("equal on every rank yes") and \
        h["world"][-1].split(";")[0] == h["single"][-1]


def world_launcher(root: Path, nproc: int):
    """The match launcher at its default size under
    ``torch.distributed.run`` on ``nproc`` ranks beside one process at the
    same shard count: exit 0, every exact line 8/8, and the world's
    answer hash equal on every rank and to the single process's."""
    lines, wall = launcher_pair(root, nproc, "repro_torch.launch.match")
    exact = [ln for ln in lines["world"]
             if "query frontiers == brute force" in ln]
    if not exact or not all(": 8/8 query" in ln for ln in exact) or \
            not answers_agree(lines):
        fail(f"launcher under torch.distributed.run ({nproc}):\n"
             + "\n".join(lines["world"][-12:]) + "\nsingle: "
             + "\n".join(lines["single"][-3:]))
    say(f"launcher under torch.distributed.run, {nproc} rank(s), default "
        f"size, beside one process at {nproc} shard(s): exit 0 in "
        f"{wall:.1f} s; {exact[-1]}; {lines['world'][-1]}")


def dist_path(torch, np, root: Path, p7=None) -> dict:
    """Phase 12: phase 7's calls over a ``torch.distributed`` world of
    cards, one rank per card (NCCL), then the launcher under
    ``torch.distributed.run``.  ``p7`` is phase 7's answers; without it
    (``--dist``) the ranks answer each call alone too.  Returns the
    kernels' launch counts on the world's rank 0."""
    import tempfile
    (root / "build").mkdir(exist_ok=True)
    n_cards = torch.cuda.device_count()
    worlds = [1] + ([min(n_cards, 4)] if n_cards >= 2 else [])
    counts = None
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        for nproc in worlds:
            t0 = time.perf_counter()
            got = run_ranks(torch, root, Path(tmp), nproc,
                            ["--dist-rank", tmp]
                            + (["--reference"] if p7 is None else []),
                            "world.pkl", "world")
            if p7 is None:
                want = {key: got["answers"]["single", key]
                        for key, *_ in world_calls()}
                walls = {key: got["walls"]["single", key]
                         for key, *_ in world_calls()}
                against = "one process"
            else:
                want = {key: answer_of(p7[key][0])
                        for key, *_ in world_calls()}
                walls = {key: p7[key][2] for key, *_ in world_calls()}
                against = "phase 7"
            world_check(np, got, want, nproc)
            world_report(got, nproc, walls, against)
            counts = counts or got["counts"]
            say(f"phase 12a: world of {nproc} == {against} "
                f"({time.perf_counter() - t0:.1f} s)")
            t0 = time.perf_counter()
            world_launcher(root, nproc)
            say(f"phase 12b: launcher over a world of {nproc} "
                f"({time.perf_counter() - t0:.1f} s)")
    return counts


# ---------------------------------------------------------------------------
# Phase 13: the matching service over a torch.distributed world of cards
# ---------------------------------------------------------------------------

def serve_rank(out: Path):
    """Phase 13a's rank code, started by ``torch.distributed.run``: NCCL
    on ``cuda:LOCAL_RANK``; phase 8a's set-up rebuilt from its seeds on a
    world mesh of ``DEV_SHARDS`` shards (phase 3's 1M x 960 corpus in an
    sSAX store, its index, two replicas, ``verify="device"``).  Rank 0
    serves it through the fronts of a ``service.world.WorldChannel`` —
    calibration, wave 1 beside the writer and the deadline wave through
    ``launch.serve_match.serve_waves``, then SERVE_WORLD["queries"]
    queries over the final corpus with every collective fenced, each
    held to a K1 brute force — while the other ranks replay its engine
    calls.  Rank 0 pickles what it measured and every broken promise
    into ``out``."""
    import os
    import pickle
    import threading
    import numpy as np
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()
    dist.init_process_group("nccl", device_id=dev)
    dist.barrier(device_ids=[dev.index])   # the communicator, before timing
    from repro_torch.core.distributed import make_engine_service, make_mesh
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import kernel_bruteforce, launcher_technique
    from repro_torch.launch.serve_match import report, serve_waves
    from repro_torch.obs import MetricsRegistry
    from repro_torch.service import MatchSession, WorldChannel
    from repro_torch.service.world import ranks_agree
    c, w = SERVE, SERVE_WORLD
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(DEV_SHARDS, dev, group=dist.group.WORLD)
    t0 = time.perf_counter()
    D = season_corpus(N_MAIN + N_QUERIES, T, L, STRENGTH,
                      per_series_strength=True, seed=1)[N_QUERIES:]
    n_q = c["clients"] * c["requests"]
    X = season_corpus(n_q + c["ingest_chunks"] * c["ingest_rows"], T, L,
                      STRENGTH, per_series_strength=True, seed=12)
    Q, extra = X[:n_q], X[n_q:]
    t_data = time.perf_counter() - t0
    enc = launcher_technique("ssax", T, L, STRENGTH)
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    engines = [make_engine_service(enc, D, mesh, batch_size=BATCH,
                                   verify="device",
                                   pairwise=make_pairwise(enc),
                                   metrics=reg)]
    store = engines[0].store
    del D
    t_index = time.perf_counter()
    store.build_index(leaf_fill=LEAF_FILL)
    t_index = time.perf_counter() - t_index
    engines.append(make_engine_service(enc, None, mesh, store=store,
                                       batch_size=BATCH, verify="device",
                                       pairwise=make_pairwise(enc)))
    for eng in engines:              # each replica uploads its mirrors
        eng.topk(Q[:1], k=1)
    torch.cuda.synchronize(dev)
    t_setup = time.perf_counter() - t0
    n0 = store.n
    channel = WorldChannel(engines, dist.group.WORLD)
    if rank:
        channel.follow()             # raises unless it equals rank 0
        dist.destroy_process_group()
        return

    problems, got = [], {}
    log = RoundsLog(engines)
    reset_launch_counts()
    session = MatchSession(channel.fronts[0], replicas=channel.fronts[1:],
                           metrics=reg, window_s=c["window_s"],
                           max_batch=c["max_batch"], max_queue=4 * n_q)
    try:
        session.start()
        cal = session.calibrate(Q[:1], k=c["k"])
        rows_in = c["ingest_rows"]
        ingest_s = []
        chunk_in = [threading.Event() for _ in range(c["ingest_chunks"])]

        def ingest(j):
            t1 = time.perf_counter()
            channel.fronts[0].ingest(extra[j * rows_in:(j + 1) * rows_in])
            ingest_s.append(time.perf_counter() - t1)
            chunk_in[j].set()

        def writer(stop):            # all of its chunks, stop or not
            for j in range(1, c["ingest_chunks"]):
                ingest(j)

        ingest(0)                    # the store's doubling, as phase 8a
        run = serve_waves(session, channel.fronts[0], Q,
                          clients=c["clients"], requests=c["requests"],
                          k=c["k"], deadline_s=c["deadline_s"],
                          writer=writer,
                          gate=lambda i: chunk_in[i % c["requests"]].wait(
                              300), timeout=300.0)
        problems += run.problems
        if len({r.epoch.n_rows for r in run.wave1}) < 2:
            problems.append("wave 1 did not span the ingest")
        # no writer: the final corpus, every collective fenced
        qf = Q[:w["queries"]]
        b0 = reg.snapshot()["counters"]["serve.batches"]
        mesh.timed, mesh.collectives = True, dict.fromkeys(mesh.collectives,
                                                           0)
        t0 = time.perf_counter()
        final = session.serve(qf, k=w["k"], timeout=300.0)
        wall_final = time.perf_counter() - t0
        mesh.timed = False
        coll = dict(mesh.collectives)
        dispatches = reg.snapshot()["counters"]["serve.batches"] - b0
    finally:
        session.close()
        every = channel.close()
    rounds = log.close()
    counts = launch_counts()
    t0 = time.perf_counter()
    want_i, want_d = kernel_bruteforce(qf, store.data, w["k"], dev)
    t_brute = time.perf_counter() - t0
    bad = [i for i, r in enumerate(final) if not (
        r.ok and np.array_equal(r.indices, want_i[i])
        and np.array_equal(r.distances, want_d[i]))]
    if bad:
        problems.append(f"{len(bad)} of {len(final)} final-corpus answers "
                        f"differ from the K1 brute force over {store.n} "
                        f"rows, e.g. query {bad[0]}")
    if counts["euclid"] != rounds:
        problems.append(f"{counts['euclid']} K1 launches in {rounds} "
                        f"verification rounds")
    if not ranks_agree(every):
        problems.append("a rank's op hash or epochs differ from rank 0's")
    if store.n != n0 + len(extra) or store.index.n != store.n:
        problems.append(f"store {store.n} rows, index {store.index.n}, "
                        f"expected {n0 + len(extra)}")
    got.update(
        problems=problems, report=report(run), counts=counts, rounds=rounds,
        calls=len(log.rounds), cal={t: e["wall_s"] for t, e in cal.items()},
        wave=wave_figures(np, run.wave1, run.wall1_s),
        final=dict(wave_figures(np, final, wall_final), n=len(final),
                   rows=store.n, dispatches=dispatches, coll=coll,
                   brute_s=t_brute),
        ingest_s=ingest_s, stats=channel.stats, every=every, world=world,
        setup=dict(data=t_data, setup=t_setup, index=t_index),
        peak=torch.cuda.max_memory_allocated(dev),
        wall=time.perf_counter() - t_all)
    with open(out / "serve-world.pkl", "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def serve_world_report(got: dict, nproc: int, fig8):
    """Phase 13a's lines, its figures beside phase 8a's."""
    if got["problems"]:
        fail(f"service over a world of {nproc}: "
             + "; ".join(got["problems"]))
    f, w, s = got["final"], got["wave"], got["stats"]
    p8 = (f"phase 8a {fig8['qps']:.1f} QPS, p50 {fig8['p50_ms']:.1f} ms, "
          f"p99 {fig8['p99_ms']:.1f} ms, peak {fig8['peak_gb']:.2f} GB"
          if fig8 else "phase 8a not run in this invocation")
    say(f"service over a world of {nproc} (NCCL, {card_label()}): command "
        f"{got['command_s']:.1f} s, rank 0 wall {got['wall']:.1f} s "
        f"(corpora {got['setup']['data']:.1f} s, engines, index and mirrors "
        f"{got['setup']['setup']:.1f} s of which the index "
        f"{got['setup']['index']:.1f} s); calibration " + ", ".join(
            f"{t} {v * 1e3:.1f} ms" for t, v in got["cal"].items()))
    for line in got["report"]:
        say(f"  {line}")
    say(f"world of {nproc}, wave 1: {w['qps']:.1f} QPS, p50 "
        f"{w['p50_ms']:.1f} ms, p99 {w['p99_ms']:.1f} ms; rank 0 peak "
        f"device memory {got['peak'] / 1e9:.2f} GB ({p8})")
    say(f"world of {nproc}, ingest beside wave 1: {len(got['ingest_s'])} "
        f"chunks of {SERVE['ingest_rows']} rows, "
        f"{sum(got['ingest_s']):.3f} s through the channel")
    by = s["by_method"]
    say(f"world of {nproc}, channel: {s['ops']} ops, {s['keepalives']} "
        f"keep-alives, broadcast {s['broadcast_s']:.3f} s for {s['bytes']} "
        f"bytes ({1e3 * s['broadcast_s'] / max(s['ops'], 1):.3f} ms per "
        f"op), queue wait {s['wait_s']:.3f} s; " + "; ".join(
            f"{m} {v['ops']} ops {v['broadcast_s']:.3f} s "
            f"({v['bytes']} bytes)" for m, v in by.items())
        + "; op hashes and epochs equal on every rank")
    say(f"world of {nproc}, final corpus ({f['rows']} rows, no writer): "
        f"{f['n']} queries at k={SERVE_WORLD['k']} == K1 brute force "
        f"bitwise ({f['brute_s']:.1f} s); {f['qps']:.1f} QPS with every "
        f"collective fenced, {f['dispatches']:g} dispatches; collectives "
        f"{f['coll']['calls']} calls, {f['coll']['bytes']} bytes, "
        f"{1e3 * f['coll']['seconds']:.3f} ms fenced = "
        f"{1e3 * f['coll']['seconds'] / max(f['dispatches'], 1):.3f} ms "
        f"per dispatch")
    say(f"world of {nproc}: K1 launches {got['counts']['euclid']} == "
        f"verification rounds {got['rounds']} over {got['calls']} engine "
        f"calls on rank 0; launches {got['counts']}")


def serve_world_launcher(root: Path, nproc: int):
    """``launch/serve_match.py`` at its default size under
    ``torch.distributed.run`` on ``nproc`` ranks beside one process at the
    same shard count: exit 0, every exact line full, and the world's
    answer hash equal to the single process's with every rank's op hash
    equal to rank 0's."""
    import re
    lines, wall = launcher_pair(root, nproc,
                                "repro_torch.launch.serve_match")
    exact = {k: [m for ln in v for m in re.findall(
        r"bit-identity vs direct topk: (\d+)/(\d+)", ln)]
        for k, v in lines.items()}
    if not all(exact[k] and all(a == b for a, b in exact[k])
               for k in exact) or not answers_agree(lines):
        fail(f"serve launcher under torch.distributed.run ({nproc}):\n"
             + "\n".join(lines["world"][-12:]) + "\nsingle: "
             + "\n".join(lines["single"][-6:]))
    world = [ln for ln in lines["world"] if ln.startswith("[world]")]
    say(f"serve launcher under torch.distributed.run, {nproc} rank(s), "
        f"default size, beside one process at {nproc} shard(s): exit 0 in "
        f"{wall:.1f} s; exact {exact['world'][-1][0]}/"
        f"{exact['world'][-1][1]}; {lines['world'][-1]}; "
        + (world[-1] if world else ""))
    for k in ("world", "single"):
        say(f"  {k}: " + next(ln for ln in lines[k] if "wave 1:" in ln))


def serve_dist_path(torch, np, root: Path, fig8=None) -> dict:
    """Phase 13: the service over a ``torch.distributed`` world of cards,
    one rank per card (NCCL), then the serve launcher under
    ``torch.distributed.run``.  ``fig8`` is phase 8a's wave figures.
    Returns the kernels' launch counts on the world's rank 0."""
    import gc
    import tempfile
    dev = torch.device("cuda")
    say(f"phase 13 starts with {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        f" GB allocated by this process")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  after releasing: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB"
        f" allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB "
        f"reserved")
    (root / "build").mkdir(exist_ok=True)
    n_cards = torch.cuda.device_count()
    worlds = [1] + ([min(n_cards, 4)] if n_cards >= 2 else [])
    counts = None
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        for nproc in worlds:
            t0 = time.perf_counter()
            got = run_ranks(torch, root, Path(tmp), nproc,
                            ["--serve-rank", tmp], "serve-world.pkl",
                            "service over a world")
            serve_world_report(got, nproc, fig8)
            counts = counts or got["counts"]
            say(f"phase 13a: service over a world of {nproc} exact "
                f"({time.perf_counter() - t0:.1f} s)")
            t0 = time.perf_counter()
            serve_world_launcher(root, nproc)
            say(f"phase 13b: serve launcher over a world of {nproc} "
                f"({time.perf_counter() - t0:.1f} s)")
    return counts


def rounds_check(path: str, calls, exact_fetch: bool):
    """One gathered K1 launch per verification round: every topk call's
    K1 launches must equal its rounds.  On whole series every round is
    one store fetch; over windows a round whose rows all sit in the row
    buffer bills none, so there fetches <= rounds."""
    launches = fetches = rounds = 0
    for res, _, c in calls:
        launches += c["euclid"]
        fetches += res.store_fetches
        rounds += res.rounds
        if c["euclid"] != res.rounds or res.store_fetches > res.rounds or (
                exact_fetch and res.store_fetches != res.rounds):
            fail(f"{path}: a topk call made {c['euclid']} K1 launches in "
                 f"{res.rounds} verification rounds with "
                 f"{res.store_fetches} store fetches")
    say(f"{path}: K1 launches {launches} == verification rounds {rounds}; "
        f"store fetches {fetches}")


def sweep_check(path: str, calls):
    """One batched K2 launch per sSAX sweep: every sSAX topk call sweeps
    all its queries once, so it must make exactly one K2 launch."""
    launches = [c["ssax_dist"] for c in calls]
    if any(n != 1 for n in launches):
        fail(f"{path}: sSAX topk calls made {launches} K2 launches, not one "
             f"each")
    say(f"{path}: K2 launches {sum(launches)} == sSAX sweep calls "
        f"{len(launches)}")


def plain_bruteforce(torch, np, ref, Q, D, dev):
    """(Q, N) f32 distances through the plain version of K1."""
    step = 1 << 18
    q = torch.as_tensor(Q).to(dev)
    out = np.empty((Q.shape[0], D.shape[0]), np.float32)
    for lo in range(0, D.shape[0], step):
        x = torch.as_tensor(D[lo:lo + step]).to(dev)
        d2 = torch.stack([ref.euclid_ref(x, qi) for qi in q])
        out[:, lo:lo + step] = d2.cpu().numpy()
    return np.sqrt(np.maximum(out, 0.0))


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("the repository's src/repro_torch is not beside this script")
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card is available")
    if sys.argv[1:2] == ["--dist-rank"]:       # phase 12's rank code
        dist_rank(root, Path(sys.argv[2]), "--reference" in sys.argv)
        return
    if sys.argv[1:2] == ["--serve-rank"]:      # phase 13's rank code
        serve_rank(Path(sys.argv[2]))
        return
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    from repro_torch.kernels import _lib, ops, ref
    say(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on "
        f"{torch.cuda.get_device_name(0)}; every time below is on this "
        f"card: {card_label()}")
    _lib.load()
    say(f"phase 1: kernels built from {_lib.CSRC.relative_to(root)} in "
        f"{_lib.build_seconds():.1f} s -> {_lib.library_path().parent}")
    if sys.argv[1:] in (["--k5"], ["--k2"], ["--split"], ["--serve"],
                        ["--lm"], ["--train"], ["--shard"], ["--dist"],
                        ["--serve-dist"]):
        if sys.argv[1] == "--k5":
            k5_shapes(torch, ops, ref, dev)
        elif sys.argv[1] == "--k2":
            k2_shapes(torch, ops, ref, *random_makers(torch, dev, 0))
            k2_scaling(torch, ops, dev)
        elif sys.argv[1] == "--serve":
            serve_only(torch, np, ops, ref, dev)
        elif sys.argv[1] == "--lm":
            t0 = time.perf_counter()
            lm_path(torch, np, ops, ref, dev)
            say(f"phase 9: LM path exact ({time.perf_counter() - t0:.1f} s)")
        elif sys.argv[1] == "--train":
            t0 = time.perf_counter()
            train_path(torch, np, dev, root)
            say(f"phase 10: training path exact "
                f"({time.perf_counter() - t0:.1f} s)")
        elif sys.argv[1] == "--shard":
            t0 = time.perf_counter()
            shard_path(torch, np, dev, root)
            say(f"phase 11: sharded training path exact "
                f"({time.perf_counter() - t0:.1f} s)")
        elif sys.argv[1] == "--dist":
            t0 = time.perf_counter()
            dist_path(torch, np, root)
            say(f"phase 12: matching over a world of cards exact "
                f"({time.perf_counter() - t0:.1f} s)")
        elif sys.argv[1] == "--serve-dist":
            t0 = time.perf_counter()
            serve_dist_path(torch, np, root)
            say(f"phase 13: the service over a world of cards exact "
                f"({time.perf_counter() - t0:.1f} s)")
        else:
            split_only(torch, np, dev)
        return

    t0 = time.perf_counter()
    rows = kernel_phase(torch, ops, ref, dev)
    say(f"phase 2: kernels agree with their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    counts, main = main_path(torch, np, dev)
    say(f"phase 3: main path exact ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    idx_counts, ssax_store = index_path(torch, np, dev, main)
    say(f"phase 4: index path exact ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    sub_counts, sub = subseq_path(torch, np, dev)
    say(f"phase 5: subsequence path exact ({time.perf_counter() - t0:.1f} "
        f"s)")

    t0 = time.perf_counter()
    win_counts = window_index_path(torch, np, dev, sub)
    say(f"phase 6: window index path exact "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    dev_counts, p7 = device_path(torch, np, dev, main, sub)
    say(f"phase 7: device-resident path exact "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    svc_counts, sj_counts, path_errs, _, fig8 = serving_path(
        torch, np, ops, ref, dev, main["D"], ssax_store, sub)
    del main, sub, ssax_store
    for name, e in path_errs.items():     # the kernel table's shapes
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    say(f"phase 8: serving path exact ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    lm_counts, lm_errs = lm_path(torch, np, ops, ref, dev)
    for name, e in lm_errs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    say(f"phase 9: LM path exact ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    p10 = train_path(torch, np, dev, root)
    say(f"phase 10: training path exact ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    shard_path(torch, np, dev, root, p10)
    say(f"phase 11: sharded training path exact "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    world_counts = dist_path(torch, np, root, p7)
    del p7
    say(f"phase 12: matching over a world of cards exact "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    serve_world_counts = serve_dist_path(torch, np, root, fig8)
    say(f"phase 13: the service over a world of cards exact "
        f"({time.perf_counter() - t0:.1f} s)")

    paths = (("main", counts, MAIN_KERNELS),
             ("index", idx_counts, MAIN_KERNELS),
             ("subsequence", sub_counts, tuple(sub_counts)),
             ("window index", win_counts, MAIN_KERNELS),
             ("device-resident", dev_counts, MAIN_KERNELS),
             ("service", svc_counts, MAIN_KERNELS),
             ("self-join", sj_counts, SELFJOIN_KERNELS),
             ("activation retrieval", lm_counts, LM_KERNELS),
             ("world (rank 0)", world_counts, MAIN_KERNELS),
             ("service over a world (rank 0)", serve_world_counts,
              SERVE_WORLD_KERNELS))
    for path, c, names in paths:
        missing = [n for n in names if c[n] <= 0]
        if missing:
            fail(f"kernels never launched on the {path} path: {missing}")
    kernels = []
    for name in (*MAIN_KERNELS, "windowed_euclid"):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(c[name] for _, c, _ in paths),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    say(f"phase 14: every kernel launched on its paths; total "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)

    print(card_label(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
