#!/usr/bin/env python3
"""Drive lightgbm_tpu_torch on one CUDA card and check every kernel.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed 42] [--out DIR] [--baseline DIR]

With --baseline, the kernel checks also run the wrappers of another
checkout of the repo (DIR's lightgbm_tpu_torch, imported under another
name, its kernels built from DIR's csrc) on the same inputs: the
histogram kernels and the traversal kernels (every traversal case and
check) must give these kernels' bits, and both are timed in the same
way, for a before-and-after comparison in one run; so do bin_dense
(DIR's kernel on the same matrices, same bits, timed in turns) and the
LambdaRank pair gradients (DIR's function on the same score, within
1e-5, timed; DIR's package trains the fused lambdarank workload beside
this one's); the serving phase also runs DIR's CompiledPredictor on the
same model file in turns with this one (single-row latency, predict's
stages, same answers); the parallel phase profiles DIR's exchanges in a
process of their own on the same inputs (same results, device kernels
and times), and the linear phase times DIR's tree_lin_raw in turns with
this one's (same bits).

Phases (any failure exits non-zero and prints no result line):
1. the card's name and power limit (nvidia-smi); build the CUDA
   kernels from lightgbm_tpu_torch/csrc with nvcc, all sources at once
   (hist.cu, with the out-of-core hist_pair_fold, seg_hist.cu,
   compact.cu, compact_hist.cu, bin.cu, rank.cu and traverse.cu);
2. kernel checks: masked_hist and frontier_hist on the card at the
   training path's shapes (1M rows x 28 features, uint8, 255 bins; an
   int16 case with 300 bins; frontier with L = 1 at the root, every row
   in leaf 0, as each tree's first launch, and L = 2), and seg_hist on
   the packed words of the same shape (7 words) over three segments
   (the whole array, a chunk-crossing one, a short one across a chunk
   edge), plus one skewed case per kernel at the root (60% of the rows
   in bin 0, as a sparse feature's zero bin: heavy collisions), each held
   against its plain PyTorch version on the same inputs (count column
   exact; grad/hess to rtol 1e-5, atol 1e-4 against the plain version
   on the card, whose index_add_ adds in another order; bit for bit
   against the plain version run on the CPU, which adds in the
   kernel's row order, for one uniform case of each source and for
   every skewed case, where a bin of 600,000 rows puts index_add_'s
   order outside that tolerance), launched twice and required bitwise
   equal, and
   timed with CUDA events beside its bound, the plain version and one
   PyTorch index_add_ call for the same function; the host's
   microseconds per call (200 launches, no sync) and the time with the
   host's enqueue included (ms_enqueued, no device sleep ahead of the
   launch) beside each; then the gather-compacted engine's kernels at
   the same shape: compact_rows and compacted_hist over a leaf of about
   1%, 10% and 50% of the rows, a 10% leaf with one skewed feature (90%
   of its rows in bin 0), int16 bins at 300 bins (10%, the sorted
   route) and at 3000 (10%, the accumulator route), each equal to its
   plain version run on the CPU (compacted_hist bit for bit; against
   the plain version on the card as above), two launches equal, timed
   beside its bound, the plain version and one torch.nonzero_static
   over the leaf's mask / one index_add_ over the leaf's gathered keys;
   the counts 0, 1, 4095, 4096, 4097 and N checked the same way,
   untimed (with --baseline every case also bit-equal to the other
   checkout's kernels, and the timed ones timed beside them);
3. data ingestion: the bench matrix (1,000,000 x 28 float32) binned on
   the card by the bench's own construction, Dataset(X).construct() with
   launch counts read from zero, against bin_dense's plain version on
   the CPU (the first 100,000 rows, the card's mappers) and the host
   pass: the same bins, each timed;
   bin_dense on the matrix with NaN, +-inf and every bound (and one
   float32 step either side) planted, in uint8 and in int16 (max_bin
   1023: the lane route; 3000: the direct route), bit for bit its plain
   version on the card and the host pass, two launches bitwise equal,
   timed with CUDA events beside its byte bound, the plain version and
   one torch.searchsorted over the same (F, N) values and (F, B)
   bounds; the matrix written as a TSV file with
   a header (%.9g), Dataset(path) against the host pass of the parsed
   matrix, save_binary and the reloaded cache (equal bins), 5 rounds
   trained from the text and from the cache (model text byte-equal),
   each stage's seconds; then the CLI as subprocesses (python -m
   lightgbm_tpu_torch task=train, then task=predict) on a 100,000-row
   LibSVM file of the same columns, the result file line for line
   Booster.predict's values written as Predictor.predict_file writes
   them ({v:g}); the rest of the run trains on the card-built dataset;
   the TSV then trains 5 rounds out of core through the file route
   (binned straight into a block store beside it), model text equal
   to the in-RAM load's;
4. the masked main path at full width: the bench workload (1,000,000 x
   28 binary, 63 leaves, 255 bins, learning rate 0.1, 5 rounds)
   through lightgbm_tpu_torch.train, with launch counts read from zero;
   the first tree grown again with the plain histogram functions;
   predict on 100k rows against a host traversal of the saved model
   text; one tree build profiled with torch.profiler;
4b. exclusive feature bundling at full width: a Flight-Delay-shaped
   table (1,000,000 rows; one-hot blocks of 12, 31, 7, 24, 22, 300 and
   300 columns and 4 dense ones: the 700 features of the LightGBM EFB
   evaluation) with default parameters (63 leaves), which bundle it into
   fewer than 20 stored rows; the plan, both datasets' construction
   seconds (bundled on the host, unbundled by bin_dense), 5 rounds
   per-iteration on each (histogram launches a tree, round times), the
   bundled first tree against the plain engines' in the same booster and
   against the unbundled run's (splits equal with leaf values within
   1e-5 relative, or, where they part, the bundled chosen gain within
   1e-5 relative of the unbundled one: a near-tie), train AUCs within
   0.002, the fused trainer on both (model text equal to the
   per-iteration one, a replay profiled, histogram milliseconds), one
   tree's histogram expansions replayed as a graph beside a fused
   replay, and the bundled train set as its own valid set scoring its
   train scores bit for bit;
5. a 2-round cache-less run (histogram_pool_size below the cache) that
   drives frontier_hist with L = 2;
6. the partitioned main path: the same workload with
   partitioned_build=true (seg_hist at every histogram, no masked or
   frontier launch), its first tree against the masked path's, no host
   sync inside build_tree_partitioned, one tree build profiled; then a
   2-round cache-less partitioned run;
7. the fused trainer (one boosting iteration captured as a CUDA graph,
   replayed once an iteration), masked and then partitioned:
   lightgbm_tpu_torch.train with no callbacks (the fast path, one
   block of 5), launch counts read from zero and counted through the
   replays (the warm-up step's and 5 replays' launches, so 310
   masked_hist + 5 frontier_hist, or 315 seg_hist, at least), the
   model against the per-iteration phase's (splits exact, leaf values
   within 1e-4 relative, and whether the text is equal byte for byte),
   AUC, peak memory within 2x the per-iteration phase's; then on a
   booster of its own the capture timed (warm_up_fused), three blocks
   of 10 timed, no host sync in a block but its one transfer (sync
   debug "warn"), and one replay profiled;
8. the fused trainer with bagging (0.7, every 2 rounds) and
   feature_fraction 0.75 on the masked, partitioned, cache-less and
   compacted builders, 4 rounds each: model text equal to the
   per-iteration loop's byte for byte, and no host sync in a block but
   its one transfer;
8b. the gather-compacted engine, the reference's default off the TPU
   (hist_compaction=auto; every other phase pins hist_compaction=false
   and so keeps the masked engine): 5 rounds per-iteration, launch
   counts read from zero (compact_rows and compacted_hist at every
   split, no masked_hist), its first tree against the masked phase's
   (splits exact, leaves within 1e-4) and against the same tree grown
   with every engine's plain version, no host sync inside a compacted
   tree build; the first tree's 62 smaller-child counts: both kernels
   at each count on the learner's bins, bit for bit their plain
   versions on the CPU, timed, summed beside their bounds (and with
   --baseline the other checkout's kernels); 2 cache-less rounds (two
   compacted passes a split); the fused trainer as in 7 (text,
   launches through the replays, blocks timed, a replay profiled with
   its histogram kernels' share and its device launches by name: one
   compact_lookback a compact_rows, one gather_sort_hist a
   compacted_hist) beside the fused masked round of this run; 5-class
   multiclass, 2 rounds per-iteration and fused (text equal, 5 x 62
   compactions a replay);
9. blockwise engine.train: a 100k-row valid set, early stopping after
   5 rounds, evals_result, 8 rounds, against the per-iteration path
   (a no-op callback): the same best iteration, trees and history
   (exact when the model text is equal, else within 1e-5 relative);
   once with the held-out labels (no stop) and once with labels drawn
   at random, where the stop breaks inside a block;
9b. checkpoint and resume: on each path a run crashed in process
   (InjectedFault) and resumed from its snapshot directory into a fresh
   booster writes the uninterrupted run's model text byte for byte:
   fused (8 rounds, snapshots every 4, crash at 6; the resumed graph
   updates the booster's own score), blockwise (the 100k-row valid set,
   early stopping: history and best iteration equal), per-iteration,
   GOSS fused and DART; each snapshot's checkpoint_write_s and bytes,
   the fused snapshot's decode and restore seconds;
9c. out of core: hist_pair_fold (csrc/hist.cu) on one block of 262,144
   and of 65,536 rows with a carry in flight, for leaf 5 of rows spread
   over 63 leaves and for leaves of 50% and 100% of the rows, bit for
   bit its plain version on the CPU, two launches equal, its counters
   left zero, timed (L2 flushed) beside its bound, its plain version,
   masked_hist over the same rows and one index_add_ over the block's
   leaf rows, its plan printed; three calls profiled in a fresh process
   (one device kernel each); the blocks of a 1M-row pass
   folded and collapsed bit-equal to masked_hist over the whole array;
   the bench matrix spilled at both block sizes (4 and 16 blocks) and
   trained 3 rounds, launch counts read from zero (one hist_pair_fold a
   block a pass, no in-RAM histogram kernel), model text byte-equal to
   the in-RAM masked run's, round times beside it, each pass's time
   beside a pinned host-to-device copy of the same bytes, the
   prefetcher's overlap_pct and wait_s, peak device memory beside the
   in-RAM run's; a crash and resume of the 4-block run byte-equal to
   its uninterrupted text;
9d. the parallel learners on an in-process mesh of 4 shards spread over
   the process's cards: the exchange fold (csrc/mesh.cu) as the
   exchanges give it, a gather-fold of descriptors into 4 shards' own
   (28, 255, 3) words: K = 8 on the last shard's owned block of 7
   features (reduce-scatter), K = 8 on a whole (1, 28, 255, 3) root
   histogram (the allgather pair) and K = 4 bfloat16 words on the owned
   block; and mesh_fold on K = 8 stacked (7, 255, 3) components; each
   bit for bit its plain version on the card and on the CPU, two
   launches equal, timed (L2 flushed) beside its bound, its plain
   version and torch.sum over the stacked components (other bits); one
   exchange of each kind (pair allgather, pair reduce-scatter at
   comm_groups 1, 2 and 7, bf16 reduce-scatter at 7) on a 4-shard mesh
   on the card profiled in a fresh process: device kernels a shard an
   exchange (one gather-fold for the pair ones), device ms and host us
   an exchange (with --baseline the other checkout's exchanges on the
   same inputs in a process of their own, their results bit-equal);
   then, launch counts read from zero, 1
   per-iteration round on the bench data of the data learner
   (reduce-scatter at the default comm_groups=2, which f_loc = 7 cuts
   to one group, and at comm_groups=7; allgather; partitioned_build=
   true), the feature learner and the voting learner: data and feature
   trees equal to the serial masked learner's of the same rounds
   (splits exact, leaves within rtol 1e-5, atol 1e-6), partitioned data to the
   serial partitioned learner's (rtol 2e-4), voting train AUC above
   0.8, every tree's collective bytes (counted by the mesh) equal to its
   CommPlan; round times beside the serial ones, the mesh's placement;
9e. the multi-process runtime (parallel/distributed.py, the ProcessMesh):
   gangs of real processes, `python -m lightgbm_tpu_torch` with a
   machine list of localhost entries and LIGHTGBM_TPU_RANK, one process
   a rank, each training the bench rows 2 rounds from the ingestion
   phase's binary cache: 2 ranks sharing card 0 (CUDA_VISIBLE_DEVICES=0)
   over gloo with pinned host copies, and where there are two cards or
   more also min(cards, 4) ranks over NCCL (a line says which ran and
   why); the data learner (reduce-scatter at comm_groups 1 and 7,
   allgather, partitioned_build=true), the feature learner and the
   voting learner (top_k 20); rank 0's model text byte-equal to the
   in-process mesh's at the same W on the same rows (lightgbm_tpu_torch.
   train from the cache), every rank's model equal to rank 0's (the
   ranks' digests, logged), the histogram and mesh_fold launches the
   ranks log; round ms (round 2) beside the in-process
   mesh's. One exchange of each kind (pair allgather, pair
   reduce-scatter at comm_groups 1, 2 and 7, bf16 reduce-scatter at 7)
   on a gang of rank processes: the rank's device kernels (one
   gather_fold an exchange; the transport's own copies and kernels
   listed apart), device ms, host us (the mesh's own work), transport
   us and wall us an exchange, the counted collective bytes against the
   learner's CommPlan unit, the results bit-equal to an in-process
   LocalMesh's. The kill case: rank 1 hard-crashes before round 2;
   rank 0 must exit with 117 within collective_timeout_s (30 s) + 10 s,
   its log naming the collective, the iteration and the rank;
9f. the out-of-core gang learner (data/ooc_parallel.py) and the
   supervisor: the gang's exchange on the card (2 ranks' carries of a
   1/63 leaf over their owned blocks of the bench bins, one gather_fold)
   bit for bit its plain version, timed beside its bound; a gang of 2
   CLI ranks (gloo over pinned copies sharing card 0; NCCL a card a rank
   where there are two cards or more) over the ingestion TSV's block
   store (the file route's, 4 blocks of 262,144 rows, built once), 3
   rounds with telemetry=true: hist_pair_fold and mesh_fold launches a
   rank as planned, the trees against the serial out-of-core learner's
   on the same store, the journal's block_reshard records; the shrink
   drill (rank 0 under `python -m lightgbm_tpu_torch.supervisor`, rank
   1 killed before round 2): the survivor shrinks to 1 rank, resumes
   from the round-2 snapshot byte-equal to a single-rank run resumed
   from it, the store's build_count 1, no binning record; a same-topology
   restart (both ranks supervised) byte-equal to the uninterrupted gang;
9g. the training telemetry: the fused compacted path with telemetry=true
   beside it without (the same syncs in a block, the same kernels in a
   replay, the same model text, round times), the journal checked
   against the schema; the roofline rows of hist_pair_fold (one
   out-of-core round over the TSV's store) and mesh_fold (the gang's
   exchange on a 2-shard mesh) from CUDA event pairs, against the
   card's copy peak;
10. multiclass: the bench matrix with its logit cut at the quintiles (5
   classes), 5 rounds (25 trees) per-iteration, fused with the masked
   builder (model text against the per-iteration one) and with the
   partitioned one (first round's trees against the masked ones), launch
   counts read from zero and counted through the replays (5 x (62
   masked_hist + 1 frontier_hist) a replay, or 5 x 63 seg_hist),
   multi_logloss after 5 rounds below the first round's, each fused
   round timed and one replay profiled; predict on 100k rows against a
   host traversal of the model text; the model frozen by
   CompiledPredictor and served through tree_raw with K = 5 (its sums
   bit-equal to predict's device path, the exact answers within the
   f64 association bound of the host path), tree_raw K = 5 timed;
11. lambdarank: the bench matrix in queries of 50-200 documents (about
   8,000, M = 200), relevance 0-4 from the logit's quantiles within each
   query, max_position 20, the default label_gain: the lambdarank_pairs
   kernel (csrc/rank.cu) bit for bit its plain version on the card and
   within 2e-4 of the largest |value| of its host float64 path, two
   calls bitwise equal, three calls profiled in a fresh process (one
   device kernel each) and one call's PyTorch operators, timed with
   CUDA events beside its bound (the function's own bytes and the pair
   arithmetic its labels need) and its plain version; 5 rounds
   per-iteration and fused (one launch a round, counted through the
   replays; NDCG@1,3,5 after 5 rounds above the first round's, model
   text), and query-unit bagging (0.7, every 2 rounds) fused against
   its per-iteration loop;
11a. GOSS (boosting=goss, learning_rate 0.25: a warm-up of 4 rounds,
   then 4 sampled) 8 rounds on the default compacted engine per
   iteration and fused (the model text equal; every sampled iteration's
   weights: at least top_n rows in the top set, the sampled rest within
   5 sigma of rand_n, the weights' sum within 5 sigma of N), the fused
   round beside the compacted phase's plain gbdt fused round, a replay
   profiled (histogram ms), the weights' device ms at 1M rows with the
   sort apart; then per iteration and fused with partitioned_build=true;
11b. DART (drop_rate 0.1) 10 rounds per iteration: the drop sets equal
   to a host replay of Random(drop_seed), the train score against a
   fresh bin-space scoring of the final model within the float32
   rounding of its adds and subtracts, the trained booster's
   predictions (host and device routes) equal to a booster loaded from
   its model text, the text round-trips byte for byte;
11c. linear leaves (linear_tree=true) 3 rounds: the fit's host seconds
   a tree, the format-version-2 text round trip, the CompiledPredictor
   exact path bit-equal to the host f64 predict on rows with 2% NaN,
   tree_lin_raw (csrc/traverse.cu) f32 and bf16, raw and transformed,
   at the 4096-row and 1-row buckets bit for bit its plain version on
   the card and across two launches, within the class-sum bound of the
   host f64 path (bf16: the pinned accuracy bound), timed with L2
   flushed beside its bound, its plain version and tree_raw on the same
   forest, ptxas's registers and spills (with --baseline the other
   checkout's tree_lin_raw on the same model and on 100 random linear
   trees, in its own leaf layout: same bits, timed in turns at 4096 rows
   and 1 row); then the serving main path (device variants and bf16
   predict) with launch counts from zero;
12. categorical features: the bench matrix plus 4 integer columns of 32
   categories that enter the label's logit, declared categorical, 2
   rounds with each builder: categorical splits, the same first tree,
   predict against the host traversal;
13. serving (lightgbm_tpu_torch.serving): the bench model trained 100
    rounds (fused masked) and frozen from its model text with
    CompiledPredictor.from_model_file (max_batch_rows 4096) in f32 and
    bf16; tree_leaf bit for bit against its plain version on the card
    over 100k rows with NaN, +-inf, +-1e10 and -0.5 planted, also on a
    predictor of the categorical phase's masked model (whose served
    leaves must equal the host traversal's); tree_raw with K = 1 (the
    bench model, float32 and bfloat16 leaf values) and K = 3 (random
    valid trees) bit for bit its plain version (f32 adds in tree order),
    bfloat16 within the predictor's accuracy_bound of the exact f64 sum,
    two launches bitwise equal; both kernels timed at the 4096-row and
    the 1-row bucket beside their bound and plain version, with L2
    flushed and L2-warm (and with --baseline the other checkout's
    kernels: same bits, both times).
    Then the main path, launch counts read from zero: bench.py
    serving_probe's numbers for each predictor (single-row predict
    p50/p99 over 100 calls, predict throughput over 100k rows, cold
    dispatches 0), and make_server in process: POSTs of 1, 64 and 4096
    rows bit-equal to CompiledPredictor.predict, 8 client threads of
    single-row requests coalescing into fewer batches, /healthz and
    /metricz. Then predict's stages timed apart on 1 row and on 100k
    rows (canonicalise and pad, the two copies, the launch, the f64
    gather and product, the sigmoid), the staged answer bit-equal to
    predict's. Served leaves must equal the host float64 traversal's
    (force_host_predict) and predict the f64 product of those leaves;
    against the host path's per-class sum it is held within the f64
    association bound (coalesced_tol). With --baseline, the other
    checkout's predictor and this one in ten pairs of turns: single-row
    p50, stages on one row, pairs won, the tree_leaf dispatch's host
    microseconds;
14. a `kernels` JSON line (launches from the fused phases, binary,
    bundled, multiclass and lambdarank, for compact_rows and
    compacted_hist from the compacted phase's fused runs, binary and
    multiclass, and the bundled phase's, for the
    traversal kernels from the serving main path and the multiclass
    serving, for bin_dense from the bench's construction, for
    lambdarank_pairs from the fused lambdarank run, for tree_lin_raw
    from the linear phase's serving, for hist_pair_fold from the
    out-of-core runs and the gang's ranks, for mesh_fold from the
    parallel phase's runs, the distributed phase's rank processes and
    the gang's ranks),
    the card line, and the result line.

Everything measured here is written to <out>/chip_smoke.json too.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bandwidth and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# about 1 ms at the H100's clock: longer than any wrapper's host time
SLEEP_CYCLES = 2_000_000
N_ROWS = 1_000_000
N_FEATURES = 28
MAX_BIN = 255
# rounds of the binary bench, blockwise and categorical phases, kept
# short so that the multiclass and lambdarank phases (NEW_ROUNDS each)
# fit the run's time; cut for the gang and telemetry phases: NEW_ROUNDS
# from 10 to 5, BLOCKWISE_ROUNDS from 10 to 8 (the random labels' stop
# at 6 still breaks inside the second block of 5)
N_ROUNDS = 5
NEW_ROUNDS = 5
BLOCKWISE_ROUNDS = 8
CATEGORICAL_ROUNDS = 2
N_CAT = 4
N_CATEGORIES = 32
DEVICE = "cuda"
BASELINE = None  # another checkout's lightgbm_tpu_torch.ops (--baseline)
# hist_compaction=false pins the full-scan masked engine in every phase
# built on these (auto resolves to the gather-compacted engine above 4,096
# rows); the compacted phase asks for auto
BENCH_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": MAX_BIN,
                "learning_rate": 0.1, "verbose": 0, "hist_compaction": "false"}


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def make_data(n, seed, f=N_FEATURES, n_cat=0, with_logit=False):
    """bench.py make_data's generator (without its label memo-buster);
    with n_cat, that many integer columns of N_CATEGORIES categories
    are appended, each adding a random per-category effect to the
    logit. with_logit: (x, y, logit)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f).astype(np.float32) / np.sqrt(f)
    logit = x @ w + 0.5 * rng.randn(n).astype(np.float32)
    if n_cat:
        cats = rng.randint(0, N_CATEGORIES, size=(n, n_cat))
        effect = rng.randn(n_cat, N_CATEGORIES).astype(np.float32)
        logit = logit + effect[np.arange(n_cat), cats].sum(1)
        x = np.concatenate([x, cats.astype(np.float32)], axis=1)
    if with_logit:
        return x, (logit > 0).astype(np.float32), logit
    return x, (logit > 0).astype(np.float32)


def make_valid(n, seed):
    """n held-out rows of make_data(N_ROWS, seed)'s problem: its feature
    weights (drawn after its N_ROWS x N_FEATURES features), with
    features and noise of their own."""
    rng = np.random.RandomState(seed)
    rng.randn(N_ROWS, N_FEATURES)
    w = rng.randn(N_FEATURES).astype(np.float32) / np.sqrt(N_FEATURES)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(n, N_FEATURES).astype(np.float32)
    logit = x @ w + 0.5 * rng.randn(n).astype(np.float32)
    return x, (logit > 0).astype(np.float32)


def auc(score, label):
    order = np.argsort(-score, kind="stable")
    lab = label[order]
    ranks_pos = np.nonzero(lab == 1)[0]
    n_pos, n_neg = len(ranks_pos), len(lab) - len(ranks_pos)
    # count of negatives ranked below each positive (no ties in practice)
    below = n_neg - (ranks_pos - np.arange(n_pos))
    return float(below.sum()) / (n_pos * n_neg)


# ------------------------------------------------------------------ timing

class Timer:
    """Median of per-launch CUDA-event times, L2 flushed before each
    launch (a 64 MB write exceeds the card's 50 MB L2). A 1 ms device
    sleep after the flush keeps the card busy while the host enqueues
    the call, so the time is the device's, not the host's wrapper time
    (that is host_us)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, reps, sleep=True, flush=True):
        """With sleep=False the time includes the host's enqueue of the
        call where it outlasts the flush; with flush=False L2 keeps what
        the previous launch left (L2-warm, as a server finds its forest
        between requests)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if flush:
                self.flush.zero_()
            if sleep:
                torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def hist_bound_ms(f, n, bin_bytes, num_leaf, b, in_rows):
    """Least time for one histogram call: every input read once (bins,
    ghc_t, row_leaf, leaf ids) and the (value, residual) pair written
    once, over HBM bandwidth; against three float32 adds per in-frontier
    (row, feature) over the float32 rate. Returns (ms, bound_by)."""
    nbytes = (f * n * bin_bytes + 3 * n * 4 + n * 4 + num_leaf * 4
              + 2 * num_leaf * f * b * 3 * 4)
    ops = 3.0 * f * in_rows
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def seg_bound_ms(w, cnt, b):
    """Least time for one seg_hist call: the segment's words (4W bytes a
    row) and statistics (12 bytes a row) read once, the bounds read and
    the (value, residual) pair written once, over HBM bandwidth; against
    three float32 adds per (segment row, feature) over the float32
    rate. Returns (ms, bound_by)."""
    f = 4 * w
    nbytes = (4 * w + 12) * cnt + 8 + 2 * f * b * 3 * 4
    ops = 3.0 * f * cnt
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compact_bound_ms(n):
    """Least time for one compact_rows call: row_leaf (4 bytes a row) and
    the leaf id read once, the (N,) index buffer and the count written
    once, over HBM bandwidth (one compare a row is far below the float32
    rate). Returns (ms, bound_by)."""
    return 1e3 * (8 * n + 8) / PEAK_BYTES_PER_S, "bytes"


def compacted_bound_ms(f, cnt, bin_bytes, b):
    """Least time for one compacted_hist call: src and the statistics
    of the leaf's `cnt` rows (4 + 12 bytes a row), their bins (F * bin
    bytes a row), the count read once and the (value, residual) pair
    written once, over HBM bandwidth; against three float32 adds per
    (row, feature) over the float32 rate. Returns (ms, bound_by)."""
    nbytes = (16 + f * bin_bytes) * cnt + 4 + 2 * f * b * 3 * 4
    ops = 3.0 * f * cnt
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def host_us(torch, fn, reps=200):
    """Host microseconds per call: perf_counter around `reps` launches
    with no sync in between (what the dispatch-bound loop pays)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def ptxas_usage(text):
    """[{kernel, registers, spill_stores, spill_loads}] from nvcc's
    -Xptxas -v output (kernel names as ptxas prints them, mangled)."""
    import re
    rows, name, spill = [], None, (None, None)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (None, None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1]})
            name = None
    return rows


def skew_bins(bins, rng):
    """60% of the entries moved to bin 0, as a sparse feature's zero bin
    (in place)."""
    bins[rng.rand(*bins.shape) < 0.6] = 0
    return bins


def load_baseline(path):
    """The lightgbm_tpu_torch package of the checkout at `path`, imported
    under another name (its modules import each other relatively): its
    wrappers build that checkout's csrc into its own csrc/build and count
    their launches apart from this one's."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(path), "lightgbm_tpu_torch")
    name = "baseline_lightgbm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(name + ".ops.traverse_kernels")
    return mod


def baseline_module(name):
    """A module of the other checkout's package (--baseline)."""
    import importlib
    return importlib.import_module(
        BASELINE.__name__.rsplit(".", 1)[0] + "." + name)


_BASELINE_FORESTS = {}


def baseline_forest(forest):
    """The same trees frozen by the other checkout's traverse_kernels
    (its kernels read its own record layout), once a forest."""
    key = id(forest)
    if key not in _BASELINE_FORESTS:
        host = [a.cpu().numpy() for a in (forest.sf, forest.thr, forest.cat,
                                          forest.lc, forest.rc, forest.node0)]
        _BASELINE_FORESTS[key] = (forest, BASELINE.traverse_kernels.freeze(
            *host, forest.depth, forest.sf.device))
    return _BASELINE_FORESTS[key][1]


def baseline_bits(torch, res, call, got):
    """With --baseline: the other checkout's wrapper on the same inputs
    must give the same bits. Returns whether it ran."""
    if BASELINE is None:
        return False
    hi, lo = call(BASELINE.hist_kernels)
    torch.cuda.synchronize()
    res["baseline_same_bits"] = bool(torch.equal(hi, got[0])
                                     and torch.equal(lo, got[1]))
    check(res["baseline_same_bits"], "the baseline gave other bits")
    return True


def time_baseline(torch, timer, res, call, got):
    """With --baseline: the other checkout's wrapper on the same inputs
    must give the same bits; both of its times go beside this one's."""
    if not baseline_bits(torch, res, call, got):
        return
    base = BASELINE.hist_kernels
    res["baseline_ms"] = timer(lambda: call(base), 20)
    res["baseline_ms_enqueued"] = timer(lambda: call(base), 20, sleep=False)
    res["baseline_host_us"] = host_us(torch, lambda: call(base))
    log(f"  baseline: same bits {res['baseline_same_bits']} ms "
        f"{res['baseline_ms']:.4f} (this {res['ms']:.4f}), enqueued "
        f"{res['baseline_ms_enqueued']:.4f} (this {res['ms_enqueued']:.4f}), "
        f"host_us {res['baseline_host_us']:.1f} (this {res['host_us']:.1f})")


def compare(torch, got_pair, want_pair):
    """Kernel pair against plain pair: (max_abs_err, count_exact, close)."""
    got = (got_pair[0] + got_pair[1]).cpu()
    want = (want_pair[0] + want_pair[1]).cpu()
    count_exact = bool(torch.equal(got[..., 2], want[..., 2]))
    close = bool(torch.allclose(got[..., :2], want[..., :2], rtol=1e-5,
                                atol=1e-4))
    return float((got - want).abs().max()), count_exact, close


# ----------------------------------------------------------- kernel checks

def check_case(res, name, cpu_check, skew):
    """A kernel case's gates: exact counts, equal launches, grad/hess
    within tolerance of the plain version on the card (not for skewed
    bins: see the module docstring) and, where it was run, equality in
    bits with the plain version on the CPU."""
    check(res["count_exact"], f"{name}: count column differs from plain")
    check(res["deterministic"], f"{name}: two launches gave different bits")
    if not skew:
        check(res["grad_hess_close"],
              f"{name}: grad/hess differ from plain beyond tolerance")
    if cpu_check:
        check(res["bitwise_vs_cpu_plain"],
              f"{name}: differs in bits from the plain version on the CPU")


def kernel_case(torch, hk, timer, name, f, n, b, dtype, leaf_ids, rng,
                cpu_check=False, skew=False, root=False):
    """One kernel against its plain version on the same card inputs;
    rows over 63 leaves, or with `root` every row in leaf 0."""
    dev = DEVICE
    np_dtype = np.uint8 if dtype == torch.uint8 else np.int16
    bins = rng.randint(0, b, size=(f, n)).astype(np_dtype)
    bins = torch.from_numpy(skew_bins(bins, rng) if skew else bins)
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = np.stack([rng.randn(n).astype(np.float32) * inbag,
                    rng.rand(n).astype(np.float32) * inbag, inbag])
    row_leaf = torch.from_numpy(np.zeros(n, np.int32) if root else
                                rng.randint(0, 63, size=n).astype(np.int32))
    ghc_t = torch.from_numpy(ghc)
    ids = torch.tensor(leaf_ids, dtype=torch.int32)
    bins_d, ghc_d, rl_d, ids_d = (t.to(dev) for t in (bins, ghc_t, row_leaf,
                                                      ids))
    if name == "masked_hist":
        def kern():
            return hk.masked_hist(bins_d, ghc_d, rl_d, ids_d, b)

        def plain():
            return hk.masked_hist_plain(bins_d, ghc_d, rl_d, ids_d, b)
    else:
        def kern():
            return hk.frontier_hist(bins_d, ghc_d, rl_d, ids_d, b)

        def plain():
            return hk.frontier_hist_plain(bins_d, ghc_d, rl_d, ids_d, b)

    hi1, lo1 = kern()
    hi2, lo2 = kern()
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(hi1, hi2) and torch.equal(lo1, lo2))
    err, count_exact, close = compare(torch, (hi1, lo1), plain())
    res = {"name": name, "shape": {"F": f, "N": n, "B": b,
                                   "bins": str(dtype).replace("torch.", ""),
                                   "L": len(leaf_ids), "skew": skew,
                                   "root": root},
           "max_abs_err": err, "count_exact": count_exact,
           "grad_hess_close": close, "deterministic": deterministic}
    if cpu_check:
        # the plain version on the CPU adds in row order, as the kernel
        # does: the two should agree bit for bit
        plain_fn = (hk.masked_hist_plain if name == "masked_hist"
                    else hk.frontier_hist_plain)
        ch, cl = plain_fn(bins, ghc_t, row_leaf, ids, b)
        res["bitwise_vs_cpu_plain"] = bool(torch.equal(hi1.cpu(), ch)
                                           and torch.equal(lo1.cpu(), cl))
    # library yardstick: ONE index_add_ on a flattened (leaf, f, bin) key
    # built outside the timed region; rows outside the frontier go to a
    # discard slot laid out like a leaf (key ((L*F + f)*B + bin)), so
    # they spread over F*B cells as a leaf's rows do, and the result is
    # sliced to the L real leaves
    in_rows = int(torch.isin(row_leaf, ids).sum())
    num_leaf = len(leaf_ids)
    slot = hk.leaf_slots(rl_d, ids_d)
    slot = torch.where(slot >= 0, slot, torch.full_like(slot, num_leaf))
    key = ((slot[None, :] * f + torch.arange(f, device=dev)[:, None]) * b
           + bins_d.long()).reshape(-1)
    cells = num_leaf * f * b
    src = ghc_d.t()[None].expand(f, n, 3).reshape(-1, 3).contiguous()

    def library():
        return torch.zeros(cells + f * b, 3, device=dev).index_add_(
            0, key, src)[:cells]

    res["ms"] = timer(kern, 20)
    res["ms_enqueued"] = timer(kern, 20, sleep=False)
    res["host_us"] = host_us(torch, kern)
    res["plain_ms"] = timer(plain, 3)
    res["library_ms"] = timer(library, 5)
    res["bound_ms"], res["bound_by"] = hist_bound_ms(
        f, n, bins.element_size(), len(leaf_ids), b, in_rows)
    log(f"{name} {res['shape']}: err {err:.3g} count_exact {count_exact} "
        f"close {close} deterministic {deterministic} ms {res['ms']:.4f} "
        f"bound {res['bound_ms']:.4f} plain {res['plain_ms']:.3f} "
        f"library {res['library_ms']:.3f} host_us {res['host_us']:.1f}"
        + (f" bitwise_vs_cpu_plain {res['bitwise_vs_cpu_plain']}"
           if cpu_check else ""))
    check_case(res, name, cpu_check, skew)
    time_baseline(torch, timer, res, lambda m: getattr(m, name)(
        bins_d, ghc_d, rl_d, ids_d, b), (hi1, lo1))
    del key, src, slot
    return res


def seg_kernel_case(torch, hk, timer, words, ghc, begin, cnt, b,
                    cpu_check=False, skew=False):
    """seg_hist against seg_hist_plain on the same card inputs; `words`
    and `ghc` are CPU tensors of the full packed array."""
    dev = DEVICE
    bounds = torch.tensor([begin, cnt], dtype=torch.int32)
    words_d, ghc_d, bounds_d = (t.to(dev) for t in (words, ghc, bounds))

    def kern():
        return hk.seg_hist(words_d, ghc_d, bounds_d, b)

    def plain():
        return hk.seg_hist_plain(words_d, ghc_d, bounds_d, b)

    hi1, lo1 = kern()
    hi2, lo2 = kern()
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(hi1, hi2) and torch.equal(lo1, lo2))
    err, count_exact, close = compare(torch, (hi1, lo1), plain())
    w, n = words.shape
    res = {"name": "seg_hist", "shape": {"W": w, "N": n, "B": b,
                                         "begin": begin, "cnt": cnt,
                                         "skew": skew},
           "max_abs_err": err, "count_exact": count_exact,
           "grad_hess_close": close, "deterministic": deterministic}
    if cpu_check:
        ch, cl = hk.seg_hist_plain(words, ghc, bounds, b)
        res["bitwise_vs_cpu_plain"] = bool(torch.equal(hi1.cpu(), ch)
                                           and torch.equal(lo1.cpu(), cl))
    # library yardstick: ONE index_add_ on the segment's flattened
    # (feature, bin) key, built outside the timed region
    f = 4 * w
    seg = slice(begin, begin + cnt)
    key = (torch.arange(f, device=dev)[:, None] * b
           + hk.unpack_words(words_d[:, seg]).long()).reshape(-1)
    src = ghc_d[:, seg].t()[None].expand(f, cnt, 3).reshape(-1, 3).contiguous()

    def library():
        return torch.zeros(f * b, 3, device=dev).index_add_(0, key, src)

    res["ms"] = timer(kern, 20)
    res["ms_enqueued"] = timer(kern, 20, sleep=False)
    res["host_us"] = host_us(torch, kern)
    res["plain_ms"] = timer(plain, 3)
    res["library_ms"] = timer(library, 5)
    res["bound_ms"], res["bound_by"] = seg_bound_ms(w, cnt, b)
    log(f"seg_hist {res['shape']}: err {err:.3g} count_exact {count_exact} "
        f"close {close} deterministic {deterministic} ms {res['ms']:.4f} "
        f"bound {res['bound_ms']:.4f} plain {res['plain_ms']:.3f} "
        f"library {res['library_ms']:.3f} host_us {res['host_us']:.1f}"
        + (f" bitwise_vs_cpu_plain {res['bitwise_vs_cpu_plain']}"
           if cpu_check else ""))
    check_case(res, "seg_hist", cpu_check, skew)
    time_baseline(torch, timer, res, lambda m: m.seg_hist(
        words_d, ghc_d, bounds_d, b), (hi1, lo1))
    del key, src
    return res


def seg_kernel_cases(torch, hk, timer, rng):
    """The three segment kinds on one 1,048,576 x 28 packed array, then
    the whole array again with skewed bins."""
    from lightgbm_tpu_torch.ops.ordered_hist import pack_feature_words
    n = 1 << 20
    bins = rng.randint(0, MAX_BIN, size=(N_FEATURES, n)).astype(np.uint8)
    words = torch.from_numpy(pack_feature_words(bins))
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = torch.from_numpy(np.stack([rng.randn(n).astype(np.float32) * inbag,
                                     rng.rand(n).astype(np.float32) * inbag,
                                     inbag]))
    cases = [seg_kernel_case(torch, hk, timer, words, ghc, begin, cnt,
                             MAX_BIN, cpu_check=cpu)
             for begin, cnt, cpu in ((0, n, False), (300_001, 200_000, True),
                                     (4090, 100, False))]
    skewed = torch.from_numpy(pack_feature_words(skew_bins(bins, rng)))
    cases.append(seg_kernel_case(torch, hk, timer, skewed, ghc, 0, n,
                                 MAX_BIN, cpu_check=True, skew=True))
    return cases


def compact_kernel_case(torch, hk, timer, row_leaf, leaf, timed=True):
    """compact_rows on the card against its plain version on the card
    and on the CPU (element for element), two launches equal; timed
    beside its bound and one torch.nonzero_static over the leaf's mask
    (built outside the timed region)."""
    dev = DEVICE
    n = row_leaf.shape[0]
    rl_d = row_leaf.to(dev)
    lid = torch.tensor([leaf], dtype=torch.int32)
    lid_d = lid.to(dev)
    src = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)

    def kern():
        return hk.compact_rows(rl_d, lid_d, src, cnt)

    def plain():
        return hk.compact_rows_plain(rl_d, lid_d, torch.empty_like(src),
                                     torch.empty_like(cnt))

    s1, c1 = (t.clone() for t in kern())
    s2, c2 = kern()
    ps, pc = plain()
    cs, cc = hk.compact_rows_plain(row_leaf, lid, torch.empty(
        n, dtype=torch.int32), torch.empty(1, dtype=torch.int32))
    torch.cuda.synchronize()
    count = int(c1[0])
    res = {"name": "compact_rows", "shape": {"N": n, "cnt": count},
           "max_abs_err": float((s1.cpu().long() - cs.long()).abs().max()),
           "deterministic": bool(torch.equal(s1, s2) and torch.equal(c1, c2)),
           "equal_plain": bool(torch.equal(s1, ps) and torch.equal(c1, pc)),
           "equal_cpu_plain": bool(torch.equal(s1.cpu(), cs)
                                   and torch.equal(c1.cpu(), cc))}
    check(res["deterministic"], f"compact_rows cnt {count}: two launches "
          "differ")
    check(res["equal_plain"] and res["equal_cpu_plain"],
          f"compact_rows cnt {count}: differs from its plain version")
    base_src, base_cnt = torch.empty_like(src), torch.empty_like(cnt)

    def baseline(m):
        return m.compact_rows(rl_d, lid_d, base_src, base_cnt)

    if not timed:
        baseline_bits(torch, res, baseline, (s1, c1))
        log(f"compact_rows {res['shape']}: equal to plain, deterministic")
        return res
    mask = rl_d == lid_d

    def library():
        return torch.nonzero_static(mask, size=n, fill_value=n)

    res["ms"] = timer(kern, 20)
    res["ms_enqueued"] = timer(kern, 20, sleep=False)
    res["host_us"] = host_us(torch, kern)
    res["plain_ms"] = timer(plain, 5)
    res["library_ms"] = timer(library, 5)
    res["bound_ms"], res["bound_by"] = compact_bound_ms(n)
    log(f"compact_rows {res['shape']}: equal to plain, deterministic, ms "
        f"{res['ms']:.4f} bound {res['bound_ms']:.4f} plain "
        f"{res['plain_ms']:.3f} library (nonzero_static) "
        f"{res['library_ms']:.3f} host_us {res['host_us']:.1f}")
    time_baseline(torch, timer, res, baseline, (s1, c1))
    return res


def compacted_kernel_case(torch, hk, timer, bins, ghc, row_leaf, leaf, b,
                          timed=True, skew=False):
    """compacted_hist on the card over compact_rows' buffer, against its
    plain version run on the CPU (bit for bit) and on the card (count
    exact, grad/hess within rtol 1e-5, atol 1e-4: index_add_ adds in
    another order there; not for `skew`, see the module docstring), two
    launches equal; timed beside its bound, the plain version on the
    card and one index_add_ over the leaf's gathered (feature, bin) keys
    (gathered outside the timed region); with --baseline the other
    checkout's kernel on the same inputs (same bits, both times)."""
    dev = DEVICE
    f, n = bins.shape
    lid = torch.tensor([leaf], dtype=torch.int32)
    src, cnt = hk.compact_rows_plain(row_leaf, lid,
                                     torch.empty(n, dtype=torch.int32),
                                     torch.empty(1, dtype=torch.int32))
    bins_d, ghc_d, src_d, cnt_d = (t.to(dev) for t in (bins, ghc, src, cnt))
    scratch = hk.CompactScratch(bins_d, b)   # as a learner holds it

    def kern():
        return hk.compacted_hist(bins_d, ghc_d, src_d, cnt_d, b,
                                 **scratch.hist_kwargs())

    def plain():
        return hk.compacted_hist_plain(bins_d, ghc_d, src_d, cnt_d, b)

    hi1, lo1 = kern()
    hi2, lo2 = kern()
    torch.cuda.synchronize()
    count = int(cnt[0])
    ch, cl = hk.compacted_hist_plain(bins, ghc, src, cnt, b)
    err, count_exact, close = compare(torch, (hi1, lo1), plain())
    res = {"name": "compacted_hist",
           "shape": {"F": f, "N": n, "B": b, "cnt": count,
                     "bins": str(bins.dtype).replace("torch.", ""),
                     "skew": skew},
           "route": hk.compacted_hist_route(b),
           "max_abs_err": err, "count_exact": count_exact,
           "grad_hess_close": close,
           "deterministic": bool(torch.equal(hi1, hi2)
                                 and torch.equal(lo1, lo2)),
           "bitwise_vs_cpu_plain": bool(torch.equal(hi1.cpu(), ch)
                                        and torch.equal(lo1.cpu(), cl))}
    check_case(res, f"compacted_hist cnt {count} B {b}", True, skew)

    def baseline(m):
        return m.compacted_hist(bins_d, ghc_d, src_d, cnt_d, b)

    if not timed:
        baseline_bits(torch, res, baseline, (hi1, lo1))
        log(f"compacted_hist {res['shape']}: bitwise the CPU plain "
            "version, deterministic")
        return res
    rows = src_d[:count].long()
    key = (torch.arange(f, device=dev)[:, None] * b
           + bins_d.index_select(1, rows).long()).reshape(-1)
    vals = ghc_d.index_select(1, rows).t()[None].expand(
        f, count, 3).reshape(-1, 3).contiguous()

    def library():
        return torch.zeros(f * b, 3, device=dev).index_add_(0, key, vals)

    res["ms"] = timer(kern, 20)
    res["ms_enqueued"] = timer(kern, 20, sleep=False)
    res["host_us"] = host_us(torch, kern)
    res["plain_ms"] = timer(plain, 3)
    res["library_ms"] = timer(library, 5)
    res["bound_ms"], res["bound_by"] = compacted_bound_ms(
        f, count, bins.element_size(), b)
    log(f"compacted_hist {res['shape']} ({res['route']} route): err "
        f"{err:.3g} count_exact {count_exact} close {close} "
        f"bitwise_vs_cpu_plain {res['bitwise_vs_cpu_plain']} ms "
        f"{res['ms']:.4f} bound {res['bound_ms']:.4f} plain "
        f"{res['plain_ms']:.3f} library {res['library_ms']:.3f} host_us "
        f"{res['host_us']:.1f}")
    del key, vals, rows
    time_baseline(torch, timer, res, baseline, (hi1, lo1))
    del scratch
    return res


COMPACT_SHARES = (0.01, 0.10, 0.50)
# int16 bins past compacted_hist's sorted route (the accumulator route)
WIDE_BINS = 3000


def compact_kernel_cases(torch, hk, timer, rng, n=1 << 20):
    """Both compaction kernels at the bench shape (1,048,576 x 28, 255
    bins): a leaf of about 1%, 10% and 50% of the rows scattered over
    the array (timed), the edge counts 0, 1, 4095, 4096, 4097 and N
    (checked), a 10% leaf whose feature 3 has 90% of its rows in bin 0,
    as a sparse column gives (timed), and int16 bins with a 10% leaf at
    300 bins (the sorted route) and at WIDE_BINS (the accumulator
    route), timed."""
    bins = torch.from_numpy(rng.randint(0, MAX_BIN, size=(N_FEATURES, n))
                            .astype(np.uint8))
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = torch.from_numpy(np.stack([rng.randn(n).astype(np.float32) * inbag,
                                     rng.rand(n).astype(np.float32) * inbag,
                                     inbag]))
    leaf = 7
    other = torch.from_numpy(rng.randint(0, 7, size=n).astype(np.int32))
    compact, hist = [], []
    for share in COMPACT_SHARES:
        row_leaf = torch.where(torch.from_numpy(rng.rand(n) < share),
                               leaf, other).to(torch.int32)
        compact.append(compact_kernel_case(torch, hk, timer, row_leaf, leaf))
        hist.append(compacted_kernel_case(torch, hk, timer, bins, ghc,
                                          row_leaf, leaf, MAX_BIN))
    for cnt in (0, 1, 4095, 4096, 4097, n):
        row_leaf = other.clone()
        row_leaf[torch.from_numpy(rng.choice(n, cnt, replace=False))] = leaf
        compact.append(compact_kernel_case(torch, hk, timer, row_leaf, leaf,
                                           timed=False))
        hist.append(compacted_kernel_case(torch, hk, timer, bins, ghc,
                                          row_leaf, leaf, MAX_BIN,
                                          timed=False))
    row_leaf = torch.where(torch.from_numpy(rng.rand(n) < 0.10), leaf,
                           other).to(torch.int32)
    skewed = bins.clone()
    in_leaf = torch.from_numpy(np.flatnonzero(row_leaf.numpy() == leaf))
    skewed[3, in_leaf[torch.from_numpy(rng.rand(len(in_leaf)) < 0.9)]] = 0
    hist.append(compacted_kernel_case(torch, hk, timer, skewed, ghc,
                                      row_leaf, leaf, MAX_BIN, skew=True))
    del skewed
    for b in (300, WIDE_BINS):
        bins16 = torch.from_numpy(rng.randint(0, b, size=(N_FEATURES, n))
                                  .astype(np.int16))
        hist.append(compacted_kernel_case(torch, hk, timer, bins16, ghc,
                                          row_leaf, leaf, b))
    check(hist[-2]["route"] == "sorted" and hist[-1]["route"] == "accumulator"
          and all(h["route"] == "sorted" for h in hist[:-1]),
          "compacted_hist took another route than its shape names")
    lib = hk._library("compact_hist.cu")
    check(all(lib.compacted_hist_route(b) == (b > hk.COMPACT_SORT_MAX_BINS)
              for b in (1, 255, 300, hk.COMPACT_SORT_MAX_BINS, WIDE_BINS)),
          "the wrapper's route disagrees with the kernel's")
    return compact, hist


# ------------------------------------------------------------------ phases

def train_rounds(torch, lgt, params, ds, rounds, first_score=None,
                 callbacks=()):
    """lightgbm_tpu_torch.train for `rounds` rounds, host ms per round
    (each ends in a device sync); `first_score`, a list, receives the
    train score after the first round; `callbacks` run after the timing
    one."""
    round_ms = []
    marks = [None]

    def timing_cb(env):
        torch.cuda.synchronize()
        now = time.perf_counter()
        round_ms.append(1e3 * (now - marks[0]))
        if first_score is not None and env.iteration == 0:
            first_score.append(env.model.gbdt.get_training_score())
        marks[0] = time.perf_counter()

    timing_cb.order = 0
    marks[0] = time.perf_counter()
    booster = lgt.train(params, ds, rounds, verbose_eval=False,
                        callbacks=[timing_cb, *callbacks])
    torch.cuda.synchronize()
    return booster, round_ms


def memory_mark(torch):
    """Start a peak-memory window: returns the bytes allocated now."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def memory_peak(torch, start):
    """{peak bytes, peak above the window's start} since memory_mark."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_bytes": peak, "peak_above_start_bytes": peak - start}


def phase_main(torch, lgt, hk, ds, y):
    """N_ROUNDS rounds of the bench workload; counts read from zero."""
    mem0 = memory_mark(torch)
    hk.reset_launch_counts()
    booster, round_ms = train_rounds(torch, lgt, BENCH_PARAMS, ds, N_ROUNDS)
    counts = hk.launch_counts()
    memory = memory_peak(torch, mem0)
    gbdt = booster.gbdt
    train_auc = auc(gbdt.get_training_score(), y)
    log(f"main path: per-round ms {[round(v, 1) for v in round_ms]}, "
        f"median {np.median(round_ms):.2f}, train AUC {train_auc:.5f}, "
        f"launches {counts}")
    leaves = [t.num_leaves for t in gbdt.models]
    check(len(gbdt.models) == N_ROUNDS, "training stopped early")
    check(counts["masked_hist"] >= N_ROUNDS * 62,
          f"masked_hist launched {counts['masked_hist']} times")
    check(counts["frontier_hist"] >= N_ROUNDS,
          f"frontier_hist launched {counts['frontier_hist']} times")
    check(train_auc > 0.8, f"train AUC {train_auc} too low")
    return booster, {"round_ms": round_ms,
                     "round_ms_median": float(np.median(round_ms)),
                     "train_auc": train_auc, "launches": counts,
                     "leaves": leaves, "memory": memory}


def builder_syncs(torch, build, args, kwargs):
    """Host syncs inside one tree build. torch.cuda's sync debug mode
    "warn" flags each synchronizing call at the Python line that made
    it; "error" raises at the first one. Returns (syncs: 0 or 1, the
    error's last frames, the warn-mode sites)."""
    import traceback
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            build(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged = sorted({f"{w.filename.split('lightgbm_tpu_torch/')[-1]}:"
                      f"{w.lineno} {str(w.message)[:100]}" for w in caught
                      if "synchron" in str(w.message).lower()
                      and "prototype" not in str(w.message)})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        build(*args, **kwargs)
    except RuntimeError as e:
        if "synchroniz" not in str(e).lower():
            raise
        return 1, [f"{fr.filename.split('lightgbm_tpu_torch/')[-1]}:"
                   f"{fr.lineno} {fr.line}"
                   for fr in traceback.extract_tb(e.__traceback__)[-4:]], flagged
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return 0, [], flagged


def builder_args(torch, booster):
    """A tree build's arguments as the learner gives them (score 0,
    every feature, every row in the bag)."""
    gbdt = booster.gbdt
    learner = gbdt.tree_learner
    n = gbdt.num_data
    g, h = gbdt.objective.get_gradients(torch.zeros(1, n, device=gbdt.device))
    fmask = torch.ones(learner.f_pad, dtype=torch.bool, device=gbdt.device)
    args = (learner.bins, learner._pad(g[0]), learner._pad(h[0]),
            learner._pad(torch.ones(n, device=gbdt.device)), fmask,
            learner.num_bin_pf, learner.is_cat)
    kwargs = {"num_leaves": 63, "max_bin": learner.max_bin,
              "params": learner.params, "max_depth": -1, "cache_hists": True,
              **learner.bundle_hooks()}
    return args, kwargs


def same_first_tree(a, b):
    """(same split features, same thresholds, max leaf rel diff)."""
    same_feat = np.array_equal(a.split_feature, b.split_feature)
    same_thr = np.array_equal(a.threshold_in_bin, b.threshold_in_bin)
    rel = float(np.max(np.abs(a.leaf_value - b.leaf_value)
                       / np.maximum(np.abs(b.leaf_value), 1e-12)))
    return same_feat, same_thr, rel


def phase_plain_tree(torch, hk, booster):
    """Grow the first tree again with the plain histogram functions; the
    same gradients (score 0) and the same feature mask (fraction 1)."""
    gbdt = booster.gbdt
    learner = gbdt.tree_learner
    n = gbdt.num_data
    g, h = gbdt.objective.get_gradients(
        torch.zeros(1, n, device=gbdt.device))
    out = learner.train_device(g[0], h[0], None,
                               masked_fn=hk.masked_hist_plain,
                               frontier_fn=hk.frontier_hist_plain)
    host, _ = learner.fetch(out)
    plain = learner.host_out_to_tree(host, shrink=gbdt.shrinkage_rate)
    same_feat, same_thr, rel = same_first_tree(plain, gbdt.models[0])
    log(f"plain first tree: same features {same_feat}, same thresholds "
        f"{same_thr}, max leaf rel diff {rel:.3g}")
    check(same_feat and same_thr, "plain histograms grew another tree")
    check(rel <= 1e-5, f"leaf values differ by {rel} relative")
    # the builder itself must not wait for the device: grow one more
    # tree with CUDA sync debugging on and count the flagged syncs
    from lightgbm_tpu_torch.models.tree_learner import build_tree_device
    args, kwargs = builder_args(torch, booster)
    syncs, sites, flagged = builder_syncs(torch, build_tree_device, args,
                                          kwargs)
    log(f"host syncs inside one tree build (error mode): {syncs} {sites}; "
        f"warn-mode messages: {flagged}")
    check(syncs == 0, f"the tree builder waits for the device at {sites}")
    return {"same_features": bool(same_feat), "same_thresholds": bool(same_thr),
            "leaf_rel_diff": rel, "builder_syncs": syncs,
            "builder_sync_sites": sites, "warn_messages": flagged}


def phase_profile(torch, booster):
    """Where one tree build's time goes: torch.profiler over one build
    plus its fetch; device busy time = the sum of CUDA kernel times."""
    from torch.profiler import ProfilerActivity, profile
    gbdt = booster.gbdt
    learner = gbdt.tree_learner
    g, h = gbdt.objective.get_gradients(
        torch.zeros(1, gbdt.num_data, device=gbdt.device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.fetch(learner.train_device(g[0], h[0]))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(evt.name, [0, 0.0])
            kernels[evt.name][0] += 1
            kernels[evt.name][1] += evt.device_time_total / 1e3
    check(kernels, "the profiler recorded no device kernel")
    busy_ms = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    res = {"tree_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
           "device_launches": sum(v[0] for v in kernels.values()),
           "top_kernels": [{"name": k[:80], "calls": v[0], "ms": v[1]}
                           for k, v in top]}
    log(f"one tree build ({'partitioned' if learner.use_partitioned else 'masked'}): "
        f"wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} "
        f"ms over {res['device_launches']} device ops; top "
        f"{[(t['name'][:40], t['calls'], round(t['ms'], 3)) for t in res['top_kernels'][:4]]}")
    return res


def check_predict(torch, booster, xp, what):
    """Booster.predict on the device path (device_predict=true: below
    device_predict_cells it would take the host path) against the host
    float64 traversal of the saved model text."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    booster.gbdt.device_predict = "true"
    t0 = time.perf_counter()
    pred = booster.predict(xp)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    booster.gbdt.device_predict = "auto"
    host = GBDT(device="cpu")
    host.load_model_from_string(booster.model_to_string())
    raw = sum(t.predict(xp.astype(np.float64)) for t in host.models)
    want = 1.0 / (1.0 + np.exp(-2.0 * host.sigmoid * raw))
    err = float(np.max(np.abs(pred - want)))
    log(f"{what}: predict {len(xp)} rows {ms:.1f} ms, max |device - host| "
        f"{err:.3g}")
    check(pred.shape == (len(xp),) and np.all(np.isfinite(pred)),
          f"{what}: predictions not finite or of the wrong shape")
    check(err <= 1e-5,
          f"{what}: device predict differs from host traversal by {err}")
    return {"predict_ms": ms, "max_abs_err": err}


def phase_predict(torch, booster, x):
    """Booster.predict on 100k rows against the host traversal."""
    return check_predict(torch, booster, x[:100_000], "main path")


def phase_cacheless(torch, lgt, hk, ds, main_booster):
    """2 rounds with histogram_pool_size below the (63, 28, 255, 3) f32
    cache (5.4 MB): both children from one frontier pass, L = 2."""
    params = dict(BENCH_PARAMS, histogram_pool_size=1)
    hk.reset_launch_counts()
    booster = lgt.train(params, ds, 2, verbose_eval=False)
    torch.cuda.synchronize()
    counts = hk.launch_counts()
    same = np.array_equal(booster.gbdt.models[0].split_feature,
                          main_booster.gbdt.models[0].split_feature)
    log(f"cache-less run: launches {counts}, first tree features equal to "
        f"the cached run's: {same}")
    check(not booster.gbdt.tree_learner.cache_hists, "cache was not off")
    check(counts["frontier_hist"] >= 2 * 63,
          f"frontier_hist launched {counts['frontier_hist']} times")
    return {"launches": counts, "first_tree_features_equal": bool(same)}


def phase_partitioned(torch, lgt, hk, ds, y, main_booster):
    """The bench workload through the leaf-contiguous builder: 10
    rounds, counts read from zero; its first tree against the masked
    path's (the JAX package's builder-parity contract,
    tests/test_partitioned.py:151-156)."""
    params = dict(BENCH_PARAMS, partitioned_build="true")
    mem0 = memory_mark(torch)
    hk.reset_launch_counts()
    booster, round_ms = train_rounds(torch, lgt, params, ds, N_ROUNDS)
    counts = hk.launch_counts()
    memory = memory_peak(torch, mem0)
    gbdt = booster.gbdt
    train_auc = auc(gbdt.get_training_score(), y)
    same_feat, same_thr, rel = same_first_tree(
        gbdt.models[0], main_booster.gbdt.models[0])
    log(f"partitioned path: per-round ms {[round(v, 1) for v in round_ms]}, "
        f"median {np.median(round_ms):.2f}, train AUC {train_auc:.5f}, "
        f"launches {counts}; first tree vs masked: same features "
        f"{same_feat}, same thresholds {same_thr}, max leaf rel diff {rel:.3g}")
    check(gbdt.tree_learner.use_partitioned, "the partitioned builder is off")
    check(len(gbdt.models) == N_ROUNDS, "training stopped early")
    check(counts["seg_hist"] >= N_ROUNDS * 63,
          f"seg_hist launched {counts['seg_hist']} times")
    check(counts["masked_hist"] == 0 and counts["frontier_hist"] == 0,
          f"the partitioned path launched masked kernels: {counts}")
    check(train_auc > 0.8, f"train AUC {train_auc} too low")
    check(same_feat and same_thr,
          "the partitioned first tree differs from the masked one")
    check(rel <= 1e-4, f"first-tree leaf values differ by {rel} relative")
    return booster, {"memory": memory, "round_ms": round_ms,
                     "round_ms_median": float(np.median(round_ms)),
                     "train_auc": train_auc, "launches": counts,
                     "first_tree_same_features": bool(same_feat),
                     "first_tree_same_thresholds": bool(same_thr),
                     "first_tree_leaf_rel_diff": rel}


def phase_partitioned_syncs(torch, booster):
    """No host sync inside build_tree_partitioned."""
    from lightgbm_tpu_torch.models.partitioned import build_tree_partitioned
    args, kwargs = builder_args(torch, booster)
    syncs, sites, flagged = builder_syncs(torch, build_tree_partitioned,
                                          args, kwargs)
    log(f"host syncs inside one partitioned tree build (error mode): "
        f"{syncs} {sites}; warn-mode sites: {flagged}")
    check(syncs == 0, f"build_tree_partitioned waits for the device at {sites}")
    return {"builder_syncs": syncs, "builder_sync_sites": sites,
            "warn_messages": flagged}


def phase_partitioned_cacheless(torch, lgt, hk, ds):
    """2 cache-less partitioned rounds: both children from two segment
    calls at every split."""
    params = dict(BENCH_PARAMS, partitioned_build="true",
                  histogram_pool_size=1)
    hk.reset_launch_counts()
    booster = lgt.train(params, ds, 2, verbose_eval=False)
    torch.cuda.synchronize()
    counts = hk.launch_counts()
    log(f"cache-less partitioned run: launches {counts}")
    check(not booster.gbdt.tree_learner.cache_hists, "cache was not off")
    check(counts["seg_hist"] >= 2 * (1 + 2 * 62),
          f"seg_hist launched {counts['seg_hist']} times")
    return {"launches": counts}


def phase_categorical(torch, lgt, seed):
    """4 categorical columns beside the bench matrix, CATEGORICAL_ROUNDS
    rounds with each builder."""
    x, y = make_data(N_ROWS, seed, n_cat=N_CAT)
    cats = list(range(N_FEATURES, N_FEATURES + N_CAT))
    ds = lgt.Dataset(x, y, categorical_feature=cats)
    res, boosters = {}, {}
    for build in ("false", "true"):
        booster = lgt.train(dict(BENCH_PARAMS, partitioned_build=build), ds,
                            CATEGORICAL_ROUNDS, verbose_eval=False)
        torch.cuda.synchronize()
        n_cat_splits = sum(int((t.decision_type == 1).sum())
                           for t in booster.gbdt.models)
        name = "partitioned" if build == "true" else "masked"
        check(booster.gbdt.tree_learner.use_partitioned == (build == "true"),
              f"categorical {name}: wrong builder")
        check(n_cat_splits > 0, f"categorical {name}: no categorical split")
        boosters[name] = booster
        res[name] = {"categorical_splits": n_cat_splits,
                     **check_predict(torch, booster, x[:100_000],
                                     f"categorical {name}")}
    same_feat, same_thr, rel = same_first_tree(
        boosters["partitioned"].gbdt.models[0],
        boosters["masked"].gbdt.models[0])
    log(f"categorical: splits {res['masked']['categorical_splits']} (masked) "
        f"{res['partitioned']['categorical_splits']} (partitioned); first "
        f"trees same features {same_feat}, thresholds {same_thr}, leaf rel "
        f"diff {rel:.3g}")
    check(same_feat and same_thr and rel <= 1e-4,
          "categorical: the two builders grew different first trees")
    res["first_tree_leaf_rel_diff"] = rel
    return res, boosters["masked"], x


def fused_runner(booster):
    """The booster's fused block runner (GBDT._get_fused_fn's cache)."""
    runners = list(booster.gbdt._fused_cache.values())
    check(len(runners) == 1, f"{len(runners)} fused runners, not one")
    return runners[0]


def same_trees(a, b):
    """(model text equal, splits and thresholds equal in every tree, max
    leaf rel diff): the JAX package's fused-vs-sequential contract
    (tests/test_core_training.py:167-199) is splits and thresholds
    exact, leaf values within rtol 1e-4."""
    ta, tb = a.gbdt.models, b.gbdt.models
    splits = len(ta) == len(tb) and all(
        np.array_equal(x.split_feature, y.split_feature)
        and np.array_equal(x.threshold_in_bin, y.threshold_in_bin)
        for x, y in zip(ta, tb))
    rel = max([float(np.max(np.abs(x.leaf_value - y.leaf_value)
                            / np.maximum(np.abs(y.leaf_value), 1e-12)))
               for x, y in zip(ta, tb)] + [0.0])
    return a.model_to_string() == b.model_to_string(), splits, rel


def transfer_line():
    """gbdt.py's line of the fused block's one device -> host transfer,
    the only sync a block may make."""
    from lightgbm_tpu_torch.models import gbdt
    with open(gbdt.__file__) as f:
        for i, line in enumerate(f, 1):
            if "ONE transfer a block" in line:
                return f"models/gbdt.py:{i}"
    raise PhaseError("the fused block's transfer line was not found")


def sync_sites(torch, fn):
    """Every host sync `fn` makes, as file:line, from torch.cuda's sync
    debug mode "warn"."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({f"{w.filename.split('lightgbm_tpu_torch/')[-1]}:{w.lineno}"
                   for w in caught if "synchron" in str(w.message).lower()
                   and "prototype" not in str(w.message)})


# device kernels of the histogram engines: the chunk partials and the
# fold (chunk_hist.cuh), the compaction (compact.cu) and the compacted
# histogram's sorted route (compact_hist.cu)
HIST_KERNEL_NAMES = ("chunk_partials", "kahan_fold", "compact_lookback",
                     "gather_sort_hist")


def profile_replay(torch, runner, reps=5):
    """One replayed iteration under torch.profiler: device busy = the sum
    of its kernels' device times, device span = first kernel start to
    last kernel end, idle share = 1 - busy / span. Then `reps` replays
    without the profiler, each timed with CUDA events (the profiler's
    tracing of 17k kernels slows the replay itself)."""
    from torch.profiler import ProfilerActivity, profile
    runner.counter.zero_()     # a replay reads and writes row 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    check(kernels, "the profiler recorded no device kernel in a replay")
    busy = sum(e.device_time_total for e in kernels) / 1e3
    span = ((max(e.time_range.end for e in kernels)
             - min(e.time_range.start for e in kernels)) / 1e3
            if kernels else 0.0)
    times = []
    for _ in range(reps):
        runner.counter.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        runner.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    hist_ms = sum(e.device_time_total for e in kernels
                  if any(k in e.name for k in HIST_KERNEL_NAMES)) / 1e3
    return {"device_ops": len(kernels),
            "hist_kernel_launches": {k: sum(k in e.name for e in kernels)
                                     for k in HIST_KERNEL_NAMES},
            "device_busy_ms": busy if kernels else None,
            "hist_ms": hist_ms, "hist_share": hist_ms / busy if busy else None,
            "device_span_ms": span if kernels else None,
            "device_idle_share": (1.0 - busy / span) if span else None,
            "replay_event_ms": float(np.median(times)),
            "replay_event_ms_all": times}


def phase_fused(torch, lgt, hk, ds, y, per_iter, per_iter_res, params,
                name):
    """The fused trainer on the bench workload: lgt.train with no
    callbacks (the fast path: one block of N_ROUNDS replays of a captured
    iteration), counts read from zero; its model against the
    per-iteration phase's; then, on a booster of its own, the capture
    timed (warm_up_fused), three blocks of N_ROUNDS timed, the block's host
    syncs listed, and one replay profiled."""
    mem0 = memory_mark(torch)
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    booster = lgt.train(params, ds, N_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = hk.launch_counts()
    memory = memory_peak(torch, mem0)
    runner = fused_runner(booster)
    per_replay = dict(runner.graph.launches) if runner.graph else {}
    text_equal, splits_equal, rel = same_trees(booster, per_iter)
    train_auc = auc(booster.gbdt.get_training_score(), y)
    setup_s = runner.warm_step_s + runner.capture_s
    res = {"train_s": train_s, "warm_step_s": runner.warm_step_s,
           "capture_s": runner.capture_s,
           "train_ms_per_round_without_capture":
               1e3 * (train_s - setup_s) / N_ROUNDS,
           "launches": counts, "launches_per_replay": per_replay,
           "model_text_equal": text_equal, "splits_equal": splits_equal,
           "leaf_rel_diff": rel, "train_auc": train_auc, "memory": memory,
           "memory_per_iteration": per_iter_res["memory"]}
    log(f"fused {name}: train {train_s:.3f} s (warm-up step "
        f"{runner.warm_step_s:.3f} s, capture {runner.capture_s:.3f} s), "
        f"launches {counts} ({per_replay} a replay), model text equal "
        f"to the per-iteration one {text_equal} (splits {splits_equal}, leaf "
        f"rel diff {rel:.3g}), AUC {train_auc:.5f}, peak above start "
        f"{memory['peak_above_start_bytes'] / 2**20:.1f} MiB (per-iteration "
        f"{per_iter_res['memory']['peak_above_start_bytes'] / 2**20:.1f})")
    check(runner.graph is not None, f"fused {name}: no graph was captured")
    check(len(booster.gbdt.models) == N_ROUNDS, f"fused {name}: stopped early")
    # the warm-up step launches what one replay does: every other launch
    # was counted through the replays
    for kname, c in per_replay.items():
        check(counts[kname] == (N_ROUNDS + 1) * c,
              f"fused {name}: {kname} counted {counts[kname]}, not "
              f"{N_ROUNDS + 1} x {c}")
    if params.get("partitioned_build") == "true":
        check(counts["seg_hist"] >= N_ROUNDS * 63,
              f"fused {name}: seg_hist launched {counts['seg_hist']} times")
    elif booster.gbdt.tree_learner.use_compact:
        check(counts["compacted_hist"] >= N_ROUNDS * 62
              and counts["compact_rows"] == counts["compacted_hist"]
              and counts["masked_hist"] == 0,
              f"fused {name}: compaction kernels launched {counts}")
        check(counts["frontier_hist"] >= N_ROUNDS,
              f"fused {name}: frontier_hist launched "
              f"{counts['frontier_hist']}")
    else:
        check(counts["masked_hist"] >= N_ROUNDS * 62,
              f"fused {name}: masked_hist launched {counts['masked_hist']}")
        check(counts["frontier_hist"] >= N_ROUNDS,
              f"fused {name}: frontier_hist launched "
              f"{counts['frontier_hist']}")
    check(splits_equal and rel <= 1e-4,
          f"fused {name}: trees differ from the per-iteration ones")
    check(train_auc > 0.8, f"fused {name}: train AUC {train_auc} too low")
    check(memory["peak_above_start_bytes"]
          <= 2 * per_iter_res["memory"]["peak_above_start_bytes"],
          f"fused {name}: peak memory above 2x the per-iteration phase's")
    del booster, runner

    # timing on a booster of its own: capture excluded, as bench.py
    # excludes compilation
    booster = lgt.Booster(params, ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(booster.gbdt.warm_up_fused(N_ROUNDS), f"fused {name}: not eligible")
    torch.cuda.synchronize()
    res["warm_up_s"] = time.perf_counter() - t0
    runner = fused_runner(booster)
    res["timed_warm_step_s"] = runner.warm_step_s
    res["timed_capture_s"] = runner.capture_s
    block_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.gbdt.train_many(N_ROUNDS)
        torch.cuda.synchronize()
        block_ms.append(1e3 * (time.perf_counter() - t0))
    res["block_ms"] = block_ms
    res["round_ms_median"] = float(np.median(block_ms)) / N_ROUNDS
    allowed = transfer_line()
    sites = sync_sites(torch, lambda: booster.gbdt.train_many(N_ROUNDS))
    res["block_sync_sites"] = sites
    res["profile"] = profile_replay(torch, fused_runner(booster))
    prof = res["profile"]
    log(f"fused {name}: warm_up_fused {res['warm_up_s']:.3f} s (warm-up "
        f"step {runner.warm_step_s:.3f} s, capture {runner.capture_s:.3f} s); "
        f"blocks of "
        f"{N_ROUNDS} {[round(v, 1) for v in block_ms]} ms, round median "
        f"{res['round_ms_median']:.2f} ms (per-iteration "
        f"{per_iter_res['round_ms_median']:.2f}); syncs in a block {sites}; "
        f"one replay profiled: device busy {prof['device_busy_ms']} ms over "
        f"{prof['device_ops']} ops in a span of {prof['device_span_ms']} ms, "
        f"idle share {prof['device_idle_share']}, histograms "
        f"{prof['hist_ms']:.2f} ms; unprofiled replays "
        f"{[round(v, 2) for v in prof['replay_event_ms_all']]} ms (events)")
    check(sites == [allowed],
          f"fused {name}: host syncs inside a block at {sites} (only "
          f"{allowed} may sync)")
    return res


SAMPLED_ROUNDS = 4
SAMPLING = {"bagging_fraction": 0.7, "bagging_freq": 2,
            "feature_fraction": 0.75}


def phase_fused_sampled(torch, lgt, ds):
    """The fused trainer with bagging (0.7, a new bag every 2 rounds) and
    feature_fraction 0.75, on the masked, partitioned and cache-less
    masked builders, 4 rounds each: the bag copied into the graph's
    static in-bag buffer between replays, each tree's feature mask read
    in the graph by the device counter. The model text must equal the
    per-iteration loop's byte for byte, and a second block may sync the
    host only at its one transfer (the bag's on-device randperm
    included)."""
    allowed = transfer_line()
    res = {}
    for name, extra in (("masked", {}),
                        ("partitioned", {"partitioned_build": "true"}),
                        ("cacheless", {"histogram_pool_size": 1}),
                        ("compacted", {"hist_compaction": "auto"})):
        params = dict(BENCH_PARAMS, **SAMPLING, **extra)
        loop = lgt.train(params, ds, SAMPLED_ROUNDS, verbose_eval=False,
                         callbacks=[lambda env: None])
        booster = lgt.train(params, ds, SAMPLED_ROUNDS, verbose_eval=False)
        torch.cuda.synchronize()
        runner = fused_runner(booster)
        check(len(booster.gbdt.models) == SAMPLED_ROUNDS,
              f"fused sampled {name}: stopped early")
        text_equal, splits_equal, rel = same_trees(booster, loop)
        sites = sync_sites(
            torch, lambda: booster.gbdt.train_many(SAMPLED_ROUNDS))
        res[name] = {"model_text_equal": text_equal,
                     "splits_equal": splits_equal, "leaf_rel_diff": rel,
                     "block_sync_sites": sites,
                     "launches_per_replay": dict(runner.graph.launches)
                     if runner.graph else {}}
        log(f"fused sampled {name}: model text equal to the per-iteration "
            f"one {text_equal} (splits {splits_equal}, leaf rel diff "
            f"{rel:.3g}); syncs in a block {sites}; "
            f"{res[name]['launches_per_replay']} a replay")
        check(runner.graph is not None,
              f"fused sampled {name}: no graph was captured")
        check(booster.gbdt.tree_learner.cache_hists is (name != "cacheless"),
              f"fused sampled {name}: the histogram cache is not as asked")
        check(booster.gbdt.tree_learner.use_compact is (name == "compacted"),
              f"fused sampled {name}: the compacted engine is not as asked")
        check(text_equal, f"fused sampled {name}: the model text differs "
              "from the per-iteration loop's")
        check(sites == [allowed],
              f"fused sampled {name}: host syncs inside a block at {sites} "
              f"(only {allowed} may sync)")
        del booster, loop, runner
    return res


COMPACT_PARAMS = dict(BENCH_PARAMS, hist_compaction="auto")
# 2 rounds (3 before the gang and telemetry phases came): the run's time
MC_COMPACT_ROUNDS = 2


def compacted_plain_tree(torch, hk, booster):
    """The compacted booster's first tree grown again with every engine's
    plain version (compact_rows_plain + compacted_hist_plain on the
    learner's shapes), and one tree build under sync debugging."""
    gbdt = booster.gbdt
    learner = gbdt.tree_learner
    dev = gbdt.device
    g, h = gbdt.objective.get_gradients(
        torch.zeros(1, gbdt.num_data, device=dev))
    src = torch.empty(learner.n_pad, dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)

    def compacted_plain(bins, ghc_t, row_leaf, leaf_id, b):
        hk.compact_rows_plain(row_leaf, leaf_id, src, cnt)
        return hk.compacted_hist_plain(bins, ghc_t, src, cnt, b)

    out = learner.train_device(g[0], h[0], None,
                               masked_fn=hk.masked_hist_plain,
                               frontier_fn=hk.frontier_hist_plain,
                               compacted_fn=compacted_plain)
    host, _ = learner.fetch(out)
    plain = learner.host_out_to_tree(host, shrink=gbdt.shrinkage_rate)
    same_feat, same_thr, rel = same_first_tree(plain, gbdt.models[0])
    from lightgbm_tpu_torch.models.tree_learner import build_tree_device
    args, kwargs = builder_args(torch, booster)
    kwargs.update(compact_hist=True, compacted_fn=learner.compacted_fn)
    syncs, sites, flagged = builder_syncs(torch, build_tree_device, args,
                                          kwargs)
    log(f"compacted plain first tree: same features {same_feat}, same "
        f"thresholds {same_thr}, max leaf rel diff {rel:.3g}; host syncs "
        f"inside one compacted tree build (error mode): {syncs} {sites}; "
        f"warn-mode messages: {flagged}")
    check(same_feat and same_thr, "compacted: plain histograms grew another "
          "tree")
    check(rel <= 1e-5, f"compacted: plain leaf values differ by {rel}")
    check(syncs == 0, f"the compacted tree builder waits for the device at "
          f"{sites}")
    return {"same_features": bool(same_feat),
            "same_thresholds": bool(same_thr), "leaf_rel_diff": rel,
            "builder_syncs": syncs, "builder_sync_sites": sites}


def compacted_multiclass(torch, lgt, hk, ds_bench, logit):
    """5 classes, MC_COMPACT_ROUNDS rounds per-iteration and fused on the
    compacted engine: K builds a replay, text equal, launches through the
    replays, one replay profiled."""
    ds = bench_subset(ds_bench, label=multiclass_labels(logit))
    params = dict(MC_PARAMS, hist_compaction="auto")
    t0 = time.perf_counter()
    loop = lgt.train(params, ds, MC_COMPACT_ROUNDS, verbose_eval=False,
                     callbacks=[lambda env: None])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    fused = lgt.train(params, ds, MC_COMPACT_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = hk.launch_counts()
    runner = fused_runner(fused)
    check(runner.graph is not None, "compacted multiclass: no graph")
    per_replay = dict(runner.graph.launches)
    text_equal, splits_equal, rel = same_trees(fused, loop)
    setup_s = runner.warm_step_s + runner.capture_s
    res = {"per_iteration_round_ms": 1e3 * loop_s / MC_COMPACT_ROUNDS,
           "train_s": train_s, "warm_step_s": runner.warm_step_s,
           "capture_s": runner.capture_s,
           "round_ms": 1e3 * (train_s - setup_s) / MC_COMPACT_ROUNDS,
           "launches": counts, "launches_per_replay": per_replay,
           "model_text_equal": text_equal, "splits_equal": splits_equal,
           "leaf_rel_diff": rel, "profile": profile_replay(torch, runner)}
    prof = res["profile"]
    log(f"compacted multiclass: per-iteration {res['per_iteration_round_ms']:.1f}"
        f" ms a round, fused {res['round_ms']:.1f} ms (setup {setup_s:.2f} s), "
        f"launches {counts} ({per_replay} a replay), text equal "
        f"{text_equal}; one replay busy {prof['device_busy_ms']} ms over "
        f"{prof['device_ops']} ops, histograms {prof['hist_ms']:.2f} ms, "
        f"idle share {prof['device_idle_share']}")
    check(fused.gbdt.tree_learner.use_compact,
          "compacted multiclass: auto did not resolve to the compacted engine")
    check(len(fused.gbdt.models) == MC_COMPACT_ROUNDS * MC_CLASSES,
          "compacted multiclass: stopped early")
    check(per_replay.get("compacted_hist", 0) >= MC_CLASSES * 62
          and per_replay.get("compact_rows") == per_replay["compacted_hist"]
          and not per_replay.get("masked_hist"),
          f"compacted multiclass: a replay launches {per_replay}")
    for kname, c in per_replay.items():
        check(counts[kname] == (MC_COMPACT_ROUNDS + 1) * c,
              f"compacted multiclass: {kname} counted {counts[kname]}, not "
              f"{MC_COMPACT_ROUNDS + 1} x {c}")
    check(text_equal, "compacted multiclass: the fused model text differs "
          "from the per-iteration one")
    return res


def smaller_child_counts(tree):
    """Rows of the smaller child of each split of `tree` (its internal and
    leaf counts): what the compacted engine histograms at that split."""
    def rows(child):
        return int(tree.internal_count[child] if child >= 0
                   else tree.leaf_count[~child])
    return [min(rows(tree.left_child[i]), rows(tree.right_child[i]))
            for i in range(tree.num_leaves - 1)]


def real_tree_cases(torch, hk, booster, leaf=7, reps=10):
    """compact_rows and compacted_hist at the smaller-child counts of the
    booster's first tree, on its own bins (the learner's (F, N_pad)
    matrix) and first-round statistics, each count's rows at random
    positions: each call against its plain version on the CPU (the
    compaction over the whole array; the histogram over the count's
    gathered rows, which is the same function), timed (median of `reps`
    with CUDA events, L2 flushed) beside its bound, and with --baseline
    the other checkout's kernels on the same inputs (same bits, both
    times). Prints the sums over the tree."""
    timer = Timer(torch)
    gbdt = booster.gbdt
    learner = gbdt.tree_learner
    bins = learner.bins
    f, n = bins.shape
    b = learner.max_bin
    g, h = gbdt.objective.get_gradients(
        torch.zeros(1, gbdt.num_data, device=DEVICE))
    ghc = torch.zeros(3, n, device=DEVICE)
    ghc[0, :gbdt.num_data], ghc[1, :gbdt.num_data] = g[0], h[0]
    ghc[2, :gbdt.num_data] = 1.0
    bins_cpu, ghc_cpu = bins.cpu(), ghc.cpu()
    counts = smaller_child_counts(gbdt.models[0])
    scratch = hk.CompactScratch(bins, b)
    lid = torch.tensor([leaf], dtype=torch.int32, device=DEVICE)
    src = torch.empty(n, dtype=torch.int32, device=DEVICE)
    cnt = torch.empty(1, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    sums = {"compact_rows_ms": 0.0, "compacted_hist_ms": 0.0,
            "compact_rows_bound_ms": 0.0, "compacted_hist_bound_ms": 0.0}
    if BASELINE is not None:
        sums.update(baseline_compact_rows_ms=0.0,
                    baseline_compacted_hist_ms=0.0)
    t0 = time.time()
    for c in counts:
        row_leaf = torch.zeros(n, dtype=torch.int32, device=DEVICE)
        row_leaf[torch.randperm(gbdt.num_data, device=DEVICE,
                                generator=gen)[:c]] = leaf

        def compact(m=hk):
            return m.compact_rows(row_leaf, lid, src, cnt,
                                  **({"flags": scratch.flags} if m is hk
                                     else {}))

        def hist(m=hk):
            return m.compacted_hist(bins, ghc, src, cnt, b,
                                    **(scratch.hist_kwargs() if m is hk
                                       else {}))

        compact()
        hi, lo = hist()
        torch.cuda.synchronize()
        want_src, want_cnt = hk.compact_rows_plain(
            row_leaf.cpu(), lid.cpu(), torch.empty(n, dtype=torch.int32),
            torch.empty(1, dtype=torch.int32))
        check(torch.equal(src.cpu(), want_src)
              and torch.equal(cnt.cpu(), want_cnt),
              f"real tree count {c}: compact_rows differs from its plain "
              "version")
        # the histogram's plain version over the gathered rows only
        pad = max(-(-c // hk.HIST_CHUNK), 1) * hk.HIST_CHUNK
        rows = want_src[:c].long()
        small_src = torch.full((pad,), pad, dtype=torch.int32)
        small_src[:c] = torch.arange(c, dtype=torch.int32)
        small_bins = torch.zeros((f, pad), dtype=bins.dtype)
        small_bins[:, :c] = bins_cpu[:, rows]
        small_ghc = torch.zeros((3, pad))
        small_ghc[:, :c] = ghc_cpu[:, rows]
        ch, cl = hk.compacted_hist_plain(small_bins, small_ghc, small_src,
                                         want_cnt, b)
        check(torch.equal(hi.cpu(), ch) and torch.equal(lo.cpu(), cl),
              f"real tree count {c}: compacted_hist differs in bits from "
              "its plain version")
        sums["compact_rows_ms"] += timer(compact, reps)
        sums["compacted_hist_ms"] += timer(hist, reps)
        sums["compact_rows_bound_ms"] += compact_bound_ms(n)[0]
        sums["compacted_hist_bound_ms"] += compacted_bound_ms(
            f, c, bins.element_size(), b)[0]
        if BASELINE is not None:
            base = BASELINE.hist_kernels
            compact(base)
            bhi, blo = hist(base)
            torch.cuda.synchronize()
            check(torch.equal(bhi, hi) and torch.equal(blo, lo),
                  f"real tree count {c}: the baseline gave other bits")
            sums["baseline_compact_rows_ms"] += timer(lambda: compact(base),
                                                      reps)
            sums["baseline_compacted_hist_ms"] += timer(lambda: hist(base),
                                                        reps)
    res = {"counts": counts, "rows": int(sum(counts)), **sums,
           "seconds": time.time() - t0}
    log(f"real tree (first compacted tree, {len(counts)} smaller children, "
        f"{res['rows']} rows, median {int(np.median(counts))}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
        + f"; {res['seconds']:.1f} s")
    return res


def phase_compacted(torch, lgt, hk, ds, y, logit, main_booster, main_fused):
    """The gather-compacted engine (hist_compaction=auto, which resolves
    to it above 4,096 rows, as in the reference off the TPU): N_ROUNDS
    rounds per-iteration with counts read from zero, its first tree
    against the masked phase's (within 1e-4) and against the plain
    engines', no host sync in a build; 2 cache-less rounds (two compacted
    passes a split); the fused trainer (phase_fused: text, launches
    through the replays, blocks timed, a replay profiled) beside the
    masked phase's fused round; 5-class multiclass fused."""
    res = {}
    mem0 = memory_mark(torch)
    hk.reset_launch_counts()
    booster, round_ms = train_rounds(torch, lgt, COMPACT_PARAMS, ds, N_ROUNDS)
    counts = hk.launch_counts()
    memory = memory_peak(torch, mem0)
    gbdt = booster.gbdt
    train_auc = auc(gbdt.get_training_score(), y)
    same_feat, same_thr, rel = same_first_tree(gbdt.models[0],
                                               main_booster.gbdt.models[0])
    res["per_iteration"] = {
        "round_ms": round_ms, "round_ms_median": float(np.median(round_ms)),
        "train_auc": train_auc, "launches": counts, "memory": memory,
        "first_tree_same_features": bool(same_feat),
        "first_tree_same_thresholds": bool(same_thr),
        "first_tree_leaf_rel_diff": rel}
    log(f"compacted path: per-round ms {[round(v, 1) for v in round_ms]}, "
        f"median {np.median(round_ms):.2f}, train AUC {train_auc:.5f}, "
        f"launches {counts}; first tree vs masked: same features "
        f"{same_feat}, same thresholds {same_thr}, max leaf rel diff {rel:.3g}")
    check(gbdt.tree_learner.use_compact,
          "compacted: auto did not resolve to the compacted engine")
    check(len(gbdt.models) == N_ROUNDS, "compacted: training stopped early")
    check(counts["compacted_hist"] >= N_ROUNDS * 62
          and counts["compact_rows"] == counts["compacted_hist"]
          and counts["frontier_hist"] >= N_ROUNDS
          and counts["masked_hist"] == 0,
          f"compacted: kernels launched {counts}")
    check(train_auc > 0.8, f"compacted: train AUC {train_auc} too low")
    check(same_feat and same_thr and rel <= 1e-4,
          "compacted: the first tree differs from the masked engine's")
    res["plain_tree"] = compacted_plain_tree(torch, hk, booster)

    hk.reset_launch_counts()
    cacheless = lgt.train(dict(COMPACT_PARAMS, histogram_pool_size=1), ds, 2,
                          verbose_eval=False)
    torch.cuda.synchronize()
    counts = hk.launch_counts()
    res["cacheless"] = {"launches": counts}
    log(f"compacted cache-less run: launches {counts}")
    check(not cacheless.gbdt.tree_learner.cache_hists
          and cacheless.gbdt.tree_learner.use_compact,
          "compacted cache-less: cache on or compaction off")
    check(counts["compacted_hist"] >= 2 * 2 * 62
          and counts["frontier_hist"] >= 2,
          f"compacted cache-less: kernels launched {counts}")
    del cacheless

    res["real_tree"] = real_tree_cases(torch, hk, booster)
    res["fused"] = phase_fused(torch, lgt, hk, ds, y, booster,
                               res["per_iteration"], COMPACT_PARAMS,
                               "compacted")
    # one device launch a call: compact_lookback a compact_rows,
    # gather_sort_hist a compacted_hist (partials and fold), and the
    # chunk accumulator and its fold only for the root's frontier pass
    per_replay = res["fused"]["launches_per_replay"]
    seen = res["fused"]["profile"]["hist_kernel_launches"]
    log(f"compacted replay, device launches by name: {seen}")
    check(seen == {"compact_lookback": per_replay["compact_rows"],
                   "gather_sort_hist": per_replay["compacted_hist"],
                   "chunk_partials": per_replay["frontier_hist"],
                   "kahan_fold": per_replay["frontier_hist"]},
          f"compacted: a replay launched {seen} for {per_replay}")
    masked_ms = main_fused["round_ms_median"]
    res["fused_vs_masked_round"] = {
        "compacted_ms": res["fused"]["round_ms_median"],
        "masked_ms": masked_ms,
        "compacted_busy_ms": res["fused"]["profile"]["device_busy_ms"],
        "masked_busy_ms": main_fused["profile"]["device_busy_ms"],
        "compacted_hist_ms": res["fused"]["profile"]["hist_ms"],
        "masked_hist_ms": main_fused["profile"]["hist_ms"]}
    log(f"fused round, compacted against masked (this run): "
        f"{res['fused_vs_masked_round']}")
    del booster
    res["multiclass"] = compacted_multiclass(torch, lgt, hk, ds, logit)
    return res


# the Flight-Delay-shaped table of the LightGBM EFB evaluation (Ke et
# al., NIPS 2017, table 1): 700 features, 696 of them the one-hot
# columns of these categorical blocks, and 4 dense ones
FLIGHT_BLOCKS = (12, 31, 7, 24, 22, 300, 300)
FLIGHT_DENSE = 4
# default parameters (is_enable_sparse true, hist_compaction auto), 63
# leaves
BUNDLED_PARAMS = {"objective": "binary", "num_leaves": 63, "verbose": 0}
BUNDLED_MAX_STORED = 20


def make_flight_data(n, seed):
    """(x, y): one-hot blocks of FLIGHT_BLOCKS (a uniform category each
    row), FLIGHT_DENSE Gaussian columns, and a binary label from a
    linear logit (a random weight per category and per dense column)
    plus noise, cut at its median."""
    rng = np.random.RandomState(seed + 7)
    f = sum(FLIGHT_BLOCKS) + FLIGHT_DENSE
    x = np.zeros((n, f), np.float32)
    logit = 0.5 * rng.randn(n)
    rows = np.arange(n)
    off = 0
    for w in FLIGHT_BLOCKS:
        cat = rng.randint(0, w, n)
        x[rows, off + cat] = 1.0
        logit += rng.randn(w)[cat]
        off += w
    dense = rng.randn(n, FLIGHT_DENSE)
    x[:, off:] = dense
    logit += dense @ rng.randn(FLIGHT_DENSE)
    return x, (logit > np.median(logit)).astype(np.float32)


def first_tree_vs_unbundled(a, b):
    """The bundled first tree `a` against the unbundled one `b`, split by
    split in split order. At the first split where they part (bin 0 of
    a bundled histogram comes from a subtraction, so a near-tie may go
    either way) both chosen gains are returned; the trees agree when no
    split parts, and then their leaf values are compared."""
    n = min(len(a.split_feature), len(b.split_feature))
    for i in range(n):
        if (a.split_feature[i] != b.split_feature[i]
                or a.threshold_in_bin[i] != b.threshold_in_bin[i]):
            return {"parted_at_split": i,
                    "bundled": [int(a.split_feature[i]),
                                int(a.threshold_in_bin[i]),
                                float(a.split_gain[i])],
                    "unbundled": [int(b.split_feature[i]),
                                  int(b.threshold_in_bin[i]),
                                  float(b.split_gain[i])]}
    if a.num_leaves != b.num_leaves:
        return {"parted_at_split": n, "bundled": None, "unbundled": None}
    rel = float(np.max(np.abs(a.leaf_value - b.leaf_value)
                       / np.maximum(np.abs(b.leaf_value), 1e-12)))
    return {"parted_at_split": None, "leaf_rel_diff": rel}


def expansion_cost(torch, booster, replay_busy_ms, reps=5):
    """The stored -> virtual histogram expansion of one tree (the root's
    and 62 children pairs', at the learner's shapes) captured as a CUDA
    graph: replays timed with CUDA events and one profiled; its device
    busy time against a fused replay's."""
    from torch.profiler import ProfilerActivity, profile
    learner = booster.gbdt.tree_learner
    bundle = learner.bundle
    s, b = learner.bins.shape[0], learner.max_bin
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    root = torch.rand((s, b, 3), device=DEVICE, generator=gen)
    pair = torch.rand((2, s, b, 3), device=DEVICE, generator=gen)
    splits = int(booster.gbdt.config.num_leaves) - 1

    def one_tree():
        bundle.expand(root)
        for _ in range(splits):
            bundle.expand(pair)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        one_tree()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        one_tree()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    del graph
    return {"stored_hist_shape": [s, b, 3],
            "virtual_hist_shape": list(bundle.shape) + [3],
            "expansions_a_tree": splits + 1,
            "tree_replay_event_ms": float(np.median(times)),
            "tree_replay_event_ms_all": times,
            "device_ops": len(kernels),
            "device_busy_ms": busy if kernels else None,
            "share_of_fused_replay_busy": (busy / replay_busy_ms
                                           if kernels and replay_busy_ms
                                           else None)}


def phase_bundled(torch, lgt, hk, seed):
    """Exclusive feature bundling at full width: the Flight-Delay-shaped
    table (N_ROWS x 700, 696 one-hot columns) with default parameters,
    which bundle it into fewer than BUNDLED_MAX_STORED stored rows; both
    datasets constructed and timed (the bundled one on the host, the
    unbundled one by bin_dense); N_ROUNDS rounds per-iteration on each
    with counts read from zero; the bundled first tree against the
    plain engines' in the same booster and against the unbundled one
    (near-ties allowed, see first_tree_vs_unbundled), train AUCs within
    0.002; the fused trainer on both (phase_fused: text equal to the
    per-iteration one, launches through the replays, a replay profiled);
    the expansion's device time a tree beside a fused replay's; the
    bundled train set as its own valid set scores its train scores."""
    res = {}
    x, y = make_flight_data(N_ROWS, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lgt.Dataset(x, y, params=BUNDLED_PARAMS).construct(device=DEVICE)
    res["construct_s"] = time.perf_counter() - t0
    core = ds._core
    plan = core.bundle_plan
    check(plan is not None, "bundled: the default parameters did not bundle")
    stored = int(core.bins.shape[0])
    res["plan"] = {"virtual_features": core.num_features,
                   "stored_rows": stored, "num_slots": plan.num_slots,
                   "bundles": int((np.bincount(plan.feat_slot) > 1).sum()),
                   "slot_bins": plan.slot_bins.tolist(),
                   "bins_dtype": str(core.bins.dtype)}
    unbundled_params = dict(BUNDLED_PARAMS, is_enable_sparse=False)
    t0 = time.perf_counter()
    flat = lgt.Dataset(x, y, params=unbundled_params).construct(
        device=DEVICE)
    torch.cuda.synchronize()
    res["construct_unbundled_s"] = time.perf_counter() - t0
    del x
    log(f"bundled: {core.num_features} virtual features in {stored} stored "
        f"rows ({res['plan']['bundles']} bundles, slot bins "
        f"{res['plan']['slot_bins']}, {core.bins.dtype}); construction "
        f"{res['construct_s']:.2f} s bundled (host), "
        f"{res['construct_unbundled_s']:.2f} s unbundled (bin_dense)")
    check(core.num_features == sum(FLIGHT_BLOCKS) + FLIGHT_DENSE
          and stored < BUNDLED_MAX_STORED,
          f"bundled: {stored} stored rows for {core.num_features} features")
    check(flat._core.bundle_plan is None
          and flat._core.bins.shape[0] == core.num_features,
          "bundled: is_enable_sparse=false still bundled")

    runs = {}
    for name, dset, params in (("bundled", ds, BUNDLED_PARAMS),
                               ("unbundled", flat, unbundled_params)):
        mem0 = memory_mark(torch)
        hk.reset_launch_counts()
        booster, round_ms = train_rounds(torch, lgt, params, dset, N_ROUNDS)
        counts = hk.launch_counts()
        run = {"round_ms": round_ms,
               "round_ms_median": float(np.median(round_ms)),
               "train_auc": auc(booster.gbdt.get_training_score(), y),
               "launches": counts,
               "launches_a_tree": {k: v / N_ROUNDS for k, v in counts.items()
                                   if v},
               "memory": memory_peak(torch, mem0)}
        log(f"{name} per-iteration: round ms "
            f"{[round(v, 1) for v in round_ms]}, median "
            f"{run['round_ms_median']:.2f}, train AUC {run['train_auc']:.5f}, "
            f"histogram launches a tree {run['launches_a_tree']}")
        check(len(booster.gbdt.models) == N_ROUNDS,
              f"{name}: training stopped early")
        check(booster.gbdt.tree_learner.use_compact
              and counts["compacted_hist"] >= N_ROUNDS * 62
              and counts["compact_rows"] == counts["compacted_hist"]
              and counts["frontier_hist"] >= N_ROUNDS
              and counts["masked_hist"] == 0,
              f"{name}: kernels launched {counts}")
        runs[name] = (booster, run)
        res[name] = run
    booster, flat_booster = runs["bundled"][0], runs["unbundled"][0]
    check(booster.gbdt.tree_learner.bins.shape[0] == stored,
          "bundled: the learner does not stream the stored rows")
    auc_gap = abs(res["bundled"]["train_auc"] - res["unbundled"]["train_auc"])
    check(auc_gap <= 0.002, f"bundled: train AUC {res['bundled']['train_auc']}"
          f" against {res['unbundled']['train_auc']} unbundled")

    cmp = first_tree_vs_unbundled(booster.gbdt.models[0],
                                  flat_booster.gbdt.models[0])
    res["first_tree_vs_unbundled"] = cmp
    log(f"bundled first tree against the unbundled one: {cmp}")
    if cmp["parted_at_split"] is None:
        check(cmp["leaf_rel_diff"] <= 1e-5, f"bundled: first-tree leaf "
              f"values differ from the unbundled ones by {cmp}")
    else:
        check(cmp["bundled"] is not None and cmp["bundled"][2]
              >= cmp["unbundled"][2] * (1 - 1e-5),
              f"bundled: the first tree parts from the unbundled one "
              f"without a near-tie: {cmp}")
    res["plain_tree"] = compacted_plain_tree(torch, hk, booster)

    res["fused"] = phase_fused(torch, lgt, hk, ds, y, booster,
                               res["bundled"], BUNDLED_PARAMS, "bundled")
    check(res["fused"]["model_text_equal"], "bundled: the fused model text "
          "differs from the per-iteration one")
    res["fused_unbundled"] = phase_fused(
        torch, lgt, hk, flat, y, flat_booster, res["unbundled"],
        unbundled_params, "unbundled")
    del flat, flat_booster, runs
    fb, fu = res["fused"]["profile"], res["fused_unbundled"]["profile"]
    res["fused_round"] = {
        "bundled_ms": res["fused"]["round_ms_median"],
        "unbundled_ms": res["fused_unbundled"]["round_ms_median"],
        "bundled_busy_ms": fb["device_busy_ms"],
        "unbundled_busy_ms": fu["device_busy_ms"],
        "bundled_hist_ms": fb["hist_ms"], "unbundled_hist_ms": fu["hist_ms"]}
    log(f"fused round at 700 features, bundled against unbundled: "
        f"{res['fused_round']}")
    res["expansion"] = expansion_cost(torch, booster, fb["device_busy_ms"])
    log(f"bundled: one tree's histogram expansions "
        f"{res['expansion']['tree_replay_event_ms']:.3f} ms (graph replay, "
        f"events), device busy {res['expansion']['device_busy_ms']} ms over "
        f"{res['expansion']['device_ops']} ops, share of a fused replay's "
        f"busy time {res['expansion']['share_of_fused_replay_busy']}")

    valid = lgt.Booster(BUNDLED_PARAMS, ds)
    valid.add_valid(ds, "self")
    for _ in range(2):
        valid.update()
    torch.cuda.synchronize()
    same = torch.equal(valid.gbdt.valid_score_updaters[0].score,
                       valid.gbdt.train_score_updater.score)
    res["valid_scores_equal_train"] = bool(same)
    log(f"bundled train set as its own valid set: scores equal {same}")
    check(same, "bundled: the valid-set traversal does not decode the slots")
    del valid, booster, ds
    return res


def blockwise_case(torch, lgt, ds, dva, rounds):
    """engine.train with the valid set, early stopping after 5 rounds and
    evals_result, blockwise and per-iteration (forced by a no-op
    callback): the same best iteration, model text and history."""
    params = dict(BENCH_PARAMS, metric=["auc", "binary_logloss"])
    runs = {}
    for mode in ("per_iteration", "blockwise"):
        ev = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster = lgt.train(params, ds, rounds, valid_sets=[dva],
                            early_stopping_rounds=5, evals_result=ev,
                            verbose_eval=False,
                            callbacks=([lambda env: None]
                                       if mode == "per_iteration" else None))
        torch.cuda.synchronize()
        runs[mode] = (booster, ev, time.perf_counter() - t0)
    (pb, pev, ps), (bb, bev, bs) = runs["per_iteration"], runs["blockwise"]
    text_equal, splits_equal, rel = same_trees(bb, pb)
    res = {"per_iteration_s": ps, "blockwise_s": bs,
           "rounds": len(bb.gbdt.models), "best_iteration": bb.best_iteration,
           "per_iteration_best_iteration": pb.best_iteration,
           "model_text_equal": text_equal, "splits_equal": splits_equal,
           "leaf_rel_diff": rel, "history_equal": pev == bev,
           "history_len": len(bev["valid_0"]["auc"]),
           "fused_runner": bool(bb.gbdt._fused_cache),
           "valid_auc": bev["valid_0"]["auc"][-1],
           "train_score_equal": bool(np.array_equal(
               bb.gbdt.get_training_score(), pb.gbdt.get_training_score()))}
    check(res["fused_runner"], "blockwise: the fused trainer did not run")
    check(bb.best_iteration == pb.best_iteration,
          "blockwise: another best iteration")
    check(splits_equal and rel <= 1e-4, "blockwise: trees differ")
    if text_equal:
        check(res["history_equal"] and res["train_score_equal"],
              "blockwise: the model text is equal but the metric history "
              "or the train score differs")
    else:
        for key in ("auc", "binary_logloss"):
            check(len(bev["valid_0"][key]) == len(pev["valid_0"][key])
                  and np.allclose(bev["valid_0"][key], pev["valid_0"][key],
                                  rtol=1e-5, atol=0),
                  f"blockwise: the {key} history differs")
    return res


def phase_blockwise(torch, lgt, ds, seed):
    """Blockwise engine.train, BLOCKWISE_ROUNDS rounds, early stopping
    after 5: with a 100k-row held-out valid set (no stop inside them: the last
    block runs to its end), and with the same rows under labels drawn
    at random (the valid loss is least after a few rounds: the stop
    breaks inside a block of 5, whose tail the replay drops, its
    train score copied into the graph's tensor)."""
    xv, yv = make_valid(100_000, seed)
    res = {}
    for name, labels in (
            ("held_out", yv),
            ("early_stop", (np.random.RandomState(seed + 2).rand(len(yv))
                            < yv.mean()).astype(np.float32))):
        dva = lgt.Dataset(xv, labels, reference=ds)
        res[name] = r = blockwise_case(torch, lgt, ds, dva, BLOCKWISE_ROUNDS)
        log(f"blockwise {name}: {r['blockwise_s']:.2f} s against "
            f"per-iteration {r['per_iteration_s']:.2f} s, {r['rounds']} trees "
            f"({r['history_len']} rounds evaluated), best iteration "
            f"{r['best_iteration']} ({r['per_iteration_best_iteration']}), "
            f"model text equal {r['model_text_equal']}, history equal "
            f"{r['history_equal']}, train score equal "
            f"{r['train_score_equal']}, valid AUC {r['valid_auc']:.5f}")
    check(res["early_stop"]["history_len"] < BLOCKWISE_ROUNDS,
          "blockwise early_stop: training did not stop early")
    check(res["early_stop"]["history_len"] % 5 != 0,
          "blockwise early_stop: the stop fell on a block's end")
    return res


# ------------------------------------------------- multiclass, lambdarank

MC_CLASSES = 5
MC_PARAMS = dict(BENCH_PARAMS, objective="multiclass", num_class=MC_CLASSES)
RANK_PARAMS = dict(BENCH_PARAMS, objective="lambdarank", max_position=20)
RANK_EVAL_AT = (1, 3, 5)
RANK_DOCS = (50, 200)
RANK_BAGGING = {"bagging_fraction": 0.7, "bagging_freq": 2}


def multiclass_labels(logit):
    """The bench's logit cut at its quintiles: five classes of 200,000
    rows (LightGBM's examples/multiclass_classification uses 5)."""
    cuts = np.quantile(logit, np.arange(1, MC_CLASSES) / MC_CLASSES)
    return np.searchsorted(cuts, logit).astype(np.float32)


def rank_queries(logit, seed):
    """Query lengths drawn from 50-200 documents (the last query takes
    the rows left), relevance 0-4 from the logit's quantiles within
    each query: web-search-ranking traffic (MSLR-WEB10K averages about
    120 documents a query). Returns (labels, counts)."""
    n = len(logit)
    rng = np.random.RandomState(seed + 7)
    counts = rng.randint(RANK_DOCS[0], RANK_DOCS[1] + 1,
                         n // RANK_DOCS[0] + 1)
    bounds = np.cumsum(counts)
    nq = int(np.searchsorted(bounds, n)) + 1
    counts = counts[:nq].copy()
    counts[-1] = n - int(bounds[nq - 2]) if nq > 1 else n
    qid = np.repeat(np.arange(nq), counts)
    order = np.lexsort((logit, qid))
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(n) - start[qid[order]]
    label = np.empty(n, np.float32)
    label[order] = (rank * 5) // counts[qid[order]]
    return label, counts


def softmax_rows(raw):
    e = np.exp(raw - raw.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def check_predict_multiclass(torch, booster, xp, what):
    """Booster.predict on the device path (tree_raw with K classes)
    against the host float64 traversal of the saved model text, softmax
    on both."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    booster.gbdt.device_predict = "true"
    t0 = time.perf_counter()
    pred = booster.predict(xp)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    booster.gbdt.device_predict = "auto"
    host = GBDT(device="cpu")
    host.load_model_from_string(booster.model_to_string())
    k = host.num_class
    raw = np.zeros((len(xp), k))
    for i, t in enumerate(host.models):
        raw[:, i % k] += t.predict(xp.astype(np.float64))
    err = float(np.max(np.abs(pred - softmax_rows(raw))))
    log(f"{what}: predict {len(xp)} rows {ms:.1f} ms, max |device - host| "
        f"{err:.3g}")
    check(pred.shape == (len(xp), k) and np.all(np.isfinite(pred)),
          f"{what}: predictions not finite or of the wrong shape")
    check(err <= 1e-5,
          f"{what}: device predict differs from host traversal by {err}")
    return {"predict_ms": ms, "max_abs_err": err}


def fused_case(torch, lgt, hk, ds, params, per_iter, name, first_trees,
               profile=True):
    """lgt.train's fast path (one block of NEW_ROUNDS replays), launch
    counts read from zero and counted through the replays, the round
    time without the runner's setup (warm-up step and capture), the
    model against `per_iter` (text byte for byte, else splits exact and
    leaves within 1e-4 relative) or, with first_trees, its first
    `first_trees` trees against per_iter's (another builder: same
    splits, leaves within 1e-4 of the tree's largest); with profile, one
    replay profiled."""
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    booster = lgt.train(params, ds, NEW_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = hk.launch_counts()
    runner = fused_runner(booster)
    check(runner.graph is not None, f"{name}: no graph was captured")
    per_replay = dict(runner.graph.launches)
    setup_s = runner.warm_step_s + runner.capture_s
    res = {"train_s": train_s, "warm_step_s": runner.warm_step_s,
           "capture_s": runner.capture_s,
           "round_ms": 1e3 * (train_s - setup_s) / NEW_ROUNDS,
           "launches": counts, "launches_per_replay": per_replay,
           "trees": len(booster.gbdt.models)}
    for kname, c in per_replay.items():
        check(counts[kname] == (NEW_ROUNDS + 1) * c,
              f"{name}: {kname} counted {counts[kname]}, not "
              f"{NEW_ROUNDS + 1} x {c}")
    if first_trees:
        # leaves relative to the tree's largest |leaf|: a class tree can
        # hold leaves near 0 whose own relative error means nothing
        rel = 0.0
        for a, b in zip(booster.gbdt.models[:first_trees],
                        per_iter.gbdt.models[:first_trees]):
            check(np.array_equal(a.split_feature, b.split_feature)
                  and np.array_equal(a.threshold_in_bin, b.threshold_in_bin),
                  f"{name}: a first-round tree differs from the masked "
                  "builder's")
            rel = max(rel, float(np.max(np.abs(a.leaf_value - b.leaf_value))
                                 / np.max(np.abs(b.leaf_value))))
        res["first_trees_leaf_rel_diff"] = rel
        check(rel <= 1e-4, f"{name}: first-round leaves differ by {rel}")
    else:
        text_equal, splits_equal, rel = same_trees(booster, per_iter)
        res.update(model_text_equal=text_equal, splits_equal=splits_equal,
                   leaf_rel_diff=rel)
        check(splits_equal and rel <= 1e-4,
              f"{name}: trees differ from the per-iteration ones")
    prof = res["profile"] = profile_replay(torch, runner) if profile else {}
    log(f"{name}: train {train_s:.2f} s (warm-up step "
        f"{runner.warm_step_s:.2f} s, capture {runner.capture_s:.2f} s), "
        f"round {res['round_ms']:.1f} ms without them, launches {counts} "
        f"({per_replay} a replay); "
        f"{({k: v for k, v in res.items() if 'equal' in k or 'rel' in k})}"
        + (f"; one replay: device busy {prof['device_busy_ms']} ms over "
           f"{prof['device_ops']} ops in a span of {prof['device_span_ms']} "
           f"ms, idle share {prof['device_idle_share']}, unprofiled "
           f"replays {[round(v, 2) for v in prof['replay_event_ms_all']]} "
           "ms" if profile else ""))
    return res


def bench_subset(ds, **fields):
    """The bench Dataset's bins for other labels: a subset of every row
    (Dataset.subset shares the parent's bin mappers and copies its
    bins) with `fields` (group=) set before it is built and the label
    after."""
    label = fields.pop("label")
    sub = ds.subset(np.arange(ds.num_data()))
    for name, value in fields.items():
        getattr(sub, "set_" + name)(value)
    sub.construct()
    sub.set_label(label)
    return sub


def phase_multiclass(torch, lgt, hk, ds_bench, x, logit, timer):
    """Multiclass at full width: 5 classes on the bench matrix, 5
    rounds (25 trees) per-iteration (masked builder), fused (masked and
    partitioned); multi_logloss falls; predict on 100k rows against the
    host traversal; the model frozen by CompiledPredictor and served
    through tree_raw with K = 5."""
    import tempfile
    from lightgbm_tpu_torch.metrics import create_metric
    from lightgbm_tpu_torch.ops import traverse_kernels as tk
    from lightgbm_tpu_torch.serving import CompiledPredictor

    y = multiclass_labels(logit)
    ds = bench_subset(ds_bench, label=y)
    k = MC_CLASSES
    res = {"classes": k, "class_counts": np.bincount(
        y.astype(np.int64)).tolist()}
    first = []
    hk.reset_launch_counts()
    per_iter, round_ms = train_rounds(torch, lgt, MC_PARAMS, ds, NEW_ROUNDS,
                                      first_score=first)
    counts = hk.launch_counts()
    metric = create_metric("multi_logloss", per_iter.config)
    metric.init(ds._core.metadata, ds.num_data())
    loss0 = metric.eval(first[0])[0]
    loss = metric.eval(per_iter.gbdt.get_training_score())[0]
    res["per_iteration"] = {"round_ms": round_ms,
                            "round_ms_median": float(np.median(round_ms)),
                            "launches": counts,
                            "multi_logloss_first": loss0,
                            "multi_logloss_last": loss}
    log(f"multiclass per-iteration: rounds {[round(v, 1) for v in round_ms]} "
        f"ms, launches {counts}, multi_logloss {loss0:.5f} -> {loss:.5f}")
    check(len(per_iter.gbdt.models) == NEW_ROUNDS * k,
          "multiclass: training stopped early")
    check(counts["masked_hist"] >= NEW_ROUNDS * k * 62
          and counts["frontier_hist"] >= NEW_ROUNDS * k,
          f"multiclass: histogram kernels launched {counts}")
    check(loss < loss0, "multiclass: multi_logloss did not fall")
    res["fused"] = fused_case(torch, lgt, hk, ds, MC_PARAMS, per_iter,
                              "multiclass fused masked", 0)
    per_replay = res["fused"]["launches_per_replay"]
    check(per_replay.get("masked_hist", 0) >= k * 62
          and per_replay.get("frontier_hist", 0) >= k,
          f"multiclass fused: a replay launches {per_replay}")
    res["fused_partitioned"] = fused_case(
        torch, lgt, hk, ds, dict(MC_PARAMS, partitioned_build="true"),
        per_iter, "multiclass fused partitioned", k, profile=False)
    per_replay = res["fused_partitioned"]["launches_per_replay"]
    check(per_replay.get("seg_hist", 0) >= k * 63
          and not per_replay.get("masked_hist"),
          f"multiclass fused partitioned: a replay launches {per_replay}")
    res["predict"] = check_predict_multiclass(torch, per_iter, x[:100_000],
                                              "multiclass")

    # served: the model file frozen, tree_raw with K = 5
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "multiclass.txt")
        per_iter.save_model(path)
        pred = CompiledPredictor.from_model_file(path,
                                                 max_batch_rows=SERVE_BUCKET)
    rows = np.ascontiguousarray(x[:SERVE_ROWS], dtype=np.float32)
    tk.reset_launch_counts()
    served_raw = pred.predict_raw_device(rows)
    served = pred.predict_device(rows)
    res["serving_launches"] = tk.launch_counts()
    per_iter.gbdt.device_predict = "true"
    want_raw = per_iter.predict(rows, raw_score=True)
    want = per_iter.predict(rows)
    per_iter.gbdt.device_predict = "auto"
    exact = pred.predict(rows[:HOST_CHECK_ROWS])
    host = per_iter.predict(rows[:HOST_CHECK_ROWS])
    res["served_vs_predict"] = {
        "device_raw_bit_equal": bool(np.array_equal(served_raw, want_raw)),
        "device_max_abs_diff": float(np.abs(served - want).max()),
        "exact_max_abs_diff": float(np.abs(exact - host).max())}
    res["tree_raw_k5"] = traverse_case(torch, tk, timer, "tree_raw", pred,
                                       rows[:SERVE_BUCKET])
    log(f"multiclass served: {pred.num_trees} trees, K = {pred.num_class}, "
        f"launches {res['serving_launches']}, {res['served_vs_predict']}")
    check(pred.num_class == k, "multiclass: the predictor lost its classes")
    check(res["serving_launches"].get("tree_raw", 0) > 0,
          "multiclass: serving did not launch tree_raw")
    check(res["served_vs_predict"]["device_raw_bit_equal"],
          "multiclass: served tree_raw sums differ from predict's")
    check(res["served_vs_predict"]["device_max_abs_diff"] <= 1e-6,
          "multiclass: served answers differ from predict's")
    check(res["served_vs_predict"]["exact_max_abs_diff"]
          <= coalesced_tol(pred),
          "multiclass: the exact served answers differ from predict's")
    return res


# the PyTorch operators a pair-gradient call may run besides the kernel
RANK_CALL_OPS = {"aten::empty", "aten::empty_strided", "aten::reshape",
                 "aten::view", "aten::_reshape_alias"}
RANK_PROFILED_CALLS = 3
# A profiling script's end: `call()` run once, then argv[2] times under
# the profiler; their device events printed as JSON. Such a script runs
# in a process of its own (fresh_process_profile): late in chip_smoke's
# run the profiler records no device event of an eager call (not even a
# device sleep) and no pair kernel in a replay, though it records the
# histogram kernels there. A device sleep opens and closes the profiled
# window and is not counted: a window that began and ended with the
# calls' own kernels once lost one of three.
PROFILE_PAD = """
def pad():
    torch.cuda._sleep(100000)
def counted(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]
"""
PROFILE_TAIL = PROFILE_PAD + """
from torch.profiler import ProfilerActivity, profile
call()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    pad()
    for _ in range(int(sys.argv[2])):
        call()
    pad()
    torch.cuda.synchronize()
ev = counted(prof)
print(json.dumps({"names": [e.name for e in ev],
                  "device_ms": [e.device_time_total / 1e3 for e in ev]}))
"""
# pair-gradient calls on the inputs saved at argv[1]
RANK_PROFILE_SRC = """
import json, sys, torch
from lightgbm_tpu_torch.ops import rank_kernels as rk
a = torch.load(sys.argv[1])
score = a.pop("score").cuda()
args = {k: v.cuda() if torch.is_tensor(v) else v for k, v in a.items()}
def call():
    rk.lambdarank_pairs(score, **args)
""" + PROFILE_TAIL


def fresh_process_profile(torch, src, saved, calls, what):
    """The device events of `calls` calls of a profiling script `src`
    (one that ends with PROFILE_TAIL) on `saved` (torch.save'd for it),
    run in a fresh process."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(saved, path)
        proc = subprocess.run(
            [sys.executable, "-c", src, path, str(calls)],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"{what}: the profiling process failed:"
          f"\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def rank_device_profile(torch, score, args):
    """The device events of RANK_PROFILED_CALLS pair-gradient calls on
    (score, args), profiled in a fresh process (RANK_PROFILE_SRC)."""
    saved = {k: v.cpu() if torch.is_tensor(v) else v
             for k, v in args.items()}
    saved["score"] = score.cpu()
    return fresh_process_profile(torch, RANK_PROFILE_SRC, saved,
                                 RANK_PROFILED_CALLS, "lambdarank gradients")


def rank_pairs_needed(qb, gain):
    """Ordered pairs (h, l) of a query with gain_h > gain_l, over every
    query: the pair terms this run's labels need (host numpy)."""
    total = 0
    for q in range(len(qb) - 1):
        g = np.sort(gain[qb[q]:qb[q + 1]])
        total += int(np.searchsorted(g, g, side="left").sum())
    return total


def rank_grad_bound_ms(qb, gain, weighted, disc_len):
    """Least time for one pair-gradient call, whatever implements it: the
    function's own inputs read once (score, each row's gain and weight,
    the query bounds, each query's inverse max DCG, the discount table)
    and the two (N,) outputs written once, over HBM bandwidth; against
    27 float32 operations for each pair term this run's labels need
    (rank_pairs_needed: differences, gaps, the discount and score terms,
    the clamped sigmoid with its exp, the lambda and hessian products,
    their two adds) and a compare and an add for each ordered pair of a
    query (the ranks), over the float32 rate. Returns (ms, bound_by,
    pairs needed, sum of n_q^2)."""
    n = int(qb[-1] - qb[0])
    nq = len(qb) - 1
    nbytes = (4 * n * (4 + (1 if weighted else 0)) + 4 * (nq + 1) + 4 * nq
              + 4 * disc_len)
    needed = rank_pairs_needed(qb, gain)
    squares = int(np.sum(np.diff(qb).astype(np.int64) ** 2))
    ops = 27.0 * needed + 2.0 * squares
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", needed, squares)


def rank_baseline_fn(torch, obj):
    """With --baseline: the other checkout's pair-gradient function for
    the objective's queries (its own layout and program)."""
    rd = baseline_module("objectives.rank_device")
    layout = rd.PaddedQueryLayout(obj.layout.boundaries, obj.num_data)
    return rd.make_lambdarank_gradfn(layout, obj.label, obj.label_gain,
                                     obj.sigmoid, obj.optimize_pos_at,
                                     obj.weights, torch.device(DEVICE))


def rank_gradients_case(torch, booster, timer):
    """lambdarank_pairs (csrc/rank.cu) at the phase's shape: bit for bit
    its plain version on the card (same inputs), within 2e-4 of the
    largest |value| of the objective's host float64 path
    (tests/test_rank_device.py's bound), two calls bitwise equal, one
    call profiled on the host and three on the device in a fresh
    process (one device kernel a call, the pair kernel: no torch pair
    program), timed with CUDA events (L2 flushed, the device sleep
    ahead) beside its bound, its plain version and the host path; with
    --baseline the other checkout's function on the same score (within
    1e-5 of the largest |value|: its sums run in another order), timed."""
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops import rank_kernels as rk
    obj = booster.objective
    n = booster.gbdt.num_data
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    score = torch.randn(1, n, device=DEVICE, generator=gen)
    before = rk.KERNELS["lambdarank_pairs"].launches
    g, h = obj.get_gradients(score)
    g2, h2 = obj.get_gradients(score)
    torch.cuda.synchronize()
    launches = rk.KERNELS["lambdarank_pairs"].launches - before
    lay = obj.layout
    args = obj._grad.inputs
    qb = args["qb"].cpu().numpy()
    gain = args["gain"].cpu().numpy()
    t0 = time.perf_counter()
    pg, ph = rk.lambdarank_grad_plain(score, **args)
    torch.cuda.synchronize()
    plain_once_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    gh, hh = obj.get_gradients_host(score.cpu().numpy())
    host_ms = 1e3 * (time.perf_counter() - t0)
    err_g = float(np.abs(g.cpu().numpy() - gh).max() / np.abs(gh).max())
    err_h = float(np.abs(h.cpu().numpy() - hh).max() / np.abs(hh).max())
    bound, bound_by, needed, squares = rank_grad_bound_ms(
        qb, gain, args["weight"] is not None, args["disc"].shape[0])
    res = {"name": "lambdarank_pairs", "queries": lay.num_queries,
           "max_docs": lay.max_docs, "pairs_needed": needed,
           "pairs_squared": squares, "grad_rel_err": err_g,
           "hess_rel_err": err_h, "launches_two_calls": launches,
           "bitwise_vs_plain": bool(torch.equal(g, pg)
                                    and torch.equal(h, ph)),
           "max_abs_err": float(max((g - pg).abs().max(),
                                    (h - ph).abs().max())),
           "deterministic": bool(torch.equal(g, g2) and torch.equal(h, h2)),
           "ms": timer(lambda: obj.get_gradients(score), 10),
           "plain_ms": timer(lambda: rk.lambdarank_grad_plain(score, **args),
                             2),
           "plain_once_ms": plain_once_ms, "library_ms": None,
           "host_f64_ms": host_ms, "bound_ms": bound, "bound_by": bound_by}
    # the device: one pair kernel a call, nothing else (a fresh process)
    dev = rank_device_profile(torch, score, args)
    res["device_ops"] = len(dev["names"])
    res["device_op_names"] = sorted(set(dev["names"]))
    res["device_busy_ms"] = sum(dev["device_ms"]) / RANK_PROFILED_CALLS
    # the call's PyTorch operators: the outputs' allocations and the
    # score's reshape, no torch pair program
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        obj.get_gradients(score)
        torch.cuda.synchronize()
    res["torch_ops"] = sorted({e.name for e in prof.events()
                               if e.name.startswith("aten::")})
    if BASELINE is not None:
        base = rank_baseline_fn(torch, obj)
        bg, bh = base(score)
        torch.cuda.synchronize()
        scale = max(float(bg.abs().max()), float(bh.abs().max()))
        res["baseline_max_abs_diff"] = float(max(
            (bg - g).abs().max(), (bh - h).abs().max()))
        res["baseline_ms"] = timer(lambda: base(score), 10)
        check(res["baseline_max_abs_diff"] <= 1e-5 * scale,
              "lambdarank gradients: the baseline's program differs by "
              f"{res['baseline_max_abs_diff']}")
    log(f"lambdarank_pairs: {lay.num_queries} queries of up to "
        f"{lay.max_docs} rows, {needed} pair terms ({squares} ordered "
        f"pairs); ms {res['ms']:.4f} (device busy "
        f"{res['device_busy_ms']:.4f} a call, {res['device_ops']} device "
        f"ops in {RANK_PROFILED_CALLS} calls {res['device_op_names']}, "
        f"torch ops {res['torch_ops']}) bound "
        f"{bound:.4f} ({bound_by}); plain "
        f"{res['plain_ms']:.1f} ms; host f64 {host_ms:.0f} ms; bits = plain "
        f"{res['bitwise_vs_plain']} (max |diff| {res['max_abs_err']:.3g}); "
        f"rel err vs f64 grad {err_g:.3g} hess {err_h:.3g}; two calls equal "
        f"{res['deterministic']}"
        + (f"; baseline program {res['baseline_ms']:.3f} ms, max |diff| "
           f"{res['baseline_max_abs_diff']:.3g}" if BASELINE else ""))
    check(launches == 2, f"lambdarank gradients: {launches} kernel launches "
          "in two calls")
    check(res["device_ops"] == RANK_PROFILED_CALLS
          and all("lambdarank_pairs" in k for k in res["device_op_names"]),
          f"lambdarank gradients: {RANK_PROFILED_CALLS} calls ran "
          f"{res['device_ops']} device ops {res['device_op_names']}, not "
          "one pair kernel each")
    check(set(res["torch_ops"]) <= RANK_CALL_OPS,
          f"lambdarank gradients: a call ran {res['torch_ops']}, not the "
          "pair kernel alone")
    check(res["bitwise_vs_plain"],
          "lambdarank gradients: the kernel differs from its plain version")
    check(err_g < 2e-4 and err_h < 2e-4,
          f"lambdarank gradients: {err_g}, {err_h} from the host f64 path")
    check(res["deterministic"], "lambdarank gradients: two calls differ")
    return res


def baseline_fused_rank(torch, x, label, counts):
    """With --baseline: the other checkout's package trains the same
    lambdarank workload fused (its own Dataset built on the card): its
    round time without the runner's setup, and its model text."""
    import sys as _sys
    base = _sys.modules[BASELINE.__name__.rsplit(".", 1)[0]]
    ds = base.Dataset(x, label, group=counts).construct(device=DEVICE)
    t0 = time.perf_counter()
    booster = base.train(RANK_PARAMS, ds, NEW_ROUNDS, verbose_eval=False,
                         device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    runner = fused_runner(booster)
    setup_s = runner.warm_step_s + runner.capture_s
    return {"round_ms": 1e3 * (train_s - setup_s) / NEW_ROUNDS,
            "train_s": train_s, "text": booster.model_to_string()}


def phase_lambdarank(torch, lgt, hk, ds_bench, x, logit, timer, seed):
    """LambdaRank at full width: the bench matrix in queries of 50-200
    documents with relevance 0-4, max_position 20, default label_gain;
    the pair gradients checked and timed; 5 rounds per-iteration and
    fused (model text; one lambdarank_pairs launch a round, counted
    through the replays), NDCG@1,3,5 rises; query-unit bagging (0.7,
    every 2 rounds) fused against its per-iteration loop; with
    --baseline the other checkout's fused round on the same workload."""
    from lightgbm_tpu_torch.metrics import create_metric

    label, counts = rank_queries(logit, seed)
    ds = bench_subset(ds_bench, label=label, group=counts)
    res = {"queries": len(counts), "docs_mean": float(counts.mean()),
           "docs_max": int(counts.max())}
    booster = lgt.Booster(RANK_PARAMS, ds)
    res["gradients"] = rank_gradients_case(torch, booster, timer)
    del booster
    first = []
    hk.reset_launch_counts()
    per_iter, round_ms = train_rounds(torch, lgt, RANK_PARAMS, ds, NEW_ROUNDS,
                                      first_score=first)
    counts_pi = hk.launch_counts()
    metric = create_metric("ndcg", type(per_iter.config).from_params(
        dict(RANK_PARAMS, ndcg_eval_at=",".join(map(str, RANK_EVAL_AT)))))
    metric.init(ds._core.metadata, ds.num_data())
    ndcg0 = metric.eval(first[0])
    ndcg = metric.eval(per_iter.gbdt.get_training_score())
    res["per_iteration"] = {"round_ms": round_ms,
                            "round_ms_median": float(np.median(round_ms)),
                            "launches": counts_pi, "ndcg_first": ndcg0,
                            "ndcg_last": ndcg}
    log(f"lambdarank per-iteration: rounds {[round(v, 1) for v in round_ms]}"
        f" ms, launches {counts_pi}, ndcg@{RANK_EVAL_AT} {ndcg0} -> {ndcg}")
    check(len(per_iter.gbdt.models) == NEW_ROUNDS,
          "lambdarank: training stopped early")
    check(counts_pi["lambdarank_pairs"] == NEW_ROUNDS,
          f"lambdarank: {counts_pi['lambdarank_pairs']} pair-gradient "
          f"launches in {NEW_ROUNDS} rounds")
    check(all(b > a for a, b in zip(ndcg0, ndcg)),
          f"lambdarank: NDCG did not rise: {ndcg0} -> {ndcg}")
    res["fused"] = fused_case(torch, lgt, hk, ds, RANK_PARAMS, per_iter,
                              "lambdarank fused", 0)
    per_replay = res["fused"]["launches_per_replay"]
    check(per_replay.get("lambdarank_pairs") == 1,
          f"lambdarank fused: a replay launches {per_replay}")
    if BASELINE is not None:
        base = baseline_fused_rank(torch, x, label, counts)
        res["baseline_fused"] = {
            "round_ms": base["round_ms"], "train_s": base["train_s"],
            "model_text_equal": base["text"] == per_iter.model_to_string()}
        log(f"lambdarank fused, baseline: round {base['round_ms']:.1f} ms "
            f"(this {res['fused']['round_ms']:.1f}); "
            f"{res['baseline_fused']}")
    del per_iter
    params = dict(RANK_PARAMS, **RANK_BAGGING)
    loop = lgt.train(params, ds, NEW_ROUNDS, verbose_eval=False,
                     callbacks=[lambda env: None])
    fused = lgt.train(params, ds, NEW_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    text_equal, splits_equal, rel = same_trees(fused, loop)
    res["bagging"] = {"model_text_equal": text_equal,
                      "splits_equal": splits_equal, "leaf_rel_diff": rel,
                      "fused_runner": bool(fused.gbdt._fused_cache)}
    log(f"lambdarank query bagging fused: {res['bagging']}")
    check(res["bagging"]["fused_runner"],
          "lambdarank bagging: the fused trainer did not run")
    check(splits_equal and rel <= 1e-4,
          "lambdarank bagging: fused trees differ from the per-iteration ones")
    return res


# ---------------------------------------------------------------- serving

SERVE_ROUNDS = 100
SERVE_BUCKET = 4096
SERVE_ROWS = 100_000
# rows held against the host float64 path (its numpy walk of 100 trees
# takes about 0.2 s a 1,000 rows)
HOST_CHECK_ROWS = 20_000
HTTP_CLIENTS = 8
HTTP_REQUESTS_EACH = 25


def plant_specials(x, rng, cols=None, frac=0.02):
    """x with NaN, +-inf, +-1e10 and -0.5 planted in `frac` of the
    entries of `cols` (all columns by default)."""
    x = np.array(x, dtype=np.float32)
    cols = np.arange(x.shape[1]) if cols is None else np.asarray(cols)
    specials = np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, -0.5],
                        np.float32)
    mask = rng.rand(len(x), len(cols)) < frac
    sub = x[:, cols]
    sub[mask] = specials[rng.randint(len(specials), size=int(mask.sum()))]
    x[:, cols] = sub
    return x


def random_forest(rng, t_cnt, max_leaves, f):
    """Random valid trees (random leaf splits, a third categorical):
    the (T, S) arrays traverse_kernels.freeze takes, and (T, L) leaf
    values."""
    s = max_leaves - 1
    sf = np.zeros((t_cnt, s), np.int32)
    thr = np.zeros((t_cnt, s), np.float32)
    cat = np.zeros((t_cnt, s), bool)
    lc = np.full((t_cnt, s), ~0, np.int32)
    rc = np.full((t_cnt, s), ~0, np.int32)
    lv = np.zeros((t_cnt, max_leaves), np.float32)
    node0 = np.zeros(t_cnt, np.int32)
    depth = 1
    for t in range(t_cnt):
        nl = rng.randint(2, max_leaves + 1)
        leaves, leaf_depth = [(-1, 0)], [0]
        for ns in range(nl - 1):
            li = rng.randint(len(leaves))
            parent, side = leaves[li]
            if parent >= 0:
                (lc if side == 0 else rc)[t, parent] = ns
            sf[t, ns] = rng.randint(f)
            cat[t, ns] = rng.rand() < 0.3
            thr[t, ns] = (rng.randint(N_CATEGORIES) if cat[t, ns]
                          else np.float32(rng.randn()))
            lc[t, ns], rc[t, ns] = ~li, ~len(leaves)
            leaves[li] = (ns, 0)
            leaves.append((ns, 1))
            leaf_depth[li] += 1
            leaf_depth.append(leaf_depth[li])
        lv[t, :nl] = rng.randn(nl) * 0.1
        depth = max(depth, max(leaf_depth))
    return (sf, thr, cat, lc, rc, node0, depth), lv


def walk_reads(forest, leaves):
    """What this run's walks read of a Forest, from the (B, T) leaves
    its rows reach: the steps taken (one compare each), the distinct
    node records on those paths, and the (T, S + 1) mask of the leaves
    reached (padding nodes and unreached subtrees are never read)."""
    lc, rc = forest.lc.cpu().numpy(), forest.rc.cpu().numpy()
    node0 = forest.node0.cpu().numpy()
    t_cnt, s = lc.shape
    reached = np.zeros((t_cnt, s + 1), bool)
    reached[np.arange(t_cnt)[None, :], leaves] = True
    depth = np.zeros((t_cnt, s + 1), np.int64)
    nodes = 0
    for t in range(t_cnt):
        stack, on_path = [(int(node0[t]), ())], set()
        while stack:
            node, path = stack.pop()
            if node < 0:
                depth[t, ~node] = len(path)
                if reached[t, ~node]:
                    on_path.update(path)
                continue
            path = path + (node,)
            stack += [(int(lc[t, node]), path), (int(rc[t, node]), path)]
        nodes += len(on_path)
    steps = float(depth[np.arange(t_cnt)[None, :], leaves].sum())
    return steps, nodes, reached


def traverse_bound_ms(x, forest, leaves, lv=None, num_class=1):
    """Least time for one traversal call on this run's rows: x and node0
    read once, the node records on the rows' paths read once, and the
    output written once (tree_leaf: (B, T) int32; tree_raw: the reached
    leaves' values read once and (B, K) float32 written), over HBM
    bandwidth; against one float32 compare per step this run's rows
    take (and one add per (row, tree) for tree_raw) over the float32
    rate. Returns (ms, bound_by)."""
    b, f = x.shape
    t = forest.sf.shape[0]
    steps, nodes, reached = walk_reads(forest, leaves)
    nbytes = b * f * 4 + nodes * 16 + t * 4
    if lv is None:
        nbytes += b * t * 4
        ops = steps
    else:
        nbytes += int(reached.sum()) * lv.element_size() + b * num_class * 4
        ops = steps + b * leaves.shape[1]
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def traverse_case(torch, tk, timer, name, pred, x_host, reps=50):
    """One traversal kernel of a frozen predictor on `x_host` rows (a
    bucket's shape): against its plain version on the card, bit for bit
    (tree_raw's plain version adds in the kernel's tree order), launched
    twice and required bitwise equal, timed beside its bound and the plain
    version with L2 flushed (`ms`) and L2-warm (`ms_warm`: no flush, as a
    server finds its forest between requests). With --baseline the other
    checkout's kernel runs on the same inputs: same bits, its flushed and
    L2-warm times beside. There is no PyTorch library call for the same
    function (library_ms None)."""
    forest = pred._forest
    x = torch.from_numpy(np.ascontiguousarray(x_host)).to(DEVICE)
    if name == "tree_leaf":
        def kern(m=tk, fr=forest):
            return m.tree_leaf(x, fr)

        def plain():
            return tk.tree_leaf_plain(x, forest)
        lv = None
    else:
        lv = (pred._lv16 if pred.serving_precision == "bf16"
              else pred._f32_values())

        def kern(m=tk, fr=forest):
            return m.tree_raw(x, fr, lv, pred.num_class)

        def plain():
            return tk.tree_raw_plain(x, forest, lv, pred.num_class)
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    t, s = forest.sf.shape
    plan = tk.plan(x.shape[0], x.shape[1], t, s,
                   None if lv is None else pred.num_class)
    res = {"name": name, "shape": {"B": x.shape[0], "F": x.shape[1],
                                   "T": int(t), "S": int(s),
                                   "depth": forest.depth,
                                   "precision": pred.serving_precision},
           "plan": plan._asdict(),
           "max_abs_err": err, "bitwise_vs_plain": bool(torch.equal(got,
                                                                    want)),
           "deterministic": bool(torch.equal(got, again))}
    leaves = tk.tree_leaf(x, forest).cpu().numpy()
    res["bound_ms"], res["bound_by"] = traverse_bound_ms(
        x, forest, leaves, lv, pred.num_class)
    res["ms"] = timer(kern, reps)
    res["ms_warm"] = timer(kern, reps, flush=False)
    res["ms_enqueued"] = timer(kern, reps, sleep=False)
    res["host_us"] = host_us(torch, kern)
    res["plain_ms"] = timer(plain, 5)
    res["library_ms"] = None
    if BASELINE is not None:
        base, bfr = BASELINE.traverse_kernels, baseline_forest(forest)
        res["baseline_same_bits"] = bool(torch.equal(kern(base, bfr), got))
        res["baseline_ms"] = timer(lambda: kern(base, bfr), reps)
        res["baseline_ms_warm"] = timer(lambda: kern(base, bfr), reps,
                                        flush=False)
        res["baseline_host_us"] = host_us(torch, lambda: kern(base, bfr))
    log(f"{name} {res['shape']}: err {err:.3g} bitwise {res['bitwise_vs_plain']}"
        f" deterministic {res['deterministic']} ms {res['ms']:.4f} warm "
        f"{res['ms_warm']:.4f} enqueued {res['ms_enqueued']:.4f} bound "
        f"{res['bound_ms']:.5f} ({res['bound_by']}) plain "
        f"{res['plain_ms']:.3f} host_us {res['host_us']:.1f}"
        + (f"; baseline same bits {res['baseline_same_bits']} ms "
           f"{res['baseline_ms']:.4f} warm {res['baseline_ms_warm']:.4f} "
           f"host_us {res['baseline_host_us']:.1f}"
           if BASELINE is not None else ""))
    check(res["deterministic"], f"{name}: two launches gave different bits")
    check(res["bitwise_vs_plain"], f"{name}: differs from plain by {err}")
    if BASELINE is not None:
        check(res["baseline_same_bits"], f"{name}: the baseline gave other "
              "bits")
    return res


def check_raw_cases(torch, tk, pred, bf16, x_host, rng):
    """tree_raw for K = 1 (the bench model, float32 and bfloat16 leaf
    values) and K = 3 (random valid trees): bit for bit the plain
    version (its f32 adds in tree order), bfloat16 within the predictor's
    accuracy_bound of the exact float64 sum, two launches bitwise equal,
    and with --baseline the other checkout's bits on the same inputs."""
    out = {}
    x = torch.from_numpy(np.ascontiguousarray(x_host)).to(DEVICE)
    leaves = tk.tree_leaf(x, pred._forest).long()
    exact = (pred._lv64[np.arange(pred.num_trees)[None, :],
                        leaves.cpu().numpy()] @ pred._onehot64)
    for p in (pred, bf16):
        lv = p._lv16 if p.serving_precision == "bf16" else p._f32_values()
        got = tk.tree_raw(x, p._forest, lv, p.num_class)
        again = tk.tree_raw(x, p._forest, lv, p.num_class)
        want = tk.tree_raw_plain(x, p._forest, lv, p.num_class)
        torch.cuda.synchronize()
        scale = float(lv.float().abs().amax(dim=1).sum())
        err = float((got - want).abs().max())
        vs_exact = float(np.abs(got.cpu().numpy() - exact).max())
        out[p.serving_precision] = {
            "max_abs_err": err, "scale": scale, "vs_exact_f64": vs_exact,
            "accuracy_bound": p.accuracy_bound,
            "bitwise_vs_plain": bool(torch.equal(got, want)),
            "deterministic": bool(torch.equal(got, again))}
        log(f"tree_raw K=1 {p.serving_precision}: {out[p.serving_precision]}")
        check(torch.equal(got, again),
              f"tree_raw {p.serving_precision}: launches differ in bits")
        check(torch.equal(got, want),
              f"tree_raw {p.serving_precision}: {err} from plain")
        if BASELINE is not None:
            base = BASELINE.traverse_kernels.tree_raw(
                x, baseline_forest(p._forest), lv, p.num_class)
            out[p.serving_precision]["baseline_same_bits"] = bool(
                torch.equal(base, got))
            check(torch.equal(base, got),
                  f"tree_raw {p.serving_precision}: the baseline gave "
                  "other bits")
        if p.serving_precision == "bf16":
            check(vs_exact <= p.accuracy_bound,
                  f"tree_raw bf16: {vs_exact} from exact, bound "
                  f"{p.accuracy_bound}")
        else:
            check(vs_exact <= 1e-6 * scale,
                  f"tree_raw f32: {vs_exact} from exact")
    arrays, lv = random_forest(rng, 96, 63, N_FEATURES)
    forest = tk.freeze(*arrays, DEVICE)
    x3 = torch.from_numpy(plant_specials(
        np.where(rng.rand(len(x_host), N_FEATURES) < 0.3,
                 rng.randint(0, N_CATEGORIES, (len(x_host), N_FEATURES)),
                 x_host).astype(np.float32), rng)).to(DEVICE)
    lv32 = torch.from_numpy(lv).to(DEVICE)
    for vals in (lv32, lv32.to(torch.bfloat16)):
        got = tk.tree_raw(x3, forest, vals, 3)
        again = tk.tree_raw(x3, forest, vals, 3)
        want = tk.tree_raw_plain(x3, forest, vals, 3)
        leaves3 = tk.tree_leaf(x3, forest)
        torch.cuda.synchronize()
        scale = float(vals.float().abs().amax(dim=1).sum())
        err = float((got - want).abs().max())
        key = "k3_" + str(vals.dtype).replace("torch.", "")
        out[key] = {"max_abs_err": err, "scale": scale,
                    "bitwise_vs_plain": bool(torch.equal(got, want)),
                    "deterministic": bool(torch.equal(got, again)),
                    "leaves_bitwise": bool(torch.equal(
                        leaves3, tk.tree_leaf_plain(x3, forest)))}
        log(f"tree_raw K=3 {key}: {out[key]}")
        check(out[key]["deterministic"] and out[key]["leaves_bitwise"],
              f"tree_raw {key}: not deterministic or leaves differ")
        check(out[key]["bitwise_vs_plain"],
              f"tree_raw {key}: {err} from plain")
        if BASELINE is not None:
            base, bfr = BASELINE.traverse_kernels, baseline_forest(forest)
            same = bool(torch.equal(base.tree_raw(x3, bfr, vals, 3), got)
                        and torch.equal(base.tree_leaf(x3, bfr), leaves3))
            out[key]["baseline_same_bits"] = same
            check(same, f"tree_raw {key}: the baseline gave other bits")
    return out


def check_leaves(torch, tk, pred, x_host, what):
    """tree_leaf bit for bit against its plain version on the card, two
    launches bitwise equal, and with --baseline the other checkout's
    bits on the same inputs."""
    x = torch.from_numpy(np.ascontiguousarray(x_host)).to(DEVICE)
    got = tk.tree_leaf(x, pred._forest)
    again = tk.tree_leaf(x, pred._forest)
    want = tk.tree_leaf_plain(x, pred._forest)
    torch.cuda.synchronize()
    res = {"rows": len(x_host), "trees": int(got.shape[1]),
           "bitwise_vs_plain": bool(torch.equal(got, want)),
           "deterministic": bool(torch.equal(got, again))}
    if BASELINE is not None:
        res["baseline_same_bits"] = bool(torch.equal(
            BASELINE.traverse_kernels.tree_leaf(
                x, baseline_forest(pred._forest)), got))
    log(f"tree_leaf {what}: {tuple(got.shape)} {res}")
    check(res["bitwise_vs_plain"],
          f"tree_leaf {what}: differs from its plain version")
    check(res["deterministic"], f"tree_leaf {what}: launches differ")
    check(res.get("baseline_same_bits", True),
          f"tree_leaf {what}: the baseline gave other bits")
    return res


def serving_probe(torch, pred, rows, label):
    """bench.py serving_probe's numbers for one predictor: single-row
    predict p50/p99 over 100 calls (nearest rank) and predict
    throughput over `rows`."""
    row = rows[:1]
    pred.predict(row)
    lats = []
    for _ in range(100):
        t0 = time.perf_counter()
        pred.predict(row)
        lats.append(time.perf_counter() - t0)
    lats.sort()
    t0 = time.perf_counter()
    out = pred.predict(rows)
    rows_s = len(rows) / (time.perf_counter() - t0)
    res = {"latency_p50_ms": lats[49] * 1e3, "latency_p99_ms": lats[98] * 1e3,
           "throughput_rows_s": rows_s, "probe_rows": len(rows),
           "cold_dispatches": pred.stats["cold_dispatches"],
           "warm_dispatches": pred.stats["warm_dispatches"]}
    log(f"serving probe {label}: p50 {res['latency_p50_ms']:.4f} ms p99 "
        f"{res['latency_p99_ms']:.4f} ms, {rows_s:.0f} rows/s over "
        f"{len(rows)} rows, cold dispatches {res['cold_dispatches']}")
    check(res["cold_dispatches"] == 0, f"{label}: a cold dispatch")
    check(out.shape == (len(rows), 1) and np.all(np.isfinite(out)),
          f"{label}: predictions not finite or of the wrong shape")
    return res, out


PREDICT_STAGES = ("canon_pad", "h2d", "launch", "d2h", "gather", "product",
                  "transform")


def predict_stages(torch, pred, rows, reps):
    """Host-clock time of each stage of CompiledPredictor.predict's exact
    path, run as predict_raw and _blocks run them, with the card
    synchronised after the host-to-device copy and after the launch so
    each device stage ends inside its own span: canonicalise and pad to
    the bucket, the copy to the card, the tree_leaf launch to its end,
    the copy back, the float64 gather of the leaf values, their product
    with the class one-hot, and the sigmoid (stages of several blocks
    add up). Medians over `reps` runs, in ms, beside the median of
    pred.predict itself on the same rows, run in turn with the stages;
    the staged answer must equal pred.predict's bit for bit."""
    samples = {k: [] for k in PREDICT_STAGES + ("staged_total", "predict")}
    want = pred.predict(rows)
    same = True
    top = pred.buckets[-1]
    for _ in range(reps):
        st = dict.fromkeys(PREDICT_STAGES, 0.0)
        t0 = time.perf_counter()
        x = pred._canon(rows)
        st["canon_pad"] += time.perf_counter() - t0
        outs = []
        for s in range(0, len(x), top):
            t0 = time.perf_counter()
            xb = x[s:s + top]
            b = pred._bucket(len(xb))
            pad = b - len(xb)
            if pad:
                xb = np.pad(xb, ((0, pad), (0, 0)))
            xb = np.ascontiguousarray(xb)
            t1 = time.perf_counter()
            dev = torch.from_numpy(xb).to(pred.device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            leaf = pred._dispatch_leaf(dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            outs.append(leaf.cpu().numpy()[:b - pad])
            t4 = time.perf_counter()
            st["canon_pad"] += t1 - t0
            st["h2d"] += t2 - t1
            st["launch"] += t3 - t2
            st["d2h"] += t4 - t3
        t0 = time.perf_counter()
        leaves = np.concatenate(outs, axis=0)
        vals = pred._lv64[np.arange(pred.num_trees)[None, :], leaves]
        t1 = time.perf_counter()
        raw = vals @ pred._onehot64
        t2 = time.perf_counter()
        got = 1.0 / (1.0 + np.exp(-2.0 * pred.sigmoid * raw))
        t3 = time.perf_counter()
        st["gather"], st["product"], st["transform"] = \
            t1 - t0, t2 - t1, t3 - t2
        same = same and bool(np.array_equal(got, want))
        for k, v in st.items():
            samples[k].append(v)
        samples["staged_total"].append(sum(st.values()))
        t0 = time.perf_counter()
        pred.predict(rows)
        samples["predict"].append(time.perf_counter() - t0)
    res = {k + "_ms": 1e3 * float(np.median(v)) for k, v in samples.items()}
    res.update(rows=len(rows), reps=reps, bit_equal_to_predict=same)
    log(f"predict stages, {len(rows)} rows (median of {reps}, ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in res.items()
                    if k.endswith("_ms")))
    check(same, f"staged predict of {len(rows)} rows differs from predict")
    return res


def coalesced_tol(pred):
    """Bound on two f64 sums of the same leaf values in two orders: T
    trees x float64 eps x the sum of each tree's largest |leaf value|
    (a sigmoid only shrinks the difference)."""
    return (pred.num_trees * float(np.finfo(np.float64).eps)
            * float(np.abs(pred._lv64).max(axis=1).sum()))


def http_phase(pred, rows):
    """make_server in process on 127.0.0.1, port 0: POSTs of 1, 64 and
    4096 rows must equal pred.predict on the same rows bit for bit; 8
    client threads of single-row requests must coalesce (fewer batches
    than requests) and agree with pred.predict on each row alone within
    coalesced_tol (a coalesced batch's f64 product associates its sums
    in another order); /healthz and /metricz answer."""
    import threading
    import urllib.request
    from lightgbm_tpu_torch.serving import make_server

    srv = make_server(pred, host="127.0.0.1", port=0, max_wait_ms=2.0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def post(r):
        req = urllib.request.Request(
            url + "/predict", data=json.dumps({"rows": r.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return np.asarray(json.loads(resp.read())["predictions"])

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            return json.loads(resp.read())

    res = {}
    try:
        exact = {}
        for n in (1, 64, SERVE_BUCKET):
            t0 = time.perf_counter()
            got = post(rows[:n])
            exact[n] = bool(np.array_equal(got, pred.predict(rows[:n])))
            res[f"post_{n}_ms"] = 1e3 * (time.perf_counter() - t0)
        res["bit_equal"] = exact
        errors, answers = [], {}
        m0 = get("/metricz")

        def client(k):
            try:
                for i in range(HTTP_REQUESTS_EACH):
                    j = k * HTTP_REQUESTS_EACH + i
                    answers[j] = post(rows[j:j + 1])
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(HTTP_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(120)
        res["concurrent_s"] = time.perf_counter() - t0
        m1 = get("/metricz")
        n_req = HTTP_CLIENTS * HTTP_REQUESTS_EACH
        want = pred.predict(rows[:n_req])
        got = np.concatenate([answers[j] for j in range(n_req)]) \
            if len(answers) == n_req else None
        res["concurrent"] = {
            "requests": n_req,
            "batches": m1["batch_count"] - m0["batch_count"],
            "errors": errors, "tol": coalesced_tol(pred),
            "max_abs_diff": (float(np.max(np.abs(got - want)))
                             if got is not None else None)}
        health = get("/healthz")
        res["healthz"] = {"status": health["status"],
                          "num_trees": health["model"]["num_trees"]}
        res["metricz"] = {k: m1[k] for k in (
            "request_count", "rows_served", "batch_count", "error_count",
            "latency_p50_ms", "latency_p99_ms", "cold_dispatches",
            "warm_dispatches")}
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(10)
    log(f"http: bit-equal {res['bit_equal']}, concurrent {res['concurrent']}"
        f", healthz {res['healthz']}, metricz {res['metricz']}")
    check(all(res["bit_equal"].values()),
          "HTTP answers differ from CompiledPredictor.predict")
    c = res["concurrent"]
    check(not c["errors"] and c["max_abs_diff"] is not None
          and c["max_abs_diff"] <= c["tol"],
          f"concurrent requests failed or disagree: {c}")
    check(c["batches"] < c["requests"],
          f"no coalescing: {c['batches']} batches for {c['requests']}")
    check(res["healthz"]["status"] == "ok", "healthz not ok")
    check(res["metricz"]["error_count"] == 0
          and res["metricz"]["cold_dispatches"] == 0,
          f"metricz: {res['metricz']}")
    return res


def compare_predictors(torch, pred, base, rows, pairs=10):
    """This checkout's predictor and the other checkout's (--baseline) on
    the same model file, in `pairs` pairs of turns whose order alternates
    (this, other, other, this, ...): a turn is 100 single-row predict
    calls (its p50) and predict's stages on one row (20 runs). Reports
    each side's median turn p50 and stages, the pairs this side won, the
    other side's own quartile spread, and the host microseconds of one
    tree_leaf dispatch at the 1-row bucket. Both must give the same
    answers."""
    preds = {"this": pred, "baseline": base}
    row = rows[:1]
    turns = {k: [] for k in preds}
    for i in range(pairs):
        for name in (("this", "baseline") if i % 2 == 0
                     else ("baseline", "this")):
            p = preds[name]
            p.predict(row)
            lats = []
            for _ in range(100):
                t0 = time.perf_counter()
                p.predict(row)
                lats.append(time.perf_counter() - t0)
            turns[name].append((1e3 * float(np.median(lats)),
                                predict_stages(torch, p, row, 20)))
    xb = torch.from_numpy(np.ascontiguousarray(row)).to(DEVICE)
    out = {"pairs": pairs, "same_answers": bool(np.array_equal(
        pred.predict(rows[:SERVE_BUCKET]), base.predict(rows[:SERVE_BUCKET])))}
    for name, p in preds.items():
        p50s = [t[0] for t in turns[name]]
        stages = {k: float(np.median([t[1][k] for t in turns[name]]))
                  for k in turns[name][0][1] if k.endswith("_ms")}
        out[name] = {"turn_p50_ms": p50s,
                     "latency_p50_ms": float(np.median(p50s)),
                     "quartile_spread_ms": float(np.subtract(
                         *np.percentile(p50s, [75, 25]))),
                     "stages_1_row_ms": stages,
                     "leaf_host_us": host_us(
                         torch, lambda p=p: p._dispatch_leaf(xb))}
        log(f"single-row predict, {name}: median turn p50 "
            f"{out[name]['latency_p50_ms']:.4f} ms (quartile spread "
            f"{out[name]['quartile_spread_ms']:.4f}), launch stage "
            f"{stages['launch_ms'] * 1e3:.1f} us, tree_leaf host "
            f"{out[name]['leaf_host_us']:.1f} us")
    out["this_wins"] = sum(a < b for a, b in zip(out["this"]["turn_p50_ms"],
                                               out["baseline"]["turn_p50_ms"]))
    log(f"single-row predict: this side won {out['this_wins']} of {pairs} "
        "pairs")
    check(out["same_answers"], "the baseline predictor gave other answers")
    return out


def phase_serving(torch, lgt, ds, x, cat_booster, cat_x, timer, seed):
    """The serving path at full width: the bench model trained 100
    rounds (fused masked trainer), frozen from its model text in f32 and
    bf16 (max_batch_rows 4096); the traversal kernels held against their
    plain versions and timed; bench.py serving_probe's numbers; the HTTP
    server. Launch counts of the serving main path (probe + HTTP) are
    read from zero."""
    import tempfile
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.ops import traverse_kernels as tk
    from lightgbm_tpu_torch.serving import CompiledPredictor

    rng = np.random.RandomState(seed + 5)
    res = {}
    t0 = time.perf_counter()
    booster = lgt.train(BENCH_PARAMS, ds, SERVE_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    check(len(booster.gbdt.models) == SERVE_ROUNDS,
          "the serving model stopped early")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_model.txt")
        booster.save_model(path)
        t0 = time.perf_counter()
        pred = CompiledPredictor.from_model_file(path, max_batch_rows=SERVE_BUCKET)
        res["warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bf16 = CompiledPredictor.from_model_file(
            path, max_batch_rows=SERVE_BUCKET, serving_precision="bf16")
        res["warmup_bf16_s"] = time.perf_counter() - t0
        host = GBDT(device="cpu")
        with open(path) as f:
            host.load_model_from_string(f.read())
        if BASELINE is not None:
            base_pred = baseline_module("serving").CompiledPredictor \
                .from_model_file(path, max_batch_rows=SERVE_BUCKET)
    host.force_host_predict = True
    res.update(num_trees=pred.num_trees, depth=pred.depth,
               node_slots=int(pred._forest.sf.shape[1]),
               compile_cache_hits=pred.stats["compile_cache_hits"],
               accuracy_bound=bf16.accuracy_bound)
    log(f"serving model: {pred.num_trees} trees ({res['node_slots']} node "
        f"slots each), depth {pred.depth}, trained in "
        f"{res['train_s']:.1f}s; warm-up f32 {res['warmup_s']:.3f}s bf16 "
        f"{res['warmup_bf16_s']:.3f}s, library found built "
        f"{res['compile_cache_hits']}, bf16 bound {bf16.accuracy_bound:.3g}")

    # kernel checks (their launches are not the main path's)
    xv, _ = make_valid(SERVE_ROWS, seed)
    xv = plant_specials(xv, rng)
    res["leaf_check"] = check_leaves(torch, tk, pred, xv, "bench model")
    cats = list(range(N_FEATURES, N_FEATURES + N_CAT))
    xc = plant_specials(cat_x[:SERVE_ROWS], rng, cols=cats, frac=0.05)
    cat_pred = CompiledPredictor.from_booster(cat_booster,
                                              max_batch_rows=SERVE_BUCKET)
    res["leaf_check_categorical"] = check_leaves(torch, tk, cat_pred, xc,
                                                 "categorical model")
    cat_leaves = cat_pred.predict_leaf_index(xc[:20_000])
    check(np.array_equal(cat_leaves, cat_booster.predict(
        xc[:20_000], pred_leaf=True)),
          "categorical: served leaf indices differ from the host traversal")
    res["raw_checks"] = check_raw_cases(torch, tk, pred, bf16,
                                        xv[:SERVE_BUCKET * 4], rng)
    cases = {
        "tree_leaf": traverse_case(torch, tk, timer, "tree_leaf", pred,
                                   xv[:SERVE_BUCKET]),
        "tree_raw": traverse_case(torch, tk, timer, "tree_raw", pred,
                                  xv[:SERVE_BUCKET]),
        "tree_leaf_1": traverse_case(torch, tk, timer, "tree_leaf", pred,
                                     xv[:1]),
        "tree_raw_1": traverse_case(torch, tk, timer, "tree_raw", pred,
                                    xv[:1]),
        "tree_raw_bf16": traverse_case(torch, tk, timer, "tree_raw", bf16,
                                       xv[:SERVE_BUCKET])}
    res["kernel_cases"] = cases

    # the main path: bench.py serving_probe on both predictors, then HTTP
    rows = np.ascontiguousarray(x[:SERVE_ROWS], dtype=np.float32)
    tk.reset_launch_counts()
    res["probe_f32"], _ = serving_probe(torch, pred, rows, "f32")
    res["probe_bf16"], served16 = serving_probe(torch, bf16, rows, "bf16")
    res["http"] = http_phase(pred, rows)
    res["launches"] = tk.launch_counts()
    log(f"serving main path launches: {res['launches']}")
    check(res["launches"]["tree_leaf"] > 0 and res["launches"]["tree_raw"] > 0,
          f"the serving path missed a kernel: {res['launches']}")
    check(res["launches"]["tree_leaf"] >= res["http"]["metricz"]["batch_count"],
          "HTTP batches did not all launch tree_leaf")
    # where a request's time goes: predict's stages timed apart (these
    # launches come after the main path's counts were read)
    res["stages_1_row"] = predict_stages(torch, pred, rows[:1], 100)
    res["stages_100k"] = predict_stages(torch, pred, rows, 5)
    if BASELINE is not None:
        res["baseline_predictor"] = compare_predictors(torch, pred,
                                                       base_pred, rows)

    # exactness: the predictor's leaves are the host f64 traversal's, and
    # its f64 reduce is the JAX predictor's product of those leaves; the
    # host path's per-class pairwise sum associates differently
    rows = rows[:HOST_CHECK_ROWS]
    served = pred.predict(rows)
    leaves = pred.predict_leaf_index(rows)
    host_leaves = host.predict_leaf_index(rows)
    res["leaves_equal_host"] = bool(np.array_equal(leaves, host_leaves))
    product = host._stacked_model_arrays(pred.num_trees)[5][
        np.arange(pred.num_trees)[None, :], host_leaves] @ pred._onehot64
    want = 1.0 / (1.0 + np.exp(-2.0 * pred.sigmoid * product))
    res["equal_to_host_leaf_product"] = bool(np.array_equal(served, want))
    host_pred = host.predict(rows)
    diff = np.abs(served - host_pred)
    res["vs_host_path"] = {"rows_bit_equal": int((diff == 0).sum()),
                           "rows": len(rows), "max_abs_diff": float(diff.max())}
    res["bf16_vs_exact"] = float(np.abs(served16[:len(rows)] - served).max())
    log(f"exact path: leaves equal host {res['leaves_equal_host']}, equal to "
        f"the host leaves' product {res['equal_to_host_leaf_product']}, vs "
        f"the host path {res['vs_host_path']}; bf16 vs exact "
        f"{res['bf16_vs_exact']:.3g} (bound {bf16.accuracy_bound:.3g})")
    check(res["leaves_equal_host"], "served leaves differ from the host's")
    check(res["equal_to_host_leaf_product"],
          "predict differs from the f64 product of the host leaves")
    check(res["vs_host_path"]["max_abs_diff"] <= coalesced_tol(pred),
          f"predict differs from the host path: {res['vs_host_path']}")
    check(res["bf16_vs_exact"] <= bf16.accuracy_bound,
          "bf16 predict outside its accuracy bound")
    return res, cases


# ------------------------------------------------- GOSS, DART, linear leaves

GOSS_PARAMS = dict(BENCH_PARAMS, boosting="goss", learning_rate=0.25,
                   hist_compaction="auto")
GOSS_ROUNDS = 8          # a warm-up of ceil(1 / 0.25) = 4, then 4 sampled
DART_PARAMS = dict(BENCH_PARAMS, boosting="dart", drop_rate=0.1)
DART_ROUNDS = 10
LINEAR_PARAMS = dict(BENCH_PARAMS, linear_tree=True)
LINEAR_ROUNDS = 3
EPS32 = float(np.finfo(np.float32).eps)


def goss_sample_check(w, cfg):
    """One sampled iteration's (N,) host weights against GOSS's
    expectations: at least top_n rows of weight 1 (ties join the top);
    the sampled rest (the rows of weight amp = n_rest / rand_n) within 5
    sigma of rand_n, a binomial over the n_rest rows with p = rand_n /
    n_rest; the weights' sum within 5 sigma of N (its mean; sigma = amp x
    the count's)."""
    n = len(w)
    top_n = max(1, int(cfg.top_rate * n))
    rand_n = int(cfg.other_rate * n)
    top = int((w == 1.0).sum())
    amp_rows = w[(w != 0.0) & (w != 1.0)]
    sampled = len(amp_rows)
    amp = float(amp_rows[0]) if sampled else 0.0
    n_rest = n - top
    p = rand_n / max(n_rest, 1)
    sigma = float(np.sqrt(n_rest * p * (1.0 - p)))
    total = float(w.astype(np.float64).sum())
    res = {"top": top, "top_n": top_n, "sampled": sampled, "rand_n": rand_n,
           "sigma": sigma, "amp": amp, "weight_sum": total, "n": n,
           "one_amp": bool(np.all(amp_rows == amp_rows[0])) if sampled
           else True}
    res["ok"] = (top >= top_n and res["one_amp"]
                 and abs(sampled - rand_n) <= 5 * sigma
                 and abs(total - n) <= 5 * amp * sigma)
    return res


def timed_updates(torch, booster, rounds, after=None):
    """`rounds` Booster.update calls, each timed on the host to a device
    sync (ms); `after(it)` runs after each, outside the timing."""
    round_ms = []
    for it in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        if after is not None:
            after(it)
    return round_ms


def goss_per_iteration(torch, lgt, ds, params):
    """GOSS_ROUNDS per-iteration rounds; each sampled iteration's weights
    kept on the device (a clone) and checked after the loop."""
    booster = lgt.Booster(dict(params), ds)
    gbdt = booster.gbdt
    kept = {}
    orig = gbdt._bagging

    def record(it, g=None, h=None):
        w = orig(it, g, h)
        if w is not None:
            kept[it] = w.clone()
        return w
    gbdt._bagging = record
    round_ms = timed_updates(torch, booster, GOSS_ROUNDS)
    samples = {it: goss_sample_check(w.cpu().numpy(), gbdt.config)
               for it, w in kept.items()}
    return booster, round_ms, samples


def phase_goss(torch, lgt, hk, ds, comp_fused, timer):
    """GOSS on the bench data at full width (learning_rate 0.25: 4
    warm-up iterations, then 4 sampled), on the default compacted engine
    per iteration (counts from zero; each sampled iteration's weights
    checked: goss_sample_check) and fused (lgt.train's fast path, counts
    through the replays; the model text must equal the per-iteration
    one), then the fused blocks timed beside the compacted phase's plain
    gbdt fused round, a replay profiled, and the weights' device time
    (_goss_weights at 1M rows, its sort apart); then both with
    partitioned_build=true."""
    res = {}
    hk.reset_launch_counts()
    booster, round_ms, samples = goss_per_iteration(torch, lgt, ds,
                                                    GOSS_PARAMS)
    counts = hk.launch_counts()
    gbdt = booster.gbdt
    warmup = gbdt._warmup
    res["per_iteration"] = {"round_ms": round_ms,
                            "round_ms_median": float(np.median(round_ms)),
                            "sampled_round_ms_median": float(np.median(
                                round_ms[warmup:])),
                            "launches": counts, "warmup": warmup,
                            "samples": {str(k): v
                                        for k, v in samples.items()}}
    log(f"goss per-iteration: round ms {[round(v, 1) for v in round_ms]} "
        f"(warm-up {warmup}), launches {counts}; samples "
        + "; ".join(f"it {k}: top {v['top']} (>= {v['top_n']}), sampled "
                    f"{v['sampled']} (rand_n {v['rand_n']}, sigma "
                    f"{v['sigma']:.1f}), amp {v['amp']:.4f}, weight sum "
                    f"{v['weight_sum']:.1f}" for k, v in samples.items()))
    check(len(gbdt.models) == GOSS_ROUNDS, "goss: training stopped early")
    check(gbdt.tree_learner.use_compact, "goss: not the compacted engine")
    check(sorted(samples) == list(range(warmup, GOSS_ROUNDS)),
          f"goss: sampled iterations {sorted(samples)}")
    check(all(v["ok"] for v in samples.values()),
          "goss: a sample is off its expectation")
    check(counts["compacted_hist"] >= GOSS_ROUNDS * 62
          and counts["frontier_hist"] >= GOSS_ROUNDS,
          f"goss: kernels launched {counts}")

    hk.reset_launch_counts()
    fused = lgt.train(dict(GOSS_PARAMS), ds, GOSS_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    counts = hk.launch_counts()
    runner = fused_runner(fused)
    per_replay = dict(runner.graph.launches) if runner.graph else {}
    text_equal = fused.model_to_string() == booster.model_to_string()
    res["fused"] = {"launches": counts, "launches_per_replay": per_replay,
                    "model_text_equal": text_equal}
    log(f"goss fused: launches {counts} ({per_replay} a replay), model "
        f"text equal to the per-iteration one {text_equal}")
    check(runner.graph is not None, "goss fused: no graph was captured")
    check(text_equal, "goss fused: model text differs from per-iteration")
    for kname, c in per_replay.items():
        check(counts[kname] == (GOSS_ROUNDS + 1) * c,
              f"goss fused: {kname} counted {counts[kname]}, not "
              f"{GOSS_ROUNDS + 1} x {c}")
    del fused, runner

    timed = lgt.Booster(dict(GOSS_PARAMS), ds)
    check(timed.gbdt.warm_up_fused(GOSS_ROUNDS), "goss: not fused-eligible")
    block_ms = []
    for _ in range(3):      # the first block holds the warm-up iterations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.gbdt.train_many(GOSS_ROUNDS)
        torch.cuda.synchronize()
        block_ms.append(1e3 * (time.perf_counter() - t0))
    runner = fused_runner(timed)
    prof = profile_replay(torch, runner)
    tg = timed.gbdt
    g, h = tg.objective.get_gradients(tg.train_score_updater.score)
    it_dev = torch.tensor([4 * GOSS_ROUNDS], dtype=torch.int64,
                          device=DEVICE)
    score = (g * h).abs().sum(dim=0)
    res["fused"].update(
        block_ms=block_ms,
        round_ms_median=float(np.median(block_ms[1:])) / GOSS_ROUNDS,
        profile=prof,
        weights_ms=timer(lambda: tg._goss_weights(it_dev, g, h), 20),
        sort_ms=timer(lambda: torch.sort(score), 20),
        # the (K, N) gradients and hessians read and the (N,) weights
        # written, over HBM bandwidth; the sort apart (sort_ms)
        weights_bound_ms=1e3 * (2 * g.numel() + tg.num_data) * 4
        / PEAK_BYTES_PER_S, weights_bound_by="bytes")
    fr = res["fused"]
    res["fused_vs_gbdt_round"] = {
        "goss_fused_ms": fr["round_ms_median"],
        "goss_per_iteration_sampled_ms":
            res["per_iteration"]["sampled_round_ms_median"],
        "gbdt_fused_ms": comp_fused["round_ms_median"],
        "goss_busy_ms": prof["device_busy_ms"],
        "gbdt_busy_ms": comp_fused["profile"]["device_busy_ms"],
        "goss_hist_ms": prof["hist_ms"],
        "gbdt_hist_ms": comp_fused["profile"]["hist_ms"]}
    log(f"goss fused blocks of {GOSS_ROUNDS} "
        f"{[round(v, 1) for v in block_ms]} ms (sampled blocks' round "
        f"{fr['round_ms_median']:.2f} ms); weights {fr['weights_ms']:.3f} ms "
        f"(sort {fr['sort_ms']:.3f} ms; bound without the sort "
        f"{fr['weights_bound_ms']:.5f} ms) at {tg.num_data} rows; a replay: "
        f"busy {prof['device_busy_ms']} ms, histograms "
        f"{prof['hist_ms']:.2f} ms, idle share {prof['device_idle_share']}; "
        f"against gbdt (this run): {res['fused_vs_gbdt_round']}")
    del timed, runner, g, h, score

    part_params = dict(GOSS_PARAMS, partitioned_build="true")
    hk.reset_launch_counts()
    seq, round_ms, samples = goss_per_iteration(torch, lgt, ds, part_params)
    seq_counts = hk.launch_counts()
    hk.reset_launch_counts()
    fused = lgt.train(dict(part_params), ds, GOSS_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    counts = hk.launch_counts()
    runner = fused_runner(fused)
    per_replay = dict(runner.graph.launches) if runner.graph else {}
    text_equal = fused.model_to_string() == seq.model_to_string()
    res["partitioned"] = {
        "round_ms_median": float(np.median(round_ms)),
        "launches_per_iteration": seq_counts, "launches_fused": counts,
        "launches_per_replay": per_replay, "model_text_equal": text_equal,
        "samples_ok": all(v["ok"] for v in samples.values())}
    log(f"goss partitioned: per-iteration round ms "
        f"{[round(v, 1) for v in round_ms]}, launches {seq_counts}; fused "
        f"launches {counts}; model text equal {text_equal}")
    check(text_equal, "goss partitioned: fused text differs")
    check(res["partitioned"]["samples_ok"], "goss partitioned: a sample is off")
    check(seq_counts["seg_hist"] >= GOSS_ROUNDS * 63
          and counts["seg_hist"] == (GOSS_ROUNDS + 1)
          * per_replay.get("seg_hist", -1),
          f"goss partitioned: seg_hist {seq_counts} / {counts}")
    return res


def dart_drop_replay(seed, rate, rounds):
    """The drop sets a DART run draws, replayed on the host from
    Random(drop_seed) (dart.hpp:85-110)."""
    from lightgbm_tpu_torch.utils.random import Random
    r = Random(seed)
    out = []
    for it in range(rounds):
        drop = ([i for i in range(it) if r.next_double() < rate]
                if rate > 1e-15 else [])
        if not drop:
            drop = [int(i) for i in r.sample(it, 1)]
        out.append(drop)
    return out


def phase_dart(torch, lgt, hk, ds, x):
    """DART on the bench data, DART_ROUNDS per-iteration rounds (counts
    from zero): the drop sets against a host replay of Random(drop_seed);
    the train score against a fresh bin-space scoring of the final model,
    within the float32 rounding of every add and subtract made (each at
    most 2^-24 of a sum no larger than the trees' largest leaves at their
    creation weight); the trained booster's predictions (host and device
    routes) against a booster loaded from its model text, which must
    round-trip byte for byte."""
    from lightgbm_tpu_torch.models.gbdt import create_boosting
    from lightgbm_tpu_torch.models.score_updater import ScoreUpdater
    hk.reset_launch_counts()
    booster = lgt.Booster(dict(DART_PARAMS), ds)
    gbdt = booster.gbdt
    drops, created = [], []

    def after(it):
        drops.append(list(gbdt.drop_index))
        created.append(float(np.abs(gbdt.models[-1].leaf_value).max()))
    round_ms = timed_updates(torch, booster, DART_ROUNDS, after)
    counts = hk.launch_counts()
    want = dart_drop_replay(gbdt.config.drop_seed, gbdt.config.drop_rate,
                            DART_ROUNDS)
    fresh = ScoreUpdater(gbdt.train_data, 1, gbdt.device)
    fresh.add_score_by_trees(gbdt.models, 1)
    score_diff = float((fresh.score - gbdt.train_score_updater.score)
                       .abs().max())
    n_ops = sum(1 + 2 * len(d) for d in drops) + DART_ROUNDS
    score_bound = n_ops * 2.0 ** -24 * sum(created)
    text = booster.model_to_string()
    loaded = create_boosting(text.splitlines()[0], DEVICE)
    loaded.load_model_from_string(text)
    rows = np.asarray(x[:HOST_CHECK_ROWS], np.float64)
    same = {}
    for route in ("false", "true"):
        gbdt.device_predict = loaded.device_predict = route
        same[route] = bool(np.array_equal(gbdt.predict(rows),
                                          loaded.predict(rows)))
    res = {"round_ms": round_ms, "round_ms_median": float(np.median(round_ms)),
           "launches": counts, "drops": drops, "drops_equal_replay":
           drops == want, "train_score_vs_fresh": score_diff,
           "train_score_bound": score_bound, "predict_equal_loaded": same,
           "text_round_trip": loaded.save_model_to_string() == text,
           "loaded_class": type(loaded).__name__}
    log(f"dart: round ms {[round(v, 1) for v in round_ms]}, launches "
        f"{counts}, drops {drops} (replay equal "
        f"{res['drops_equal_replay']}), train score vs a fresh scoring "
        f"{score_diff:.3g} (bound {score_bound:.3g}), predict equal to the "
        f"loaded booster {same}, text round trip {res['text_round_trip']}")
    check(len(gbdt.models) == DART_ROUNDS, "dart: training stopped early")
    check(res["drops_equal_replay"], f"dart: drop sets {drops} != {want}")
    check(score_diff <= score_bound, "dart: train score off a fresh scoring")
    check(all(same.values()), "dart: predictions differ from a reload")
    check(res["text_round_trip"] and res["loaded_class"] == "DART",
          "dart: the model text does not round-trip")
    check(counts["masked_hist"] >= DART_ROUNDS * 62,
          f"dart: masked_hist launched {counts['masked_hist']}")
    return res


def plant_nan(x, rng, frac=0.02):
    """x (float32) with NaN in `frac` of its entries."""
    x = np.array(x, dtype=np.float32)
    x[rng.rand(*x.shape) < frac] = np.nan
    return x


def lin_bound_ms(x, forest, leaves, lv, lin, num_class):
    """Least time for one tree_lin_raw call on this run's rows: x and
    node0 read once, the node records on the rows' paths read once and
    the (B, K) sums written once; of the linear blocks only what the
    rows' lanes need, once for each (tree, leaf) some row reaches: its
    count, and at a linear leaf its intercept and the coefficient and
    column of each live slot; of the leaf values those of the reached
    leaves whose value some lane returns (a constant leaf, or a linear
    one that a row's NaN in a live column sends to its fallback). Over
    HBM bandwidth; against one compare a walk step, a multiply and an
    add a live slot, one add for the intercept at a linear lane and one
    a (row, tree) for the class sums, over the float32 rate. Returns
    (ms, bound_by)."""
    b, f = x.shape
    t = forest.sf.shape[0]
    t_idx = np.broadcast_to(np.arange(leaves.shape[1])[None, :],
                            leaves.shape)
    from lightgbm_tpu_torch.ops.traverse_kernels import unpack_linear
    steps, nodes, reached = walk_reads(forest, leaves)
    _, _, feat, cnt, _ = (a.cpu().numpy() for a in unpack_linear(lin))
    word = lin.dtype.itemsize
    lane_cnt = np.maximum(cnt[t_idx, leaves], 0)               # (B, T)
    xf = x.cpu().numpy()[np.arange(b)[:, None, None],
                         feat[t_idx, leaves]]                  # (B, T, C)
    live = np.arange(feat.shape[2]) < lane_cnt[:, :, None]
    needs_lv = (lane_cnt == 0) | (np.isnan(xf) & live).any(axis=2)
    lv_leaves = np.zeros(cnt.shape, bool)
    lv_leaves[t_idx[needs_lv], leaves[needs_lv]] = True
    r_cnt = np.maximum(cnt[reached], 0)
    nbytes = (b * f * 4 + nodes * 16 + t * 4 + b * num_class * 4
              + r_cnt.size * 4
              + int((r_cnt > 0).sum()) * word
              + int(r_cnt.sum()) * (word + 4)
              + int(lv_leaves.sum()) * lv.element_size())
    ops = (steps + 2 * float(lane_cnt.sum()) + float((lane_cnt > 0).sum())
           + b * t)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def lin_checks(torch, tk, pred, pred16, rows, host_raw, bucket):
    """tree_lin_raw on `bucket` rows: each precision (f32, bf16) and
    variant (raw, transformed) bit for bit its plain version on the card
    and across two launches; f32 raw within the class-sum bound of the
    host f64 path ((T + 9) roundings of a lane's terms' magnitude, |const|
    + sum |coef x|, summed over trees: the 8 slots' products and adds
    then the tree-order adds), bf16 raw within the pinned accuracy
    bound."""
    x = torch.from_numpy(np.ascontiguousarray(rows[:bucket])).to(DEVICE)
    leaves = pred.predict_leaf_index(rows[:bucket])
    t_idx = np.arange(pred.num_trees)[None, :]
    xf = np.nan_to_num(rows[:bucket].astype(np.float64)[
        np.arange(bucket)[:, None, None], pred._lin_feat[t_idx, leaves]])
    live = (np.arange(tk.COEF_PAD)[None, None, :]
            < pred._lin_cnt[t_idx, leaves][:, :, None])
    mag = (np.abs(pred._lin_const64[t_idx, leaves])
           + np.where(live, np.abs(pred._lin_coef64[t_idx, leaves] * xf),
                      0.0).sum(axis=2))
    mag = np.maximum(mag, np.abs(pred._lv64[t_idx, leaves]))
    bound = (pred.num_trees + tk.COEF_PAD + 1) * EPS32 * float(
        mag.max(axis=0).sum())
    out = {"rows": bucket, "class_sum_bound": bound}
    for p in (pred, pred16):
        lv = p._linear_values()
        for transform in (False, True):
            def kern():
                return tk.tree_lin_raw(x, p._forest, lv, p._lin_dev,
                                       p.num_class, transform, p.sigmoid)
            got, again = kern(), kern()
            want = tk.tree_lin_raw_plain(x, p._forest, lv, p._lin_dev,
                                         p.num_class, transform, p.sigmoid)
            torch.cuda.synchronize()
            key = f"{p.serving_precision}_{'tr' if transform else 'raw'}"
            out[key] = {
                "bitwise_vs_plain": bool(torch.equal(
                    got.view(torch.int32), want.view(torch.int32))),
                "deterministic": bool(torch.equal(got.view(torch.int32),
                                                  again.view(torch.int32))),
                "max_abs_err": float((got - want).abs().max())}
            if not transform:
                vs = float(np.abs(got.cpu().numpy().astype(np.float64)
                                  - host_raw[:bucket]).max())
                out[key]["vs_host_f64"] = vs
                limit = bound if p is pred else p.accuracy_bound
                out[key]["limit"] = limit
                check(vs <= limit, f"tree_lin_raw {key} {bucket} rows: {vs} "
                      f"from the host f64 path (bound {limit})")
            check(out[key]["bitwise_vs_plain"],
                  f"tree_lin_raw {key} {bucket} rows: differs from plain "
                  f"by {out[key]['max_abs_err']}")
            check(out[key]["deterministic"],
                  f"tree_lin_raw {key} {bucket} rows: launches differ")
    log(f"tree_lin_raw checks, {bucket} rows: {out}")
    return out


def random_linear_blocks(rng, t, l, f):
    """Random linear blocks for a (T, L) forest: a third of the leaves
    constant, the rest 1..8 live slots on random columns."""
    from lightgbm_tpu_torch.ops.traverse_kernels import COEF_PAD
    cnt = rng.randint(1, COEF_PAD + 1, size=(t, l)).astype(np.int32)
    cnt[rng.rand(t, l) < 1.0 / 3.0] = 0
    feat = rng.randint(0, f, size=(t, l, COEF_PAD)).astype(np.int32)
    coef = rng.randn(t, l, COEF_PAD) * 0.05
    const = rng.randn(t, l) * 0.1
    return const, coef, feat, cnt


def lin_forest_case(torch, tk, timer, rng, rows):
    """tree_lin_raw on a forest of the serving model's size (100 random
    trees of 63 leaves, random linear blocks) at a 4096-row bucket:
    bit for bit its plain version, timed beside tree_raw on the same
    forest, its plain version and its bound."""
    arrays, lv = random_forest(rng, SERVE_ROUNDS, 63, N_FEATURES)
    forest = tk.freeze(*arrays, DEVICE)
    const, coef, feat, cnt = random_linear_blocks(rng, *lv.shape,
                                                  N_FEATURES)
    lin = tk.freeze_linear(const, coef, feat, cnt, lv, torch.float32, DEVICE)
    lv32 = torch.from_numpy(lv).to(DEVICE)
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(DEVICE)
    got = tk.tree_lin_raw(x, forest, lv32, lin, 1)
    want = tk.tree_lin_raw_plain(x, forest, lv32, lin, 1)
    torch.cuda.synchronize()
    leaves = tk.tree_leaf(x, forest).cpu().numpy()
    res = {"T": SERVE_ROUNDS, "L": 63, "B": len(rows),
           "bitwise_vs_plain": bool(torch.equal(got.view(torch.int32),
                                                want.view(torch.int32))),
           "live_slots_per_lane": float(cnt[np.arange(SERVE_ROUNDS)[None, :],
                                            leaves].mean())}
    res["bound_ms"], res["bound_by"] = lin_bound_ms(x, forest, leaves, lv32,
                                                    lin, 1)
    res["ms"] = timer(lambda: tk.tree_lin_raw(x, forest, lv32, lin, 1), 50)
    res["ms_1_row"] = timer(lambda: tk.tree_lin_raw(x[:1], forest, lv32, lin,
                                                    1), 50)
    res["tree_raw_ms"] = timer(lambda: tk.tree_raw(x, forest, lv32, 1), 50)
    res["plain_ms"] = timer(lambda: tk.tree_lin_raw_plain(x, forest, lv32,
                                                          lin, 1), 5)
    lin_baseline(torch, tk, timer, res, x, forest, lv32, lin,
                 (const, coef, feat, cnt), got)
    log(f"tree_lin_raw on 100 random trees of 63 leaves, {len(rows)} rows: "
        f"{res}")
    check(res["bitwise_vs_plain"], "tree_lin_raw, 100 trees: differs from "
          "its plain version")
    return res


def lin_baseline(torch, tk, timer, res, x, forest, lv, lin, blocks, got,
                 k=1):
    """With --baseline: the other checkout's tree_lin_raw on the same
    forest, rows and linear blocks (frozen in its own layout from the host
    `blocks`): the same bits as `got`, timed at the bucket and at 1 row in
    turns with this checkout's (this, the other, the other, this; the
    median of each's two)."""
    if BASELINE is None:
        return
    btk = BASELINE.traverse_kernels
    bfr = baseline_forest(forest)
    blin = btk.freeze_linear(*blocks, lv.dtype, DEVICE)
    res["baseline_same_bits"] = bool(torch.equal(
        btk.tree_lin_raw(x, bfr, lv, blin, k).view(torch.int32),
        got.view(torch.int32)))
    for rows, key in ((x, ""), (x[:1], "_1_row")):
        calls = (lambda: tk.tree_lin_raw(rows, forest, lv, lin, k),
                 lambda: btk.tree_lin_raw(rows, bfr, lv, blin, k))
        turns = [timer(calls[i], 50) for i in (0, 1, 1, 0)]
        res["turns" + key] = turns
        res["this_ms" + key] = float(np.median([turns[0], turns[3]]))
        res["baseline_ms" + key] = float(np.median([turns[1], turns[2]]))
    log(f"  baseline tree_lin_raw: same bits {res['baseline_same_bits']}, "
        f"ms {res['baseline_ms']:.4f} (this {res['this_ms']:.4f}), 1 row "
        f"{res['baseline_ms_1_row']:.4f} (this {res['this_ms_1_row']:.4f})")
    check(res["baseline_same_bits"], "tree_lin_raw: the baseline gave other "
          "bits")


def phase_linear(torch, lgt, ds, x, timer, seed, ptxas):
    """Linear leaves on the bench data: LINEAR_ROUNDS per-iteration rounds
    (the fit's host seconds a tree); the format-version-2 text through
    save, load, save; a CompiledPredictor of the model whose exact path
    equals the host f64 predict in bits on rows with 2% NaN; tree_lin_raw
    held to its plain version (lin_checks, 4096-row and 1-row buckets),
    timed with L2 flushed beside its bound, its plain version and
    tree_raw on the same forest; ptxas's registers and spills of its
    instantiations; then the serving main path (the `_device` variants
    and bf16 predict) with launches counted from zero."""
    from lightgbm_tpu_torch.models.gbdt import GBDT, create_boosting
    from lightgbm_tpu_torch.ops import traverse_kernels as tk
    from lightgbm_tpu_torch.serving import CompiledPredictor
    rng = np.random.RandomState(seed + 13)
    # the fit's host seconds a tree (it starts after the tree's one sync)
    fit_s, fit = [], GBDT._fit_linear_tree

    def timed_fit(self, *args):
        t0 = time.perf_counter()
        out = fit(self, *args)
        fit_s.append(time.perf_counter() - t0)
        return out
    GBDT._fit_linear_tree = timed_fit
    try:
        booster, round_ms = train_rounds(torch, lgt, LINEAR_PARAMS, ds,
                                         LINEAR_ROUNDS)
    finally:
        GBDT._fit_linear_tree = fit
    gbdt = booster.gbdt
    res = {"round_ms": round_ms, "round_ms_median": float(np.median(round_ms)),
           "fit_s_per_tree": fit_s,
           "linear_leaves": [int((t.leaf_coeff_count > 0).sum())
                             for t in gbdt.models]}
    log(f"linear: round ms {[round(v, 1) for v in round_ms]}, the fit's "
        f"host s a tree {[round(v, 3) for v in fit_s]}, linear "
        f"leaves a tree {res['linear_leaves']}")
    check(len(gbdt.models) == LINEAR_ROUNDS
          and all(t.is_linear for t in gbdt.models),
          "linear: a tree stopped or has no linear leaf")
    text = booster.model_to_string()
    loaded = create_boosting(text.splitlines()[0], "cpu")
    loaded.load_model_from_string(text)
    res["text_round_trip"] = (text.splitlines()[1] == "format_version=2"
                              and loaded.save_model_to_string() == text)
    check(res["text_round_trip"], "linear: v2 text does not round-trip")

    rows = plant_nan(x[:HOST_CHECK_ROWS], rng)
    host_raw = gbdt.predict_raw(rows.astype(np.float64))
    host_pred = gbdt.predict(rows.astype(np.float64))
    pred = CompiledPredictor.from_booster(booster, max_batch_rows=SERVE_BUCKET)
    pred16 = CompiledPredictor.from_booster(booster,
                                            max_batch_rows=SERVE_BUCKET,
                                            serving_precision="bf16")
    res["exact_raw_equal_host"] = bool(np.array_equal(pred.predict_raw(rows),
                                                      host_raw))
    res["exact_equal_host"] = bool(np.array_equal(pred.predict(rows),
                                                  host_pred))
    log(f"linear serving: {pred.num_trees} trees, exact path equal to the "
        f"host f64 path: raw {res['exact_raw_equal_host']}, transformed "
        f"{res['exact_equal_host']}; bf16 bound {pred16.accuracy_bound:.3g}")
    check(res["exact_raw_equal_host"] and res["exact_equal_host"],
          "linear: the exact path differs from the host f64 path")
    res["checks"] = {str(b): lin_checks(torch, tk, pred, pred16, rows,
                                        host_raw, b)
                     for b in (SERVE_BUCKET, 1)}

    xb = torch.from_numpy(np.ascontiguousarray(rows[:SERVE_BUCKET])).to(
        DEVICE)
    lv, lin = pred._f32_values(), pred._lin_dev
    leaves = pred.predict_leaf_index(rows[:SERVE_BUCKET])
    case = {"name": "tree_lin_raw",
            "shape": {"B": SERVE_BUCKET, "F": int(xb.shape[1]),
                      "T": pred.num_trees,
                      "S": int(pred._forest.sf.shape[1])},
            "max_abs_err": res["checks"][str(SERVE_BUCKET)]["f32_raw"][
                "max_abs_err"], "library_ms": None}
    case["bound_ms"], case["bound_by"] = lin_bound_ms(
        xb, pred._forest, leaves, lv, lin, pred.num_class)
    case["ms"] = timer(lambda: tk.tree_lin_raw(xb, pred._forest, lv, lin,
                                               pred.num_class), 50)
    case["ms_warm"] = timer(lambda: tk.tree_lin_raw(
        xb, pred._forest, lv, lin, pred.num_class), 50, flush=False)
    case["ms_transformed"] = timer(lambda: tk.tree_lin_raw(
        xb, pred._forest, lv, lin, pred.num_class, True, pred.sigmoid), 50)
    case["plain_ms"] = timer(lambda: tk.tree_lin_raw_plain(
        xb, pred._forest, lv, lin, pred.num_class), 5)
    case["tree_raw_ms"] = timer(lambda: tk.tree_raw(
        xb, pred._forest, lv, pred.num_class), 50)
    case["ms_1_row"] = timer(lambda: tk.tree_lin_raw(
        xb[:1], pred._forest, lv, lin, pred.num_class), 50)
    lin_baseline(torch, tk, timer, case, xb, pred._forest, lv, lin,
                 (pred._lin_const64, pred._lin_coef64, pred._lin_feat,
                  pred._lin_cnt),
                 tk.tree_lin_raw(xb, pred._forest, lv, lin, pred.num_class),
                 pred.num_class)
    case["ptxas"] = [r for r in ptxas.get(tk.SOURCE, [])
                     if "Lb1EEEv" in r["kernel"]]
    res["kernel_case"] = case
    log(f"tree_lin_raw {case['shape']}: ms {case['ms']:.4f} (L2-warm "
        f"{case['ms_warm']:.4f}, transformed {case['ms_transformed']:.4f}, "
        f"1 row {case['ms_1_row']:.4f}) bound {case['bound_ms']:.5f} "
        f"({case['bound_by']}), plain {case['plain_ms']:.3f}, tree_raw on "
        f"the same forest {case['tree_raw_ms']:.4f}; ptxas "
        + "; ".join(f"{r['registers']} registers, spills "
                    f"{r['spill_stores']}/{r['spill_loads']}"
                    for r in case["ptxas"]))
    check(len(case["ptxas"]) == 4, "linear: ptxas lists "
          f"{len(case['ptxas'])} tree_lin_raw instantiations, not 4")
    res["forest_100"] = lin_forest_case(torch, tk, timer, rng,
                                        rows[:SERVE_BUCKET])

    # the main path: the linear model served through its device variants
    tk.reset_launch_counts()
    dev_raw = pred.predict_raw_device(rows)
    dev_pred = pred.predict_device(rows)
    raw16 = pred16.predict_raw(rows)
    pred16_out = pred16.predict(rows)
    res["launches"] = tk.launch_counts()
    bound = res["checks"][str(SERVE_BUCKET)]["class_sum_bound"]
    res["device_vs_host"] = float(np.abs(dev_raw - host_raw).max())
    res["device_transformed_vs_host"] = float(np.abs(dev_pred
                                                     - host_pred).max())
    res["bf16_vs_host"] = float(max(np.abs(raw16 - host_raw).max(),
                                    np.abs(pred16_out - host_pred).max()))
    log(f"linear serving main path: launches {res['launches']}, device f32 "
        f"vs host {res['device_vs_host']:.3g} (transformed "
        f"{res['device_transformed_vs_host']:.3g}), bf16 vs host "
        f"{res['bf16_vs_host']:.3g} (bound {pred16.accuracy_bound:.3g})")
    check(res["launches"]["tree_lin_raw"] > 0,
          f"linear serving missed tree_lin_raw: {res['launches']}")
    # the transform adds its f32 exp, add and divide on values below 1
    check(res["device_vs_host"] <= bound
          and res["device_transformed_vs_host"] <= bound + 4 * EPS32,
          "linear: the device variants are off the host path")
    check(res["bf16_vs_host"] <= pred16.accuracy_bound,
          "linear: bf16 outside its pinned bound")
    return res, case


# ---------------------------------------------------------------- ingestion

# int16 cases: the lane route's widest table (1,024 bounds), and the
# direct route with its bounds in shared-memory feature tiles
INGEST_INT16_BINS = (1023, 3000)
CLI_ROWS = 100_000
CLI_ROUNDS = 5
TORCH_BIN_DTYPE = {np.dtype(np.uint8): "uint8", np.dtype(np.int16): "int16",
                   np.dtype(np.int32): "int32"}


def bin_bound_ms(n, f, b, out_bytes):
    """Least time for one bin_dense call: x's used columns read once
    (f32), the bounds and columns read once and the (F, N) bins written
    once, over HBM bandwidth; against the binary search's float32
    compares (ceil(log2(B + 1)) a value) over the float32 rate.
    Returns (ms, bound_by)."""
    nbytes = n * f * 4 + f * b * 4 + f * 4 + n * f * out_bytes
    ops = float(n) * f * int(np.ceil(np.log2(b + 1)))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def plant_on_bounds(x, mappers, real_idx, rng):
    """x with each feature's finite bounds (as float32) planted, and one
    float32 step on either side of them, in random rows (in place)."""
    n = len(x)
    for j, m in zip(real_idx, mappers):
        b = np.asarray(m.bin_upper_bound[np.isfinite(m.bin_upper_bound)],
                       np.float32)
        on = np.concatenate([b, np.nextafter(b, np.float32(np.inf)),
                             np.nextafter(b, np.float32(-np.inf))])
        x[rng.choice(n, len(on), replace=False), j] = on
    return x


def bin_kernel_case(torch, bk, timer, x, core, label):
    """bin_dense at the bench shape against its plain version on the
    card and the host pass (bit for bit), two launches bitwise equal,
    timed beside its bound, its plain version and torch.searchsorted
    over the same (F, N) values and (F, B) bounds."""
    dt = core.bins.dtype
    tdt = getattr(torch, TORCH_BIN_DTYPE[np.dtype(dt)])
    mappers, real = core.bin_mappers, core.real_feature_idx
    bounds_np = bk.dense_bounds([m.bin_upper_bound for m in mappers])
    xd = torch.from_numpy(x).to(DEVICE)
    cols = torch.from_numpy(real.astype(np.int32)).to(DEVICE)
    bounds = torch.from_numpy(bounds_np).to(DEVICE)

    def call():
        return bk.bin_dense(xd, cols, bounds, tdt)

    one, two = call(), call()
    torch.cuda.synchronize()
    plain = bk.bin_dense_plain(xd, cols, bounds, tdt)
    host = np.stack([m.value_to_bin(x[:, j]).astype(dt)
                     for j, m in zip(real, mappers)])
    got = one.cpu().numpy()
    # torch.searchsorted (left) over the transposed values: #{b < v}
    # for every sorted bound row, the same function
    xt = torch.nan_to_num(xd.index_select(1, cols.long()).t().contiguous(),
                          nan=0.0, posinf=float("inf"),
                          neginf=float("-inf"))
    lib = torch.searchsorted(bounds, xt)
    n, f = x.shape[0], len(real)
    res = {"name": "bin_dense", "case": label, "rows": n, "features": f,
           "bins": int(bounds_np.shape[1]), "dtype": TORCH_BIN_DTYPE[
               np.dtype(dt)],
           "deterministic": bool(torch.equal(one, two)),
           "bitwise_vs_plain": bool(torch.equal(one, plain)),
           "bitwise_vs_host": bool(np.array_equal(got, host)),
           "library_same": bool(torch.equal(lib.to(tdt), one)),
           "max_abs_err": float((one.long() - plain.long()).abs().max())}
    res["bound_ms"], res["bound_by"] = bin_bound_ms(
        n, f, res["bins"], one.element_size())
    res["ms"] = timer(call, 20)
    res["plain_ms"] = timer(
        lambda: bk.bin_dense_plain(xd, cols, bounds, tdt), 3)
    res["library_ms"] = timer(lambda: torch.searchsorted(bounds, xt), 20)
    res["host_us"] = host_us(torch, call, reps=50)
    if BASELINE is not None:        # the other checkout's kernel, in turns
        base_bk = baseline_module("ops.bin_kernels")
        res["baseline_same_bits"] = bool(torch.equal(
            base_bk.bin_dense(xd, cols, bounds, tdt), one))
        pair = [timer(lambda: base_bk.bin_dense(xd, cols, bounds, tdt), 20),
                timer(call, 20), timer(call, 20),
                timer(lambda: base_bk.bin_dense(xd, cols, bounds, tdt), 20)]
        res["baseline_ms"] = float(np.median([pair[0], pair[3]]))
        res["turns_ms"] = pair
        log(f"  baseline: same bits {res['baseline_same_bits']}, ms "
            f"{res['baseline_ms']:.4f} (turns {[round(v, 4) for v in pair]})")
        check(res["baseline_same_bits"], f"bin_dense {label}: the baseline "
              "gave other bits")
    log(f"bin_dense {label}: {res['ms']:.4f} ms (bound {res['bound_ms']:.4f}"
        f" {res['bound_by']}, plain {res['plain_ms']:.3f}, searchsorted "
        f"{res['library_ms']:.4f}), bits = plain {res['bitwise_vs_plain']},"
        f" = host {res['bitwise_vs_host']}, two launches equal "
        f"{res['deterministic']}")
    check(res["deterministic"], f"bin_dense {label}: two launches differ")
    check(res["bitwise_vs_plain"], f"bin_dense {label}: differs from plain")
    check(res["bitwise_vs_host"], f"bin_dense {label}: differs from host")
    return res


def write_tsv(path, x, y):
    """The matrix as TSV with a header, label first, %.9g (float32 round
    trips)."""
    header = "\t".join(["label"] + [f"f{j}" for j in range(x.shape[1])])
    np.savetxt(path, np.column_stack([y.astype(np.float64), x]),
               fmt="%.9g", delimiter="\t", header=header, comments="")


def write_libsvm(path, x, y):
    with open(path, "w") as f:
        for row, lab in zip(x, y):
            f.write("%g " % lab + " ".join(
                f"{j}:{v:.9g}" for j, v in enumerate(row) if v != 0.0)
                + "\n")


def cli_phase(torch, lgt, x, y, work):
    """The CLI as subprocesses on a LibSVM file of the bench's columns:
    task=train, then task=predict; the result file line for line
    Booster.predict's values written as Predictor.predict_file writes
    them ({v:g})."""
    from lightgbm_tpu_torch.io.parser import parse_text_file
    data = os.path.join(work, "cli.svm")
    model = os.path.join(work, "cli_model.txt")
    result = os.path.join(work, "cli_pred.txt")
    t0 = time.time()
    write_libsvm(data, x[:CLI_ROWS], y[:CLI_ROWS])
    res = {"rows": CLI_ROWS, "write_s": time.time() - t0}
    params = {k: v for k, v in BENCH_PARAMS.items() if k != "verbose"}
    argv = [f"{k}={v}" for k, v in params.items()]
    for task, extra in (("train", [f"num_trees={CLI_ROUNDS}",
                                   f"output_model={model}"]),
                        ("predict", [f"input_model={model}",
                                     f"output_result={result}"])):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "lightgbm_tpu_torch", f"task={task}",
             f"data={data}"] + argv + extra, capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        res[f"{task}_s"] = time.time() - t0
        check(proc.returncode == 0,
              f"CLI task={task} exited {proc.returncode}: "
              f"{(proc.stdout + proc.stderr)[-2000:]}")
    _, feats, _, _, _ = parse_text_file(data)
    booster = lgt.Booster(model_file=model)
    pred = booster.predict(feats)
    want = [f"{v:g}" for v in pred]
    with open(result) as f:
        got = f.read().splitlines()
    res["lines_equal"] = got == want
    res["trees"] = len(booster.gbdt.models)
    log(f"CLI: train {res['train_s']:.1f}s, predict {res['predict_s']:.1f}s "
        f"on {CLI_ROWS} LibSVM rows, {res['trees']} trees, result file = "
        f"Booster.predict line for line: {res['lines_equal']}")
    check(res["trees"] == CLI_ROUNDS, "the CLI model lacks trees")
    check(res["lines_equal"], "CLI predictions differ from Booster.predict")
    return res


# rows the ingestion phase bins with bin_dense's plain version on the CPU
INGEST_CPU_ROWS = 100_000


def phase_ingest(torch, lgt, timer, x, y, seed, work):
    """Data ingestion on the card: bin_dense at the bench shape (uint8,
    and int16 at max_bin 1023 and 3000); the bench's own construction
    (Dataset(X).construct() on the card, launches counted from zero)
    against the plain version on the CPU (the first INGEST_CPU_ROWS
    rows, the card's mappers) and the host pass; the bench matrix through
    a TSV file (left in `work` for the out-of-core file route, its path in
    report["tsv"] and the model trained from it in
    report["text_model"]), the binary cache and training from both; the
    CLI. Returns (the card-built dataset, report, kernel cases); the
    binary cache stays in `work` for the distributed phase (its path in
    report["cache"])."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import CoreDataset, DatasetLoader
    from lightgbm_tpu_torch.io.parser import parse_text_file
    from lightgbm_tpu_torch.ops import bin_kernels as bk
    from lightgbm_tpu_torch.utils.device import resolve_device
    rng = np.random.RandomState(seed + 8)
    res = {}
    # the bench's construction, launches read from zero
    bk.reset_launch_counts()
    t0 = time.time()
    ds = lgt.Dataset(x, y).construct(device=DEVICE)
    torch.cuda.synchronize()
    res["construct_card_s"] = time.time() - t0
    res["launches"] = bk.launch_counts()
    core = ds._core
    # device="cpu" bins with bin_dense's plain version; over the whole
    # matrix that takes about 19 s, so it bins the first
    # INGEST_CPU_ROWS rows with the card's own mappers
    t0 = time.time()
    on_cpu = DatasetLoader(Config.from_params({"verbose": 0}),
                           device="cpu")._bin_dense_on_device(
        x[:INGEST_CPU_ROWS], core.real_feature_idx, core.bin_mappers,
        core.bins.dtype)[0]
    res["construct_cpu_plain_s"] = time.time() - t0
    t0 = time.time()
    host = lgt.Dataset(x, y).construct()
    res["construct_host_s"] = time.time() - t0
    res["same_bins_cpu"] = bool(np.array_equal(
        core.bins[:, :INGEST_CPU_ROWS], on_cpu))
    res["same_bins_host"] = bool(np.array_equal(core.bins, host._core.bins))
    res["device_bins_seeded"] = str(resolve_device(DEVICE)) in \
        core._device_bins
    log(f"ingest: Dataset(X).construct() on the card {res['construct_card_s']:.2f}"
        f"s, plain version on the CPU ({INGEST_CPU_ROWS} rows) "
        f"{res['construct_cpu_plain_s']:.2f}s, host pass "
        f"{res['construct_host_s']:.2f}s; same bins {res['same_bins_cpu']} /"
        f" {res['same_bins_host']}; launches {res['launches']}")
    check(res["launches"]["bin_dense"] >= 1,
          "the card's construction did not launch bin_dense")
    check(res["same_bins_cpu"] and res["same_bins_host"],
          "bins on the card differ from the CPU's")
    check(res["device_bins_seeded"], "the card's bins did not seed the cache")
    del on_cpu, host

    # the kernel at the bench shape, specials planted
    xs = plant_specials(x, rng)
    plant_on_bounds(xs, core.bin_mappers, core.real_feature_idx, rng)
    cases = [bin_kernel_case(torch, bk, timer, xs, core, "uint8")]
    for max_bin in INGEST_INT16_BINS:
        wide = DatasetLoader(Config.from_params(
            {"max_bin": max_bin, "verbose": 0})).construct_from_matrix(x)
        xw = plant_specials(x, rng)
        plant_on_bounds(xw, wide.bin_mappers, wide.real_feature_idx, rng)
        cases.append(bin_kernel_case(torch, bk, timer, xw, wide,
                                     f"int16 (max_bin {max_bin})"))
        del xw, wide
    del xs
    res["kernel_cases"] = cases

    # the file path: TSV with a header, the binary cache
    tsv = os.path.join(work, "bench.tsv")
    t0 = time.time()
    write_tsv(tsv, x, y)
    res["tsv_write_s"] = time.time() - t0
    res["tsv_bytes"] = os.path.getsize(tsv)
    params = dict(BENCH_PARAMS, has_header=True)
    t0 = time.time()
    label, feats, names, _, _ = parse_text_file(tsv, has_header=True)
    res["parse_s"] = time.time() - t0
    t0 = time.time()
    from_text = lgt.Dataset(tsv, params=params).construct(device=DEVICE)
    res["text_load_s"] = time.time() - t0
    tcore = from_text._core
    from lightgbm_tpu_torch.io.metadata import Metadata
    meta = Metadata(len(label))
    meta.set_label(label)
    t0 = time.time()
    want = DatasetLoader(Config.from_params(params))._construct(
        feats, names, set(), set(), meta)
    res["host_binning_of_parsed_s"] = time.time() - t0
    res["text_same_bins_as_parsed_host_pass"] = bool(
        np.array_equal(tcore.bins, want.bins))
    # %.9g round-trips float32, but the parse keeps float64 (the JAX
    # parser's rule), so bounds and bins may move in the last bit: a
    # count for the record, not a check
    res["text_bins_unlike_matrix"] = int((tcore.bins != core.bins).sum())
    res["text_label_equal"] = bool(np.array_equal(tcore.metadata.label, y))
    del feats, want
    cache = os.path.join(work, "bench.bin")
    t0 = time.time()
    from_text.save_binary(cache)
    res["save_binary_s"] = time.time() - t0
    t0 = time.time()
    loaded = CoreDataset.load_binary(cache)
    res["load_binary_s"] = time.time() - t0
    res["cache_bytes"] = os.path.getsize(cache)
    res["cache_same_bins"] = bool(np.array_equal(np.asarray(loaded.bins),
                                                 tcore.bins))
    del loaded
    t0 = time.time()
    from_cache = lgt.Dataset(cache, params=params).construct(device=DEVICE)
    res["cache_dataset_s"] = time.time() - t0
    texts = []
    for d in (from_text, from_cache):
        booster = lgt.train(BENCH_PARAMS, d, N_ROUNDS, verbose_eval=False)
        texts.append(booster.model_to_string())
    res["model_text_equal"] = texts[0] == texts[1]
    res["tsv"], res["text_model"] = tsv, texts[0]
    log(f"ingest files: TSV {res['tsv_bytes'] / 1e6:.0f} MB written in "
        f"{res['tsv_write_s']:.1f}s; parse {res['parse_s']:.2f}s, "
        f"Dataset(path) {res['text_load_s']:.2f}s (host binning of the "
        f"parsed matrix alone {res['host_binning_of_parsed_s']:.2f}s), "
        f"save_binary {res['save_binary_s']:.2f}s, load_binary "
        f"{res['load_binary_s']:.3f}s, Dataset(cache) "
        f"{res['cache_dataset_s']:.2f}s; bins = parsed host pass "
        f"{res['text_same_bins_as_parsed_host_pass']}, unlike the float32 "
        f"matrix's {res['text_bins_unlike_matrix']}, cache "
        f"{res['cache_same_bins']}; model text from text = from cache "
        f"{res['model_text_equal']}")
    check(res["text_same_bins_as_parsed_host_pass"],
          "Dataset(path) bins differ from the host pass of the parse")
    check(res["text_label_equal"], "the TSV round trip changed the labels")
    check(res["cache_same_bins"], "the binary cache changed the bins")
    check(res["model_text_equal"], "training from the cache gave another "
          "model than training from the text")
    del from_text, from_cache
    # the distributed phase's gangs load their rows from the cache
    res["cache"] = cache
    res["cli"] = cli_phase(torch, lgt, x, y, work)
    return ds, res, cases


# ----------------------------------------------- checkpoint and resume

# 8 rounds (10 before the gang and telemetry phases came): the fused
# and blockwise crashes at 6 still resume from the snapshot at 4
RESUME_ROUNDS = 8
RESUME_PERIOD = 4


def crash_and_resume(torch, lgt, params, ds, rounds, period, crash_at, work,
                     valid=None, per_iteration=False):
    """An uninterrupted run; a run writing snapshots every `period`
    rounds, crashed in process (InjectedFault) at iteration `crash_at`;
    and a fresh booster resumed from the newest snapshot. The resumed
    model text must equal the uninterrupted one byte for byte (with a
    valid set, the eval history and best iteration too)."""
    from lightgbm_tpu_torch import callback
    from lightgbm_tpu_torch.utils import faults
    from lightgbm_tpu_torch.utils.checkpoint import CheckpointManager
    d = tempfile.mkdtemp(prefix="ckpt_", dir=work)

    def run(ckpt=False, crash=None, resume=False):
        cbs = [lambda env: None] if per_iteration else []
        ck = callback.checkpoint(d, period=period) if ckpt else None
        if ck is not None:
            cbs.append(ck)
        ev = {}
        kw = ({} if valid is None else
              {"valid_sets": [valid], "early_stopping_rounds": 5,
               "evals_result": ev})
        if crash is not None:
            faults.set_fault("crash_at_iteration", crash)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            b = lgt.train(dict(params), ds, rounds, verbose_eval=False,
                          callbacks=cbs or None,
                          resume_from=d if resume else None, **kw)
            torch.cuda.synchronize()
        except faults.InjectedFault:
            b = None
        finally:
            faults.clear_faults()
        return b, ev, ck, time.perf_counter() - t0

    ref, ref_ev, _, ref_s = run()
    crashed, _, ck, crash_s = run(ckpt=True, crash=crash_at)
    snaps = CheckpointManager(d).checkpoints()
    got, got_ev, _, resume_s = run(ckpt=True, resume=True)
    res = {"rounds": rounds, "period": period, "crash_at": crash_at,
           "crashed": crashed is None,
           "snapshots_at_crash": [it for it, _ in snaps],
           "snapshot_bytes": os.path.getsize(snaps[-1][1]) if snaps else 0,
           "checkpoint_write_s": ck.last_write_s,
           "uninterrupted_s": ref_s, "crashed_run_s": crash_s,
           "resumed_run_s": resume_s,
           "model_text_equal": (got is not None and got.model_to_string()
                                == ref.model_to_string())}
    if valid is not None:
        res["history_equal"] = got_ev == ref_ev
        res["best_iteration_equal"] = got.best_iteration == ref.best_iteration
    if got is not None and got.gbdt._fused_cache:
        runner = fused_runner(got)
        res["fused_graph"] = runner.graph is not None
        res["graph_score_is_booster_score"] = (
            runner.score is got.gbdt.train_score_updater.score)
    res["dir"] = d
    return res


def phase_resume(torch, lgt, ds, seed):
    """Checkpoint and resume at full width: on each training path a run
    crashed in process mid-run and resumed from its snapshot directory
    into a fresh booster writes the uninterrupted run's model text byte
    for byte: the fused fast path (RESUME_ROUNDS rounds, snapshots every
    RESUME_PERIOD, the resumed graph updating the booster's own score),
    the blockwise path (a 100k-row valid set, early stopping: history
    and best iteration equal), the per-iteration path, GOSS fused and
    DART. Each snapshot's write seconds (checkpoint_write_s) and bytes;
    the fused case's restore timed apart (decode, then
    restore_training_state into a fresh booster)."""
    from lightgbm_tpu_torch.utils.checkpoint import CheckpointManager
    res = {}
    xv, yv = make_valid(100_000, seed)
    cases = {
        "fused": dict(params=BENCH_PARAMS, rounds=RESUME_ROUNDS,
                      period=RESUME_PERIOD, crash_at=6),
        "blockwise": dict(params=dict(BENCH_PARAMS, metric="auc"),
                          rounds=RESUME_ROUNDS, period=RESUME_PERIOD,
                          crash_at=6,
                          valid=lgt.Dataset(xv, yv, reference=ds)),
        "per_iteration": dict(params=BENCH_PARAMS, rounds=6, period=2,
                              crash_at=5, per_iteration=True),
        "goss_fused": dict(params=GOSS_PARAMS, rounds=GOSS_ROUNDS,
                           period=RESUME_PERIOD, crash_at=6),
        "dart": dict(params=DART_PARAMS, rounds=6, period=2, crash_at=5),
    }
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as work:
        for name, kw in cases.items():
            r = res[name] = crash_and_resume(torch, lgt, ds=ds, work=work,
                                             **kw)
            log(f"resume {name}: crashed at {r['crash_at']} "
                f"(snapshots {r['snapshots_at_crash']}, newest "
                f"{r['snapshot_bytes'] / 1e6:.2f} MB, checkpoint_write_s "
                f"{r['checkpoint_write_s']:.3f}); runs uninterrupted "
                f"{r['uninterrupted_s']:.2f} s, crashed "
                f"{r['crashed_run_s']:.2f} s, resumed "
                f"{r['resumed_run_s']:.2f} s; model text equal "
                f"{r['model_text_equal']}"
                + "".join(f", {k} {r[k]}" for k in (
                    "history_equal", "best_iteration_equal", "fused_graph",
                    "graph_score_is_booster_score") if k in r))
            check(r["crashed"], f"resume {name}: the injected crash did "
                  "not fire")
            check(r["model_text_equal"], f"resume {name}: the resumed model "
                  "differs from the uninterrupted one")
            for k in ("history_equal", "best_iteration_equal", "fused_graph",
                      "graph_score_is_booster_score"):
                check(r.get(k, True), f"resume {name}: {k} is false")
        d = res["fused"].pop("dir")
        t0 = time.perf_counter()
        state, _ = CheckpointManager(d).load_latest()
        decode_s = time.perf_counter() - t0
        booster = lgt.Booster(dict(BENCH_PARAMS), ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.gbdt.restore_training_state(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        res["fused"].update(decode_s=decode_s, restore_s=restore_s)
        for r in res.values():
            r.pop("dir", None)
        log(f"resume: the fused case's newest snapshot decoded in "
            f"{decode_s:.3f} s, restored into a fresh booster in "
            f"{restore_s:.3f} s")
        del booster, state
    return res


# ---------------------------------------------------------- out of core

OOC_ROUNDS = 3
OOC_BLOCK_ROWS = (262_144, 65_536)


# the leaves hist_pair_fold is timed at: leaf 5 of rows spread over 63
# leaves (about 1.6%, the share of a tree's typical leaf), and leaves of
# 50% and 100% of the rows
FOLD_SHARES = (None, 0.5, 1.0)
FOLD_PROFILED_CALLS = 3
# hist_pair_fold calls on the inputs saved at argv[1], one scratch
FOLD_PROFILE_SRC = """
import json, sys, torch
from lightgbm_tpu_torch.ops import hist_kernels as hk
a = [t.cuda() for t in torch.load(sys.argv[1])]
acc, comp, bins = a[0], a[1], a[2]
scratch = hk.FoldScratch(bins.shape[1], bins.shape[0], acc.shape[1], "cuda")
def call():
    hk.hist_pair_fold(*a, acc.shape[1], scratch=scratch)
""" + PROFILE_TAIL


def fold_bound_ms(f, rows, bin_bytes, b, in_rows):
    """Least time for one hist_pair_fold call: the block's row_leaf and
    the leaf id read once, the leaf's rows' bins and g/h/w read once
    (what this run's leaf needs), the (F, B, 3) carry pair read and
    written once, over HBM bandwidth; against three float32 adds per
    (leaf row, feature) over the float32 rate. Returns (ms, bound_by)."""
    nbytes = (4 * rows + 4 + in_rows * (f * bin_bytes + 12)
              + 2 * 2 * f * b * 3 * 4)
    ops = 3.0 * f * in_rows
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def fold_inputs(torch, rng, rows, share=None):
    """(bins, ghc_t, row_leaf, leaf id) on the host: the bench shape's
    (28, rows) uint8 bins at 255 bins, leaf 5; with share None the rows
    spread over 63 leaves, else that share of them in leaf 5."""
    inbag = (rng.rand(rows) < 0.8).astype(np.float32)
    row_leaf = rng.randint(0, 63, size=rows).astype(np.int32)
    if share is not None:
        row_leaf = np.where(rng.rand(rows) < share, 5,
                            row_leaf % 5).astype(np.int32)
    return [torch.from_numpy(a) for a in (
        rng.randint(0, MAX_BIN, size=(N_FEATURES, rows)).astype(np.uint8),
        np.stack([rng.randn(rows).astype(np.float32) * inbag,
                  rng.rand(rows).astype(np.float32) * inbag, inbag]),
        row_leaf, np.array([5], np.int32))]


def fold_kernel_case(torch, hk, timer, rng, rows, share=None):
    """hist_pair_fold on one out-of-core block of `rows` rows (a leaf of
    `share` of them, fold_inputs), seeded with a carry in flight: bit for
    bit its plain version on the CPU, two launches equal; timed (L2
    flushed) beside its bound, the plain version on the card, masked_hist
    over the same rows and one index_add_ over the block's rows of the
    leaf; its plan (hk.fold_plan)."""
    f, b = N_FEATURES, MAX_BIN
    host = fold_inputs(torch, rng, rows, share)
    dev = [t.to(DEVICE) for t in host]
    acc0 = torch.from_numpy(rng.randn(f, b, 3).astype(np.float32))
    comp0 = torch.from_numpy((rng.randn(f, b, 3) * 1e-7).astype(np.float32))
    want = hk.hist_pair_fold_plain(acc0.clone(), comp0.clone(), *host, b)
    scratch = hk.FoldScratch(rows, f, b, DEVICE)
    outs = []
    for _ in range(2):
        acc, comp = acc0.to(DEVICE).clone(), comp0.to(DEVICE).clone()
        hk.hist_pair_fold(acc, comp, *dev, b, scratch=scratch)
        outs.append([t.cpu().clone() for t in (acc, comp)])
    bitwise = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                  for g, w in zip(outs[0], want))
    deterministic = all(torch.equal(g, h) for g, h in zip(*outs))
    err = float((hk.hist_pair_collapse(*outs[0])
                 - hk.hist_pair_collapse(*want)).abs().max())
    acc, comp = acc0.to(DEVICE).clone(), comp0.to(DEVICE).clone()
    acc_p, comp_p = acc0.to(DEVICE).clone(), comp0.to(DEVICE).clone()
    in_leaf = (dev[2] == 5).nonzero()[:, 0]
    keys = (torch.arange(f, device=DEVICE)[:, None] * b
            + dev[0][:, in_leaf].long()).reshape(-1)
    src = dev[1][:, in_leaf].t()[None].expand(f, -1, 3).reshape(-1, 3) \
        .contiguous()
    res = {"name": "hist_pair_fold",
           "shape": {"F": f, "R": rows, "B": b, "bins": "uint8",
                     "leaf": "5 of 63" if share is None else share,
                     "leaf_rows": int(in_leaf.numel())},
           "plan": hk.fold_plan(rows, f, b),
           "max_abs_err": err, "bitwise_vs_cpu_plain": bitwise,
           "deterministic": deterministic,
           "ms": timer(lambda: hk.hist_pair_fold(acc, comp, *dev, b,
                                                 scratch=scratch), 20),
           "plain_ms": timer(lambda: hk.hist_pair_fold_plain(
               acc_p, comp_p, *dev, b), 3),
           "masked_hist_ms": timer(lambda: hk.masked_hist(*dev, b), 20),
           "library_ms": timer(lambda: torch.zeros(
               f * b, 3, device=DEVICE).index_add_(0, keys, src), 5)}
    res["bound_ms"], res["bound_by"] = fold_bound_ms(
        f, rows, 1, b, int(in_leaf.numel()))
    log(f"hist_pair_fold {res['shape']} plan {res['plan']}: bitwise vs CPU "
        f"plain {bitwise}, deterministic {deterministic}, ms "
        f"{res['ms']:.4f} (index_add_ {res['library_ms']:.4f}, masked_hist "
        f"on the same rows {res['masked_hist_ms']:.4f}) bound "
        f"{res['bound_ms']:.4f} plain {res['plain_ms']:.3f}")
    check(bitwise, "hist_pair_fold differs in bits from its plain version "
          "on the CPU")
    check(deterministic, "hist_pair_fold: two launches gave different bits")
    check(not scratch.counters.any(), "hist_pair_fold left a counter set")
    if rows == OOC_BLOCK_ROWS[0] and share is None:
        prof = fresh_process_profile(
            torch, FOLD_PROFILE_SRC, [t.cpu() for t in (acc0, comp0, *dev)],
            FOLD_PROFILED_CALLS, "hist_pair_fold")
        res["device_events"] = prof
        log(f"hist_pair_fold: {FOLD_PROFILED_CALLS} calls profiled in a "
            f"fresh process: device events {prof['names']}")
        check(len(prof["names"]) == FOLD_PROFILED_CALLS
              and all("pair_fold_kernel" in nm for nm in prof["names"]),
              "hist_pair_fold: not one device launch a call")
    del keys, src, scratch
    return res


def block_fold_equals_masked(torch, hk, rng, n=1 << 20):
    """The blocks of a pass over n rows folded on the card at each
    OOC_BLOCK_ROWS, collapsed: masked_hist over the whole array, bit for
    bit."""
    dev = [t.to(DEVICE) for t in fold_inputs(torch, rng, n)]
    hi, lo = hk.masked_hist(*dev, MAX_BIN)
    want = (hi + lo).view(torch.int32)
    out = {}
    for rows in OOC_BLOCK_ROWS:
        acc = torch.zeros(hi.shape, dtype=torch.float32, device=DEVICE)
        comp = torch.zeros_like(acc)
        for s in range(0, n, rows):
            hk.hist_pair_fold(acc, comp, dev[0][:, s:s + rows].contiguous(),
                              dev[1][:, s:s + rows].contiguous(),
                              dev[2][s:s + rows], dev[3], MAX_BIN)
        out[str(rows)] = bool(torch.equal(
            hk.hist_pair_collapse(acc, comp).view(torch.int32), want))
    log(f"block folds over {n} rows equal masked_hist bit for bit: {out}")
    check(all(out.values()), "a blockwise fold differs from masked_hist")
    return out


def ooc_run(torch, lgt, x, y, block_rows):
    """OOC_ROUNDS rounds out of core: the bench matrix binned on the card
    and spilled at `block_rows`, then trained (round times, peak device
    memory above the start, the prefetcher's counters). Returns (booster,
    report, the out-of-core Dataset)."""
    params = dict(BENCH_PARAMS, out_of_core=True, block_rows=block_rows)
    t0 = time.time()
    dso = lgt.Dataset(x, y, params=params).construct(device=DEVICE)
    spill_s = time.time() - t0
    mem0 = memory_mark(torch)
    booster, round_ms = train_rounds(torch, lgt, params, dso, OOC_ROUNDS)
    memory = memory_peak(torch, mem0)
    learner = booster.gbdt.tree_learner
    st = learner.stats()
    passes = learner.prefetcher.passes
    res = {"block_rows": block_rows,
           "blocks": learner.train_set.block_store.num_blocks,
           "spill_s": spill_s, "round_ms": round_ms,
           "round_ms_median": float(np.median(round_ms)), "memory": memory,
           "passes": passes, "pass_ms": 1e3 * st["prefetch_wall_s"] / passes,
           **st}
    return booster, res, dso


def phase_ooc(torch, lgt, hk, timer, ds, x, y, seed):
    """Out-of-core training at full width. hist_pair_fold at both block
    sizes and each of FOLD_SHARES against its plain version and bound
    (fold_kernel_case; the first, 262,144 rows and leaf 5 of 63, is the
    kernels line's and is profiled for its device launches), and the
    blockwise fold against masked_hist over a 1M-row array; the in-RAM
    masked run (OOC_ROUNDS rounds per iteration on the card-built
    dataset); the bench matrix spilled at each OOC_BLOCK_ROWS (4 and 16
    blocks) and trained OOC_ROUNDS rounds, launches counted from zero,
    model text byte-equal to the in-RAM run's, round times, each pass's
    time beside a pinned host-to-device copy of the same bytes, the
    prefetcher's overlap_pct and wait_s, and peak device memory against
    the in-RAM run's; then a crash and resume of the 4-block run."""
    from lightgbm_tpu_torch import callback
    from lightgbm_tpu_torch.utils import faults
    rng = np.random.RandomState(seed + 14)
    res = {"kernel_cases": [fold_kernel_case(torch, hk, timer, rng, rows,
                                             share)
                            for rows in OOC_BLOCK_ROWS
                            for share in FOLD_SHARES],
           "block_fold_equal": block_fold_equals_masked(torch, hk, rng)}
    mem0 = memory_mark(torch)
    ref, ref_ms = train_rounds(torch, lgt, BENCH_PARAMS, ds, OOC_ROUNDS)
    res["in_ram"] = {"round_ms": ref_ms,
                     "round_ms_median": float(np.median(ref_ms)),
                     "memory": memory_peak(torch, mem0),
                     "resident_bins_bytes": int(ds._core.bins.nbytes)}
    want = ref.model_to_string()
    n_pad = -(-N_ROWS // hk.HIST_CHUNK) * hk.HIST_CHUNK
    pinned = torch.empty(N_FEATURES * n_pad, dtype=torch.uint8,
                         pin_memory=True)
    on_card = torch.empty_like(pinned, device=DEVICE)
    res["pinned_h2d_ms"] = timer(
        lambda: on_card.copy_(pinned, non_blocking=True), 10)
    res["pinned_h2d_bytes"] = pinned.numel()
    del pinned, on_card
    hk.reset_launch_counts()
    runs = {}
    for rows in OOC_BLOCK_ROWS:
        booster, r, dso = ooc_run(torch, lgt, x, y, rows)
        r["model_text_equal"] = booster.model_to_string() == want
        runs[rows] = (booster, dso)
        res[f"blocks_{r['blocks']}"] = r
        log(f"ooc {r['blocks']} blocks of {rows}: spill {r['spill_s']:.2f} "
            f"s, round ms {[round(v, 1) for v in r['round_ms']]} (in RAM "
            f"{[round(v, 1) for v in ref_ms]}), {r['passes']} passes of "
            f"{r['pass_ms']:.2f} ms (pinned copy of the bytes "
            f"{res['pinned_h2d_ms']:.3f} ms), overlap "
            f"{r['prefetch_overlap_pct']}%, wait {r['prefetch_wait_s']:.3f}"
            f" s, read {r['prefetch_read_s']:.3f} s; peak above start "
            f"{r['memory']['peak_above_start_bytes'] / 1e6:.1f} MB (in RAM "
            f"{res['in_ram']['memory']['peak_above_start_bytes'] / 1e6:.1f}"
            f" MB + {res['in_ram']['resident_bins_bytes'] / 1e6:.1f} MB "
            f"resident bins); model text equal {r['model_text_equal']}")
        check(r["model_text_equal"], f"ooc {rows}: model text differs from "
              "the in-RAM masked run's")
    res["launches"] = hk.launch_counts()
    # one launch a block of every pass (a pass folds one leaf)
    want_folds = sum(res[f"blocks_{runs[r][1]._core.block_store.num_blocks}"]
                     ["passes"] * runs[r][1]._core.block_store.num_blocks
                     for r in OOC_BLOCK_ROWS)
    check(res["launches"]["hist_pair_fold"] == want_folds
          and want_folds >= OOC_ROUNDS * 63 * 20,
          f"ooc: hist_pair_fold launched {res['launches']['hist_pair_fold']}"
          f" times, not {want_folds}")
    check(res["launches"]["masked_hist"] == 0
          and res["launches"]["frontier_hist"] == 0,
          f"ooc: an in-RAM kernel ran: {res['launches']}")

    # crash at 2 with snapshots every 2, resume: the uninterrupted
    # 4-block run's text
    rows = OOC_BLOCK_ROWS[0]
    params = dict(BENCH_PARAMS, out_of_core=True, block_rows=rows)
    uninterrupted, dso = runs.pop(rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ooc_") as d:
        faults.set_fault("crash_at_iteration", 2)
        try:
            lgt.train(params, dso, OOC_ROUNDS, verbose_eval=False,
                      callbacks=[callback.checkpoint(d, period=2)])
            crashed = False
        except faults.InjectedFault:
            crashed = True
        finally:
            faults.clear_faults()
        t0 = time.perf_counter()
        got = lgt.train(params, dso, OOC_ROUNDS, verbose_eval=False,
                        callbacks=[callback.checkpoint(d, period=2)],
                        resume_from=d)
        torch.cuda.synchronize()
        res["resume"] = {"crashed": crashed,
                         "resumed_s": time.perf_counter() - t0,
                         "model_text_equal": got.model_to_string()
                         == uninterrupted.model_to_string()}
        del dso, got, uninterrupted, runs
    log(f"ooc crash and resume: {res['resume']}")
    check(res["resume"]["crashed"] and res["resume"]["model_text_equal"],
          "ooc: the resumed run differs from the uninterrupted one")
    return res


def phase_ooc_file(torch, lgt, hk, tsv, want_text):
    """The ingestion phase's 1M-row TSV trained out of core through the
    file route (binned straight into a block store beside it, never a
    matrix): the model text of the in-RAM load of the same file."""
    params = dict(BENCH_PARAMS, has_header=True, out_of_core=True)
    before = hk.KERNELS["hist_pair_fold"].launches
    t0 = time.time()
    dso = lgt.Dataset(tsv, params=params).construct(device=DEVICE)
    load_s = time.time() - t0
    t0 = time.time()
    booster = lgt.train(params, dso, N_ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    res = {"load_s": load_s, "train_s": time.time() - t0,
           "blocks": dso._core.block_store.num_blocks,
           "launches": hk.KERNELS["hist_pair_fold"].launches - before,
           "model_text_equal": booster.model_to_string() == want_text,
           "model_text": booster.model_to_string()}
    log(f"ooc file route: block store built in {load_s:.2f} s "
        f"({res['blocks']} blocks), {N_ROUNDS} rounds in "
        f"{res['train_s']:.2f} s, model text equal to the in-RAM load's "
        f"{res['model_text_equal']}")
    check(res["model_text_equal"], "ooc file route: model text differs")
    return res


PARALLEL_SHARDS = 4
# 1 round (3 before the distributed phase came, 2 before the gang and
# telemetry phases): the run's time limit
PARALLEL_ROUNDS = 1
# (name, parameters over BENCH_PARAMS); every case at PARALLEL_SHARDS
PARALLEL_CASES = (
    ("data_rs", {"tree_learner": "data"}),
    ("data_rs_groups7", {"tree_learner": "data", "comm_groups": 7}),
    ("data_allgather", {"tree_learner": "data",
                        "hist_exchange": "allgather"}),
    ("feature", {"tree_learner": "feature"}),
    ("voting", {"tree_learner": "voting"}),
    ("data_partitioned", {"tree_learner": "data",
                          "partitioned_build": "true"}),
)


def fold_bound_ms_mesh(k, cells, word_bytes):
    """Least time for one mesh_fold call: the K components read once and
    the output written once, over HBM bandwidth; against the fold's four
    float32 adds per component and cell over the float32 rate. Returns
    (ms, bound_by)."""
    nbytes = k * cells * word_bytes + cells * 4
    ops = 4.0 * k * cells
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def mesh_fold_case(torch, mk, timer, rng, k, shape, dtype):
    """mesh_fold on K stacked components of `shape` (histogram-like words
    with cancelling pairs and zeros of both signs): bit for bit its plain
    version on the card and on the CPU, two launches equal; timed (L2
    flushed) beside its bound, its plain version on the card and one
    torch.sum over the stack (the library call; other bits)."""
    host = (rng.randn(k, *shape) * 1e4).astype(np.float32)
    host[k // 2:] -= host[:k - k // 2][::-1]
    host += (rng.randn(k, *shape) * 1e-3).astype(np.float32)
    flat = host.reshape(k, -1)
    flat[:, 0] = -0.0
    flat[1:, 1] = 0.0
    comps = torch.from_numpy(host).to(dtype)
    dev = comps.to(DEVICE)
    a, b = mk.mesh_fold(dev), mk.mesh_fold(dev)
    got = a.cpu().view(torch.int32)
    bitwise_card = torch.equal(got, mk.mesh_fold_plain(dev).cpu().view(
        torch.int32))
    want = mk.mesh_fold_plain(comps)
    bitwise_cpu = torch.equal(got, want.view(torch.int32))
    deterministic = torch.equal(a, b)
    cells = int(np.prod(shape))
    res = {"name": "mesh_fold",
           "shape": {"K": k, "cells": list(shape),
                     "dtype": str(dtype).replace("torch.", "")},
           "max_abs_err": float((a.cpu() - want).abs().max()),
           "bitwise_vs_card_plain": bitwise_card,
           "bitwise_vs_cpu_plain": bitwise_cpu,
           "deterministic": deterministic,
           "ms": timer(lambda: mk.mesh_fold(dev), 50),
           "plain_ms": timer(lambda: mk.mesh_fold_plain(dev), 10),
           "library_ms": timer(lambda: torch.sum(dev.float(), 0)
                               if dtype != torch.float32
                               else torch.sum(dev, 0), 50),
           "library_bits_equal": torch.equal(
               torch.sum(dev.float(), 0).cpu().view(torch.int32), got)}
    res["bound_ms"], res["bound_by"] = fold_bound_ms_mesh(
        k, cells, dev.element_size())
    log(f"mesh_fold {res['shape']}: bitwise vs plain on the card "
        f"{bitwise_card}, on the CPU {bitwise_cpu}, deterministic "
        f"{deterministic}, ms {res['ms']:.4f} bound {res['bound_ms']:.5f} "
        f"plain {res['plain_ms']:.4f} torch.sum {res['library_ms']:.4f} "
        f"(same bits {res['library_bits_equal']})")
    check(bitwise_card and bitwise_cpu, f"mesh_fold {res['shape']} differs "
          "in bits from its plain version")
    check(deterministic, "mesh_fold: two launches gave different bits")
    return res


def exchange_words(rng, w, shape, words=2, dtype=None):
    """`words` lists of W contiguous host tensors of `shape`, one a shard
    (the shards' hi and lo, or their collapsed word): histogram-like
    values with cancelling pairs and zeros of both signs."""
    import torch
    out = []
    for i in range(words):
        host = (rng.randn(w, *shape) * (1e4 if i == 0 else 1e-3)).astype(
            np.float32)
        if i == 0:
            host[w // 2:] -= host[:w - w // 2][::-1]
            host.reshape(w, -1)[:, 0] = -0.0
            host.reshape(w, -1)[1:, 1] = 0.0
        t = torch.from_numpy(host)
        out.append([(t[j].to(dtype) if dtype else t[j]).contiguous()
                    for j in range(w)])
    return out


def gather_fold_case(torch, mk, timer, rng, w, shape, dtype, scatter,
                     words=2):
    """The gather-fold as an exchange gives it (LocalMesh.fold_exchange):
    K = words x W descriptors into W shards' own (..., F, B, 3) word
    tensors on the card, for the last shard's owned block of F / W
    features (`scatter`) or the whole histogram: bit for bit its plain
    version on the card and on the CPU, two launches equal; timed (L2
    flushed) beside its bound, its plain version on the card and one
    torch.sum over the stacked components (made before the timer; the
    library call, other bits)."""
    lead, (f, b, s) = shape[:-3], shape[-3:]
    n_lead = int(np.prod(lead, dtype=np.int64))
    f_out = f // w if scatter else f
    run, row = f_out * b * s, f * b * s
    off = (w - 1) * run if scatter else 0
    host = [t for ws in exchange_words(rng, w, shape, words, dtype)
            for t in ws]
    hcomps = [(t, off, row) for t in host]
    dcomps = [(t.to(DEVICE), off, row) for t in host]
    out_shape = (*lead, f_out, b, s)

    def kern():
        return mk.gather_fold(dcomps, n_lead, run, torch.empty(
            out_shape, device=DEVICE))

    a, b2 = kern(), kern()
    got = a.cpu().view(torch.int32)
    want_card = mk.gather_fold_plain(dcomps, n_lead, run, torch.empty(
        out_shape, device=DEVICE))
    want = mk.gather_fold_plain(hcomps, n_lead, run, torch.empty(out_shape))
    bitwise_card = torch.equal(got, want_card.cpu().view(torch.int32))
    bitwise_cpu = torch.equal(got, want.view(torch.int32))
    deterministic = torch.equal(a, b2)
    stack = torch.stack([t.narrow(-3, off // (b * s), f_out).float()
                         for t, _, _ in dcomps])
    k = len(dcomps)
    res = {"name": "mesh_fold", "route": "gather_fold",
           "shape": {"K": k, "words": list(shape), "out": list(out_shape),
                     "owned_block": bool(scatter),
                     "dtype": str(host[0].dtype).replace("torch.", "")},
           "max_abs_err": float((a.cpu() - want).abs().max()),
           "bitwise_vs_card_plain": bitwise_card,
           "bitwise_vs_cpu_plain": bitwise_cpu,
           "deterministic": deterministic,
           "ms": timer(kern, 50),
           "host_us": host_us(torch, kern),
           "plain_ms": timer(lambda: mk.gather_fold_plain(
               dcomps, n_lead, run, torch.empty(out_shape, device=DEVICE)),
               10),
           "library_ms": timer(lambda: torch.sum(stack, 0), 50),
           "library_bits_equal": torch.equal(
               torch.sum(stack, 0).cpu().view(torch.int32), got)}
    res["bound_ms"], res["bound_by"] = fold_bound_ms_mesh(
        k, n_lead * run, host[0].element_size())
    log(f"gather-fold {res['shape']}: bitwise vs plain on the card "
        f"{bitwise_card}, on the CPU {bitwise_cpu}, deterministic "
        f"{deterministic}, ms {res['ms']:.4f} (host_us "
        f"{res['host_us']:.1f}) bound {res['bound_ms']:.5f} plain "
        f"{res['plain_ms']:.4f} torch.sum {res['library_ms']:.4f} (same "
        f"bits {res['library_bits_equal']})")
    check(bitwise_card and bitwise_cpu, f"gather-fold {res['shape']} "
          "differs in bits from its plain version")
    check(deterministic, "gather-fold: two launches gave different bits")
    return res


# the exchanges profiled in a fresh process: (name, exchange, groups,
# features, precision); the reduce-scatter's comm_groups 2 on 56
# features (F / W = 14), since 2 does not tile the bench's 7
EXCHANGE_CASES = (
    ("pair_allgather", "allgather", 1, N_FEATURES, "pair"),
    ("pair_rs_groups1", "reduce_scatter", 1, N_FEATURES, "pair"),
    ("pair_rs_groups2", "reduce_scatter", 2, 2 * N_FEATURES, "pair"),
    ("pair_rs_groups7", "reduce_scatter", 7, N_FEATURES, "pair"),
    ("bf16_rs_groups7", "reduce_scatter", 7, N_FEATURES, "bf16"),
)
EXCHANGE_PROFILED = 3     # exchanges a shard in the profiled run
EXCHANGE_TIMED = 50       # exchanges a shard in the host-timed run
# the exchanges of EXCHANGE_CASES in a fresh process, on the inputs
# saved at argv[1] ({name: (hi list, lo list)}), by the checkout at
# argv[3] (this one when empty): for each, a W-shard mesh on the card
# runs one exchange a shard (warm-up), then EXCHANGE_PROFILED under the
# profiler (its device events, the window padded as PROFILE_TAIL's), then
# EXCHANGE_TIMED, three times, on the
# host clock: each shard's time in its exchange calls less its time in
# the mesh's barriers (the host work of an exchange, every shard's), and
# the loop's wall time with the barriers' hand-overs; the shards'
# results of the first exchange go to argv[2]
EXCHANGE_PROFILE_SRC = """
import json, sys, threading, time, torch
if sys.argv[3]:
    sys.path.insert(0, sys.argv[3])
from torch.profiler import ProfilerActivity, profile
from lightgbm_tpu_torch.parallel import mesh as pm
a = torch.load(sys.argv[1])
cases, inputs = a["cases"], a["inputs"]
out, results = {}, {}
waited = threading.local()
wait = pm.LocalMesh._wait
def timed_wait(self, tag):
    t0 = time.perf_counter()
    try:
        return wait(self, tag)
    finally:
        waited.s = getattr(waited, "s", 0.0) + time.perf_counter() - t0
pm.LocalMesh._wait = timed_wait
for name, exchange, groups, f, precision in cases:
    hi, lo = ([t.cuda() for t in ws] for ws in inputs[name])
    w = len(hi)
    mesh = pm.LocalMesh(w, "cuda")
    own = []
    def one(r):
        pair = (hi[r], lo[r])
        w0, t0 = getattr(waited, "s", 0.0), time.perf_counter()
        if exchange == "allgather":
            fn = (pm.pair_allreduce(pair, mesh) if precision == "pair"
                  else pm.compressed_allreduce(pair, mesh, precision))
        elif precision == "pair":
            fn = pm.pair_reduce_scatter(pair, mesh, w, groups)
        else:
            fn = pm.compressed_reduce_scatter(pair, mesh, w, groups,
                                              precision)
        own.append(time.perf_counter() - t0 - (waited.s - w0))
        return fn
    def many(n):
        return mesh.run(lambda r: [one(r) for _ in range(n)])
    results[name] = [o[0].cpu() for o in many(1)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad()
        many(%d)
        pad()
        torch.cuda.synchronize()
    ev = counted(prof)
    host, wall = [], []
    for _ in range(3):
        spans = []
        for n in (0, %d):
            del own[:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            many(n)
            spans.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        host.append(sum(own) / %d)
        wall.append((spans[1] - spans[0]) / %d)
    out[name] = {"names": sorted({e.name for e in ev}),
                 "device_events": len(ev),
                 "device_ms": sum(e.device_time_total for e in ev) / 1e3,
                 "host_s": sorted(host)[1], "wall_s": sorted(wall)[1]}
torch.save(results, sys.argv[2])
print(json.dumps(out))
""" % (EXCHANGE_PROFILED, EXCHANGE_TIMED, EXCHANGE_TIMED, EXCHANGE_TIMED)
EXCHANGE_PROFILE_SRC = PROFILE_PAD + EXCHANGE_PROFILE_SRC


def exchange_profile(torch, inputs, root=""):
    """EXCHANGE_PROFILE_SRC in a fresh process (the checkout at `root`,
    or this one) on `inputs`: for each exchange its device kernels a
    shard an exchange, device ms an exchange (every shard's kernels),
    host us an exchange (every shard's own host work, barriers taken
    out; the median of three runs) and wall us an exchange (with the
    barriers' hand-overs), and the shards' results."""
    w = PARALLEL_SHARDS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exchange_") as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save({"cases": EXCHANGE_CASES, "inputs": inputs}, path)
        proc = subprocess.run(
            [sys.executable, "-c", EXCHANGE_PROFILE_SRC, path,
             path + ".out", root], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0, "exchange profile: the profiling "
              f"process failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        results = torch.load(path + ".out")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {}
    for name, p in prof.items():
        n = EXCHANGE_PROFILED
        out[name] = {"device_kernel_names": p["names"],
                     "kernels_a_shard_exchange": p["device_events"] / (n * w),
                     "device_ms_an_exchange": p["device_ms"] / n,
                     "host_us_an_exchange": 1e6 * p["host_s"],
                     "wall_us_an_exchange": 1e6 * p["wall_s"]}
    return out, results


def exchange_cases(torch, rng):
    """Each exchange of EXCHANGE_CASES profiled in a fresh process
    (exchange_profile; a late in-process profiler records no eager device
    event), one device kernel a shard an exchange required of the pair
    ones; with --baseline the other checkout's exchanges on the same
    inputs in a process of their own, their results bit-equal."""
    w = PARALLEL_SHARDS
    inputs = {name: exchange_words(rng, w, (f, MAX_BIN, 3))
              for name, _, _, f, _ in EXCHANGE_CASES}
    res, results = exchange_profile(torch, inputs)
    for name, r in res.items():
        log(f"exchange {name} ({w} shards, one card): "
            f"{r['kernels_a_shard_exchange']:.2f} device kernels a shard "
            f"({r['device_kernel_names']}), device ms "
            f"{r['device_ms_an_exchange']:.4f}, host us "
            f"{r['host_us_an_exchange']:.1f} (wall "
            f"{r['wall_us_an_exchange']:.1f}) an exchange")
        if name.startswith("pair"):
            check(r["kernels_a_shard_exchange"] == 1.0
                  and all("gather_fold" in k
                          for k in r["device_kernel_names"]),
                  f"exchange {name}: not one gather-fold a shard")
    if BASELINE is not None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            BASELINE.__file__)))
        base, base_results = exchange_profile(torch, inputs, root)
        for name, r in res.items():
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(results[name], base_results[name]))
            r["baseline"] = dict(base[name], same_bits=same)
            log(f"  baseline {name}: "
                f"{base[name]['kernels_a_shard_exchange']:.2f} device "
                f"kernels a shard ({base[name]['device_kernel_names']}), "
                f"device ms {base[name]['device_ms_an_exchange']:.4f}, host "
                f"us {base[name]['host_us_an_exchange']:.1f} (wall "
                f"{base[name]['wall_us_an_exchange']:.1f}); same bits "
                f"{same}")
            check(same, f"exchange {name}: the baseline gave other bits")
    return res


def phase_parallel(torch, lgt, hk, timer, ds, y, seed):
    """The data-, feature- and voting-parallel learners on an in-process
    mesh of PARALLEL_SHARDS shards (see the module doc, 9d). Returns the
    report and the mesh_fold cases (the first the gather-fold of the
    default reduce-scatter's owned block)."""
    from lightgbm_tpu_torch.ops import mesh_kernels as mk
    rng = np.random.RandomState(seed + 15)
    w = PARALLEL_SHARDS
    f_loc = N_FEATURES // w
    full = (N_FEATURES, MAX_BIN, 3)
    cases = [gather_fold_case(torch, mk, timer, rng, w, full, None, True),
             gather_fold_case(torch, mk, timer, rng, w, (1, *full), None,
                              False),
             gather_fold_case(torch, mk, timer, rng, w, full, torch.bfloat16,
                              True, words=1),
             mesh_fold_case(torch, mk, timer, rng, 2 * w, (f_loc, MAX_BIN, 3),
                            torch.float32)]
    res = {"shards": w, "cards": torch.cuda.device_count(),
           "kernel_cases": cases,
           "exchanges": exchange_cases(torch, rng)}
    serial, ser_ms = train_rounds(torch, lgt, BENCH_PARAMS, ds,
                                  PARALLEL_ROUNDS)
    part_params = dict(BENCH_PARAMS, partitioned_build="true")
    serial_part, part_ms = train_rounds(torch, lgt, part_params, ds,
                                        PARALLEL_ROUNDS)
    res["serial"] = {"round_ms": ser_ms,
                     "round_ms_median": float(np.median(ser_ms))}
    res["serial_partitioned"] = {"round_ms": part_ms,
                                 "round_ms_median": float(np.median(part_ms))}
    hk.reset_launch_counts()
    for name, extra in PARALLEL_CASES:
        params = dict(BENCH_PARAMS, num_machines=w, **extra)
        per_tree = []

        def bytes_cb(env):
            learner = env.model.gbdt.tree_learner
            per_tree.append((dict(learner.mesh.collective_bytes),
                             {k: learner.collective_bytes.get(
                                 f"collective_bytes_{k}", 0)
                              for k in learner.mesh.collective_bytes}))

        bytes_cb.order = 1
        before = hk.launch_counts()
        t0 = time.time()
        booster, round_ms = train_rounds(torch, lgt, params, ds,
                                         PARALLEL_ROUNDS,
                                         callbacks=[bytes_cb])
        train_s = time.time() - t0
        gbdt = booster.gbdt
        learner = gbdt.tree_learner
        after = hk.launch_counts()
        ref = serial_part if name == "data_partitioned" else serial
        same_splits = all(
            np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold_in_bin, b.threshold_in_bin)
            for a, b in zip(ref.gbdt.models, gbdt.models))
        rel = max(float(np.max(np.abs(a.leaf_value - b.leaf_value)
                               / np.maximum(np.abs(a.leaf_value), 1e-12)))
                  for a, b in zip(ref.gbdt.models, gbdt.models))
        plan = learner._comm_plan.per_tree(learner.split_iterations)
        prev = dict.fromkeys(plan, 0)
        bytes_ok = len(per_tree) == PARALLEL_ROUNDS
        for counted, planned in per_tree:
            bytes_ok &= counted == planned and all(
                counted[k] - prev[k] == plan[k] for k in plan)
            prev = counted
        r = {"params": extra, "round_ms": round_ms,
             "round_ms_median": float(np.median(round_ms)),
             "train_s": train_s, "placement": learner.mesh.describe(),
             "use_reduce_scatter": getattr(learner, "use_reduce_scatter",
                                           None),
             "comm_groups_effective": getattr(
                 learner, "comm_groups_effective", None),
             "use_partitioned": learner.use_partitioned,
             "trees": len(gbdt.models),
             "leaves": [t.num_leaves for t in gbdt.models],
             "same_splits_as_serial": same_splits,
             "leaf_rel_diff_vs_serial": rel,
             "train_auc": auc(gbdt.get_training_score(), y),
             "collective_bytes_per_tree": plan,
             "collective_bytes_equal_plan": bool(bytes_ok),
             "launches": {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}}
        res[name] = r
        ref_ms = part_ms if name == "data_partitioned" else ser_ms
        log(f"parallel {name}: round ms {[round(v, 1) for v in round_ms]} "
            f"(serial {[round(v, 1) for v in ref_ms]}), placement "
            f"{r['placement']['devices']}, same splits {same_splits}, leaf "
            f"rel {rel:.2e}, AUC {r['train_auc']:.5f}, bytes a tree {plan} "
            f"equal to the plan {bytes_ok}, launches {r['launches']}")
        check(len(gbdt.models) == PARALLEL_ROUNDS,
              f"parallel {name}: {len(gbdt.models)} trees")
        check(bytes_ok, f"parallel {name}: collective bytes differ from "
              "the CommPlan")
        check(r["launches"].get("seg_hist" if learner.use_partitioned
                                else "masked_hist", 0)
              >= w * PARALLEL_ROUNDS * 62,
              f"parallel {name}: histogram launches {r['launches']}")
        if name == "voting":
            check(r["train_auc"] > 0.8, f"parallel voting: train AUC "
                  f"{r['train_auc']}")
        elif name == "data_partitioned":
            check(same_splits and all(np.allclose(
                a.leaf_value, b.leaf_value, rtol=2e-4, atol=1e-6)
                for a, b in zip(ref.gbdt.models, gbdt.models)),
                f"parallel {name}: trees differ from the serial "
                f"partitioned learner's (rel {rel})")
        else:
            # atol: a leaf near zero keeps the float32 error of its
            # parent's sums (the shards' chunks are not the serial ones)
            check(same_splits and all(np.allclose(
                a.leaf_value, b.leaf_value, rtol=1e-5, atol=1e-6)
                for a, b in zip(ref.gbdt.models, gbdt.models)),
                f"parallel {name}: trees differ from the serial masked "
                f"learner's (rel {rel})")
        if name.startswith("data") and name != "data_partitioned":
            check(r["launches"].get("mesh_fold", 0) > 0,
                  f"parallel {name}: mesh_fold never launched")
        del booster, gbdt, learner
    res["launches"] = hk.launch_counts()
    check(res["launches"]["mesh_fold"] > 0, "mesh_fold never launched")
    return res, cases


DIST_SHARDS = 2          # ranks of the gangs on one card
# 2 rounds (3 before the gang and telemetry phases came): the run's time
# limit; a round's time is read from round 2
DIST_ROUNDS = 2
DIST_KILL_TIMEOUT_S = 30  # collective_timeout_s of the kill case
DIST_KILL_ROUNDS = 3      # the kill before round 2 needs a third round
DIST_KILL_MARGIN_S = 10
# (name, parameters over BENCH_PARAMS); each a gang of its own
DIST_CASES = (
    ("data_rs", {"tree_learner": "data"}),
    ("data_rs_groups7", {"tree_learner": "data", "comm_groups": 7}),
    ("data_allgather", {"tree_learner": "data",
                        "hist_exchange": "allgather"}),
    ("data_partitioned", {"tree_learner": "data",
                          "partitioned_build": "true"}),
    ("feature", {"tree_learner": "feature"}),
    ("voting", {"tree_learner": "voting", "top_k": 20}),
)
# the cases that also run over NCCL where there are two cards or more
DIST_NCCL_CASES = ("data_rs", "voting")
# the exchanges profiled in the ranks: EXCHANGE_CASES (comm_groups 2 on
# 56 features, which tile the owned block at W = 2 and 4)
DIST_EXCHANGE_CASES = EXCHANGE_CASES
# one rank of the exchange profile: the machine list at argv[1], the
# inputs at argv[2] ({"cases", "inputs": {name: (hi list, lo list)}}), the
# results to argv[3] + rank. The rank joins the process group from the
# machine list (init_from_config, the transport by the topology), then
# for each exchange on a ProcessMesh: one exchange (its result saved, its
# counted bytes beside the learner's CommPlan unit), EXCHANGE_PROFILED
# under the profiler (the device events), and EXCHANGE_TIMED, three
# times, on the host clock: the loop's wall time, the time inside the
# transport (the backend collective with its pinned copies and syncs) and
# the rest, the mesh's own host work
DIST_EXCHANGE_SRC = PROFILE_PAD + """
import json, os, sys, time, torch
from torch.profiler import ProfilerActivity, profile
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.parallel import distributed as pd, mesh as pm
rank = int(os.environ["LIGHTGBM_TPU_RANK"])
a = torch.load(sys.argv[2])
cases, inputs = a["cases"], a["inputs"]
w = len(next(iter(inputs.values()))[0])
pd.init_from_config(Config.from_params({
    "num_machines": w, "tree_learner": "data",
    "machine_list_file": sys.argv[1]}), "cuda")
mesh = pm.ProcessMesh(torch.device("cuda", torch.cuda.current_device()))
spent = [0.0]
transfer = mesh._transfer
def timed_transfer(*args):
    t0 = time.perf_counter()
    try:
        return transfer(*args)
    finally:
        spent[0] += time.perf_counter() - t0
mesh._transfer = timed_transfer
out, results = {"transport": mesh.transport}, {}
for name, exchange, groups, _, precision in cases:
    hi, lo = (ws[rank].cuda() for ws in inputs[name])
    f, b = hi.shape[0], hi.shape[1]
    words = f * b * 3 * 4
    def one():
        pair = (hi, lo)
        if exchange == "allgather":
            return (pm.pair_allreduce(pair, mesh) if precision == "pair"
                    else pm.compressed_allreduce(pair, mesh, precision))
        if precision == "pair":
            return pm.pair_reduce_scatter(pair, mesh, w, groups)
        return pm.compressed_reduce_scatter(pair, mesh, w, groups,
                                            precision)
    def many(n):
        return mesh.run(lambda r: [one() for _ in range(n)])[rank]
    before = mesh.collective_bytes["hist_reduce"]
    hk.reset_launch_counts()
    results[name] = many(1)[0].cpu()
    folds = hk.launch_counts()["mesh_fold"]
    moved_bytes = mesh.collective_bytes["hist_reduce"] - before
    unit = words // (2 if precision == "bf16" else 1)
    if exchange == "allgather":
        plan = (2 if precision == "pair" else 1) * pm.allgather_recv_bytes(
            unit, w)
    else:
        plan = (2 if precision == "pair" else 1) * pm.alltoall_recv_bytes(
            unit, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad()
        many(%d)
        pad()
        torch.cuda.synchronize()
    ev = counted(prof)
    host, wall, trans = [], [], []
    for _ in range(3):
        spans, moved = [], []
        for n in (0, %d):
            torch.cuda.synchronize()
            spent[0] = 0.0
            t0 = time.perf_counter()
            many(n)
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t0)
            moved.append(spent[0])
        per = (spans[1] - spans[0]) / %d
        tr = (moved[1] - moved[0]) / %d
        wall.append(per)
        trans.append(tr)
        host.append(per - tr)
    fold = [e for e in ev if "gather_fold" in e.name]
    rest = {}
    for e in ev:
        if "gather_fold" not in e.name:
            k = rest.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.device_time_total / 1e3
    out[name] = {"fold_names": sorted({e.name for e in fold}),
                 "fold_events": len(fold),
                 "fold_device_ms": sum(e.device_time_total
                                       for e in fold) / 1e3,
                 "transport_events": rest,
                 "device_ms": sum(e.device_time_total for e in ev) / 1e3,
                 "mesh_fold_launches_first": folds,
                 "host_s": sorted(host)[1], "wall_s": sorted(wall)[1],
                 "transport_s": sorted(trans)[1],
                 "counted_bytes": moved_bytes, "plan_bytes": plan}
torch.save(results, sys.argv[3] + str(rank))
print("DIST_EXCHANGES " + json.dumps(out), flush=True)
""" % (EXCHANGE_PROFILED, EXCHANGE_TIMED, EXCHANGE_TIMED, EXCHANGE_TIMED)


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def write_machine_list(path, w, port=None):
    """W localhost entries from `port` (a free port by default); the
    first is the store."""
    port = free_port() if port is None else port
    with open(path, "w") as f:
        f.write("".join(f"127.0.0.1 {port + r}\n" for r in range(w)))
    return path


def run_gang(cmd, w, work, tag, env=None, timeout=240):
    """`cmd` (argv after the interpreter) on W rank processes started
    together, LIGHTGBM_TPU_RANK=r each, with `env` ({rank: {var: value}}
    and None for every rank): [(exit code, log text, exit time)] in rank
    order and the start time. A rank still running at `timeout` is
    killed; none outlives the call."""
    procs, logs = [], []
    t_start = time.monotonic()
    try:
        for r in range(w):
            e = dict(os.environ, LIGHTGBM_TPU_RANK=str(r))
            e.pop("LIGHTGBM_TPU_FAULTS", None)
            e.update((env or {}).get(None, {}))
            e.update((env or {}).get(r, {}))
            logs.append(open(os.path.join(work, f"{tag}.rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable] + cmd, env=e, stdout=logs[-1],
                stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        done = {}
        while len(done) < w and time.monotonic() - t_start < timeout:
            for r, p in enumerate(procs):
                if r not in done and p.poll() is not None:
                    done[r] = time.monotonic()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for r, p in enumerate(procs):
        logs[r].seek(0)
        out.append((p.returncode, logs[r].read(),
                    done.get(r, time.monotonic())))
        logs[r].close()
    return out, t_start


def gang_round_ms(text):
    """Round ms of a CLI rank's log ("... seconds elapsed, finished
    iteration k", per iteration)."""
    import re
    marks = [float(m.group(1)) for m in re.finditer(
        r"([0-9.]+) seconds elapsed, finished iteration \d+", text)]
    return [1e3 * (b - a) for a, b in zip([0.0] + marks, marks)]


def gang_launches(text):
    """The kernel launches a CLI rank logs at the end of its run."""
    import ast
    line = [ln for ln in text.splitlines()
            if "kernel launches in this process:" in ln]
    check(line, "a rank logged no kernel launches")
    return ast.literal_eval(line[-1].split("kernel launches in this "
                                           "process:", 1)[1].strip())


# one rank of the CLI gangs: the runs at argv[1] ([{"tag", "argv"}]), each
# an Application on the card in turn in this one process (the process
# group of the first run serves the rest), between markers that cut the
# rank's log into the runs' own; the kernel launch counts start from
# zero at each run
DIST_RUNS_SRC = """
import json, sys
from lightgbm_tpu_torch.application import Application
from lightgbm_tpu_torch.ops import hist_kernels as hk
for run in json.load(open(sys.argv[1])):
    print("DIST_RUN_BEGIN " + run["tag"], flush=True)
    hk.reset_launch_counts()
    Application(run["argv"]).run()
    print("DIST_RUN_END " + run["tag"], flush=True)
"""


def dist_cli_gangs(w, cache, work, transport, cases, env=None):
    """The CLI training runs of `cases` (each the argv of python -m
    lightgbm_tpu_torch on the bench rows from the binary cache) on ONE
    gang of W rank processes, one after another (DIST_RUNS_SRC: a rank
    process a gang, not a process a run); returns ({tag: record}, the
    gang's wall seconds)."""
    params = {k: v for k, v in BENCH_PARAMS.items() if k != "verbose"}
    key = transport.replace("+", "_")
    mlist = write_machine_list(os.path.join(work, f"{key}_{w}.mlist"), w)
    runs = []
    for name, extra in cases:
        tag = f"{name}_{key}_{w}"
        model = os.path.join(work, f"{tag}.model.txt")
        # a hung collective ends the gang well inside the run's limit
        runs.append({"tag": tag, "model": model, "argv": (
            ["task=train", f"data={cache}", f"num_trees={DIST_ROUNDS}",
             f"num_machines={w}", f"machine_list_file={mlist}",
             f"output_model={model}", "verbose=1", "metric_freq=0",
             "collective_timeout_s=120"]
            + [f"{k}={v}" for k, v in dict(params, **extra).items()])})
    path = os.path.join(work, f"runs_{key}_{w}.json")
    with open(path, "w") as f:
        json.dump(runs, f)
    t0 = time.time()
    ranks, _ = run_gang(["-c", DIST_RUNS_SRC, path], w, work,
                        f"gangs_{key}_{w}", env=env, timeout=600)
    wall = time.time() - t0
    for r, (rc, text, _) in enumerate(ranks):
        check(rc == 0, f"distributed {key}: rank {r} exited {rc}:\n"
              f"{text[-3000:]}")
    out = {}
    for run in runs:
        tag = run["tag"]
        pieces = [text.split(f"DIST_RUN_BEGIN {tag}\n", 1)[1].split(
            f"DIST_RUN_END {tag}", 1)[0] for _, text, _ in ranks]
        for r, piece in enumerate(pieces):
            check(f"[rank {r}]" in piece
                  and "ranks hold the same model" in piece,
                  f"distributed {tag}: rank {r} did not agree on the model")
        res = {"exit_codes": [rc for rc, _, _ in ranks],
               "transport": ranks[0][1].split("transport=", 1)[1].split()[
                   0].rstrip(","),
               "round_ms": gang_round_ms(pieces[0]),
               "launches": [gang_launches(p) for p in pieces]}
        res["round_ms_median_2_3"] = float(np.median(res["round_ms"][1:3]))
        with open(run["model"]) as f:
            res["model_text"] = f.read()
        out[tag] = res
    return out, wall


def dist_exchange_profile(torch, w, work, env):
    """DIST_EXCHANGE_SRC on a gang of W ranks, each exchange's results
    held bit for bit against an in-process LocalMesh of W shards on the
    card over the same inputs; returns the profile of rank 0 (rank 1's
    bits checked too)."""
    from lightgbm_tpu_torch.parallel import mesh as pm
    rng = np.random.RandomState(w + 71)
    inputs = {name: exchange_words(rng, w, (f, MAX_BIN, 3))
              for name, _, _, f, _ in DIST_EXCHANGE_CASES}
    path = os.path.join(work, f"exchange_inputs_{w}.pt")
    torch.save({"cases": DIST_EXCHANGE_CASES, "inputs": inputs}, path)
    mlist = write_machine_list(os.path.join(work, f"exchange_{w}.mlist"), w)
    ranks, _ = run_gang(["-c", DIST_EXCHANGE_SRC, mlist, path,
                         path + ".out"], w, work, f"exchange_{w}", env=env)
    for r, (rc, text, _) in enumerate(ranks):
        check(rc == 0, f"distributed exchange profile: rank {r} exited "
              f"{rc}:\n{text[-3000:]}")
    prof = json.loads([ln for ln in ranks[0][1].splitlines()
                       if ln.startswith("DIST_EXCHANGES ")][-1].split(
                           " ", 1)[1])
    local = pm.LocalMesh(w, "cuda")
    for name, exchange, groups, _, precision in DIST_EXCHANGE_CASES:
        hi, lo = ([t.to(DEVICE) for t in ws] for ws in inputs[name])

        def one(r):
            pair = (hi[r], lo[r])
            if exchange == "allgather":
                return pm.pair_allreduce(pair, local)
            if precision == "pair":
                return pm.pair_reduce_scatter(pair, local, w, groups)
            return pm.compressed_reduce_scatter(pair, local, w, groups,
                                                precision)

        want = [t.cpu() for t in local.run(one)]
        same = all(torch.equal(
            torch.load(path + f".out{r}")[name].view(torch.int32),
            want[r].view(torch.int32)) for r in range(w))
        p = prof[name]
        p["bits_equal_local_mesh"] = same
        n = EXCHANGE_PROFILED
        log(f"distributed exchange {name} ({w} ranks, {prof['transport']}):"
            f" {p['fold_events'] / n:.2f} gather_fold a rank an exchange "
            f"({p['fold_device_ms'] / n:.4f} device ms), the transport's "
            f"own {{name: [events, ms]}} {p['transport_events']} over {n} "
            f"exchanges, device ms {p['device_ms'] / n:.4f}, host us "
            f"{1e6 * p['host_s']:.1f}, transport us "
            f"{1e6 * p['transport_s']:.1f}, wall us {1e6 * p['wall_s']:.1f}"
            f" an exchange; bytes {p['counted_bytes']} (plan "
            f"{p['plan_bytes']}); bits = LocalMesh {same}")
        check(same, f"distributed exchange {name}: other bits than the "
              "in-process mesh")
        check(p["fold_events"] == n and p["mesh_fold_launches_first"] == 1,
              f"distributed exchange {name}: not one gather_fold a rank "
              "an exchange")
        check(p["counted_bytes"] == p["plan_bytes"],
              f"distributed exchange {name}: counted bytes "
              f"{p['counted_bytes']} differ from the plan's "
              f"{p['plan_bytes']}")
    return prof


def dist_kill_case(work, cache, w, env):
    """Rank 1 hard-crashes just before round 2 (rank_crash_at_iteration);
    rank 0 must exit with the watchdog's 117 within
    DIST_KILL_TIMEOUT_S + DIST_KILL_MARGIN_S of rank 1's death, its log
    naming the collective, the iteration and the rank."""
    mlist = write_machine_list(os.path.join(work, "kill.mlist"), w)
    params = {k: v for k, v in BENCH_PARAMS.items() if k != "verbose"}
    argv = (["-m", "lightgbm_tpu_torch", "task=train", f"data={cache}",
             f"num_trees={DIST_KILL_ROUNDS}", f"num_machines={w}",
             "tree_learner=data", f"machine_list_file={mlist}",
             f"output_model={os.path.join(work, 'kill.model.txt')}",
             f"collective_timeout_s={DIST_KILL_TIMEOUT_S}", "verbose=0"]
            + [f"{k}={v}" for k, v in params.items()])
    env = dict(env or {})
    env[1] = {"LIGHTGBM_TPU_FAULTS": "rank_crash_at_iteration=1:2"}
    ranks, _ = run_gang(argv, w, work, "kill", env=env,
                        timeout=DIST_KILL_TIMEOUT_S + 120)
    (rc0, text0, t0), (rc1, _, t1) = ranks[0], ranks[1]
    line = ([ln for ln in text0.splitlines() if "collective watchdog" in ln]
            or [""])[-1]
    res = {"exit_codes": [rc for rc, _, _ in ranks],
           "rank0_after_rank1_s": t0 - t1, "line": line[:400],
           "timeout_s": DIST_KILL_TIMEOUT_S, "margin_s": DIST_KILL_MARGIN_S}
    log(f"distributed kill case: exit codes {res['exit_codes']}, rank 0 "
        f"ended {res['rank0_after_rank1_s']:.2f} s after rank 1 "
        f"(collective_timeout_s {DIST_KILL_TIMEOUT_S}): {line[:300]}")
    check(rc1 == 43 and rc0 == 117, f"distributed kill case: exit codes "
          f"{res['exit_codes']}, want [117, 43]:\n{text0[-2000:]}")
    check(t0 - t1 < DIST_KILL_TIMEOUT_S + DIST_KILL_MARGIN_S,
          f"distributed kill case: rank 0 took {t0 - t1:.1f} s")
    check("rank 0" in line and "tree_build" in line
          and "iteration 2" in line, f"distributed kill case: the log "
          f"line does not name the rank, collective and iteration: {line}")
    return res


def phase_distributed(torch, lgt, cache, work):
    """The multi-process runtime (see the module doc, 9e): CLI gangs of
    DIST_SHARDS ranks sharing the card over gloo with pinned host copies
    (and over NCCL where there are two cards or more), each learner's
    model byte-equal to the in-process mesh's at the same W on the same
    rows, the exchange profile and the kill case. Returns the report and
    the mesh_fold launches of the gangs' ranks."""
    cards = torch.cuda.device_count()
    gangs = [("gloo+pinned", DIST_SHARDS,
              {None: {"CUDA_VISIBLE_DEVICES": "0"}}, DIST_CASES)]
    if cards >= 2:
        gangs.append(("nccl", min(cards, 4), None,
                      [c for c in DIST_CASES if c[0] in DIST_NCCL_CASES]))
        why = (f"{cards} cards: the ranks share card 0 over gloo with "
               f"pinned host copies, and {min(cards, 4)} ranks take a card "
               "each over NCCL")
    else:
        why = ("one card: NCCL refuses two ranks on one device, so the "
               "ranks share it over gloo with pinned host copies; no NCCL "
               "run")
    log(f"distributed: {why}")
    res = {"cards": cards, "transports_why": why, "gangs": {},
           "gangs_wall_s": {}}
    params = dict(BENCH_PARAMS)
    ds = lgt.Dataset(cache, params=params)
    fold_launches = 0
    for transport, w, env, cases in gangs:
        records, res["gangs_wall_s"][transport] = dist_cli_gangs(
            w, cache, work, transport, cases, env=env)
        for name, extra in cases:
            tag = f"{name}_{transport.replace('+', '_')}_{w}"
            gang = records[tag]
            local, local_ms = train_rounds(
                torch, lgt, dict(params, num_machines=w, **extra), ds,
                DIST_ROUNDS)
            same = local.model_to_string() == gang.pop("model_text")
            gang["in_process_round_ms"] = local_ms
            gang["in_process_round_ms_median_2_3"] = float(
                np.median(local_ms[1:3]))
            gang["model_byte_equal_in_process"] = same
            folds = sum(c.get("mesh_fold", 0) for c in gang["launches"])
            hists = sum(c.get("seg_hist" if "partitioned" in name
                              else "masked_hist", 0)
                        for c in gang["launches"])
            fold_launches += folds
            res["gangs"][tag] = gang
            log(f"distributed {tag}: transport {gang['transport']}, round "
                f"ms {[round(v, 1) for v in gang['round_ms']]} (median of "
                f"2-3 {gang['round_ms_median_2_3']:.1f}; in-process mesh "
                f"at W={w} {[round(v, 1) for v in local_ms]}, median "
                f"{gang['in_process_round_ms_median_2_3']:.1f}), model "
                f"byte-equal to the in-process mesh {same}, launches a "
                f"rank {gang['launches']}")
            check(gang["transport"] == transport,
                  f"distributed {tag}: transport {gang['transport']}")
            check(same, f"distributed {tag}: the gang's model differs from "
                  "the in-process mesh's")
            check(hists >= w * DIST_ROUNDS * 62,
                  f"distributed {tag}: histogram launches "
                  f"{gang['launches']}")
            if name.startswith("data") and name != "data_partitioned":
                check(folds >= w * DIST_ROUNDS * 63,
                      f"distributed {tag}: mesh_fold launches {folds}")
            del local
        res[f"exchanges_{transport}"] = dist_exchange_profile(
            torch, w, work, env)
    res["kill"] = dist_kill_case(work, cache, DIST_SHARDS, gangs[0][2])
    res["mesh_fold_launches"] = fold_launches
    return res


GANG_SHARDS = 2
GANG_ROUNDS = 3
GANG_BLOCK_ROWS = 262_144
# the drills' timeouts: a dead gloo peer fails the survivor's collective
# at once; the barrier then waits 2 x max(heartbeat, collective, 5) s for
# the dead rank's marker
GANG_HEARTBEAT_S = 5
GANG_COLLECTIVE_S = 5


def gang_argv(tsv, work, tag, mlist, extra=()):
    """The CLI arguments of one out-of-core gang rank: the ingestion
    phase's TSV over its block store (the file route's, block_rows
    262,144: 4 blocks), GANG_ROUNDS rounds, telemetry on (the journal
    in the tag's snapshot directory)."""
    params = {k: v for k, v in BENCH_PARAMS.items() if k != "verbose"}
    return (["task=train", f"data={tsv}", "has_header=true",
             "out_of_core=true", f"block_rows={GANG_BLOCK_ROWS}",
             "tree_learner=data", f"num_machines={GANG_SHARDS}",
             f"machine_list_file={mlist}", f"num_trees={GANG_ROUNDS}",
             f"output_model={os.path.join(work, tag + '.model.txt')}",
             f"snapshot_dir={os.path.join(work, tag + '.snaps')}",
             "telemetry=true", "verbose=1", "metric_freq=0",
             "enable_load_from_binary_file=false"]
            + [f"{k}={v}" for k, v in params.items()] + list(extra))


def gang_journal(work, tag):
    from lightgbm_tpu_torch.telemetry import journal
    recs, bad = journal.read_journal(os.path.join(work, tag + ".snaps",
                                                  "journal.jsonl"))
    check(bad == 0, f"gang {tag}: {bad} torn journal lines")
    errors = [e for r in recs for e in journal.validate_record(r)]
    check(not errors, f"gang {tag}: journal schema errors {errors[:5]}")
    return recs


def tree_structure(text):
    """Each tree's (split features, thresholds, leaf counts) and leaf
    values of a model text."""
    from lightgbm_tpu_torch.models.gbdt import create_boosting
    booster = create_boosting("gbdt", "cpu")
    booster.load_model_from_string(text)
    return [((t.split_feature_real.tolist(), t.threshold.tolist(),
              t.leaf_count.tolist()), t.leaf_value)
            for t in booster.models]


def gang_exchange_case(torch, hk, mk, timer, ds_core, rng):
    """The gang's exchange on the card: each rank's (acc, -comp) carry of
    a 1/63 leaf over its owned blocks of the bench bins (hist_pair_fold
    a block), folded by one gather_fold through a LocalMesh of
    GANG_SHARDS shards on the card (the ProcessMesh folds its receive
    buffer in the same order): bit for bit its plain version on the CPU
    copies, timed beside its bound, its plain version and torch.sum."""
    from lightgbm_tpu_torch.parallel import mesh as pm
    f, n = ds_core.bins.shape
    n_pad = -(-n // hk.HIST_CHUNK) * hk.HIST_CHUNK
    bins = torch.zeros((f, n_pad), dtype=torch.uint8, device=DEVICE)
    bins[:, :n] = torch.from_numpy(np.ascontiguousarray(ds_core.bins))
    ghc = torch.zeros((3, n_pad), dtype=torch.float32)
    ghc[0, :n] = torch.from_numpy(rng.randn(n).astype(np.float32))
    ghc[1, :n] = torch.from_numpy((rng.rand(n) + 0.1).astype(np.float32))
    ghc[2, :n] = 1.0
    ghc = ghc.to(DEVICE)
    row_leaf = torch.from_numpy(rng.randint(0, 63, n_pad).astype(
        np.int32)).to(DEVICE)
    leaf = torch.full((1,), 5, dtype=torch.int32, device=DEVICE)
    blocks = [(s, min(s + GANG_BLOCK_ROWS, n_pad))
              for s in range(0, n_pad, GANG_BLOCK_ROWS)]
    from lightgbm_tpu_torch.parallel.machines import partition_blocks
    words = []
    for r in range(GANG_SHARDS):
        lo, hi = partition_blocks(len(blocks), GANG_SHARDS, r)
        acc = torch.zeros((1, f, MAX_BIN, 3), dtype=torch.float32,
                          device=DEVICE)
        comp = torch.zeros_like(acc)
        for s, e in blocks[lo:hi]:
            hk.hist_pair_fold(acc[0], comp[0], bins[:, s:e].contiguous(),
                              ghc[:, s:e].contiguous(), row_leaf[s:e], leaf,
                              MAX_BIN)
        words.append((acc, (-comp).contiguous()))
    mesh = pm.LocalMesh(GANG_SHARDS, DEVICE)

    def exchange():
        return mesh.run(lambda r: pm.pair_allreduce(words[r], mesh))

    got = exchange()
    comps = [(t.cpu(), 0, f * MAX_BIN * 3) for i in range(2)
             for t in (words[r][i] for r in range(GANG_SHARDS))]
    want = torch.empty((1, f, MAX_BIN, 3))
    mk.gather_fold_plain(comps, 1, f * MAX_BIN * 3, want)
    same = all(torch.equal(g.cpu().view(torch.int32), want.view(torch.int32))
               for g in got)
    stacked = torch.stack([t for i in range(2)
                           for t in (words[r][i] for r in range(GANG_SHARDS))])
    k, cells = 2 * GANG_SHARDS, f * MAX_BIN * 3
    res = {"name": "mesh_fold",
           "shape": {"K": k, "cells": [1, f, MAX_BIN, 3],
                     "dtype": "float32", "what": "the gang's exchange"},
           "max_abs_err": float((got[0].cpu() - want).abs().max()),
           "bitwise_vs_cpu_plain": same,
           "ms": timer(lambda: mk.mesh_fold(stacked), 50),
           "exchange_ms": timer(exchange, 20),
           "plain_ms": timer(lambda: mk.mesh_fold_plain(stacked), 10),
           "library_ms": timer(lambda: torch.sum(stacked, 0), 50)}
    res["bound_ms"], res["bound_by"] = fold_bound_ms_mesh(k, cells, 4)
    log(f"gang exchange on the card ({GANG_SHARDS} ranks' carries of a "
        f"1/63 leaf over {len(blocks)} blocks): bits = plain {same}; "
        f"mesh_fold ms {res['ms']:.4f} (the exchange through the mesh "
        f"{res['exchange_ms']:.4f}), bound {res['bound_ms']:.5f}, plain "
        f"{res['plain_ms']:.4f}, torch.sum {res['library_ms']:.4f}")
    check(same, "gang exchange: other bits than its plain version")
    return res


def start_supervised_gang(tsv, work, tag, env_by_rank, supervised, port):
    """A gang of GANG_SHARDS ranks from `port`, each `python -m
    lightgbm_tpu_torch` or, for the ranks in `supervised`, `python -m
    lightgbm_tpu_torch.supervisor` (which relaunches it), snapshots
    every round; returns the started processes and their log files."""
    mlist = write_machine_list(os.path.join(work, f"{tag}.mlist"),
                               GANG_SHARDS, port)
    knobs = [f"heartbeat_timeout_s={GANG_HEARTBEAT_S}",
             f"collective_timeout_s={GANG_COLLECTIVE_S}", "max_restarts=2",
             "snapshot_freq=1"]
    argv = gang_argv(tsv, work, tag, mlist, knobs)
    procs, logs = [], []
    for r in range(GANG_SHARDS):
        e = dict(os.environ, LIGHTGBM_TPU_RANK=str(r))
        e.pop("LIGHTGBM_TPU_FAULTS", None)
        e.pop("LIGHTGBM_TPU_RESTART_ATTEMPT", None)
        e.update(env_by_rank.get(None, {}))
        e.update(env_by_rank.get(r, {}))
        module = ("lightgbm_tpu_torch.supervisor" if r in supervised
                  else "lightgbm_tpu_torch")
        logs.append(open(os.path.join(work, f"{tag}.rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module] + argv, env=e, stdout=logs[-1],
            stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__))))
    return procs, logs


def finish_gangs(gangs, timeout=300):
    """Wait for every process of the started `gangs` (killing those still
    running at `timeout`); [[(exit code, log text)] a rank] a gang."""
    t_end = time.monotonic() + timeout
    try:
        for procs, _ in gangs:
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, t_end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
    finally:
        for procs, _ in gangs:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    out = []
    for procs, logs in gangs:
        ranks = []
        for p, f in zip(procs, logs):
            f.seek(0)
            ranks.append((p.returncode, f.read()))
            f.close()
        out.append(ranks)
    return out


def phase_gang(torch, lgt, hk, timer, tsv, serial_text, ds, work, env):
    """The out-of-core gang learner (9f): the gang's exchange on the card
    against its plain version; an uninterrupted gang of GANG_SHARDS ranks
    over the TSV's shared block store (built once by the file route),
    GANG_ROUNDS rounds, its trees against the serial out-of-core
    learner's on the same store (the file route's first GANG_ROUNDS
    trees), the ranks' hist_pair_fold and mesh_fold launches, the
    journal's block_reshard records; the shrink drill (rank 0 under a
    supervisor, rank 1 killed before round 2: the survivor shrinks to 1
    rank and resumes from the round-2 snapshot, byte-equal to a
    single-rank run resumed from that snapshot, the store not rebuilt, no
    binning record); a same-topology restart (both ranks under
    supervisors, rank 1 killed before round 2) byte-equal to the
    uninterrupted gang."""
    from lightgbm_tpu_torch.ops import mesh_kernels as mk
    from lightgbm_tpu_torch.parallel.machines import partition_blocks
    rng = np.random.RandomState(97)
    res = {"exchange": gang_exchange_case(torch, hk, mk, timer, ds._core,
                                          rng)}
    store_dir = tsv + ".blocks"

    def build_count():
        with open(os.path.join(store_dir, "manifest.json")) as f:
            return json.load(f)["build_count"]

    blocks = -(-N_ROWS // GANG_BLOCK_ROWS)
    # the uninterrupted gang
    mlist = write_machine_list(os.path.join(work, "gang.mlist"), GANG_SHARDS)
    t0 = time.time()
    ranks, _ = run_gang(["-m", "lightgbm_tpu_torch"]
                        + gang_argv(tsv, work, "gang", mlist), GANG_SHARDS,
                        work, "gang", env=env)
    res["gang_s"] = time.time() - t0
    for r, (rc, text, _) in enumerate(ranks):
        check(rc == 0, f"gang: rank {r} exited {rc}:\n{text[-3000:]}")
        check("ranks hold the same model" in text,
              f"gang: rank {r} did not agree on the model")
    text0 = ranks[0][1]
    res["transport"] = text0.split("transport=", 1)[1].split()[0].rstrip(",")
    res["round_ms"] = gang_round_ms(text0)
    res["launches"] = [gang_launches(t) for _, t, _ in ranks]
    passes = GANG_ROUNDS * 63
    owned = [partition_blocks(blocks, GANG_SHARDS, r)
             for r in range(GANG_SHARDS)]
    want_folds = [(hi - lo) * passes for lo, hi in owned]
    folds = [c["hist_pair_fold"] for c in res["launches"]]
    exchanges = [c["mesh_fold"] for c in res["launches"]]
    with open(os.path.join(work, "gang.model.txt")) as f:
        gang_text = f.read()
    gang_trees = tree_structure(gang_text)
    serial_trees = tree_structure(serial_text)[:GANG_ROUNDS]
    res["trees_structurally_equal"] = [a[0] == b[0] for a, b in
                                       zip(gang_trees, serial_trees)]
    res["leaf_abs_diff"] = [float(np.max(np.abs(a[1] - b[1])))
                            for a, b in zip(gang_trees, serial_trees)]
    recs = gang_journal(work, "gang")
    reshard = sorted([(r["rank"], r["shards"], r["block_lo"], r["block_hi"])
                      for r in recs if r["event"] == "block_reshard"])
    res["block_reshard"] = reshard
    res["build_count"] = build_count()
    log(f"gang ({GANG_SHARDS} ranks, {res['transport']}): {res['gang_s']:.1f}"
        f" s, round ms {[round(v, 1) for v in res['round_ms']]}, launches a "
        f"rank {res['launches']} (hist_pair_fold {want_folds} wanted, "
        f"mesh_fold {passes} a rank), trees structurally equal to the "
        f"serial out-of-core learner's {res['trees_structurally_equal']}, "
        f"leaf abs diff {res['leaf_abs_diff']}, block_reshard {reshard}, "
        f"store build_count {res['build_count']}")
    check(folds == want_folds, f"gang: hist_pair_fold launches {folds}, "
          f"not {want_folds}")
    check(exchanges == [passes] * GANG_SHARDS,
          f"gang: mesh_fold launches {exchanges}, not {passes} a rank")
    check(all(res["trees_structurally_equal"])
          and max(res["leaf_abs_diff"]) <= 1e-5,
          "gang: trees differ from the serial out-of-core learner's")
    check(reshard == [(r, GANG_SHARDS, lo, hi)
                      for r, (lo, hi) in enumerate(owned)],
          f"gang: block_reshard records {reshard}")
    check(res["build_count"] == 1, "gang: the store was built again")

    # the two drills at once (each a gang of its own, ports apart: a
    # restart shifts them by its attempt): the shrink drill, rank 0
    # supervised and rank 1 killed before round 2; the same-topology
    # restart, both ranks supervised, rank 1 killed before round 2
    drill_env = dict(env or {})
    drill_env[1] = dict((env or {}).get(1, {}),
                        LIGHTGBM_TPU_FAULTS="rank_crash_at_iteration=1:2")
    port = free_port()
    t0 = time.time()
    shrink_ranks, restart_ranks = finish_gangs([
        start_supervised_gang(tsv, work, "shrink", drill_env, {0}, port),
        start_supervised_gang(tsv, work, "restart", drill_env, {0, 1},
                              port + 8)])
    res["drills_s"] = time.time() - t0
    (rc0, out0), (rc1, out1) = shrink_ranks
    recs = gang_journal(work, "shrink")
    adopted = [(r["shards"], r["block_lo"], r["block_hi"]) for r in recs
               if r["event"] == "block_reshard" and r.get("attempt", 0) >= 1]
    res["shrink"] = {
        "exit_codes": [rc0, rc1],
        "shrunk": "shrinking the world to 1 rank(s)" in out0,
        "resumed": "Resuming from checkpoint" in out0,
        "adopted": adopted, "build_count": build_count(),
        "binning_records": sum(r["event"] == "binning" for r in recs),
        "restart_records": [(r.get("source"), r["exit_code"],
                             r.get("survivors")) for r in recs
                            if r["event"] == "restart"]}
    # the reference: one rank resumed from the same round-2 snapshot
    # (the CLI in this process, on the card)
    from lightgbm_tpu_torch.application import Application
    ref = os.path.join(work, "shrink.ref.snaps")
    os.makedirs(ref)
    snap = "snapshot.iter00000002.ckpt"
    shutil.copy(os.path.join(work, "shrink.snaps", snap),
                os.path.join(ref, snap))
    params = {k: v for k, v in BENCH_PARAMS.items() if k != "verbose"}
    Application(["task=train", f"data={tsv}", "has_header=true",
                 "out_of_core=true", f"block_rows={GANG_BLOCK_ROWS}",
                 f"num_trees={GANG_ROUNDS}", "snapshot_freq=1",
                 f"snapshot_dir={ref}", "verbose=0", "metric_freq=0",
                 "enable_load_from_binary_file=false",
                 f"output_model={os.path.join(work, 'shrink.ref.model.txt')}"]
                + [f"{k}={v}" for k, v in params.items()]).run()
    with open(os.path.join(work, "shrink.model.txt")) as f:
        shrunk_text = f.read()
    with open(os.path.join(work, "shrink.ref.model.txt")) as f:
        res["shrink"]["byte_equal_single_rank_resume"] = f.read() == \
            shrunk_text
    log(f"gang shrink drill: {res['shrink']}")
    s = res["shrink"]
    check(rc1 == 43 and rc0 == 0, f"gang shrink drill: exit codes "
          f"{[rc0, rc1]}:\n{out0[-3000:]}")
    check(s["shrunk"] and s["resumed"]
          and s["adopted"] == [(1, 0, blocks)]
          and s["build_count"] == 1 and s["binning_records"] == 0
          and s["byte_equal_single_rank_resume"],
          f"gang shrink drill: {s}")

    # the same-topology restart: the barrier saw both ranks, the world
    # stayed 2
    (rc0, out0), (rc1, out1) = restart_ranks
    with open(os.path.join(work, "restart.model.txt")) as f:
        restarted = f.read()
    res["restart"] = {"exit_codes": [rc0, rc1],
                      "same_world": "restarting rank 0 as rank 0 of 2"
                                    in out0,
                      "resumed": "Resuming from checkpoint" in out0,
                      "byte_equal_uninterrupted": restarted == gang_text,
                      "build_count": build_count()}
    log(f"gang same-topology restart: {res['restart']}")
    check(res["restart"]["exit_codes"] == [0, 0]
          and res["restart"]["same_world"] and res["restart"]["resumed"]
          and res["restart"]["byte_equal_uninterrupted"]
          and res["restart"]["build_count"] == 1,
          f"gang same-topology restart: {res['restart']}:\n{out0[-3000:]}")
    res["mesh_fold_launches"] = sum(exchanges)
    res["hist_pair_fold_launches"] = sum(folds)
    return res


TELEMETRY_ROUNDS = N_ROUNDS


def phase_telemetry(torch, lgt, hk, ds, tsv, work):
    """The training telemetry (9g) on the fused compacted path: a booster
    with telemetry=true beside one without, each captured
    (warm_up_fused), two blocks of TELEMETRY_ROUNDS timed, the host syncs
    of a block listed, one replay's device kernels by name: the same
    syncs, the same kernels and the same model text with telemetry on.
    The journal of the telemetry booster checked against the schema
    (run_start, one iteration record a block, comm, memory). Then one
    out-of-core round over the TSV's store and the gang's exchange with
    the roofline table on: its hist_pair_fold and mesh_fold rows (CUDA
    event pairs, resolved at the read) against the card's copy peak."""
    from lightgbm_tpu_torch.ops import mesh_kernels as mk
    from lightgbm_tpu_torch.parallel import mesh as pm
    from lightgbm_tpu_torch.telemetry import journal, roofline
    res = {}
    jdir = os.path.join(work, "telemetry")
    allowed = transfer_line()
    roofline.TABLE.reset()
    boosters = {"off": lgt.Booster(dict(COMPACT_PARAMS), ds),
                "on": lgt.Booster(dict(COMPACT_PARAMS, telemetry=True,
                                       telemetry_dir=jdir), ds)}
    for name, booster in boosters.items():
        check(booster.gbdt.warm_up_fused(TELEMETRY_ROUNDS),
              f"telemetry {name}: not eligible for the fused trainer")
        res[name] = {"block_ms": []}
    # blocks in turns: off, on, on, off, off, on
    for name in ("off", "on", "on", "off", "off", "on"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boosters[name].gbdt.train_many(TELEMETRY_ROUNDS)
        torch.cuda.synchronize()
        res[name]["block_ms"].append(1e3 * (time.perf_counter() - t0))
    for name, booster in boosters.items():
        sites = sync_sites(
            torch, lambda: booster.gbdt.train_many(TELEMETRY_ROUNDS))
        runner = fused_runner(booster)
        text = booster.model_to_string()
        prof = profile_replay(torch, runner, reps=3)
        res[name].update({
            "round_ms": float(np.median(res[name]["block_ms"]))
            / TELEMETRY_ROUNDS,
            "sync_sites": sites,
            "launches_per_replay": dict(runner.graph.launches),
            "replay_kernels": prof["hist_kernel_launches"],
            "replay_device_ops": prof["device_ops"],
            "replay_busy_ms": prof["device_busy_ms"], "model_text": text})
    boosters["on"].gbdt.close_telemetry()
    # every launch the telemetry booster's capture made was left out of
    # the roofline table (a replay runs without the wrappers)
    res["captured_unrecorded"] = roofline.TABLE.captured_unrecorded
    del boosters, booster, runner
    on, off = res["on"], res["off"]
    res["same_model_text"] = on.pop("model_text") == off.pop("model_text")
    recs, bad = journal.read_journal(journal.journal_path(jdir, 0))
    errors = [e for r in recs for e in journal.validate_record(r)]
    events = [r["event"] for r in recs]
    blocks = [r for r in recs if r["event"] == "iteration"]
    res["journal"] = {"records": len(recs), "torn": bad,
                      "schema_errors": errors[:5],
                      "events": {e: events.count(e) for e in set(events)},
                      "blocks": [(r.get("block"), r.get("fused"))
                                 for r in blocks]}
    log(f"telemetry on the fused compacted path: round ms on "
        f"{on['round_ms']:.2f} against off {off['round_ms']:.2f} (blocks "
        f"{[round(v, 1) for v in on['block_ms']]} / "
        f"{[round(v, 1) for v in off['block_ms']]}); syncs in a block on "
        f"{on['sync_sites']} off {off['sync_sites']}; a replay's kernels on "
        f"{on['replay_kernels']} ({on['replay_device_ops']} device ops) off "
        f"{off['replay_kernels']} ({off['replay_device_ops']}); model text "
        f"equal {res['same_model_text']}; launches of the capture left "
        f"out of the roofline table {res['captured_unrecorded']}; journal "
        f"{res['journal']}")
    check(on["sync_sites"] == off["sync_sites"] == [allowed],
          f"telemetry: a block's syncs {on['sync_sites']} (off "
          f"{off['sync_sites']})")
    check(on["launches_per_replay"] == off["launches_per_replay"]
          and on["replay_kernels"] == off["replay_kernels"]
          and on["replay_device_ops"] == off["replay_device_ops"],
          "telemetry: a replay launches other kernels with telemetry on")
    check(res["same_model_text"], "telemetry: the model text differs")
    check(res["captured_unrecorded"] > 0,
          "telemetry: the capture's launches were not noted")
    check(bad == 0 and not errors and events[0] == "run_start"
          and len(blocks) == 4
          and all(b == (TELEMETRY_ROUNDS, True)
                  for b in res["journal"]["blocks"])
          and "comm" in events and "memory" in events,
          f"telemetry: journal {res['journal']}")

    # the roofline rows of the gang's kernels, timed by CUDA events
    roofline.TABLE.reset()
    params = dict(BENCH_PARAMS, has_header=True, out_of_core=True,
                  block_rows=262_144, telemetry=True, telemetry_dir=jdir)
    booster = lgt.train(params, lgt.Dataset(tsv, params=params), 1,
                        verbose_eval=False)
    torch.cuda.synchronize()
    booster.gbdt.close_telemetry()
    del booster
    roofline.TABLE.enabled = True
    rng = np.random.RandomState(5)
    words = exchange_words(rng, GANG_SHARDS, (1, N_FEATURES, MAX_BIN, 3))
    mesh = pm.LocalMesh(GANG_SHARDS, DEVICE)
    dev = [[t.to(DEVICE) for t in ws] for ws in words]
    for _ in range(50):
        mesh.run(lambda r: pm.pair_allreduce((dev[0][r], dev[1][r]), mesh))
    snap = roofline.TABLE.snapshot(warn_fraction=0.5)
    roofline.TABLE.enabled = False
    res["roofline"] = snap
    peak = snap["peak_bytes_per_s"]
    rows = {k: snap["kernels"].get(k) for k in ("hist_pair_fold",
                                                 "mesh_fold")}
    log(f"roofline (CUDA events, copy peak {peak / 1e9:.1f} GB/s): "
        + "; ".join(f"{k}: {v['calls']} calls, {v['seconds'] * 1e3:.3f} "
                    f"ms, {v['bytes_per_s'] / 1e9:.2f} GB/s = "
                    f"{v['pct_of_peak']}% of the peak"
                    for k, v in rows.items() if v))
    check(all(rows.values()) and rows["hist_pair_fold"]["calls"] >= 63 * 4
          and rows["mesh_fold"]["calls"] == 50 * GANG_SHARDS,
          f"telemetry: roofline rows {rows}")
    return res


def kernel_line(case, launches, source, replaces):
    """One entry of the `kernels` JSON line."""
    return {"name": case["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


def main():
    global BASELINE
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--baseline", default=None,
                    help="another checkout whose kernels are timed beside "
                         "these on the same inputs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch as lgt
        from lightgbm_tpu_torch.ops import hist_kernels as hk
        from lightgbm_tpu_torch.ops import traverse_kernels
    except ImportError as e:
        print(f"chip_smoke: lightgbm_tpu_torch not importable ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    report = {"card": card, "seed": args.seed, "rows": N_ROWS}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    dist_work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t0 = time.time()
        # every kernel source at once: the histogram kernels' and the
        # serving path's traversal kernels
        hk.build(hk.SOURCES + (traverse_kernels.SOURCE,))
        report["build_s"] = time.time() - t0
        report["ptxas"] = {src: ptxas_usage(out)
                           for src, out in hk.BUILD_OUTPUT.items()}
        for src, rows in report["ptxas"].items():
            for r in rows:
                log(f"ptxas {src}: {r['kernel'][:70]}: {r['registers']} "
                    f"registers, spills {r['spill_stores']}/"
                    f"{r['spill_loads']} bytes")
        if args.baseline:
            BASELINE = load_baseline(args.baseline).ops
            BASELINE.hist_kernels.build(
                BASELINE.hist_kernels.SOURCES
                + (BASELINE.traverse_kernels.SOURCE,))
            report["baseline"] = args.baseline
        log(f"kernels built in {report['build_s']:.1f}s")

        rng = np.random.RandomState(args.seed)
        timer = Timer(torch)
        n = 1 << 20
        cases = [
            kernel_case(torch, hk, timer, "masked_hist", N_FEATURES, n,
                        MAX_BIN, torch.uint8, [5], rng, cpu_check=True),
            kernel_case(torch, hk, timer, "frontier_hist", N_FEATURES, n,
                        MAX_BIN, torch.uint8, [0], rng, root=True),
            kernel_case(torch, hk, timer, "frontier_hist", N_FEATURES, n,
                        MAX_BIN, torch.uint8, [5, 17], rng),
            kernel_case(torch, hk, timer, "masked_hist", N_FEATURES, n, 300,
                        torch.int16, [5], rng),
            kernel_case(torch, hk, timer, "masked_hist", N_FEATURES, n,
                        MAX_BIN, torch.uint8, [0], rng, cpu_check=True,
                        skew=True, root=True),
            kernel_case(torch, hk, timer, "frontier_hist", N_FEATURES, n,
                        MAX_BIN, torch.uint8, [0], rng, cpu_check=True,
                        skew=True, root=True),
        ]
        report["kernel_cases"] = cases
        seg_cases = seg_kernel_cases(torch, hk, timer, rng)
        report["seg_kernel_cases"] = seg_cases
        t0 = time.time()
        compact_cases, compacted_cases = compact_kernel_cases(torch, hk,
                                                              timer, rng)
        report["compact_kernel_cases"] = compact_cases
        report["compacted_kernel_cases"] = compacted_cases
        report["compact_kernel_cases_s"] = time.time() - t0

        x, y, logit = make_data(N_ROWS, args.seed, with_logit=True)
        t0 = time.time()
        # the ingestion phase's files stay until the end: the
        # distributed phase's gangs load its binary cache, the gang
        # phase its TSV over the file route's block store
        ds, report["ingest"], bin_cases = phase_ingest(
            torch, lgt, timer, x, y, args.seed, dist_work)
        report["ingest"]["phase_s"] = time.time() - t0
        t0 = time.time()
        tsv = report["ingest"].pop("tsv")
        report["ooc_file"] = phase_ooc_file(
            torch, lgt, hk, tsv, report["ingest"].pop("text_model"))
        report["ooc_file"]["phase_s"] = time.time() - t0
        serial_text = report["ooc_file"].pop("model_text")
        cache = report["ingest"].pop("cache")
        booster, report["main"] = phase_main(torch, lgt, hk, ds, y)
        report["plain_tree"] = phase_plain_tree(torch, hk, booster)
        report["predict"] = phase_predict(torch, booster, x)
        report["profile"] = phase_profile(torch, booster)
        t0 = time.time()
        report["bundled"] = phase_bundled(torch, lgt, hk, args.seed)
        report["bundled"]["phase_s"] = time.time() - t0
        report["cacheless"] = phase_cacheless(torch, lgt, hk, ds, booster)
        part, report["partitioned"] = phase_partitioned(torch, lgt, hk, ds,
                                                        y, booster)
        report["profile_partitioned"] = phase_profile(torch, part)
        report["partitioned_syncs"] = phase_partitioned_syncs(torch, part)
        report["partitioned_cacheless"] = phase_partitioned_cacheless(
            torch, lgt, hk, ds)
        report["fused"] = phase_fused(torch, lgt, hk, ds, y, booster,
                                      report["main"], BENCH_PARAMS, "masked")
        report["fused_partitioned"] = phase_fused(
            torch, lgt, hk, ds, y, part, report["partitioned"],
            dict(BENCH_PARAMS, partitioned_build="true"), "partitioned")
        report["fused_sampled"] = phase_fused_sampled(torch, lgt, ds)
        t0 = time.time()
        report["compacted"] = phase_compacted(torch, lgt, hk, ds, y, logit,
                                              booster, report["fused"])
        report["compacted"]["phase_s"] = time.time() - t0
        report["blockwise"] = phase_blockwise(torch, lgt, ds, args.seed)
        t0 = time.time()
        report["resume"] = phase_resume(torch, lgt, ds, args.seed)
        report["resume"]["phase_s"] = time.time() - t0
        log(f"resume phase: {report['resume']['phase_s']:.1f} s")
        t0 = time.time()
        report["ooc"] = phase_ooc(torch, lgt, hk, timer, ds, x, y, args.seed)
        report["ooc"]["phase_s"] = time.time() - t0
        log(f"ooc phase: {report['ooc']['phase_s']:.1f} s (file route "
            f"{report['ooc_file']['phase_s']:.1f} s)")
        t0 = time.time()
        report["parallel"], mesh_cases = phase_parallel(
            torch, lgt, hk, timer, ds, y, args.seed)
        report["parallel"]["phase_s"] = time.time() - t0
        log(f"parallel phase: {report['parallel']['phase_s']:.1f} s")
        t0 = time.time()
        report["distributed"] = phase_distributed(torch, lgt, cache,
                                                  dist_work)
        report["distributed"]["phase_s"] = time.time() - t0
        log(f"distributed phase: {report['distributed']['phase_s']:.1f} s")
        t0 = time.time()
        gang_env = ({None: {"CUDA_VISIBLE_DEVICES": "0"}}
                    if torch.cuda.device_count() < 2 else None)
        report["gang"] = phase_gang(torch, lgt, hk, timer, tsv, serial_text,
                                    ds, dist_work, gang_env)
        report["gang"]["phase_s"] = time.time() - t0
        log(f"gang phase: {report['gang']['phase_s']:.1f} s")
        t0 = time.time()
        report["telemetry"] = phase_telemetry(torch, lgt, hk, ds, tsv,
                                              dist_work)
        report["telemetry"]["phase_s"] = time.time() - t0
        log(f"telemetry phase: {report['telemetry']['phase_s']:.1f} s")
        del booster, part
        t0 = time.time()
        report["multiclass"] = phase_multiclass(torch, lgt, hk, ds, x,
                                                logit, timer)
        report["multiclass"]["phase_s"] = time.time() - t0
        t0 = time.time()
        report["lambdarank"] = phase_lambdarank(torch, lgt, hk, ds, x,
                                                logit, timer, args.seed)
        report["lambdarank"]["phase_s"] = time.time() - t0
        t0 = time.time()
        report["goss"] = phase_goss(torch, lgt, hk, ds,
                                    report["compacted"]["fused"], timer)
        report["goss"]["phase_s"] = time.time() - t0
        t0 = time.time()
        report["dart"] = phase_dart(torch, lgt, hk, ds, x)
        report["dart"]["phase_s"] = time.time() - t0
        t0 = time.time()
        report["linear"], lin_case = phase_linear(
            torch, lgt, ds, x, timer, args.seed, report["ptxas"])
        report["linear"]["phase_s"] = time.time() - t0
        report["categorical"], cat_booster, cat_x = phase_categorical(
            torch, lgt, args.seed)
        serving, serve_cases = phase_serving(torch, lgt, ds, x, cat_booster,
                                             cat_x, timer, args.seed)
        report["serving"] = serving
        del ds, cat_booster
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        _write(args.out, report)
        return 1
    finally:
        shutil.rmtree(dist_work, ignore_errors=True)
    report["total_s"] = time.time() - t_start
    log(f"all phases passed in {report['total_s']:.1f}s")

    def fused_launches(name):
        """A kernel's launches on the fused main paths (counted through
        the graph's replays): the binary bench phases and the
        multiclass and lambdarank phases."""
        return sum(report[a][b]["launches"].get(name, 0) if b else
                   report[a]["launches"].get(name, 0)
                   for a, b in (("fused", None), ("fused_partitioned", None),
                                ("bundled", "fused"),
                                ("bundled", "fused_unbundled"),
                                ("multiclass", "fused"),
                                ("multiclass", "fused_partitioned"),
                                ("lambdarank", "fused")))

    hist_src = "lightgbm_tpu_torch/csrc/hist.cu"
    kernels = [
        # each kernel at its main-path shape, launches from the fused
        # paths
        kernel_line(cases[0], fused_launches("masked_hist"), hist_src,
                    "lightgbm_tpu/ops/pallas_hist.py:62"),
        kernel_line(cases[1], fused_launches("frontier_hist"), hist_src,
                    "lightgbm_tpu/ops/pallas_hist.py:81"),
        kernel_line(seg_cases[0], fused_launches("seg_hist"),
                    "lightgbm_tpu_torch/csrc/seg_hist.cu",
                    "lightgbm_tpu/ops/ordered_hist.py:123")]
    # the gather-compacted engine's kernels at a 10% leaf, launches from
    # the compacted phase's fused runs (binary and multiclass) and the
    # bundled phase's (bundled and unbundled)
    comp, bund = report["compacted"], report["bundled"]

    def compacted_launches(name):
        return (comp["fused"]["launches"].get(name, 0)
                + comp["multiclass"]["launches"].get(name, 0)
                + bund["fused"]["launches"].get(name, 0)
                + bund["fused_unbundled"]["launches"].get(name, 0))

    share = COMPACT_SHARES.index(0.10)
    kernels += [
        kernel_line(compact_cases[share], compacted_launches("compact_rows"),
                    "lightgbm_tpu_torch/csrc/compact.cu",
                    "lightgbm_tpu/ops/partition.py:44 (XLA "
                    "compact_gather_indices, no Pallas counterpart)"),
        kernel_line(compacted_cases[share],
                    compacted_launches("compacted_hist"),
                    "lightgbm_tpu_torch/csrc/compact_hist.cu",
                    "lightgbm_tpu/ops/histogram.py:573 (XLA "
                    "compacted_histograms; off the TPU the host route "
                    "_compacted_bincount :527; no Pallas counterpart)")]
    # the serving path's kernels, launches from its requests; the JAX
    # package runs this walk as XLA under the jitted serving kernels
    trav_src = "lightgbm_tpu_torch/csrc/traverse.cu"
    serve_counts = report["serving"]["launches"]
    mc_serve = report["multiclass"]["serving_launches"]
    kernels += [
        kernel_line(serve_cases["tree_leaf"], serve_counts["tree_leaf"]
                    + mc_serve.get("tree_leaf", 0),
                    trav_src, "lightgbm_tpu/serving/compiled_model.py:76 "
                    "(XLA device_traverse, no Pallas counterpart)"),
        kernel_line(serve_cases["tree_raw"], serve_counts["tree_raw"]
                    + mc_serve.get("tree_raw", 0),
                    trav_src, "lightgbm_tpu/serving/compiled_model.py:110 "
                    "(XLA device_traverse, no Pallas counterpart)")]
    # linear-leaf serving's value stage, launches from the linear phase's
    # serving main path (its device variants and bf16)
    kernels.append(kernel_line(
        lin_case, report["linear"]["launches"]["tree_lin_raw"], trav_src,
        "lightgbm_tpu/serving/compiled_model.py:170 (XLA _linraw_kernel, "
        "and _lintransformed_kernel :183; no Pallas counterpart)"))
    # the dataset's binning kernel, launches from the bench's construction
    kernels.append(kernel_line(
        bin_cases[0], report["ingest"]["launches"]["bin_dense"],
        "lightgbm_tpu_torch/csrc/bin.cu",
        "lightgbm_tpu/io/dataset.py:156 (XLA _bin_dense_on_device, no "
        "Pallas counterpart)"))
    # the LambdaRank pair gradients, launches from the fused lambdarank
    # run; the JAX package computes them as XLA
    kernels.append(kernel_line(
        report["lambdarank"]["gradients"], fused_launches("lambdarank_pairs"),
        "lightgbm_tpu_torch/csrc/rank.cu",
        "lightgbm_tpu/objectives/rank_device.py:54 (XLA "
        "make_lambdarank_gradfn, no Pallas counterpart)"))
    # the out-of-core block fold at the 4-block run's block size, launches
    # from the spilled runs (4 and 16 blocks) and the file route
    kernels.append(kernel_line(
        report["ooc"]["kernel_cases"][0],
        report["ooc"]["launches"]["hist_pair_fold"]
        + report["ooc_file"]["launches"]
        + report["gang"]["hist_pair_fold_launches"], hist_src,
        "lightgbm_tpu/ops/histogram.py:277 (XLA hist_pair_fold_block, and "
        "hist_pair_fold_collapse :324; no Pallas counterpart)"))
    # the mesh's exchange fold at the default reduce-scatter's owned
    # block, launches from the parallel phase's runs and the distributed
    # phase's rank processes
    kernels.append(kernel_line(
        mesh_cases[0], report["parallel"]["launches"]["mesh_fold"]
        + report["distributed"]["mesh_fold_launches"]
        + report["gang"]["mesh_fold_launches"],
        "lightgbm_tpu_torch/csrc/mesh.cu",
        "lightgbm_tpu/parallel/mesh.py:138 (XLA kahan_fold under "
        "pair_allreduce :161, pair_reduce_scatter :216 and compressed_* "
        ":173, :230; no Pallas counterpart)"))
    report["kernels"] = kernels
    _write(args.out, report)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _write(out_dir, report):
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    except OSError as e:
        print(f"chip_smoke: could not write report: {e}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
