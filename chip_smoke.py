"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the repository root; needs one card)

Phases, one JSON line each:
  1. build the kernels from dgl_hack_tpu_torch/csrc (nvcc, sm_90a);
  2. K1 (segment sum) against its plain version: forward and dx on a
     small graph (zero-in-degree rows, a hub of >= 10k in-edges, F in
     {7, 16, 41, 128}); gspmm with a dst-side operand, which reduces
     through K1; K1's long-row split (a hub over 101 pieces, rows of T
     and T + 1 edges, empty rows around long rows, every mode and weight
     kind at F in {1, 7, 16, 41, 128, 602}, misaligned x and weight); and
     at bench.py's shape (power-law, N=1M, deg 16, F=128), forward and dx
     timed beside torch.sparse.mm, with the row plans' build time and the
     feature-slice widths 16, 32, 64 and none;
  3. K2/K3 (fused GAT forward/backward) against the plain composed
     version and its autograd, in both softmax modes, on a graph with a
     dst hub (K2's pieces) and a src hub (K3's), plus a large-spread case
     in 'exact' mode and H = 2, D = 3,100 (wider than the first K3 took),
     with the row plans' piece counts; and at bench.py's shape (H = 8,
     D = 8, attn_w), checked and timed;
  4. GCN training through train_node_classifier on synthetic Reddit at
     full size (232,965 nodes x 602 features, 41 classes);
  5. GAT training on the same graph (8 heads x 8 hidden, 1 output head),
     after K2/K3 checked and timed at both layers' shapes (H = 8, D = 8
     and H = 1, D = 41, each with the sweep of floats per lane), with its
     peak memory and a torch.profiler profile of one step;
  6. K4/K5 (segment max and its fused argmax backward) against their plain
     versions on phase 2's small graph, whose hub K4 takes in pieces (F in
     {7, 16, 41, 128}; weights none, (E,) and (E, F); one case of integer
     features, which tie); through the long-row split in both directions
     (phase 2's plan graph and its transpose, F in {1, ..., 602}, a NaN,
     misaligned tensors); at bench.py's shape (F = 128), timed at every
     slice width; and on synthetic Reddit at both GraphSAGE layer widths
     (F = 602, as it is and padded to 608 as gspmm runs it, and 16), timed
     at every slice width, with K1 at F = 602 and 608 (the mean
     aggregator's layer 0);
  7. GraphSAGE-pool training (hidden 16, 2 layers) on synthetic Reddit,
     then 3 steps each of the mean and gcn aggregators;
  8. K6 (gSDDMM) against its plain version on phase 2's small graph (F in
     {7, 16, 41, 128}, every op with an 'u' and an 'e' lhs; dot at (H, D)
     in {(1, 16), (4, 16), (2, 7), (1, 41), (1, 128)}), and GsddmmFn's
     gradients (K6 + K1) against autograd through the plain version;
  9. K6 at bench.py's shape (u_dot_v and u_sub_v, F = 128), timed with its
     plain version and cuSPARSE's SDDMM (torch.sparse.sampled_addmm);
 10. graph-transformer training (examples/train_transformer.py at its
     full width: Dm 64, 4 heads, vocab 16, 2 + 2 layers) at batch 256 and
     sequence length 64, 5 steps after a warm-up step, with K6 and K1 at
     its shapes and a small forward held against the CPU; the profile of
     one step groups device time by kernel and by the torch op, autograd
     node and source line that launched it;
 11. SGC (k = 2), APPNP (hidden 64, k = 10) and TAGCN (hidden 16, k = 2)
     on full synthetic Reddit through train_node_classifier, 3 steps each
     (every propagation K1);
 12. K1's sorted-rows route (edge-row mode over runs of consecutive rows:
     readouts, copy_e sums) against its plain version at a readout of
     1,024 graphs of 24 nodes (F = 32), a single-graph readout over
     synthetic Reddit (F = 602, one row of 911 pieces) and copy_e sum over
     its 23.5 M CSC rows (F = 8), timed beside torch.segment_reduce;
 13. GIN graph classification at the full width of examples/train_gin.py
     (hidden 32, 3 layers, the SBM mixture of 24-node graphs, Adam lr
     5e-3): one forward held against the CPU, 5 steps in batches of 16,
     then 5 timed steps on a batch of 1,024 graphs with a torch.profiler
     profile of one step;
 14. every layer and pooling of the GIN/propagation/attention slice
     (SGConv, APPNPConv, TAGConv, ChebConv, AGNNConv, EdgeConv,
     GatedGraphConv, NNConv, the global poolings, Set2Set, the set
     transformer, Sequential, WeightBasis) and GINConv(max), forward and
     backward on the card against the same module on the CPU, on a batch
     holding a dst hub and a src hub of 700 edges, with each module's
     kernel launches;
 15. a twin of __graft_entry__.entry(): a GAT forward on a 512-node graph,
     held against the same model on the CPU;
 16. masked graphs (``masked_kernels``): a block at the shape of the
     sampled GraphSAGE's layer 0 (524,288 src, 32,768 dst, 327,680 edge
     slots, 30% padding, every 64th dst row padding alone), K1 forward and
     dx and K4/K5 at F = 602, K2/K3 at H = 8, D = 8 with attn_w (through
     gat_attention_fused on the masked block) and K6's u_dot_v over every
     slot, each against its plain version in float64 over the real-edge
     view, timed, with the view's and its row plans' build time; and
     gspmm (u_mul_e sum, copy_lhs mean with gradients, copy_lhs max) on
     the block against references built on the host from the mask alone;
 17. the native host sampler (``native_sampler``: the port's copy of
     fastgraph.cpp built with g++ into build/, OpenMP or not) on full
     synthetic Reddit at the sampled GraphSAGE's layer shapes (1,024
     seeds at fanout 25, 32,768 at fanout 10), with and without
     replacement: every pick a real in-edge of its seed, the counts
     right, no repeats without replacement, the picks repeatable, its
     host ms beside the plain numpy version; then the sampled GraphSAGE
     example (``sage_sampling_train``,
     examples/train_sage_sampling_torch.py) on full synthetic Reddit at
     its widths: 20 minibatches with the mean aggregator and 5 with pool,
     each evaluated on 4 test batches; per-step host sampling (split into
     sample_neighbors, to_block and the rest), copy, plan
     and device times, peak memory, the device's busy share over steps
     3-7 of a mean run of its own and the launches (K1; K4/K5; nothing
     plain); the same mean loop through the prefetchers (``prefetch``):
     ThreadedPrefetcher (losses equal to the unprefetched run's) and
     PooledPrefetcher with 2 and 4 workers over 32 batches' worth of
     training nodes (every one trained on), each with its step, busy
     share and launches; and ``NodeFlow.prop_flow`` over the sampler's
     blocks at F = 602 with mean (K1) and max (K4/K5), forward and the
     parent features' gradient, against the CPU, each block timed
     (``nodeflow``);
 18. R-GCN entity classification (``rgcn_train``, the model and trainer
     of examples/train_rgcn_torch.py) on synthetic AM at full stats
     (1,666,764 nodes, 11,976,642 edges, 266 relations) with the AM
     hyper-parameters of the R-GCN paper (hidden 10, 40 bases, l2 5e-4,
     two layers, self-loop, lr 1e-2): K1 at the (dst, etype)-pair path's
     shapes (the pair graph's forward with no weight and with an (E,)
     norm, its dx over the CSR rows, the edge-row pair sum) against its
     plain version, timed beside torch.sparse.mm / torch.segment_reduce;
     a small RelGraphConv (basis with and without w_comp, with and
     without the plan, bdd, a norm) against the CPU; a warm-up step and 5
     epochs with peak memory, prepare_rgcn's seconds and one profiled
     step; then synthetic AIFB at full size, 50 epochs, test accuracy;
 19. the heterograph R-GCN twin (``rgcn_hetero_train``,
     examples/train_rgcn_hetero_torch.py at its defaults): 20 epochs on
     the card, the first 5 losses against the same twin on the CPU, and a
     multi_update_all with max builtins (K4/K5) against the CPU;
 20. PageRank (``pagerank``) at bench.py's graph, 20 iterations through
     each form of the message-passing API (the twin's loop,
     update_all, pull, push, send_and_recv, send then recv), each against
     a float64 plain version on the card and, over 2 iterations, the same
     form on the CPU,
      one iteration of each timed, and K1 at F = 1 beside its bound,
     plain version and torch.sparse.mm;
 21. ``message_subsets``: send_and_recv over half of that graph's edges
     and push from a tenth of its nodes (sum, F = 1 and 16), each call's
     masked graph's real-edge view and row plans timed apart from K1 over
     the view, and the cost of one prop_edges frontier;
 22. ``sage_lstm_train``: the sampled GraphSAGE twin with the lstm
     aggregator on full synthetic Reddit, 8 steps, and SAGEConv('lstm') at
     the layer-0 block against the CPU; ``reddit_max_subset``:
     send_and_recv with fn.max over half of synthetic Reddit's edges at F
     = 602 (K4/K5 through the view), against the chosen edges' own graph;
 23. ``prop_nodes_topo`` on a 131,072-node DAG of 32 levels against the
     CPU (K1's edge-row mode once a level);
 24. the Tree-LSTM twin (``tree_lstm``) at hidden 150, its first losses
     against the CPU's (no kernel on this path);
 25. the PinSAGE recommendation twin (``pinsage_rec``) at MovieLens-1M's
     counts (6,040 users, 3,706 items): the PinSAGE sampler's host
     seconds, 60 epochs (gspmm u_mul_e and copy_rhs: K1), the loss
     falling, HITS@10 and MRR;
 26. the GraphSAGE control-variate twin (``sage_cv``: gspmm mean over
     padded blocks, K1 through the real-edge view) and the adaptive-
     sampling GCN twin (``adaptive_sampling``: full-graph gspmm mean, K1)
     at their CLI defaults, losses finite and falling;
 27. bf16 rows (``bf16_kernels``, after phase 9): K1 in every mode
     (forward, dx, edge rows) and weight kind (none, (E,) float32 and
     bf16, (E, F) float32, and a float32 result) at F = 7 and 1 on phase
     2's small graph and at bench.py's graph (F = 128), K4/K5 there, K1's
     edge-row mode at the GIN readout (1,024 x 24, F = 32) and every
     kernel on the masked layer-0 block (F = 602); each timed at bench.py's
     shape and on the block beside the float32 kernel on the same shape,
     its plain version and torch.sparse.mm on a bf16 CSR (or torch's
     message where it refuses); ``bf16_reddit`` (after phase 6): the same
     at synthetic Reddit's F = 602 padded to 640 (64 bf16 columns a line)
     as GspmmSum and GspmmMax run it, then gspmm max in bf16 forward and
     backward through dt.gspmm, K4/K5's main path, launches counted;
 28. bench.py's loop (``headline``): its graph prepared as bench.py does
     (the dense-hub hybrid: threshold 28,000, budget 6 GB), with the
     port's default threshold and with dense_hub=False (K1 alone), each
     run as bench.py runs it (K = 12 minus K = 2 chained gspmm(copy_lhs,
     sum) * 1e-3, one readback) in float32 and with a bf16 carry: edges/s,
     share of the compulsory-byte bound, windows, dense rows, C's bytes and
     build ms, peak memory; one iteration of each hybrid against K1 alone;
 29. the hybrid's parts (``hybrid``) at bench.py's shape, forward and
     backward, in float32 and bf16, against K1 alone, with the inputs of
     the port's default breakeven as this run measures them;
 30. bf16 rows in K2/K3 and K6 (``bf16_attention``, after phase 27):
     gat_attention_fused over bf16 operands on phase 3's graph (both
     softmax modes) and the masked layer-0 block, K6 in every op, dot
     shape and gradient, each against its plain version in float64; K6 at
     bench.py's shape (u_dot_v, u_sub_v, F = 128) timed beside the float32
     kernel and sampled_addmm in bf16; then bf16 gsddmm through dt.gsddmm
     at that shape, forward and backward, with its launches (K6's bf16
     path); phase 27 also checks that bf16 calls of K2/K3 and K6 reach
     their bf16 kernels;
 31. ``bf16_attention_reddit`` (after phase 5): K2/K3 over a bf16 Wh at
     both GAT layer shapes on synthetic Reddit, against float64, timed
     beside the float32 kernels and swept over floats per lane and values
     per load; a bf16 dt.gat_attention forward and backward there;
 32. ``gat_train_packed``: phase 5's GAT training with
     DGL_TPU_GAT_PACKED=1 (the hidden layer on bf16 Wh, the odd-width
     output layer unpacked), 5 steps, the first loss against phase 5's,
     epoch ms, peak memory, launches, and a packed GATConv on the card
     against the CPU;
 33. the HAN, capsule and GraphWriter twins (``han``, ``capsule``,
     ``graphwriter``) at their CLI defaults, 40, 20 and 20 epochs: losses
     falling, the first against the CPU's, epoch ms, launches (K2/K3; K6
     and K1);
 34. the chemistry model zoo (``chem_train``): SchNet, MGCN, MPNN,
     AttentiveFP, the GCN and GAT classifiers, Weave and WLN at the JAX
     classes' default widths, each through examples/train_chem_torch.py's
     pieces on one batch of 1,024 synthetic molecules (about 16.5 k atoms,
     33 k directed bonds): the batch's host build, copy and plan build
     apart, 2 warm-up and 5 timed Adam steps, peak memory, launches (K1;
     K2/K3; K6), one step's device ms by kernel family, and the first
     step's forward and gradients on the whole batch against a CPU copy
     of the same model, which takes the card's relu gates;
 35. ``chem_twins``: the chem twin for gcn and schnet, MoNet and DiffPool
     at their CLI defaults; ``small_twins``: GGNN, DGI, GCMC, RRN and the
     point cloud at theirs, LGNN at 200 nodes a graph (line graphs of
     about 0.88 M edges): the first loss against the CPU's, losses
     falling, step ms, launches;
 36. ``profiling`` (after phase 2): ``utils.profiling.timed_loop`` over
     K1 at bench.py's shape against ``cuda_ms`` of the same chained link
     (within 25%), K1 alone beside them; ``datasets``: every dataset of
     tests/fixtures/data parsed on the host (no synthetic stand-in), each
     node-classification and PPI graph through gspmm copy_u sum (K1) on
     the card against K1's plain version in float64, and a card graph and
     a card heterograph through the npz graph files and back;
     ``checkpoint_resume``: GCN on synthetic Cora, 3 Adam steps, a
     checkpoint of the model and Adam, a fresh pair loaded from it and 2
     more steps, the 5 losses equal to 5 uninterrupted steps bit for bit;
 37. ``cluster_gcn_train`` (examples/train_cluster_gcn_torch.py) on full
     synthetic Reddit (``RedditDataset(scale=1.0)``) at --parts 8,
     --hidden 32: Fennel's and the halo build's host seconds, each part's
     nodes, edges and inner edges, at 0 halo hops (``metis_partition`` as
     the CLI calls it: parts of one self-loop a row) and 1 hop; K1 on a
     part of each against its plain version, timed beside its bound; the
     first part step's loss and gradients against a CPU copy (relu gates
     replayed); 2 + 5 epochs with the median step, peak memory, launches
     and one profiled step's device ms and busy share; the full-graph
     evaluation of the last model through K1;
 38. ``segment_ids`` (right after the build): the plain segment
     reductions and ``bincount`` on the card with ids outside [0, n),
     every reducer, against the CPU; ``kg_train``
     (examples/train_kg_torch.py at DGL-KE's FB15k widths: TransE_l2,
     hidden 400, batch 1,024, 256 negatives, chunk 64, on synthetic FB15k
     at scale 0.1): dense, --sparse_emb and --async_update, 50 steps each,
     the first 5 losses against a CPU copy, the step (CUDA events and host
     clock), a profiled window (busy share, launches), peak memory and the
     MRR; the three trainers timed again on random tables at FB15k's full
     counts (14,951 entities, 1,345 relations); one step of each other
     score function at hidden 400 against the CPU; ``eval_ranks`` of 512
     triples at FB15k's full counts (TransE_l2 and l1) with peak memory;
     ``kg_dist`` (the twin's 2 servers and 2 clients, 20 steps, row
     gradients on the card) and a round trip over NativeTransport on two
     local ports; ``dgmg_train`` (examples/train_dgmg_torch.py's model at
     the DGMG class defaults: 48 traces, 5 Adam steps, the first loss
     against the CPU, the first 3 losses against the same steps on the
     card in float64, a profiled step; a trace that fills 32 nodes and 64
     bonds, finite at the class's init, where it is chaotic, and against
     the CPU with the propagation weights halved; 8 samples from
     ``generate``).  None of these paths reaches a hand-written kernel; no
     plain path may run on the card.
 39. multi-GPU (``parallel/``) on ranks that share the card over
     gloo (a ``RankPool`` of 4 spawned processes, which load the library
     phase 1 built; one card allows no NCCL group of more than one rank):
     ``spatial_reddit`` (after ``cluster_gcn_train``): a Fennel plan of
     full synthetic Reddit in 4 parts with hub replication (the parent
     builds it once and writes each rank its slice), spatial GCN (602 ->
     16 -> 41, 3 steps) and spatial GAT (8 heads x 8, then one head, 2
     steps), each rank's forward rows against the single-process forward
     over the whole graph, the plan's build s and stats, the all_to_all
     bytes a step, step ms, the exchange's ms (CUDA events) and peak
     memory a rank; ``spatial_kernels``: the halo gspmm at the dry run's
     size (sum, mean, max, min with overlap on and off, weighted u_mul_e,
     hubs, the dense hub, bf16 on the wire), forward and dx against the
     single-graph gspmm on the card; ``multichip_dryrun``: the twin of
     ``__graft_entry__.dryrun_multichip`` at 4 ranks (mesh node 2 x tp 2)
     on the card against the same ranks running it on the CPU;
     ``nccl_one_rank``: spatial GCN over a one-part plan in a one-rank
     NCCL group against the single-graph forward.  K1, K2/K3 and K4/K5
     launch from the ranks; no plain path.
 40. the port's tools (``tools``, after ``hybrid``): tools/
     regression_torch.py on its train_gcn, train_gat and pagerank rows
     (each row ok), tools/tune_hybrid_torch.py's sweep at two (threshold,
     budget) points in float32 and bf16 on ``headline``'s graph,
     tools/scaling_torch.py at P = 1 and 2 over gloo with spatial GAT at
     P = 2 on 20,000 nodes (rows ok, all_to_all bytes equal to
     tools/scaling.py's formula) and tools/partition_torch.py on the cora
     stand-in; ``dispatch``: DGL_TPU_DEBUG_DISPATCH=1 over gspmm sum, max,
     a hybrid, a masked block, gsddmm and gat_attention on the card, each
     line once after two calls;
 41. ``rank_kernels`` (after ``nccl_one_rank``): the kernels as the ranks
     of ``parallel/`` run them, in one process: K1's forward and dx over
     rank 0's local and remote splits of ``spatial_reddit``'s plan at F =
     16, K2/K3 over its partition's real-edge view at H = 8, D = 8 and
     H = 1, D = 41, K4/K5 over rank 0's splits of the dry run's graph at
     F = 32, each against its plain version, timed beside it, its bound
     and the library call.
Then the card's name and power limit, the per-kernel JSON line, and as
the last line {"ok": true, "device": {...}}.  Any failure exits non-zero.

Tolerances (max abs error / max |reference|): bf16 sums (K1, K5 dx
under a weight, the hybrid) within one bf16 ulp of the float64 sum of the
same values plus K1_TOL * max|reference| (``BF16_ULPS``: the order of the
float32 sums); bf16 results of K2/K3 and K6's dot and gradients the same
with the float32 kernel's tolerance in place of K1_TOL, K6's bf16
elementwise ops equal to their plain versions, and K2/K3's float32
outputs over a bf16 Wh within GAT_TOL of float64; bf16 max/min and K5's
dx of an integer cotangent equal to their plain versions; a float32
hybrid within 1e-5 of K1 alone; a chemistry model's output and
gradients within LAYER_TOL of the CPU's; the packed GAT's first loss
within 2^-8 of the unpacked one, a packed GATConv within 2^-8 + GAT_TOL of the CPU
(``PACKED_LOSS_TOL``, ``PACKED_LAYER_TOL``); a twin's first loss within
LAYER_TOL of the CPU's; a Cluster-GCN part's first loss and gradients
within LAYER_TOL of the CPU's; the fixture graphs' K1 within K1_TOL of
float64; timed_loop within 25% of cuda_ms; the segment reductions with
out-of-range ids within 1e-6 of the CPU (``bincount`` equal); the KG
losses, tables and all-entity scores and the DGMG first loss within
LAYER_TOL of the CPU, DGMG's first 3 Adam losses within LAYER_TOL of the
card's float64 run, the full DGMG trace's NLL and gradients (with its
propagation weights halved) within LAYER_TOL of the CPU; the spatial
GCN's rows and every halo gspmm case within LAYER_TOL of the single-graph
result, the spatial GAT's within GAT_TOL, the bf16 wire's within 2^-8 of
each row's sum of |terms|, the dry run's losses on the card within 1e-4
of the CPU's.  K1 (its
rows route too)
and K5 <= 2e-5 against their plain versions run in float64 (the kernels'
f32 sums); the slice's layers <= 1e-4 against the CPU (``LAYER_TOL``);
K2, K3 <= 1e-4 against their f32 plain versions (the exp adds rounding);
K4 equal to its plain version (the max is exact); K6 equal to its plain
version for add/sub/mul/div/copy_rhs (one IEEE op per element), dot <= 1e-5
against its plain version run in float64, and its backward (K1 sums)
<= 2e-5 against autograd through the plain version in float64.  Every
kernel result must repeat bitwise across two runs.

Each kernel's bound is the larger of its compulsory bytes (each input
read once, each output written once) at 3.35 TB/s and its operations at
the fp32 rate of 67 TFLOP/s (H100 SXM data sheet); its library time is
one PyTorch call computing the same function where there is one
(``torch.sparse.mm`` on a CSR matrix for K1, ``torch.segment_reduce``
for its rows route, ``torch.sparse.sampled_addmm``
on a CSR matrix, batched over heads, for K6's dot, the masked block's
too), timed only.
"""
import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
K1_TOL, GAT_TOL, K5_TOL = 2e-5, 1e-4, 2e-5
LAYER_TOL = 1e-4
K6_DOT_TOL, K6_BWD_TOL = 1e-5, 2e-5
BF16_ULPS = 1.0        # bf16 sums: ulps of the float64 sum, + K1_TOL of max
HYBRID_TOL = 1e-5      # a float32 hybrid against K1 alone
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so
    far (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def rel_err(out, ref) -> float:
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((out - ref).abs().max()) if ref.numel() else 0.0
    return err / max(scale, 1e-30)


def abs_err(out, ref) -> float:
    return float((out - ref).abs().max()) if ref.numel() else 0.0


BUSY = {}


def keep_busy() -> None:
    """Queue about 5 ms of work on the card (two 4096-wide fp32 matmuls),
    behind which the host can queue a batch of short launches."""
    if "a" not in BUSY:
        BUSY["a"] = torch.ones((4096, 4096), device="cuda")
        BUSY["out"] = torch.empty_like(BUSY["a"])
    for _ in range(2):
        torch.mm(BUSY["a"], BUSY["a"], out=BUSY["out"])


def reset_peak_memory() -> None:
    """Start a peak-memory reading: drop ``keep_busy``'s buffers and the
    allocator's cache first, so that the peak is the run's own."""
    BUSY.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def cuda_ms(fn, reps: int = 10, one_launch: bool = False,
            queued: bool = False) -> float:
    """Median milliseconds of one fn() from CUDA events, after one warm-up.
    A call of under 2 ms is timed as a batch of up to 20 launches queued
    behind ``keep_busy``, so that the events bracket device time alone:
    with one launch per pair of events the wrapper's host time counts too,
    and it alone spread such a reading by +-15% between processes.
    ``one_launch`` times every call that second way, as this script timed
    all calls before it batched the short ones; ``queued`` queues a longer
    call too (one a batch), so that two forms of a kernel on either side
    of 2 ms are read the same way."""
    def timed(batch):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if batch:
            keep_busy()                     # the host runs ahead
        s.record()
        for _ in range(max(batch, 1)):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / max(batch, 1)
    fn()
    torch.cuda.synchronize()
    batch = 0 if one_launch else \
        int(min(20, 2.0 // max(timed(0), 1e-3)))        # 0: one, no queue
    if queued:
        batch = max(batch, 1)
    return float(np.median([timed(batch) for _ in range(reps)]))


def both_ms(fn, reps: int = 10):
    """(ms, one_launch_ms) of fn(): ``cuda_ms``'s reading and, for a call
    short enough to be batched, the one-launch reading beside it, which is
    what records made before the batching hold; else None."""
    ms = cuda_ms(fn, reps)
    return ms, (cuda_ms(fn, reps, one_launch=True) if ms < 2.0 else None)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(num_bytes: int, num_ops: float):
    """(ms, what sets it): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = num_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing(ms, plain_ms, num_bytes, num_ops, shape, library_ms=None):
    """One kernel's record; ``ms`` is a time or ``both_ms``'s pair."""
    ms, one = ms if isinstance(ms, tuple) else (ms, None)
    b_ms, b_by = bound(num_bytes, num_ops)
    return {"ms": ms, "one_launch_ms": one, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "shape": shape}


def k1_ref(sk, indptr, x, gidx=None, eid=None, w=None):
    """K1's plain version run in float64 on the same inputs, rounded to
    float32: the reference then carries no f32 summation error of its own
    (a hub row sums ~10^5 terms, and the f32 plain version's atomic adds
    err about as much as the kernel's fixed-order sum)."""
    return sk.segment_sum_plain(
        indptr, x.double(), gidx, eid,
        None if w is None else w.double()).float()


class Checks:
    """Largest error per kernel, and failures (raised at the end of a
    phase so each phase prints what it measured)."""

    def __init__(self):
        self.max_abs = {}
        self.failures = []

    def compare(self, kernel, what, out, ref, tol, again=None):
        out, ref = out.detach(), ref.detach()
        rel = rel_err(out, ref)
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0),
                                   abs_err(out, ref))
        ok = rel <= tol and bool(out.isfinite().all())
        if again is not None and not bool((out == again).all()):
            self.failures.append(f"{kernel} {what}: not bitwise repeatable")
        if not ok:
            self.failures.append(f"{kernel} {what}: rel err {rel:.3g} > {tol}")
        return rel

    def exact(self, kernel, what, out, ref, again):
        """The kernel's result must equal its plain version's exactly."""
        out, ref = out.detach(), ref.detach()
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0),
                                   abs_err(out, ref))
        if not bool((out == ref).all()):
            self.failures.append(f"{kernel} {what}: differs from plain, max "
                                 f"abs err {abs_err(out, ref):.3g}")
        if not bool((out == again).all()):
            self.failures.append(f"{kernel} {what}: not bitwise repeatable")

    def raise_if_failed(self, phase):
        if self.failures:
            raise SystemExit(f"{phase} failed: " + "; ".join(self.failures))


def phase_build(build):
    t0 = time.perf_counter()
    build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    ptxas = [ln.strip() for ln in str(build.BUILD_INFO.get("ptxas", ""))
             .splitlines() if "registers" in ln or "spill" in ln
             or "entry function" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": card, "library": build.BUILD_INFO.get("path"),
          "ptxas": ptxas})
    return card


def _k1_cases(sk, g, F, checks, tag, rng, weights=True, modes=("fwd", "rev"),
              plans=False):
    """K1 forward (CSC), dx (CSR) and, when asked, edge-row mode against
    the plain version in float64, each repeated bitwise.  With ``plans``
    the graph's cached row plans are passed, else K1 builds them."""
    dev = g.device
    E = g.num_edges()
    ins = {"fwd": (g.num_src_nodes, dict(indptr=g.csc_indptr, gidx=g.src),
                   "csc"),
           "rev": (g.num_dst_nodes, dict(indptr=g.csr_indptr,
                                         gidx=sk.rev_gidx(g),
                                         eid=g.csr_eids), "csr"),
           "edge": (E, dict(indptr=g.csc_indptr), "csc")}
    ws = [None]
    if weights:
        ws += [torch.from_numpy(rng.normal(size=(E,)).astype(np.float32))
               .to(dev),
               torch.from_numpy(rng.normal(size=(E, F)).astype(np.float32))
               .to(dev)]
    errs = {}
    for d in modes:
        rows, args, direction = ins[d]
        inp = torch.from_numpy(rng.normal(size=(rows, F))
                               .astype(np.float32)).to(dev)
        plan = sk.graph_row_plan(g, direction) if plans else None
        for w in ws:
            kind = "none" if w is None else ("scalar" if w.dim() == 1
                                             else "full")
            out = sk.segment_sum(x=inp, w=w, site=d, plan=plan, **args)
            again = sk.segment_sum(x=inp, w=w, site=d, plan=plan, **args)
            ref = k1_ref(sk, x=inp, w=w, **args)
            errs[f"{d}.{kind}"] = checks.compare(
                "segment_sum", f"{tag} F={F} {d} w={kind}", out, ref, K1_TOL,
                again)
    return errs


def _v_side_cases(dt, sk, g, src, dst, checks, rng, F=16):
    """gspmm with a dst-side operand on CUDA: it decomposes into one K1
    forward plus a per-node combine, launches nothing plain, and agrees
    with the same call on the CPU in float64."""
    gc = dt.graph((src, dst), num_nodes=g.num_src_nodes)
    x = rng.uniform(0.5, 1.5, size=(g.num_src_nodes, F))
    y = rng.uniform(0.5, 1.5, size=(g.num_dst_nodes, F))
    errs = {}
    for op, red in (("add", "sum"), ("sub", "mean"), ("dot", "sum")):
        name = f"u_{op}_v.{red}"
        sk.LAUNCHES.reset()
        out = dt.gspmm(g, op, red, torch.from_numpy(x).float().to(g.device),
                       torch.from_numpy(y).float().to(g.device), "u", "v")
        counts = dict(sk.LAUNCHES.counts)
        ref = dt.gspmm(gc, op, red, torch.from_numpy(x),
                       torch.from_numpy(y), "u", "v").float()
        errs[name] = checks.compare("segment_sum", name, out.cpu(), ref,
                                    K1_TOL)
        if counts != {"segment_sum.fwd": 1}:
            checks.failures.append(f"{name}: launches {counts}, expected "
                                   "one segment_sum.fwd and nothing plain")
    return errs


def csr_matrix(g, batch=None, reverse=False):
    """The graph's CSC direction as a sparse CSR matrix (dst x src) of
    ones, optionally ``batch`` copies: for the library calls
    ``torch.sparse.mm``, which K1's forward matches, and
    ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM), whose values come out
    in internal edge order.  ``reverse``: the CSR direction (src x dst),
    which K1's dx matches."""
    if reverse:
        crow, col = g.csr_indptr.long(), g.dst[g.csr_eids.long()].long()
        size = (g.num_src_nodes, g.num_dst_nodes)
    else:
        crow, col = g.csc_indptr.long(), g.src.long()
        size = (g.num_dst_nodes, g.num_src_nodes)
    if batch is not None:
        crow = crow.expand(batch, -1).contiguous()
        col = col.expand(batch, -1).contiguous()
        size = (batch,) + size
    return torch.sparse_csr_tensor(
        crow, col, torch.ones(col.shape, dtype=torch.float32,
                              device=g.device), size=size)


def phase_k1(dt, sk, checks, dev):
    from dgl_hack_tpu_torch.data import random_power_law_graph
    rng = np.random.default_rng(0)
    # small graph: rows 4000.. have no in-edges, node 0 is a hub
    N = 5000
    src = rng.integers(0, N, 60_000)
    dst = rng.integers(0, 4000, 60_000)
    dst[:12_000] = 0
    g = dt.graph((src, dst), num_nodes=N, device=dev)
    small = {F: _k1_cases(sk, g, F, checks, "small", rng)
             for F in (7, 16, 41, 128)}
    v_side = _v_side_cases(dt, sk, g, src, dst, checks, rng)
    x = torch.from_numpy(rng.normal(size=(N, 128)).astype(np.float32)
                         ).to(dev)
    emit({"phase": "k1_small", "nodes": N, "edges": g.num_edges(),
          "hub_in_degree": int(g.in_degrees()[0]), "rel_err": small,
          "v_side_rel_err": v_side,
          "fwd_ms_F128": cuda_ms(lambda: sk.segment_sum(
              g.csc_indptr, x, g.src, plan=sk.graph_row_plan(g, "csc"))),
          "fwd_plain_ms_F128": cuda_ms(
              lambda: sk.segment_sum_plain(g.csc_indptr, x, g.src))})
    checks.raise_if_failed("k1_small")

    plan_edges = phase_k1_plan(dt, sk, checks, dev)

    t0 = time.perf_counter()
    gb = random_power_law_graph(1_000_000, 16.0, alpha=2.1, seed=0)
    build_s = time.perf_counter() - t0
    # K1 alone: the phases that share this graph measure K1 (the port's
    # default would densify its hub window; ``headline`` measures that)
    gb = dt.prepare_spmm(gb, dense_hub=False, device=dev)
    F = 128
    errs = _k1_cases(sk, gb, F, checks, "bench", rng, weights=False,
                     plans=True)
    x = torch.from_numpy(rng.normal(size=(gb.num_src_nodes, F))
                         .astype(np.float32)).to(dev)
    dst_csr = sk.rev_gidx(gb)
    fwd = (gb.csc_indptr, x, gb.src)
    rev = (gb.csr_indptr, x, dst_csr, gb.csr_eids)
    p_fwd, p_rev = sk.graph_row_plan(gb, "csc"), sk.graph_row_plan(gb, "csr")
    times = {
        "fwd_ms": cuda_ms(lambda: sk.segment_sum(*fwd, plan=p_fwd)),
        "fwd_plain_ms": cuda_ms(lambda: sk.segment_sum_plain(*fwd)),
        "rev_plain_ms": cuda_ms(lambda: sk.segment_sum_plain(*rev)),
    }
    times["rev_ms"], times["rev_one_launch_ms"] = both_ms(
        lambda: sk.segment_sum(*rev, site="rev", plan=p_rev))
    A = csr_matrix(gb)
    times["fwd_library_ms"] = cuda_ms(lambda: torch.sparse.mm(A, x))
    A = csr_matrix(gb, reverse=True)
    times["rev_library_ms"] = cuda_ms(lambda: torch.sparse.mm(A, x))
    del A
    out = sk.segment_sum(*fwd, plan=p_fwd)
    times["fwd_bound_ms"], _ = bound(
        nbytes(gb.csc_indptr, gb.src, x, out), gb.num_edges() * F)
    times["rev_bound_ms"], _ = bound(
        nbytes(gb.csr_indptr, dst_csr, x, out), gb.num_edges() * F)
    ref = k1_ref(sk, *fwd)
    sweep = k1_slice_sweep(sk, checks, "bench fwd F=128", fwd, p_fwd, ref)
    del ref, out
    E = gb.num_edges()
    emit({"phase": "k1_bench_shape", "nodes": gb.num_src_nodes, "edges": E,
          "F": F, "graph_build_s": build_s,
          "plan_build_ms": plan_build_ms(sk, gb), "rel_err": errs, **times,
          "fwd_edges_per_s": E / (times["fwd_ms"] * 1e-3),
          "max_in_degree": int(gb.in_degrees().max()),
          "max_out_degree": int(gb.out_degrees().max()),
          "slice_width_rule": sk.slice_width(gb.num_src_nodes, F, False),
          "slice_sweep_fwd": sweep})
    checks.raise_if_failed("k1_bench_shape")
    return g, gb, plan_edges


def plan_build_ms(sk, g):
    """Milliseconds to build K1's row plan of each direction on the card,
    with the plan's size: set-up, once per graph, apart from the kernel
    times."""
    res = {}
    for direction, indptr in (("csc", g.csc_indptr), ("csr", g.csr_indptr)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = sk.row_plan(indptr)
        torch.cuda.synchronize()
        res[direction] = {"ms": 1e3 * (time.perf_counter() - t0),
                          "long_rows": plan.long_rows.numel(),
                          "pieces": plan.pieces.shape[0]}
    return res


def slice_sweep(launch, F, check, reps=5):
    """ms of ``launch(s)``, a kernel's launcher, at feature-slice widths
    16, 32, 64 and F (no slicing); ``check(s, out, again)`` holds each
    width's result, and its repeat, to the reference."""
    res = {}
    for s in (16, 32, 64, F):
        check(s, launch(s), launch(s))
        res[str(s)] = cuda_ms(lambda: launch(s), reps=reps)
    return res


def k1_slice_sweep(sk, checks, what, args, plan, ref):
    """K1's slice sweep, each width held to the float64 reference."""
    return slice_sweep(
        sk.segment_sum_launcher(*args, plan=plan), args[1].shape[1],
        lambda s, out, again: checks.compare(
            "segment_sum", f"{what} slice {s}", out, ref, K1_TOL, again))


def phase_k1_plan(dt, sk, checks, dev):
    """K1's long-row split on the card.  Row 1 is a hub of 101 pieces of
    K1_PIECE edges, rows 3 and 4 have exactly T and T + 1 edges, row 6 has
    3T + 5; rows 0, 2, 5 and the last are empty.  Every mode and weight
    kind at F in {1, 7, 16, 41, 128, 602} (F = 602 takes float2 loads),
    then an x and a weight 4 bytes off 16-byte alignment (narrow loads),
    each against the float64 plain version and repeated bitwise."""
    rng = np.random.default_rng(11)
    T, n = sk.K1_PIECE, 2048
    deg = rng.integers(0, T // 2 + 1, n)
    deg[[0, 2, 5, n - 1]] = 0
    deg[1], deg[3], deg[4], deg[6] = 100 * T + 3, T, T + 1, 3 * T + 5
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.shape[0])
    g = dt.prepare_spmm(dt.graph((src, dst), num_nodes=n), device=dev)
    plan = sk.graph_row_plan(g, "csc")
    hub_pieces = int(plan.piece_ptr[1] - plan.piece_ptr[0])
    if plan.long_rows.tolist() != [1, 4, 6] or hub_pieces != 101:
        checks.failures.append(f"k1 plan: long rows {plan.long_rows.tolist()}"
                               f", hub pieces {hub_pieces}")
    errs = {F: _k1_cases(sk, g, F, checks, "plan", rng,
                         modes=("fwd", "rev", "edge"), plans=True)
            for F in (1, 7, 16, 41, 128, 602)}
    vec = {}
    for F in (128, 602):
        buf = torch.from_numpy(rng.normal(size=n * F + 1).astype(np.float32)
                               ).to(dev)
        wbuf = torch.from_numpy(rng.normal(size=g.num_edges() * F + 1)
                                .astype(np.float32)).to(dev)
        x_off, w_off = buf[1:].view(n, F), wbuf[1:].view(-1, F)
        x_al = buf[:-1].view(n, F)
        for name, x, w in (("x_off", x_off, None), ("w_off", x_al, w_off)):
            args = dict(indptr=g.csc_indptr, x=x, gidx=g.src, w=w)
            vec[f"F{F}.{name}"] = sk.vector_width(F, x, w)
            checks.compare("segment_sum", f"plan F={F} {name}",
                           sk.segment_sum(plan=plan, **args),
                           k1_ref(sk, **args), K1_TOL,
                           sk.segment_sum(plan=plan, **args))
        vec[f"F{F}.aligned"] = sk.vector_width(F, x_al)
    if vec != {"F128.x_off": 1, "F128.w_off": 1, "F128.aligned": 4,
               "F602.x_off": 1, "F602.w_off": 1, "F602.aligned": 2}:
        checks.failures.append(f"k1 load widths {vec}")
    emit({"phase": "k1_plan", "nodes": n, "edges": g.num_edges(),
          "long_rows": plan.long_rows.tolist(), "hub_pieces": hub_pieces,
          "pieces": plan.pieces.shape[0], "load_width": vec,
          "plan_build_ms": plan_build_ms(sk, g), "rel_err": errs})
    checks.raise_if_failed("k1_plan")
    return src, dst, n


def composed_gat(g, fsrc, el, er, w, slope):
    """Plain composed GAT edge phase in torch (gather, leaky, segment
    softmax, weighted segment sum); autograd gives its gradients."""
    from dgl_hack_tpu_torch.ops import segment
    src, dst = g.src.long(), g.dst.long()
    N = g.num_dst_nodes
    raw = el[src] + er[dst]
    # jax.nn.leaky_relu's where(x >= 0): slope 1 at 0, as K3 (bf16 logits
    # hit 0; F.leaky_relu's slope there is the negative slope)
    logit = torch.where(raw >= 0, raw, slope * raw)
    a = segment.segment_softmax(logit, dst, N)
    if w is not None:
        a = a * w
    return segment.segment_sum(a[:, :, None] * fsrc[src], dst, N)


def _gat_case(gk, g, H, D, mode, checks, rng, tag, scale=1.0):
    dev = g.device
    N, E = g.num_src_nodes, g.num_edges()

    def t(shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape))
                                .astype(np.float32)).to(dev)

    fsrc, el, er = t((N, H, D)), t((N, H), scale), t((N, H), scale)
    w = torch.from_numpy((rng.random((E, H)) > 0.3).astype(np.float32)
                         / 0.7).to(dev)
    dout = t((N, H, D))
    ins = [v.clone().requires_grad_(True) for v in (fsrc, el, er, w)]
    ref = composed_gat(g, *ins, 0.2)
    gref = torch.autograd.grad(ref, ins, dout)
    outs = []
    for _ in range(2):
        kin = [v.clone().requires_grad_(True) for v in (fsrc, el, er, w)]
        out = gk.gat_attention_fused(g, *kin[:3], 0.2, kin[3], softmax=mode)
        outs.append((out, torch.autograd.grad(out, kin, dout)))
    (out, gout), (out2, gout2) = outs
    errs = {"fwd": checks.compare("gat_fwd", f"{tag} H={H} D={D} {mode}",
                                  out, ref, GAT_TOL, out2)}
    for name, a, b, r in zip(("dfsrc", "del", "der", "dattn_w"), gout, gout2,
                             gref):
        errs[name] = checks.compare("gat_bwd", f"{tag} H={H} D={D} {mode} "
                                    f"{name}", a, r, GAT_TOL, b)
    return errs


def _gat_hub_graph(dt, dev, rng):
    """20,000 nodes, 400,000 edges: 1000 isolated dst rows, a dst hub of
    15,000 in-edges (K2's pieces) and a src hub of 15,000 out-edges
    (K3's)."""
    N = 20_000
    src = rng.integers(0, N, 400_000)
    dst = rng.integers(0, N - 1000, 400_000)      # 1000 isolated dst rows
    dst[:15_000] = 3                              # a dst hub: K2's pieces
    src[15_000:30_000] = 5                        # a src hub: K3's pieces
    return dt.graph((src, dst), num_nodes=N, device=dev)


def phase_gat(dt, gk, sk, checks, dev):
    """K2/K3 through gat_attention_fused and its gradients against the
    composed plain version, in both softmax modes, on a graph with a dst
    hub (K2 takes it in pieces of the CSC row plan) and a src hub (K3 in
    pieces of the CSR plan); a large-spread 'exact' case; and H = 2,
    D = 3,100 (H*D + H > 6,144, wider than the first K3 took) on a graph
    small enough for the composed reference."""
    rng = np.random.default_rng(1)
    g = _gat_hub_graph(dt, dev, rng)
    N = g.num_src_nodes
    res = {}
    for H, D in ((8, 8), (1, 7)):
        for mode in ("shift", "exact"):
            res[f"H{H}D{D}.{mode}"] = _gat_case(gk, g, H, D, mode,
                                                checks, rng, "small")
    # logit spread > 100: only 'exact' is held to it ('shift' underflows)
    res["H8D8.exact.spread"] = _gat_case(gk, g, 8, 8, "exact", checks,
                                         rng, "spread", scale=60.0)
    n = 2000
    s2, d2 = rng.integers(0, n, 20_000), rng.integers(0, n, 20_000)
    d2[:1500], s2[1500:3000] = 1, 2               # hubs of 6 pieces
    g2 = dt.graph((s2, d2), num_nodes=n, device=dev)
    for mode in ("shift", "exact"):
        res[f"H2D3100.{mode}"] = _gat_case(gk, g2, 2, 3100, mode, checks,
                                           rng, "wide")
    emit({"phase": "gat_vs_composed", "nodes": N, "edges": g.num_edges(),
          "plan": _plan_sizes(sk, g), "wide_plan": _plan_sizes(sk, g2),
          "rel_err": res})
    checks.raise_if_failed("gat_vs_composed")


def _reddit(dt, dev):
    """``RedditDataset(scale=1.0)``: offline, the synthetic stand-in at
    Reddit's full size."""
    import warnings
    from dgl_hack_tpu_torch.data import RedditDataset
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "reddit raw files not found")
        ds = RedditDataset(scale=1.0)
    g = dt.prepare_spmm(ds.graph, device=dev)
    return ds, g, time.perf_counter() - t0


def _train(build, model, ds, g, epochs, lr, dev, weight_decay=5e-4):
    from dgl_hack_tpu_torch.models.training import train_node_classifier
    build.LAUNCHES.reset()
    res = train_node_classifier(model, g, ds.features, ds.labels,
                                ds.train_mask, ds.val_mask, ds.test_mask,
                                num_epochs=epochs, lr=lr,
                                weight_decay=weight_decay, device=dev)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    return res, counts


def _check_training(name, res, counts, need):
    losses = res["losses"]
    problems = []
    if not all(np.isfinite(losses)):
        problems.append(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses}")
    for k in need:
        if counts.get(k, 0) <= 0:
            problems.append(f"kernel {k} never launched")
    plain = {k: v for k, v in counts.items() if k.startswith("plain.")}
    if plain:
        problems.append(f"plain path ran on CUDA: {plain}")
    if problems:
        raise SystemExit(f"{name} failed: " + "; ".join(problems))


def phase_gcn(dt, build, sk, ds, g, checks, dev, timings):
    from dgl_hack_tpu_torch.models import GCN
    rng = np.random.default_rng(2)
    # K1 at the main path's shapes: GCN aggregates at the hidden width 16
    x = torch.from_numpy(rng.normal(size=(g.num_src_nodes, 16))
                         .astype(np.float32)).to(dev)
    dst_csr = sk.rev_gidx(g)
    fwd = (g.csc_indptr, x, g.src)
    rev = (g.csr_indptr, x, dst_csr, g.csr_eids)
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    out = sk.segment_sum(*fwd, plan=p_fwd)
    checks.compare("segment_sum", "reddit F=16 fwd", out, k1_ref(sk, *fwd),
                   K1_TOL, sk.segment_sum(*fwd, plan=p_fwd))
    checks.compare("segment_sum", "reddit F=16 rev",
                   sk.segment_sum(*rev, site="rev", plan=p_rev),
                   k1_ref(sk, *rev), K1_TOL,
                   sk.segment_sum(*rev, site="rev", plan=p_rev))
    A = csr_matrix(g)
    timings["segment_sum"] = timing(
        both_ms(lambda: sk.segment_sum(*fwd, plan=p_fwd)),
        cuda_ms(lambda: sk.segment_sum_plain(*fwd)),
        nbytes(g.csc_indptr, g.src, x, out), g.num_edges() * 16,
        "synthetic Reddit, F=16, forward",
        library_ms=cuda_ms(lambda: torch.sparse.mm(A, x)))
    rev_ms, rev_one = both_ms(
        lambda: sk.segment_sum(*rev, site="rev", plan=p_rev))
    timings["segment_sum"].update(
        rev_ms=rev_ms, rev_one_launch_ms=rev_one,
        rev_plain_ms=cuda_ms(lambda: sk.segment_sum_plain(*rev)))
    del A
    checks.raise_if_failed("gcn kernel check")

    torch.manual_seed(0)
    model = GCN(hidden_feats=16, out_feats=ds.num_classes, num_layers=2,
                dropout=0.5)
    res, counts = _train(build, model, ds, g, 5, 1e-2, dev)
    emit({"phase": "gcn_train", "nodes": g.num_src_nodes,
          "edges": g.num_edges(), "features": int(ds.features.shape[1]),
          "classes": ds.num_classes, "epochs": 5, "losses": res["losses"],
          "train_time_s": res["train_time_s"],
          "epoch_ms": 1e3 * res["train_time_s"] / 4,
          "test_acc": res["test_acc"], "launches": counts,
          "k1_reddit": timings["segment_sum"]})
    _check_training("gcn_train", res, counts,
                    ("segment_sum.fwd", "segment_sum.rev"))
    return counts


def _gat_kernels_at(gk, sk, g, H, D, checks, rng, tag, timed=False,
                    sweep=False, bf16=False):
    """K2, K3 and K1's edge-row (der) call on a graph at head shape (H, D)
    with attn_w, against their plain versions, each repeated bitwise.
    With ``timed`` returns K2's and K3's timing records (shift mode), with
    ``sweep`` also their sweeps of floats per lane (4, 8), each held to
    the plain version.  ``bf16``: Wh in bf16 (the packed GAT's rows; el,
    er, w and dout float32), held to the plain versions run in float64 on
    the same values, timed beside the float32 kernel on the same shape
    (``f32_ms``) and swept over values per load too."""
    dev = g.device
    N, E = g.num_src_nodes, g.num_edges()
    kf, kb = ("gat_fwd_bf16", "gat_bwd_bf16") if bf16 else ("gat_fwd",
                                                            "gat_bwd")

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    def wide(*a):          # float64 copies for a bf16 run's references
        return [x.double() if bf16 else x for x in a]

    wh, el, er, dout = t((N, H * D)), t((N, H)), t((N, H)), t((N, H * D))
    if bf16:
        wh = wh.to(BF16)
    w = torch.from_numpy((rng.random((E, H)) > 0.6).astype(np.float32)
                         / 0.4).to(dev)
    shift = gk.shift_bound(el, er, 0.2).contiguous()
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    fwd_args = (g.csc_indptr, g.src, wh, el, er, w, shift, 0.2, False)
    rst, den, sh = gk.gat_fwd(*fwd_args, plan=p_fwd)
    again = gk.gat_fwd(*fwd_args, plan=p_fwd)
    ref = gk.gat_fwd_plain(g.csc_indptr, g.src, wh, *wide(el, er, w, shift),
                           0.2, False)
    for i, name in enumerate(("rst", "den")):
        checks.compare(kf, f"{tag} H={H} D={D} {name}",
                       (rst, den)[i], ref[i], GAT_TOL, again[i])
    del again
    sds = (rst.view(N, H, D) * dout.view(N, H, D)).sum(-1).contiguous()
    bwd_args = (g.csr_indptr, g.csr_eids, sk.rev_gidx(g), wh, el, er, sh,
                den, sds, dout, w, 0.2)
    outs = gk.gat_bwd(*bwd_args, plan=p_rev)
    outs2 = gk.gat_bwd(*bwd_args, plan=p_rev)
    refs = gk.gat_bwd_plain(*bwd_args[:4], *wide(*bwd_args[4:11]), 0.2)
    for name, a, b, r in zip(("dwh", "del", "draw", "dw"), outs, outs2, refs):
        checks.compare(kb, f"{tag} H={H} D={D} {name}", a, r,
                       GAT_TOL, b)
    del outs2
    draw = outs[2]
    der = sk.segment_sum(g.csc_indptr, draw, site="edge", plan=p_fwd)
    checks.compare("segment_sum", f"{tag} der H={H}", der,
                   k1_ref(sk, g.csc_indptr, draw), K1_TOL,
                   sk.segment_sum(g.csc_indptr, draw, site="edge",
                                  plan=p_fwd))
    res = {}
    # a bf16 run and its float32 form on the same shape are both read
    # behind a queue (cuda_ms ``queued``): their times straddle 2 ms
    tm = (lambda fn: (cuda_ms(fn, queued=True), None)) if bf16 else both_ms
    if timed:
        shape = f"{tag}, H={H}, D={D}, attn_w" + (", bf16 Wh" if bf16 else "")
        # per edge and head: logit, leaky, exp, weight, den (~8) and D
        # multiply-adds forward; about twice that backward
        res["gat_fwd"] = timing(
            tm(lambda: gk.gat_fwd(*fwd_args, plan=p_fwd)),
            cuda_ms(lambda: gk.gat_fwd_plain(*fwd_args), reps=3),
            nbytes(g.csc_indptr, g.src, wh, el, er, w, shift, rst, den),
            E * H * (8 + 2 * D), shape + ", shift mode")
        # as the main path runs it: attn_w is a dropout mask, so no dw;
        # with dw beside it
        res["gat_bwd"] = timing(
            tm(lambda: gk.gat_bwd(*bwd_args, False, plan=p_rev)),
            cuda_ms(lambda: gk.gat_bwd_plain(*bwd_args, False), reps=3),
            nbytes(*bwd_args[:11], *outs[:3]), E * H * (12 + 4 * D),
            shape + ", no dw")
        dw_ms, dw_one = tm(lambda: gk.gat_bwd(*bwd_args, plan=p_rev))
        res["gat_bwd"].update(with_dw_ms=dw_ms, with_dw_one_launch_ms=dw_one,
                              with_dw_bound_ms=bound(
                                  nbytes(*bwd_args[:11], *outs),
                                  E * H * (12 + 4 * D))[0])
        if bf16:               # the float32 kernels on the same shape
            wh32 = wh.float()
            res["gat_fwd"]["f32_ms"] = tm(lambda: gk.gat_fwd(
                *fwd_args[:2], wh32, *fwd_args[3:], plan=p_fwd))[0]
            res["gat_bwd"]["f32_ms"] = tm(lambda: gk.gat_bwd(
                *bwd_args[:3], wh32, *bwd_args[4:], False, plan=p_rev))[0]
            del wh32
    if sweep:
        res["lane_sweep"] = gat_lane_sweep(
            gk, checks, f"{tag} H={H} D={D}",
            gk.gat_fwd_launcher(*fwd_args, p_fwd)[0],
            gk.gat_bwd_launcher(*bwd_args, plan=p_rev), ref[:2], refs,
            names=(kf, kb), settings=((4, 4), (8, 4), (8, 8)) if bf16
            else ((4, None), (8, None)), queued=bf16)
    del ref, refs, outs, fwd_args, bwd_args
    torch.cuda.empty_cache()
    return res


def gat_lane_sweep(gk, checks, what, launch_fwd, launch_bwd, ref_fwd,
                   ref_bwd, reps=5, names=("gat_fwd", "gat_bwd"),
                   settings=((4, None), (8, None)), queued=False):
    """ms of K2 and K3 at each (floats per lane, values per load) of
    ``settings`` (None: the wrapper's rule; the rules: ``K2_LANE_FLOATS``,
    ``K3_LANE_FLOATS``, and for bf16 Wh ``K2_BF16_VALUES``,
    ``K3_BF16_VALUES``), each setting's results and their repeat held to
    the plain versions; ``queued``: see ``cuda_ms``."""
    res = {"k2": {}, "k3": {}}
    for f, v in settings:
        label = f"lane_floats {f}" + ("" if v is None else f" values {v}")
        for key, kernel, launch, refs, outs in (
                ("k2", names[0], launch_fwd, ref_fwd, ("rst", "den")),
                ("k3", names[1], launch_bwd, ref_bwd,
                 ("dwh", "del", "draw", "dw"))):
            for name, a, b, r in zip(outs, launch(f, v), launch(f, v),
                                     refs):
                checks.compare(kernel, f"{what} {label} {name}", a, r,
                               GAT_TOL, b)
            res[key][label] = cuda_ms(lambda: launch(f, v), reps=reps,
                                      queued=queued)
    return res


def _train_step(model, ds, g, lr, dev):
    """train_node_classifier's own training step (``node_classifier_step``)
    on ``model``, taken once as a warm-up, for the profile."""
    from dgl_hack_tpu_torch.models.training import node_classifier_step
    step, _ = node_classifier_step(model, g, ds.features, ds.labels,
                                   ds.train_mask, lr=lr, device=dev)
    step()                                      # warm-up, outside the trace
    return step


def phase_gat_train(dt, build, gk, sk, ds, g, checks, dev, timings):
    """K2/K3 at the GAT main path's shapes on synthetic Reddit (hidden
    layer H = 8, D = 8; output layer H = 1, D = 41), checked, timed and
    swept over floats per lane; then GAT training 5 steps with its peak
    memory, and a torch.profiler profile of one step."""
    from dgl_hack_tpu_torch.models import GAT
    rng = np.random.default_rng(3)
    N, E = g.num_src_nodes, g.num_edges()
    hidden = _gat_kernels_at(gk, sk, g, 8, 8, checks, rng,
                             "synthetic Reddit", timed=True, sweep=True)
    timings["gat_fwd"], timings["gat_bwd"] = hidden["gat_fwd"], \
        hidden["gat_bwd"]
    out = _gat_kernels_at(gk, sk, g, 1, ds.num_classes, checks, rng,
                          "synthetic Reddit", timed=True, sweep=True)
    checks.raise_if_failed("gat kernel check")

    torch.manual_seed(0)
    model = GAT(hidden_feats=8, out_feats=ds.num_classes, heads=(8, 1),
                feat_drop=0.6, attn_drop=0.6)
    lr = 5e-3
    reset_peak_memory()
    res, counts = _train(build, model, ds, g, 5, lr, dev)
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_step(_train_step(res["model"], ds, g, lr, dev),
                            "gat_train")
    epoch_ms = 1e3 * res["train_time_s"] / 4
    emit({"phase": "gat_train", "nodes": N, "edges": E,
          "heads": [8, 1], "hidden": 8, "epochs": 5,
          "losses": res["losses"], "train_time_s": res["train_time_s"],
          "epoch_ms": epoch_ms, "test_acc": res["test_acc"],
          "launches": counts, "peak_memory_bytes": peak,
          "k2_reddit": timings["gat_fwd"], "k3_reddit": timings["gat_bwd"],
          "k2_reddit_H1D41": out["gat_fwd"],
          "k3_reddit_H1D41": out["gat_bwd"],
          "sweep_H8D8": hidden["lane_sweep"],
          "sweep_H1D41": out["lane_sweep"], "profile": profile,
          "device_busy_share": profile["device_ms"] / epoch_ms})
    _check_training("gat_train", res, counts,
                    ("gat_fwd", "gat_bwd", "segment_sum.edge"))
    return counts, res["losses"]


def phase_gat_bench(gk, sk, gb, checks):
    """K2/K3 at bench.py's shape (power-law, N = 1M, in-degree 16, a dst hub
    of ~173k edges that K2 takes in 677 pieces) at H = 8, D = 8 with
    attn_w: checked and timed."""
    rng = np.random.default_rng(14)
    res = _gat_kernels_at(gk, sk, gb, 8, 8, checks, rng, "bench.py graph",
                          timed=True)
    emit({"phase": "gat_bench_shape", "nodes": gb.num_src_nodes,
          "edges": gb.num_edges(), "plan": _plan_sizes(sk, gb),
          "k2": res["gat_fwd"], "k3": res["gat_bwd"]})
    checks.raise_if_failed("gat_bench_shape")


def _k4k5_case(sm, sk, g, x, w, gout, checks, what, plans=True, x_bwd=None):
    """K4 against its plain version (exactly) and K5 against its plain
    version run in float64 (K5_TOL), each repeated bitwise.  With ``plans``
    the graph's cached row plans are passed, else the wrappers build them.
    ``x_bwd`` is the x that K5 takes where it is not K4's: x without the
    zero columns that pad it.  Returns raw, the errors and the float64
    reference's dx in float32."""
    p_fwd = sk.graph_row_plan(g, "csc") if plans else None
    p_rev = sk.graph_row_plan(g, "csr") if plans else None
    fwd = (g.csc_indptr, x, g.src, w)
    raw = sm.segment_max(*fwd, plan=p_fwd)
    checks.exact("segment_max", what, raw, sm.segment_max_plain(*fwd),
                 sm.segment_max(*fwd, plan=p_fwd))
    args = (g.csr_indptr, sk.rev_gidx(g), g.csr_eids,
            x if x_bwd is None else x_bwd, w, raw, gout)
    out = sm.segment_max_bwd(*args, plan=p_rev)
    again = sm.segment_max_bwd(*args, plan=p_rev)
    ref = [None if r is None else r.float() for r in
           sm.segment_max_bwd_plain(*args, acc_dtype=torch.float64)]
    errs = {}
    for name, a, b, r in zip(("dx", "dw"), out, again, ref):
        if r is not None:
            errs[name] = checks.compare("segment_max_bwd", f"{what} {name}",
                                        a, r, K5_TOL, b)
    return raw, errs, ref[0]


def _k4k5_weights(g, F, rng):
    """The three weight kinds of K4/K5 on g: none, (E,), (E, F)."""
    E = g.num_edges()
    return (("none", None),
            ("scalar", torch.from_numpy(rng.normal(size=E).astype(np.float32)
                                        ).to(g.device)),
            ("full", torch.from_numpy(rng.normal(size=(E, F))
                                      .astype(np.float32)).to(g.device)))


def _plan_sizes(sk, g):
    return {d: {"long_rows": sk.graph_row_plan(g, d).long_rows.numel(),
                "pieces": sk.graph_row_plan(g, d).pieces.shape[0]}
            for d in ("csc", "csr")}


def phase_k4k5_small(sm, sk, g, checks):
    """K4/K5 on phase 2's small graph (zero-in-degree rows, a hub of
    12,010 in-edges, which K4 takes as 47 pieces of its row plan) at F in
    {7, 16, 41, 128}, weights none, (E,), (E, F), plus integer features,
    whose messages tie (there the wrappers build the plans themselves)."""
    rng = np.random.default_rng(4)
    dev = g.device
    E = g.num_edges()

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    res = {}
    for F in (7, 16, 41, 128):
        x = t(rng.normal(size=(g.num_src_nodes, F)))
        gout = t(rng.normal(size=(g.num_dst_nodes, F)))
        for kind, w in _k4k5_weights(g, F, rng):
            _, res[f"F{F}.{kind}"], _ = _k4k5_case(
                sm, sk, g, x, w, gout, checks, f"small F={F} w={kind}")
    x = t(rng.integers(0, 3, size=(g.num_src_nodes, 16)))
    gout = t(rng.normal(size=(g.num_dst_nodes, 16)))
    _, res["ties.F16"], _ = _k4k5_case(sm, sk, g, x, None, gout, checks,
                                       "small ties F=16", plans=False)
    emit({"phase": "k4k5_small", "nodes": g.num_src_nodes, "edges": E,
          "plan": _plan_sizes(sk, g), "rel_err": res})
    checks.raise_if_failed("k4k5_small")


def phase_k4k5_plan(dt, sm, sk, plan_edges, checks, dev):
    """K4/K5 through the long-row split on phase k1_plan's graph (a hub of
    101 pieces, rows of exactly T and T + 1 edges, empty rows) and on its
    transpose, where the hub is a src row and K5 walks the pieces: every
    weight kind at F in {1, 7, 16, 41, 128, 602} (F = 602 takes float2
    loads), one NaN feature, and an x, a raw and a weight 4 bytes off
    16-byte alignment (narrow loads)."""
    rng = np.random.default_rng(12)
    src, dst, n = plan_edges
    res, plans = {}, {}
    for tag, (s, d) in (("hub_dst", (src, dst)), ("hub_src", (dst, src))):
        g = dt.prepare_spmm(dt.graph((s, d), num_nodes=n), device=dev)
        plans[tag] = _plan_sizes(sk, g)
        for F in (1, 7, 16, 41, 128, 602):
            x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32)
                                 ).to(dev)
            gout = torch.from_numpy(rng.normal(size=(n, F))
                                    .astype(np.float32)).to(dev)
            for kind, w in _k4k5_weights(g, F, rng):
                _, res[f"{tag}.F{F}.{kind}"], _ = _k4k5_case(
                    sm, sk, g, x, w, gout, checks, f"plan {tag} F={F} "
                    f"w={kind}")
    if plans["hub_dst"]["csc"] != {"long_rows": 3, "pieces": 101 + 2 + 4} \
            or plans["hub_src"]["csr"] != plans["hub_dst"]["csc"]:
        checks.failures.append(f"k4k5 plans {plans}")
    # a NaN feature: its rows' raw is NaN in K4 and in the plain version
    x = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)).to(dev)
    deg = g.out_degrees()
    x[int(((deg > 0) & (deg < 64)).nonzero()[0]), 3] = float("nan")
    raw = sm.segment_max(g.csc_indptr, x, g.src)
    ref = sm.segment_max_plain(g.csc_indptr, x, g.src)
    nan_rows = int(raw[:, 3].isnan().sum())
    if not 0 < nan_rows < 64 or not bool((raw.isnan() == ref.isnan()).all()) \
            or not bool((raw.nan_to_num(7.0) == ref.nan_to_num(7.0)).all()):
        checks.failures.append("segment_max: NaN rows differ from plain")
    dx, _ = sm.segment_max_bwd(g.csr_indptr, sk.rev_gidx(g), g.csr_eids, x,
                               None, raw, gout[:, :16].contiguous())
    if not bool(dx.isfinite().all()):
        checks.failures.append("segment_max_bwd: a NaN max passed a "
                               "gradient")
    # misaligned tensors take narrower loads, never the plain version
    vec = {}
    for F in (128, 602):
        E = g.num_edges()
        xb, rb, gb_, wb = (torch.from_numpy(
            rng.normal(size=rows * F + 1).astype(np.float32)).to(dev)
            for rows in (n, n, n, E))
        x_al, g_al, w_al = (b[:-1].view(-1, F) for b in (xb, gb_, wb))
        x_off, w_off = xb[1:].view(n, F), wb[1:].view(E, F)
        for name, x, w in (("x_off", x_off, None), ("w_off", x_al, w_off)):
            vec[f"F{F}.{name}"] = sk.vector_width(F, x, w)
            _k4k5_case(sm, sk, g, x, w, g_al, checks,
                       f"plan F={F} {name}")
        # K5 alone with a misaligned raw (a view of a copy of K4's result)
        raw = sm.segment_max(g.csc_indptr, x_al, g.src, w_al)
        rb[1:].copy_(raw.view(-1))
        args = (g.csr_indptr, sk.rev_gidx(g), g.csr_eids, x_al, w_al,
                rb[1:].view(n, F), g_al)
        vec[f"F{F}.raw_off"] = sk.vector_width(F, *args[3:])
        ref = sm.segment_max_bwd_plain(*args, acc_dtype=torch.float64)
        for name, a, b, r in zip(("dx", "dw"), sm.segment_max_bwd(*args),
                                 sm.segment_max_bwd(*args), ref):
            checks.compare("segment_max_bwd", f"plan F={F} raw_off {name}",
                           a, r.float(), K5_TOL, b)
        vec[f"F{F}.aligned"] = sk.vector_width(F, x_al, w_al, raw, g_al)
    # K5 with x and dx narrower than raw and g, as GspmmMax runs it padded
    # (here the hub is a src row, so the partial dx rows are narrow too)
    narrow = {}
    for F, Fp in ((16, 32), (41, 64), (602, 608)):
        x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32)
                             ).to(dev)
        xp = sk.pad_columns(x, Fp)
        gp = torch.from_numpy(rng.normal(size=(n, Fp)).astype(np.float32)
                              ).to(dev)
        for kind, w in _k4k5_weights(g, F, rng)[:2]:
            _, narrow[f"F{F}.{kind}"], _ = _k4k5_case(
                sm, sk, g, xp, w, gp, checks, f"plan F={F} in {Fp} w={kind}",
                x_bwd=x)
        vec[f"F{F}.in{Fp}"] = list(sm.max_bwd_load_widths(Fp, x, None, xp,
                                                          gp))
    if vec != {"F16.in32": [4, 4], "F41.in64": [4, 1], "F602.in608": [4, 2],
               "F128.x_off": 1, "F128.w_off": 1, "F128.raw_off": 1,
               "F128.aligned": 4, "F602.x_off": 1, "F602.w_off": 1,
               "F602.raw_off": 1, "F602.aligned": 2}:
        checks.failures.append(f"k4k5 load widths {vec}")
    emit({"phase": "k4k5_plan", "nodes": n, "edges": g.num_edges(),
          "plan": plans, "load_width": vec, "nan_rows": nan_rows,
          "rel_err": res, "narrow_x_rel_err": narrow})
    checks.raise_if_failed("k4k5_plan")


def _k4k5_timings(sm, sk, g, x, gout, raw, shape, plain_reps=3, x_bwd=None):
    """K4 and K5 (no weight) timed with CUDA events beside their plain
    versions, with their byte bounds: the indices (not ``csr_eids``, which
    K5 reads only under a weight) and each feature array once.  With
    ``x_bwd`` (see ``_k4k5_case``) the bound counts every feature array at
    x_bwd's columns, those of the function that gspmm computes, and the
    bound over the arrays as they are run is ``bound_ms_at_run_width``."""
    E, F = g.num_edges(), x.shape[1]
    dst_csr = sk.rev_gidx(g)
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    fwd = (g.csc_indptr, x, g.src)
    rev = (g.csr_indptr, dst_csr, g.csr_eids, x if x_bwd is None else x_bwd,
           None, raw, gout)
    dx, _ = sm.segment_max_bwd(*rev, plan=p_rev)
    k4_arrays, k5_arrays = (x, raw), (rev[3], raw, gout, dx)
    cols = dx.shape[1]

    def at_cols(*arrays):
        return sum(4 * a.shape[0] * cols for a in arrays)
    k4 = timing(both_ms(lambda: sm.segment_max(*fwd, plan=p_fwd)),
                cuda_ms(lambda: sm.segment_max_plain(*fwd), reps=plain_reps),
                nbytes(g.csc_indptr, g.src) + at_cols(*k4_arrays), E * cols,
                shape)
    k5 = timing(both_ms(lambda: sm.segment_max_bwd(*rev, plan=p_rev)),
                cuda_ms(lambda: sm.segment_max_bwd_plain(*rev),
                        reps=plain_reps),
                nbytes(g.csr_indptr, dst_csr) + at_cols(*k5_arrays),
                2 * E * cols, shape)
    if x_bwd is not None:
        k4["bound_ms_at_run_width"] = bound(
            nbytes(g.csc_indptr, g.src, *k4_arrays), E * F)[0]
        k5["bound_ms_at_run_width"] = bound(
            nbytes(g.csr_indptr, dst_csr, *k5_arrays), 2 * E * F)[0]
    return k4, k5


def _k4k5_slice_sweeps(sm, sk, g, x, gout, raw, ref_dx, checks, what,
                       x_bwd=None):
    """K4's and K5's feature-slice widths 16, 32, 64 and none: K4 equal to
    its unsliced result (itself equal to the plain version), K5 within
    K5_TOL of the float64 reference."""
    F = x.shape[1]
    k4 = slice_sweep(
        sm.segment_max_launcher(g.csc_indptr, x, g.src,
                                plan=sk.graph_row_plan(g, "csc")), F,
        lambda s, out, again: checks.exact(
            "segment_max", f"{what} slice {s}", out, raw, again))
    k5 = slice_sweep(
        lambda s, launch=sm.segment_max_bwd_launcher(
            g.csr_indptr, sk.rev_gidx(g), g.csr_eids,
            x if x_bwd is None else x_bwd, None, raw, gout,
            plan=sk.graph_row_plan(g, "csr")): launch(s)[0], F,
        lambda s, out, again: checks.compare(
            "segment_max_bwd", f"{what} slice {s} dx", out, ref_dx, K5_TOL,
            again))
    return {"k4": k4, "k5": k5}


def phase_k4k5_bench(sm, sk, gb, checks):
    """K4/K5 at bench.py's shape (power-law, N = 1M, in-degree 16, F = 128,
    a hub row of ~173k in-edges cut into pieces), checked, timed, and at
    every slice width."""
    rng = np.random.default_rng(13)
    F, N = 128, gb.num_src_nodes
    x = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                         ).to(gb.device)
    gout = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                            ).to(gb.device)
    raw, errs, ref_dx = _k4k5_case(sm, sk, gb, x, None, gout, checks,
                                   "bench F=128")
    k4, k5 = _k4k5_timings(sm, sk, gb, x, gout, raw,
                           "bench.py graph, F=128, no weight")
    sweeps = _k4k5_slice_sweeps(sm, sk, gb, x, gout, raw, ref_dx, checks,
                                "bench F=128")
    del x, gout, raw, ref_dx
    torch.cuda.empty_cache()
    emit({"phase": "k4k5_bench_shape", "nodes": N, "edges": gb.num_edges(),
          "F": F, "plan": _plan_sizes(sk, gb), "rel_err": errs,
          "k4": k4, "k5": k5,
          "slice_width_rule": {
              "k4": sk.slice_width(N, F, False),
              "k5": sm.max_bwd_slice_width(N, F, 0, False)},
          "slice_sweep": sweeps})
    checks.raise_if_failed("k4k5_bench_shape")


def _padded_kernels(sm, sk, g, x, gout, checks, timings):
    """K4, K5 and K1 as gspmm runs them at Reddit's F = 602: K4 and K1 on
    x, and K5 on raw and the cotangent, padded with zero columns to 608,
    whole 128-byte L2 lines (``padded_width``); K5 takes x itself and
    writes dx at 602.  Checked, timed at every slice width (K1 also
    beside its plain version and torch.sparse.mm on the padded x), with
    the padding copy's own time and gspmm max's time end to end (padding,
    K4, the zero fill; then with its backward: the cotangent's padding,
    K5)."""
    N, E, F = g.num_src_nodes, g.num_edges(), x.shape[1]
    Fp = sk.padded_width(N, F, None)
    xp, gp = sk.pad_columns(x, Fp), sk.pad_columns(gout, Fp)
    raw, errs, ref_dx = _k4k5_case(sm, sk, g, xp, None, gp, checks,
                                   f"reddit F={F} padded to {Fp}", x_bwd=x)
    shape = f"synthetic Reddit, F={F} padded to {Fp}, relu features, " \
            "no weight"
    timings["segment_max"], timings["segment_max_bwd"] = _k4k5_timings(
        sm, sk, g, xp, gp, raw, shape, x_bwd=x)
    res = {"width": Fp, "rel_err": errs, "k4": timings["segment_max"],
           "k5": timings["segment_max_bwd"],
           "slice_sweep": _k4k5_slice_sweeps(sm, sk, g, xp, gp, raw, ref_dx,
                                             checks, f"reddit F={Fp}",
                                             x_bwd=x),
           "k5_load_widths": sm.max_bwd_load_widths(Fp, x, None, raw, gp),
           "pad_ms": cuda_ms(lambda: sk.pad_columns(x, Fp))}
    del raw, ref_dx
    fwd = (g.csc_indptr, xp, g.src)
    plan = sk.graph_row_plan(g, "csc")
    ref = k1_ref(sk, *fwd)
    res["k1_rel_err"] = checks.compare(
        "segment_sum", f"reddit F={Fp} fwd", sk.segment_sum(*fwd, plan=plan),
        ref, K1_TOL, sk.segment_sum(*fwd, plan=plan))
    res["k1_ms"] = cuda_ms(lambda: sk.segment_sum(*fwd, plan=plan))
    res["k1_plain_ms"] = cuda_ms(lambda: sk.segment_sum_plain(*fwd), reps=3)
    A = csr_matrix(g)
    res["k1_library_ms"] = cuda_ms(lambda: torch.sparse.mm(A, xp), reps=3)
    del A
    res["k1_slice_sweep"] = k1_slice_sweep(sk, checks, f"reddit F={Fp}", fwd,
                                           plan, ref)
    del ref, xp, gp
    xg = x.clone().requires_grad_()

    def fwd_bwd():
        xg.grad = None
        (sm.gspmm_max(g, xg) * gout).sum().backward()
    with torch.no_grad():
        res["gspmm_max_fwd_ms"] = cuda_ms(lambda: sm.gspmm_max(g, x))
    res["gspmm_max_fwd_bwd_ms"] = cuda_ms(fwd_bwd)
    return res


def phase_sage_kernels(sm, sk, g, checks, dev, timings):
    """K4/K5 at the GraphSAGE-pool main path's shapes on synthetic Reddit:
    layer 0 reduces relu(fc_pool(x)) at F = 602, which gspmm pads to 608
    (the kernels are timed at both widths; the padded one is the main
    path's), layer 1 at F = 16 (relu zeros tie, as on the main path); K1 at
    F = 602, the mean aggregator's layer 0, and padded.  Timed with CUDA
    events against the plain versions."""
    rng = np.random.default_rng(5)
    N, E = g.num_src_nodes, g.num_edges()
    res = {}
    for F in (602, 16):
        x = torch.relu(torch.from_numpy(
            rng.normal(size=(N, F)).astype(np.float32)).to(dev))
        gout = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                                ).to(dev)
        raw, res[f"F{F}"], ref_dx = _k4k5_case(
            sm, sk, g, x, None, gout, checks, f"reddit F={F}")
        k4, k5 = _k4k5_timings(
            sm, sk, g, x, gout, raw,
            f"synthetic Reddit, F={F}, relu features, no weight")
        if F == 16:
            narrow = {"k4_reddit_F16": k4, "k5_reddit_F16": k5}
        if F == 602:
            unpadded = {"k4_reddit_F602": k4, "k5_reddit_F602": k5}
            sweeps = _k4k5_slice_sweeps(sm, sk, g, x, gout, raw, ref_dx,
                                        checks, "reddit F=602")
            rule = {"k4": sk.slice_width(N, F, False),
                    "k5": sm.max_bwd_slice_width(N, F, 0, False)}
            fwd = (g.csc_indptr, x, g.src)
            plan = sk.graph_row_plan(g, "csc")
            out = sk.segment_sum(*fwd, plan=plan)
            ref = k1_ref(sk, *fwd)
            res["k1.F602"] = checks.compare(
                "segment_sum", "reddit F=602 fwd", out, ref, K1_TOL,
                sk.segment_sum(*fwd, plan=plan))
            A = csr_matrix(g)
            k1_602 = timing(
                cuda_ms(lambda: sk.segment_sum(*fwd, plan=plan)),
                cuda_ms(lambda: sk.segment_sum_plain(*fwd), reps=3),
                nbytes(g.csc_indptr, g.src, x, out), E * F,
                "synthetic Reddit, F=602, forward",
                library_ms=cuda_ms(lambda: torch.sparse.mm(A, x), reps=3))
            k1_602.update(
                slice_width_rule=sk.slice_width(N, F, False),
                slice_sweep=k1_slice_sweep(sk, checks, "reddit F=602", fwd,
                                           plan, ref))
            del ref, out, A, raw, ref_dx
            torch.cuda.empty_cache()
            padded = _padded_kernels(sm, sk, g, x, gout, checks, timings)
            raw = ref_dx = None
        del x, gout, raw, ref_dx
        torch.cuda.empty_cache()
    emit({"phase": "sage_kernels", "nodes": N, "edges": E, "rel_err": res,
          **unpadded, **narrow, "k4k5_slice_width_rule": rule,
          "k4k5_slice_sweep": sweeps, "k1_reddit_F602": k1_602,
          "padded": padded})
    checks.raise_if_failed("sage_kernels")


def phase_sage_train(build, ds, g, dev):
    """GraphSAGE-pool on full synthetic Reddit through train_node_classifier
    (5 steps), then the mean and gcn aggregators (3 steps each), at the
    learning rate of examples/train_sage_sampling.py."""
    from dgl_hack_tpu_torch.models import GraphSAGE
    counts = {}
    for agg, epochs, need in (
            ("pool", 5, ("segment_max.fwd", "segment_max.bwd")),
            ("mean", 3, ("segment_sum.fwd", "segment_sum.rev")),
            ("gcn", 3, ("segment_sum.fwd", "segment_sum.rev"))):
        torch.manual_seed(0)
        model = GraphSAGE(hidden_feats=16, out_feats=ds.num_classes,
                          num_layers=2, aggregator_type=agg, dropout=0.5)
        reset_peak_memory()
        res, c = _train(build, model, ds, g, epochs, 3e-3, dev)
        emit({"phase": f"sage_{agg}_train", "nodes": g.num_src_nodes,
              "edges": g.num_edges(), "features": int(ds.features.shape[1]),
              "hidden": 16, "epochs": epochs, "losses": res["losses"],
              "train_time_s": res["train_time_s"],
              "epoch_ms": 1e3 * res["train_time_s"] / (epochs - 1),
              "test_acc": res["test_acc"], "launches": c,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        _check_training(f"sage_{agg}_train", res, c, need)
        del model, res
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts


K6_ELEM_OPS = ("copy_rhs", "add", "sub", "mul", "div")


def _signed(rng, shape, dev):
    """Magnitudes in [0.5, 2) with random signs, so div stays finite."""
    a = rng.uniform(0.5, 2.0, size=shape) * rng.choice((-1.0, 1.0),
                                                        size=shape)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _k6_lhs(g, kind, lhs_u, lhs_e):
    return (lhs_u, g.src) if kind == "u" else (lhs_e, None)


def _k6_elem_cases(k6, g, F, checks, tag, rng):
    """K6's elementwise ops with an 'u' and an 'e' lhs, equal to the plain
    version bitwise and repeated bitwise."""
    dev = g.device
    lhs_u = _signed(rng, (g.num_src_nodes, F), dev)
    lhs_e = _signed(rng, (g.num_edges(), F), dev)
    rhs = _signed(rng, (g.num_dst_nodes, F), dev)
    for op in K6_ELEM_OPS:
        for kind in (("u",) if op == "copy_rhs" else ("u", "e")):
            lhs, src = _k6_lhs(g, kind, lhs_u, lhs_e)
            args = (op, g.dst, rhs, lhs, src)
            checks.exact("sddmm", f"{tag} F={F} {op} {kind}",
                         k6.sddmm(*args), k6.sddmm_plain(*args),
                         k6.sddmm(*args))


def _k6_dot_case(k6, g, H, D, kind, checks, tag, rng):
    """K6's dot against its plain version run in float64."""
    dev = g.device
    lhs_u = _signed(rng, (g.num_src_nodes, H * D), dev)
    lhs_e = _signed(rng, (g.num_edges(), H * D), dev) if kind == "e" \
        else None
    rhs = _signed(rng, (g.num_dst_nodes, H * D), dev)
    lhs, src = _k6_lhs(g, kind, lhs_u, lhs_e)
    ref = k6.sddmm_plain("dot", g.dst, rhs.double(), lhs.double(), src,
                         D).float()
    return checks.compare(
        "sddmm", f"{tag} dot H={H} D={D} {kind}",
        k6.sddmm("dot", g.dst, rhs, lhs, src, D), ref, K6_DOT_TOL,
        k6.sddmm("dot", g.dst, rhs, lhs, src, D))


def _k6_bwd_case(k6, g, op, kind, F, D, checks, rng):
    """GsddmmFn's gradients (K6 and K1) against autograd through the plain
    version in float64."""
    dev = g.device
    lhs_u = _signed(rng, (g.num_src_nodes, F), dev)
    lhs_e = _signed(rng, (g.num_edges(), F), dev)
    rhs = _signed(rng, (g.num_dst_nodes, F), dev)
    lhs, src = _k6_lhs(g, kind, lhs_u, lhs_e)
    if op == "copy_rhs":
        lhs = None
    gout = torch.from_numpy(rng.normal(
        size=(g.num_edges(), F // D if op == "dot" else F))
        .astype(np.float32)).to(dev)
    ins = [t for t in (lhs, rhs) if t is not None]
    ins64 = [t.double().requires_grad_() for t in ins]
    l64 = ins64[0] if lhs is not None else None
    ref = k6.sddmm_plain(op, g.dst, ins64[-1], l64, src, D)
    grefs = torch.autograd.grad(ref, ins64, gout.double())
    runs = []
    for _ in range(2):
        a = [t.clone().requires_grad_() for t in ins]
        out = k6.GsddmmFn.apply(a[0] if lhs is not None else None, a[-1], g,
                                op, kind, D)
        runs.append(torch.autograd.grad(out, a, gout))
    names = ("dlhs", "drhs") if lhs is not None else ("drhs",)
    return {n: checks.compare("sddmm_bwd", f"{op} {kind} F={F} {n}", r1,
                              r.float(), K6_BWD_TOL, r2)
            for n, r1, r2, r in zip(names, *runs, grefs)}


def phase_k6_small(k6, g, checks):
    """K6 on phase 2's small graph (zero-in-degree rows 4000.., a hub of
    12,010 in-edges), forward and backward."""
    rng = np.random.default_rng(6)
    for F in (7, 16, 41, 128):
        _k6_elem_cases(k6, g, F, checks, "small", rng)
    dot = {f"H{H}D{D}.{kind}": _k6_dot_case(k6, g, H, D, kind, checks,
                                            "small", rng)
           for H, D in ((1, 16), (4, 16), (2, 7), (1, 41), (1, 128))
           for kind in ("u", "e")}
    bwd = {}
    for F in (7, 41):
        for op in K6_ELEM_OPS:
            for kind in (("u",) if op == "copy_rhs" else ("u", "e")):
                bwd[f"{op}.{kind}.F{F}"] = _k6_bwd_case(
                    k6, g, op, kind, F, 0, checks, rng)
    for H, D in ((1, 16), (4, 16), (2, 7)):
        for kind in ("u", "e"):
            bwd[f"dot.H{H}D{D}.{kind}"] = _k6_bwd_case(
                k6, g, "dot", kind, H * D, D, checks, rng)
    emit({"phase": "k6_small", "nodes": g.num_src_nodes,
          "edges": g.num_edges(), "elementwise": "bitwise equal to plain",
          "dot_rel_err": dot, "bwd_rel_err": bwd})
    checks.raise_if_failed("k6_small")


def library_sddmm_ms(g, lhs, rhs, H, reps=10):
    """ms of one ``sampled_addmm`` computing every head's u_dot_v (beta 0,
    so the pattern's values do not enter)."""
    D = lhs.shape[1] // H
    A = csr_matrix(g, None if H == 1 else H)
    if H == 1:
        m1, m2 = rhs, lhs.t()
    else:
        m1 = rhs.view(-1, H, D).permute(1, 0, 2).contiguous()
        m2 = lhs.view(-1, H, D).permute(1, 2, 0).contiguous()
    return cuda_ms(lambda: torch.sparse.sampled_addmm(A, m1, m2, beta=0.0),
                   reps=reps)


def phase_k6_bench(k6, gb, checks):
    """K6 at bench.py's shape (power-law, N = 1M, in-degree 16, F = 128,
    a hub row of ~173k in-edges): u_dot_v against the float64 plain
    version and u_sub_v bitwise against the plain version, timed."""
    rng = np.random.default_rng(8)
    F, E = 128, gb.num_edges()
    lhs = _signed(rng, (gb.num_src_nodes, F), gb.device)
    rhs = _signed(rng, (gb.num_dst_nodes, F), gb.device)
    args = (gb.dst, rhs, lhs, gb.src)
    out = k6.sddmm("dot", *args, F)
    ref = k6.sddmm_plain("dot", gb.dst, rhs.double(), lhs.double(),
                         gb.src, F).float()
    dot_err = checks.compare("sddmm", "bench dot F=128", out, ref,
                             K6_DOT_TOL, k6.sddmm("dot", *args, F))
    del ref
    lib_ms = library_sddmm_ms(gb, lhs, rhs, 1)
    res = {"dot": timing(
        cuda_ms(lambda: k6.sddmm("dot", *args, F)),
        cuda_ms(lambda: k6.sddmm_plain("dot", *args, F), reps=3),
        nbytes(gb.src, gb.dst, lhs, rhs, out), 2 * E * F,
        "bench.py graph, u_dot_v, F=128", library_ms=lib_ms)}
    del out
    out = k6.sddmm("sub", *args)
    checks.exact("sddmm", "bench sub F=128", out,
                 k6.sddmm_plain("sub", *args), k6.sddmm("sub", *args))
    res["sub"] = timing(
        cuda_ms(lambda: k6.sddmm("sub", *args)),
        cuda_ms(lambda: k6.sddmm_plain("sub", *args), reps=3),
        nbytes(gb.src, gb.dst, lhs, rhs, out), E * F,
        "bench.py graph, u_sub_v, F=128")
    del out
    torch.cuda.empty_cache()
    emit({"phase": "k6_bench_shape", "nodes": gb.num_src_nodes, "edges": E,
          "F": F, "dot_rel_err": dot_err,
          **res, "dot_edges_per_s": E / (res["dot"]["ms"] * 1e-3)})
    checks.raise_if_failed("k6_bench_shape")


TF_B, TF_L, TF_VOCAB, TF_DIM, TF_HEADS = 256, 64, 16, 64, 4


def _transformer_kernels(k6, graphs, checks, timings):
    """K6 at the transformer's shapes on the complete encoder graph: the
    forward's multi-head u_dot_v (H = 4, D = 16) against the float64 plain
    version, and the backward's per-edge g * q[dst] (an 'e' lhs, F = 64)
    bitwise against the plain version; both timed."""
    rng = np.random.default_rng(9)
    g = graphs[0]
    H, D, E = TF_HEADS, TF_DIM // TF_HEADS, g.num_edges()
    k = _signed(rng, (g.num_src_nodes, TF_DIM), g.device)
    q = _signed(rng, (g.num_dst_nodes, TF_DIM), g.device)
    args = (g.dst, q, k, g.src, D)
    out = k6.sddmm("dot", *args)
    ref = k6.sddmm_plain("dot", g.dst, q.double(), k.double(), g.src,
                         D).float()
    err = checks.compare("sddmm", "transformer dot H=4 D=16", out, ref,
                         K6_DOT_TOL, k6.sddmm("dot", *args))
    lib_ms = library_sddmm_ms(g, k, q, H)
    timings["sddmm"] = timing(
        both_ms(lambda: k6.sddmm("dot", *args)),
        cuda_ms(lambda: k6.sddmm_plain("dot", *args), reps=3),
        nbytes(g.src, g.dst, k, q, out), 2 * E * TF_DIM,
        f"transformer complete graph (B={TF_B}, L={TF_L}), u_dot_v, "
        f"H={H}, D={D}", library_ms=lib_ms)
    gl = _signed(rng, (E, TF_DIM), g.device)
    bargs = ("mul", g.dst, q, gl, None)
    bout = k6.sddmm(*bargs)
    checks.exact("sddmm", "transformer bwd g*q[dst] F=64", bout,
                 k6.sddmm_plain(*bargs), k6.sddmm(*bargs))
    bwd_ms, bwd_one = both_ms(lambda: k6.sddmm(*bargs))
    timings["sddmm"].update(
        bwd_ms=bwd_ms, bwd_one_launch_ms=bwd_one,
        bwd_plain_ms=cuda_ms(lambda: k6.sddmm_plain(*bargs), reps=3),
        bwd_bound_ms=bound(nbytes(g.dst, q, gl, bout), E * TF_DIM)[0],
        dot_rel_err=err)
    _transformer_k1(timings, g, rng, checks)


def _transformer_k1(k6_timings, g, rng, checks):
    """K1 at the transformer's shapes on the complete encoder graph: the
    u_mul_e aggregation (the attention weight expanded to (E, 64)) and its
    dx over the CSR direction, against the float64 plain version."""
    from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
    E = g.num_edges()
    v = _signed(rng, (g.num_src_nodes, TF_DIM), g.device)
    w = _signed(rng, (E, TF_DIM), g.device)
    dout = _signed(rng, (g.num_dst_nodes, TF_DIM), g.device)
    dst_csr = sk.rev_gidx(g)
    fwd = (g.csc_indptr, v, g.src, None, w)
    rev = (g.csr_indptr, dout, dst_csr, g.csr_eids, w)
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    out = sk.segment_sum(*fwd, plan=p_fwd)
    checks.compare("segment_sum", "transformer u_mul_e F=64", out,
                   k1_ref(sk, *fwd), K1_TOL, sk.segment_sum(*fwd, plan=p_fwd))
    dx = sk.segment_sum(*rev, site="rev", plan=p_rev)
    checks.compare("segment_sum", "transformer dx F=64", dx,
                   k1_ref(sk, *rev), K1_TOL,
                   sk.segment_sum(*rev, site="rev", plan=p_rev))
    fwd_ms, fwd_one = both_ms(lambda: sk.segment_sum(*fwd, plan=p_fwd))
    rev_ms, rev_one = both_ms(lambda: sk.segment_sum(*rev, site="rev",
                                                     plan=p_rev))
    k6_timings["segment_sum_tf"] = {
        "fwd_ms": fwd_ms, "rev_ms": rev_ms,
        "fwd_one_launch_ms": fwd_one, "rev_one_launch_ms": rev_one,
        "fwd_plain_ms": cuda_ms(lambda: sk.segment_sum_plain(*fwd), reps=3),
        "rev_plain_ms": cuda_ms(lambda: sk.segment_sum_plain(*rev), reps=3),
        "fwd_bound_ms": bound(nbytes(g.csc_indptr, g.src, v, w, out),
                              2 * E * TF_DIM)[0],
        "rev_bound_ms": bound(nbytes(g.csr_indptr, dst_csr, g.csr_eids,
                                     dout, w, dx), 2 * E * TF_DIM)[0],
        "shape": "transformer complete graph, u_mul_e, F=64, (E, F) weight"}


def _profile_step(step, phase="transformer_train"):
    """Device time by kernel over one training step, from torch.profiler
    (CUPTI): the kernels' total and the largest entries, and the same time
    grouped by the torch op that launched each kernel (``_by_op``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_stack=True) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    if not rows:
        raise SystemExit(f"{phase} failed: torch.profiler recorded no "
                         "device time for a training step")
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows), "kernels": len(rows),
            "top": [{"name": n[:90], "ms": ms, "calls": c}
                    for n, ms, c in rows[:12]],
            **_by_op(prof.events())}


def _site(ev):
    """The two innermost frames in the port or this script that ran an op
    ('file(line): function < its caller'): from the op's recorded stack,
    or from the Python-function events that torch.profiler's
    ``with_stack`` nests the op under."""
    marks = ("dgl_hack_tpu_torch/", "chip_smoke.py")
    frames = list(ev.stack or ())
    parent = ev.cpu_parent
    while parent is not None:
        frames.append(parent.name)
        parent = parent.cpu_parent
    ours = [f[f.index(m):] for f in frames for m in marks if m in f]
    return " < ".join(ours[:2]) or None


def _by_op(events, top=16):
    """Device time of the kernels launched under each torch op, grouped by
    the innermost op (or autograd node, for K1-K6, which launch through
    ctypes inside a backward), the autograd node whose backward ran it
    ("forward" outside the backward), the op's first input shape and its
    Python site where the profiler recorded one: the op's own stack, or
    for a backward op of a builtin node the stack of the forward op that
    made the node (matched by sequence number); "?" where it recorded
    none.  ``gathers`` keeps the groups of torch's gather kernels alone."""
    fwd_site = {}
    for ev in events:
        if ev.sequence_nr >= 0 and not ev.name.startswith("autograd::"):
            site = _site(ev)
            if site is not None:
                fwd_site.setdefault(ev.sequence_nr, site)
    groups, gathers = {}, {}
    for ev in events:
        if not ev.kernels:
            continue
        node, site = "forward", _site(ev)
        parent = ev.cpu_parent
        while parent is not None:
            if parent.name.startswith("autograd::engine::evaluate_function"):
                node = parent.name.split(": ", 1)[-1]
                if site is None:
                    site = fwd_site.get(parent.sequence_nr)
                break
            parent = parent.cpu_parent
        shape = ev.input_shapes[0] if ev.input_shapes else None
        key = (ev.name, node, str(shape), site or "?")
        for k in ev.kernels:
            for table, keep in ((groups, True), (gathers, "gather" in k.name)):
                if keep:
                    grp = table.setdefault(key, {"ms": 0.0, "launches": 0,
                                                 "kernels": set()})
                    grp["ms"] += k.duration / 1e3
                    grp["launches"] += 1
                    grp["kernels"].add(k.name[:60])

    def rows(table):
        out = [{"op": k[0], "autograd": k[1], "shape": k[2], "site": k[3],
                "ms": v["ms"],
                "launches": v["launches"], "kernels": sorted(v["kernels"])}
               for k, v in table.items()]
        return sorted(out, key=lambda r: -r["ms"])[:top]
    return {"by_op_ms": sum(v["ms"] for v in groups.values()),
            "by_op": rows(groups), "gathers": rows(gathers)}


def _transformer_vs_cpu(dev):
    """A small transformer (B = 2, L = 6, Dm = 16, 2 heads) on the card
    against the same model on the CPU: loss and logits."""
    from dgl_hack_tpu_torch.models import (GraphTransformer, build_graphs,
                                           copy_task_loss)
    rng = np.random.default_rng(10)
    model = GraphTransformer(8, 6, 16, 2, rng=rng)
    seq = torch.from_numpy(rng.integers(0, 8, (2, 6))).long()
    with torch.no_grad():
        loss, logits = copy_task_loss(model, build_graphs(2, 6), seq, seq)
        loss_d, logits_d = copy_task_loss(
            model.to(dev), build_graphs(2, 6, device=dev), seq.to(dev),
            seq.to(dev))
    return (rel_err(logits_d.cpu(), logits),
            abs(float(loss_d) - float(loss)) / abs(float(loss)))


def phase_transformer(build, k6, checks, dev, timings):
    """Graph-transformer training at the JAX example's full width on one
    fixed copy-task batch (B = 256, L = 64): a warm-up step, then 5 timed
    steps through the entry points a user calls (GraphTransformer,
    copy_task_loss, torch.optim.Adam at the example's lr 3e-3)."""
    from dgl_hack_tpu_torch.models import (GraphTransformer, build_graphs,
                                           copy_task_loss)
    from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
    t0 = time.perf_counter()
    graphs = build_graphs(TF_B, TF_L, device=dev)
    build_s = time.perf_counter() - t0
    _transformer_kernels(k6, graphs, checks, timings)
    small_rel, small_loss_rel = _transformer_vs_cpu(dev)
    if not (small_rel <= GAT_TOL and small_loss_rel <= GAT_TOL):
        checks.failures.append(f"transformer small forward vs CPU: logits "
                               f"rel err {small_rel}, loss {small_loss_rel}")
    checks.raise_if_failed("transformer kernel check")
    BUSY.clear()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    model = GraphTransformer(TF_VOCAB, TF_L, TF_DIM, TF_HEADS,
                             rng=rng).to(dev)
    seq = torch.from_numpy(rng.integers(0, TF_VOCAB, (TF_B, TF_L))
                           ).long().to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)

    def step():
        loss, _ = copy_task_loss(model, graphs, seq, seq)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step()]                        # warm-up, outside the clock
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    build.LAUNCHES.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = dict(build.LAUNCHES.counts)
    losses = [float(v) for v in losses]
    profile = _profile_step(step)
    emit({"phase": "transformer_train", "batch": TF_B, "seq_len": TF_L,
          "dim": TF_DIM, "heads": TF_HEADS, "vocab": TF_VOCAB,
          "edges": {"encoder": graphs[0].num_edges(),
                    "decoder": graphs[1].num_edges(),
                    "cross": graphs[2].num_edges()},
          "graph_build_s": build_s,
          "plan_build_ms": [plan_build_ms(sk, g) for g in graphs],
          "steps": steps, "losses": losses,
          "train_time_s": train_s, "epoch_ms": 1e3 * train_s / steps,
          "launches": counts,
          "launches_per_step": {k: v / steps for k, v in counts.items()},
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "small_vs_cpu_rel_err": small_rel, "k6": timings["sddmm"],
          "k1": timings["segment_sum_tf"], "profile": profile,
          "device_busy_share": profile["device_ms"] / (1e3 * train_s / steps)})
    _check_training("transformer_train", {"losses": losses}, counts,
                    ("sddmm.fwd", "sddmm.bwd", "segment_sum.fwd",
                     "segment_sum.rev"))
    del model, opt, graphs
    torch.cuda.empty_cache()
    return counts


def phase_k1_rows(sk, g, ds, checks, dev, timings):
    """K1's sorted-rows route (edge-row mode over consecutive rows,
    ``SegmentSumRows``) against its plain version in float64, repeated
    bitwise, at the three shapes of the slice's paths: a readout of 1,024
    graphs of 24 nodes (F = 32), a single-graph readout over synthetic
    Reddit's 232,965 nodes (F = 602, one row of 911 pieces), and copy_e
    sum over its 23.5 M CSC rows (F = 8); each timed with its plain
    version and torch.segment_reduce, the library call."""
    rng = np.random.default_rng(12)
    cases = [("readout 1024 x 24, F=32", sk.segments([24] * 1024, dev),
              32, None),
             ("one graph of synthetic Reddit, F=602",
              sk.segments([g.num_dst_nodes], dev), 602,
              torch.from_numpy(ds.features).to(dev)),
             ("copy_e over synthetic Reddit's CSC rows, F=8",
              sk.graph_segments(g, "csc"), 8, None)]
    res = {}
    for what, seg, F, x in cases:
        rows = seg.ids.numel()
        if x is None:
            x = torch.from_numpy(rng.normal(size=(rows, F))
                                 .astype(np.float32)).to(dev)
        out = sk.segment_sum_rows(x, seg)
        checks.compare("segment_sum", f"rows {what}", out,
                       k1_ref(sk, seg.indptr, x), K1_TOL,
                       sk.segment_sum_rows(x, seg))
        lengths = (seg.indptr[1:] - seg.indptr[:-1]).long()
        rec = timing(
            both_ms(lambda: sk.segment_sum_rows(x, seg)),
            cuda_ms(lambda: sk.segment_sum_plain(seg.indptr, x), reps=3),
            nbytes(seg.indptr, x, out), rows * F, what,
            library_ms=cuda_ms(lambda: torch.segment_reduce(
                x, "sum", lengths=lengths)))
        rec.update(segments=seg.indptr.numel() - 1, rows=rows,
                   pieces=seg.plan.pieces.shape[0])
        res[what] = rec
        del x, out
    timings["segment_sum_rows"] = res
    emit({"phase": "k1_rows", "cases": res})
    checks.raise_if_failed("k1_rows")


def phase_propagation_train(build, ds, g, dev):
    """SGC (k = 2), APPNP (hidden 64, k = 10, alpha 0.1, dropout 0.5) and
    TAGCN (hidden 16, k = 2) on full synthetic Reddit through
    train_node_classifier, 3 steps each, at the widths, learning rates and
    weight decays of examples/train_{sgc,appnp,tagcn}.py: every
    propagation is a copy_u sum through K1."""
    from dgl_hack_tpu_torch.models import APPNP, SGC, TAGCN
    C = ds.num_classes
    counts = {}
    for name, make, lr, wd in (
            ("sgc", lambda: SGC(C, k=2), 0.2, 5e-6),
            ("appnp", lambda: APPNP(64, C, k=10, alpha=0.1, dropout=0.5),
             1e-2, 5e-4),
            ("tagcn", lambda: TAGCN(16, C, k=2, dropout=0.5), 1e-2, 5e-4)):
        torch.manual_seed(0)
        reset_peak_memory()
        res, c = _train(build, make(), ds, g, 3, lr, dev, weight_decay=wd)
        emit({"phase": f"{name}_train", "nodes": g.num_src_nodes,
              "edges": g.num_edges(), "features": int(ds.features.shape[1]),
              "epochs": 3, "losses": res["losses"],
              "train_time_s": res["train_time_s"],
              "epoch_ms": 1e3 * res["train_time_s"] / 2,
              "test_acc": res["test_acc"], "launches": c,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        _check_training(f"{name}_train", res, c, ("segment_sum.fwd",))
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts


GIN_DATA = dict(nodes_per_graph=24, communities=(1, 4), p_in=0.6,
                p_out=0.05, seed=0)


def _gin_eval_loss(model, batches):
    """Mean cross-entropy of the log-softmax over batches, no gradient."""
    with torch.no_grad():
        model.eval()
        return float(np.mean([float(torch.nn.functional.cross_entropy(
            model(bg, x), y)) for bg, x, y in batches]))


def phase_gin_train(build, checks, dev):
    """GIN graph classification at the full width of examples/train_gin.py
    (hidden 32, 3 layers, 2 classes, the SBM mixture of 200 graphs of 24
    nodes with 8 features, Adam lr 5e-3) in batches of 16 graphs: one
    forward held against the same model on the CPU, then a warm-up step
    and 4 timed steps over the first batches, whose losses must be finite
    and whose mean loss over those batches must fall;
    then one batch of 1,024 graphs of the same generator (24,576 nodes):
    a warm-up step, 5 timed steps, peak memory and a torch.profiler
    profile of one step."""
    from dgl_hack_tpu_torch.data import sbm_mixture
    from dgl_hack_tpu_torch.models import GIN
    from dgl_hack_tpu_torch.models.training import (graph_batches,
                                                    graph_classifier_step)
    ds = sbm_mixture(num_graphs=200, **GIN_DATA)
    train_b = graph_batches(ds, 0, 160, 16, dev)
    cpu_b = graph_batches(ds, 0, 16, 16, "cpu")[0]
    torch.manual_seed(0)
    model = GIN(hidden_feats=32, out_feats=ds.num_classes, num_layers=3)
    with torch.no_grad():
        ref = model(*cpu_b[:2])                 # CPU: materialises params
        out = copy.deepcopy(model).to(dev)(*train_b[0][:2])
    rel = rel_err(out.cpu(), ref)
    if not (rel <= GAT_TOL and torch.isfinite(out).all()):
        checks.failures.append(f"gin forward vs CPU: rel err {rel}")
    checks.raise_if_failed("gin forward vs CPU")

    step, _ = graph_classifier_step(model, train_b[0], lr=5e-3, device=dev)
    before = _gin_eval_loss(model, train_b[:5])
    build.LAUNCHES.reset()
    losses = [step(*train_b[0])]                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in train_b[1:5]:
        losses.append(step(*b))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 4
    counts = dict(build.LAUNCHES.counts)
    after = _gin_eval_loss(model, train_b[:5])
    losses = [float(v) for v in losses]

    big_ds = sbm_mixture(num_graphs=1024, **GIN_DATA)
    big = graph_batches(big_ds, 0, 1024, 1024, dev)[0]
    torch.manual_seed(0)
    big_model = GIN(hidden_feats=32, out_feats=2, num_layers=3)
    reset_peak_memory()
    big_step, _ = graph_classifier_step(big_model, big, lr=5e-3, device=dev)
    build.LAUNCHES.reset()
    big_losses = [big_step(*big)]               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        big_losses.append(big_step(*big))
    torch.cuda.synchronize()
    big_ms = 1e3 * (time.perf_counter() - t0) / 5
    big_counts = dict(build.LAUNCHES.counts)
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_step(lambda: big_step(*big), "gin_train")
    emit({"phase": "gin_train", "graphs": len(ds.graphs), "batch": 16,
          "nodes_per_batch": train_b[0][0].num_nodes(),
          "edges_first_batch": train_b[0][0].num_edges(),
          "rel_err_vs_cpu": rel, "step_losses": losses,
          "mean_loss_before": before, "mean_loss_after": after,
          "step_ms": step_ms, "launches": counts,
          "big": {"graphs": 1024, "nodes": big[0].num_nodes(),
                  "edges": big[0].num_edges(),
                  "losses": [float(v) for v in big_losses],
                  "step_ms": big_ms, "graphs_per_s": 1024 / (big_ms * 1e-3),
                  "peak_memory_bytes": peak, "launches": big_counts,
                  "profile": profile,
                  "device_busy_share": profile["device_ms"] / big_ms}})
    need = ("segment_sum.fwd", "segment_sum.rev", "segment_sum.rows")
    _check_training("gin_train", {"losses": [before, *losses, after]},
                    counts, need)
    _check_training("gin_train batch 1024",
                    {"losses": [float(v) for v in big_losses]}, big_counts,
                    need)
    return counts


# ---------------------------------------------------------------------------
# masked (padded) graphs and the sampled GraphSAGE example
# ---------------------------------------------------------------------------
MASKED_SHAPE = dict(num_src=524_288, num_dst=32_768, fanout=10)
MASKED_PAD, MASKED_EMPTY_EVERY = 0.3, 64


def _masked_block(dt, dev, rng):
    """A block at the shape of the sampled GraphSAGE's layer 0 (524,288
    src, 32,768 dst, 10 edge slots a dst: 327,680): src ids uniform over
    the src set, 30% of the slots padding and every 64th dst row padding
    alone.  Built on the host, as to_block builds blocks."""
    Ns, Nd, fan = (MASKED_SHAPE[k] for k in ("num_src", "num_dst",
                                              "fanout"))
    dst = np.repeat(np.arange(Nd, dtype=np.int32), fan)
    src = rng.integers(0, Ns, dst.shape[0]).astype(np.int32)
    mask = rng.random(dst.shape[0]) >= MASKED_PAD
    mask[dst % MASKED_EMPTY_EVERY == 0] = False
    return dt.block((src, dst), Ns, Nd, edge_mask=mask).to(dev)


def _view_build_ms(sk, g, reps=5):
    """Milliseconds to build the real-edge view (one host sync) and its row
    plans of both directions, each from nothing, median of ``reps``."""
    view_ms, plan_ms = [], []
    for _ in range(reps):
        g.derived.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view = sk.real_edges(g).graph
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sk.graph_row_plan(view, "csc")
        sk.graph_row_plan(view, "csr")
        sk.rev_gidx(view)
        torch.cuda.synchronize()
        view_ms.append(1e3 * (t1 - t0))
        plan_ms.append(1e3 * (time.perf_counter() - t1))
    return {"view_ms": float(np.median(view_ms)),
            "row_plans_ms": float(np.median(plan_ms))}


def _masked_gspmm_vs_mask(dt, g, rng, checks):
    """gspmm on the card through the real-edge view against references
    built on the host from ``edge_mask`` alone, in float64 over the slots
    the mask keeps, so that a view built wrong on the card shows: u_mul_e
    sum with dx and dw (dw 0 at padded slots), copy_lhs mean with dx, and
    copy_lhs max (exact; rows of no real edge 0).  F = 16, w (E, 1), edge
    data in internal order as gspmm takes it.  Returns each relative error."""
    F = 16
    Ns, Nd = g.num_src_nodes, g.num_dst_nodes
    x = torch.from_numpy(rng.normal(size=(Ns, F)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(g.num_edges(), 1)).astype(
        np.float32))
    dout = torch.from_numpy(rng.normal(size=(Nd, F)).astype(np.float32))
    keep = g.edge_mask.cpu()
    src, dst = g.src.cpu().long()[keep], g.dst.cpu().long()[keep]
    deg = torch.bincount(dst, minlength=Nd)
    x64 = x.double().requires_grad_(True)
    w64 = w.double().requires_grad_(True)
    zeros = torch.zeros(Nd, F, dtype=torch.float64)
    refs = {"sum": zeros.index_add(0, dst, x64[src] * w64[keep]),
            "mean": zeros.index_add(0, dst, x64[src])
            / deg.clamp(min=1)[:, None]}
    errs = {}
    for red, args in (("sum", ("mul", x, w)), ("mean", ("copy_lhs", x))):
        ins = [a.detach().to(g.device).requires_grad_(True)
               for a in args[1:]]
        out = dt.gspmm(g, args[0], red, *ins)
        grads = torch.autograd.grad(out, ins, dout.to(g.device))
        rgrads = torch.autograd.grad(refs[red], [x64, w64][:len(ins)],
                                     dout.double())
        errs[red] = {"fwd": rel_err(out.detach().cpu().double(),
                                    refs[red].detach())}
        for name, a, r in zip(("dx", "dw"), grads, rgrads):
            errs[red][name] = rel_err(a.cpu().double(), r)
        if red == "sum" and float(grads[1][~g.edge_mask].abs().max()) != 0:
            checks.failures.append("gspmm masked sum: dw at padded slots "
                                   "is not 0")
    ref_max = torch.full((Nd, F), -np.inf).scatter_reduce(
        0, dst[:, None].expand(-1, F), x[src], "amax")
    ref_max[deg == 0] = 0.0
    out_max = dt.gspmm(g, "copy_lhs", "max", x.to(g.device)).cpu()
    errs["max"] = {"fwd": rel_err(out_max, ref_max)}
    for red, e in errs.items():
        tol = 0.0 if red == "max" else K1_TOL
        if not all(v <= tol for v in e.values()):
            checks.failures.append(f"gspmm masked {red} against the "
                                   f"mask's own reference: {e} > {tol}")
    return errs


def phase_masked_kernels(dt, sk, sm, gk, k6, checks, dev):
    """Every kernel on a masked block at layer 0's shape of the sampled
    GraphSAGE (``_masked_block``), through the real-edge view as gspmm,
    gat_attention and gsddmm run them: K1's forward and dx and K4/K5 at
    F = 602, at the width gspmm runs them (``run_width``: x of 524,288
    rows takes no slice, so no padding), against their plain versions run
    in float64 (K4 exactly) over the same view; K2/K3
    at H = 8, D = 8 with attn_w through ``gat_attention_fused`` on the
    masked block, against the composed GAT over the real edges in float64,
    attn_w's gradient 0 at the padded slots; K6's u_dot_v (H = 8, D = 8)
    over every slot, padding included, against its plain version in
    float64; gspmm end to end against a host reference built from the
    mask without the view (``_masked_gspmm_vs_mask``).  Timed beside the
    plain versions, K1 also beside torch.sparse.mm over the real edges,
    with the view's and the row plans' build time.  Each bound counts the real edges and the rows of
    x they read."""
    rng = np.random.default_rng(21)
    g = _masked_block(dt, dev, rng)
    build = _view_build_ms(sk, g)
    view = sk.real_edges(g)
    kg = view.graph
    Ns, Nd, F = g.num_src_nodes, g.num_dst_nodes, 602
    R = kg.num_edges()
    rows_read = int(torch.unique(kg.src).numel())
    res = {"num_src": Ns, "num_dst": Nd, "slots": g.num_edges(),
           "real_edges": R, "src_rows_read": rows_read,
           "all_padding_rows": int(((sk.real_in_degrees(g) == 0)
                                    & (g.in_degrees() > 0)).sum()),
           **build}
    timings = {}
    # K1 forward and dx, at gspmm's run width
    x = torch.relu(torch.from_numpy(rng.normal(size=(Ns, F)).astype(
        np.float32)).to(dev))
    Fp = sk.run_width(x, None)
    xp = sk.pad_columns(x, Fp)
    p_fwd, p_rev = sk.graph_row_plan(kg, "csc"), sk.graph_row_plan(kg, "csr")
    fwd = (kg.csc_indptr, xp, kg.src)
    out = sk.segment_sum(*fwd, plan=p_fwd)
    res["k1_fwd_rel_err"] = checks.compare(
        "segment_sum", f"masked F={F} padded to {Fp} fwd", out,
        k1_ref(sk, *fwd), K1_TOL, sk.segment_sum(*fwd, plan=p_fwd))
    A = csr_matrix(kg)
    dst_rows = int((sk.real_in_degrees(g) > 0).sum())
    timings["k1_fwd"] = timing(
        both_ms(lambda: sk.segment_sum(*fwd, plan=p_fwd)),
        cuda_ms(lambda: sk.segment_sum_plain(*fwd), reps=3),
        nbytes(kg.csc_indptr, kg.src) + 4 * F * (rows_read + Nd), R * F,
        f"masked block {Ns} x {Nd}, {R} real of {g.num_edges()} slots, "
        f"F={F} padded to {Fp}, forward",
        library_ms=cuda_ms(lambda: torch.sparse.mm(A, xp), reps=3))
    del out, A
    dout = torch.from_numpy(rng.normal(size=(Nd, Fp)).astype(np.float32)
                            ).to(dev)
    rev = (kg.csr_indptr, dout, sk.rev_gidx(kg), kg.csr_eids)
    dx = sk.segment_sum(*rev, plan=p_rev)
    ref = k1_ref(sk, *rev)
    res["k1_dx_rel_err"] = checks.compare(
        "segment_sum", f"masked F={Fp} dx", dx, ref, K1_TOL,
        sk.segment_sum(*rev, plan=p_rev))
    # dx walks 524,288 CSR rows, most of them empty, once per slice of
    # the gathered cotangent: the widths side by side
    res["k1_dx_slice_rule"] = sk.slice_width(Nd, Fp, False)
    res["k1_dx_slice_sweep"] = k1_slice_sweep(sk, checks, "masked dx", rev,
                                              p_rev, ref)
    At = csr_matrix(kg, reverse=True)
    timings["k1_dx"] = timing(
        both_ms(lambda: sk.segment_sum(*rev, plan=p_rev)),
        cuda_ms(lambda: sk.segment_sum_plain(*rev), reps=3),
        nbytes(kg.csr_indptr, rev[2]) + 4 * F * (dst_rows + Ns), R * F,
        f"masked block, F={Fp}, dx",
        library_ms=cuda_ms(lambda: torch.sparse.mm(At, dout), reps=3))
    del dx, At, rev, ref
    # K4/K5 at 602 as GspmmMax runs them
    raw, res["k4k5_rel_err"], ref_dx = _k4k5_case(
        sm, sk, kg, xp, None, dout, checks, f"masked F={F} padded to {Fp}",
        x_bwd=x)
    res["k5_slice_rule"] = sm.max_bwd_slice_width(Nd, Fp, 0, False)
    res["k4k5_slice_sweep"] = _k4k5_slice_sweeps(
        sm, sk, kg, xp, dout, raw, ref_dx, checks, "masked", x_bwd=x)
    del ref_dx
    k4, k5 = _k4k5_timings(sm, sk, kg, xp, dout, raw,
                           f"masked block, F={F} padded to {Fp}", x_bwd=x)
    # the bound over what this block's data needs: the real edges' indices,
    # the x rows they read, raw and the cotangent at the dst rows they
    # reach, the outputs whole
    k4["bound_ms"], k4["bound_by"] = bound(
        nbytes(kg.csc_indptr, kg.src) + 4 * F * (rows_read + Nd), R * F)
    k5["bound_ms"], k5["bound_by"] = bound(
        nbytes(kg.csr_indptr, sk.rev_gidx(kg))
        + 4 * F * (rows_read + 2 * dst_rows + Ns), 2 * R * F)
    timings["k4"], timings["k5"] = k4, k5
    del raw, xp, dout, x
    torch.cuda.empty_cache()
    # K2/K3 through gat_attention_fused on the masked block
    H, D = 8, 8

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)
    w = torch.from_numpy((rng.random((g.num_edges(), H)) > 0.6).astype(
        np.float32) / 0.4).to(dev)
    ins, gout = [t((Ns, H, D)), t((Ns, H)), t((Nd, H)), w], t((Nd, H, D))
    runs = []
    for _ in range(2):
        kin = [v.clone().requires_grad_(True) for v in ins]
        out = gk.gat_attention_fused(g, *kin[:3], 0.2, kin[3])
        runs.append((out, torch.autograd.grad(out, kin, gout)))
    ins64 = [v.double().requires_grad_(True) for v in ins]
    ref = composed_gat(kg, *ins64[:3], ins64[3][view.eid], 0.2)
    grefs = torch.autograd.grad(ref, ins64, gout.double())
    (out, grads), (out2, grads2) = runs
    res["gat_rel_err"] = {"fwd": checks.compare(
        "gat_fwd", "masked H=8 D=8", out, ref.float(), GAT_TOL, out2)}
    for name, a, b, r in zip(("dfsrc", "del", "der", "dattn_w"), grads,
                             grads2, grefs):
        res["gat_rel_err"][name] = checks.compare(
            "gat_bwd", f"masked H=8 D=8 {name}", a, r.float(), GAT_TOL, b)
    pad = ~g.edge_mask
    if float(grads[3][pad].abs().max()) != 0.0:
        checks.failures.append("gat_bwd masked: attn_w gradient at padded "
                               "slots is not 0")
    del runs, ref, grefs, ins64, out, out2, grads, grads2
    wh, el, er = ins[0].reshape(Ns, H * D), ins[1], ins[2]
    w_r = w[view.eid].contiguous()
    shift = gk.shift_bound(el, er, 0.2).contiguous()
    fwd_args = (kg.csc_indptr, kg.src, wh, el, er, w_r, shift, 0.2, False)
    rst, den, _ = gk.gat_fwd(*fwd_args, plan=p_fwd)
    timings["gat_fwd"] = timing(
        both_ms(lambda: gk.gat_fwd(*fwd_args, plan=p_fwd)),
        cuda_ms(lambda: gk.gat_fwd_plain(*fwd_args), reps=3),
        nbytes(kg.csc_indptr, kg.src, er, w_r, shift, rst, den)
        + rows_read * 4 * H * (D + 1), R * H * (8 + 2 * D),
        "masked block, H=8, D=8, attn_w, shift mode")
    sds = (rst.view(Nd, H, D) * gout).sum(-1).contiguous()
    bwd_args = (kg.csr_indptr, kg.csr_eids, sk.rev_gidx(kg), wh, el, er,
                shift, den, sds, gout.reshape(Nd, H * D), w_r, 0.2)
    # read: indices, wh and el at the rows read, the dst operands and
    # dout, attn_w; written: dwh and del whole, draw per real edge
    timings["gat_bwd"] = timing(
        both_ms(lambda: gk.gat_bwd(*bwd_args, False, plan=p_rev)),
        cuda_ms(lambda: gk.gat_bwd_plain(*bwd_args, False), reps=3),
        nbytes(*bwd_args[:3], *bwd_args[5:11])
        + 4 * H * (D + 1) * (rows_read + Ns) + R * H * 4,
        R * H * (12 + 4 * D), "masked block, H=8, D=8, no dw")
    del fwd_args, bwd_args, rst, den, sds, ins, gout, w, w_r, wh
    torch.cuda.empty_cache()
    # K6 u_dot_v over every slot, the mask unread
    lhs, rhs = t((Ns, H * D)), t((Nd, H * D))
    dot = k6.sddmm("dot", g.dst, rhs, lhs, g.src, D)
    res["k6_rel_err"] = checks.compare(
        "sddmm", "masked u_dot_v H=8 D=8", dot,
        k6.sddmm_plain("dot", g.dst, rhs.double(), lhs.double(), g.src,
                       D).float(), K6_DOT_TOL,
        k6.sddmm("dot", g.dst, rhs, lhs, g.src, D))
    dot_api = dt.gsddmm(g, "dot", lhs.view(Ns, H, D), rhs.view(Nd, H, D))
    if not bool((dot_api.reshape(dot.shape) == dot).all()):
        checks.failures.append("sddmm masked: gsddmm differs from K6 over "
                               "every slot")
    timings["k6_u_dot_v"] = timing(
        both_ms(lambda: k6.sddmm("dot", g.dst, rhs, lhs, g.src, D)),
        cuda_ms(lambda: k6.sddmm_plain("dot", g.dst, rhs, lhs, g.src, D),
                reps=3),
        nbytes(g.dst, g.src, rhs, dot) + int(torch.unique(g.src).numel())
        * 4 * H * D, g.num_edges() * H * D * 2,
        "masked block, every slot, H=8, D=8",
        library_ms=library_sddmm_ms(g, lhs, rhs, H, reps=3))
    # edge_softmax on the masked block (torch ops): padded slots get 0,
    # the rest agree with the CPU
    logits = t((g.num_edges(), H, 1))
    soft = dt.edge_softmax(g, logits)
    res["edge_softmax_rel_err"] = rel_err(
        soft.cpu(), dt.edge_softmax(g.to("cpu"), logits.cpu()))
    if not res["edge_softmax_rel_err"] <= LAYER_TOL \
            or float(soft[~g.edge_mask].abs().max()) != 0.0:
        checks.failures.append("edge_softmax masked: "
                               f"{res['edge_softmax_rel_err']} vs the CPU, "
                               "or padded slots not 0")
    res["gspmm_vs_mask_rel_err"] = _masked_gspmm_vs_mask(dt, g, rng, checks)
    del lhs, rhs, dot, dot_api, g, kg, view, logits, soft
    torch.cuda.empty_cache()
    emit({"phase": "masked_kernels", **res, "timings": timings})
    checks.raise_if_failed("masked_kernels")
    return timings


def _load_twin(name="train_sage_sampling_torch", folder="examples"):
    """<folder>/<name>.py, imported by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Window:
    """torch.profiler over a window of a training loop's steps: ``on_step``
    (the loop's hook, called with the step's index after each step) starts
    it at the sync after step ``first`` and stops it at the sync after step
    ``last``; ``stats`` reads the kernels' summed device time (one stream,
    so the sum is the busy time) against the window's wall time.  The
    profiler's own cost lies inside the window, so ``window_ms_per_step``
    beside the unprofiled step shows that cost."""

    def __init__(self, first, last):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.first, self.last = first, last
        self.t0 = self.t1 = None

    def on_step(self, n):
        if n == self.first:
            torch.cuda.synchronize()
            self.prof.start()
            self.t0 = time.perf_counter()
        elif n == self.last:
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.stop()

    def stats(self, phase):
        """The window's wall and device ms (in all and a step), the busy
        share and the host's (the rest of the window: the card idle,
        waiting for the host), the kernel launches a step and the largest
        kernels."""
        rows = [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                for e in self.prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0]
        if not rows:
            raise SystemExit(f"{phase} failed: torch.profiler recorded no "
                             "device time")
        steps = self.last - self.first
        wall = 1e3 * (self.t1 - self.t0)
        dev_ms = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        return {"window_hook_values": [self.first, self.last],
                "steps": steps, "wall_ms": wall, "device_ms": dev_ms,
                "window_ms_per_step": wall / steps,
                "device_ms_per_step": dev_ms / steps,
                "busy_share": dev_ms / wall, "host_share": 1.0 - dev_ms / wall,
                "launches_per_step": sum(r[2] for r in rows) / steps,
                "top": [{"name": n, "ms": ms, "calls": c}
                        for n, ms, c in rows[:8]]}


def _busy_share(twin, ds, dev, warm=2, steps=5, aggregator="mean", **kw):
    """The device's busy share over training steps ``warm + 1`` to
    ``warm + steps`` of the twin's loop (``_Window``; its ``on_step`` hook
    is called with the count of steps done).  The dataset's upload, the
    model's set-up, the warm steps and evaluation lie outside the window.
    ``kw`` goes to the twin's ``train`` (a prefetcher)."""
    win = _Window(warm, warm + steps)
    twin.train(ds, aggregator=aggregator, max_steps=warm + steps,
               eval_batches=0, device=dev, log=None, on_step=win.on_step,
               **kw)
    return win.stats("sage_sampling_train")


class _HostSplit:
    """Times the sampler's two host stages apart while it is entered:
    ``sampling.neighbor``'s ``sample_neighbors`` and ``to_block`` (the
    names ``MultiLayerNeighborSampler`` calls) are wrapped with host
    clocks, and ``on_step`` (the twin's hook) closes each step's sums."""

    STAGES = ("sample_neighbors", "to_block")

    def __init__(self):
        from dgl_hack_tpu_torch.sampling import neighbor
        self.mod = neighbor
        self.acc = dict.fromkeys(self.STAGES, 0.0)
        self.steps = []

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.STAGES}
        for name, fn in self.orig.items():
            def timed(*args, _fn=fn, _name=name, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.acc[_name] += 1e3 * (time.perf_counter() - t0)
            setattr(self.mod, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)

    def on_step(self, n):
        self.steps.append(dict(self.acc))
        self.acc = dict.fromkeys(self.STAGES, 0.0)

    def split(self, sample_ms):
        """Medians over steps 2.. of each stage's ms and of the rest of the
        step's host sampling time (``sample_ms``, the twin's)."""
        parts = {f"{n}_ms": [st[n] for st in self.steps]
                 for n in self.STAGES}
        parts["rest_ms"] = [t - sum(st.values())
                            for t, st in zip(sample_ms, self.steps)]
        return {k: float(np.median(v[1:])) for k, v in parts.items()}


def phase_sage_sampling_train(build, ds, dev):
    """The sampled GraphSAGE twin's loop (examples/
    train_sage_sampling_torch.py) on full synthetic Reddit at the JAX
    example's widths (602 features, hidden 16, 41 classes, fanouts 10,25,
    batch 1,024, Adam at 3e-3, dropout 0.5): 20 minibatches with the mean
    aggregator and 5 with pool, each then evaluated on 4 test batches.
    Per step the host's sampling and block build (the native sampler's
    picks and the frontiers: ``sample_neighbors``; ``to_block``; the rest,
    ``_HostSplit``), the copy to the card, the blocks' plans (real-edge
    view, row plans) and the device step are timed apart; peak memory;
    the device's busy share over mean steps 3-7 of a run of its own under
    torch.profiler (``_busy_share``); the launches (K1 for mean, K4/K5 for
    pool, no plain path).  Returns the launches and the mean run's
    losses."""
    twin = _load_twin()
    counts, mean_losses = {}, None
    for agg, steps, need in (("mean", 20, ("segment_sum.fwd",)),
                             ("pool", 5, ("segment_max.fwd",
                                          "segment_max.bwd"))):
        torch.manual_seed(0)
        reset_peak_memory()
        build.LAUNCHES.reset()
        t0 = time.perf_counter()
        with _HostSplit() as split:
            res = twin.train(ds, aggregator=agg, max_steps=steps,
                             eval_batches=4, device=dev, log=None,
                             on_step=split.on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = dict(build.LAUNCHES.counts)
        losses = res["losses"]
        steady = {k: float(np.median(v[1:])) for k, v in
                  res["times"].items()}
        rec = {"phase": f"sage_sampling_{agg}", "steps": res["steps"],
               "losses": losses, "test_acc": res["test_acc"],
               "test_nodes": res["test_nodes"], "wall_s": wall,
               "median_ms_after_first": steady,
               "host_split_ms": split.split(res["times"]["sample_ms"]),
               "step_total_ms": sum(steady.values()),
               "first_step_ms": {k: v[0] for k, v in res["times"].items()},
               "launches": c,
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        problems = []
        if res["steps"] != steps or not all(np.isfinite(losses)):
            problems.append(f"{res['steps']} steps, losses {losses}")
        elif not np.mean(losses[-3:]) < np.mean(losses[:3]):
            problems.append(f"loss did not fall: {losses}")
        for k in need:
            if c.get(k, 0) <= 0:
                problems.append(f"kernel {k} never launched")
        plain = {k: v for k, v in c.items() if k.startswith("plain.")}
        if plain:
            problems.append(f"plain path ran on CUDA: {plain}")
        if agg == "mean":
            rec["profile"] = _busy_share(twin, ds, dev)
            mean_losses = losses
        emit(rec)
        if problems:
            raise SystemExit(f"sage_sampling_{agg} failed: "
                             + "; ".join(problems))
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts, mean_losses


def _layer_graph(dt):
    """A batch of a 2,048-node graph whose node 0 has 700 in-edges (a dst
    hub: 3 pieces of K1's CSC plan) and node 1 700 out-edges (a src hub:
    3 pieces of the CSR plan), with duplicate edges, and three small
    graphs; the first graph's 2,048 node rows are one readout segment of
    8 pieces."""
    rng = np.random.default_rng(13)
    n = 2048
    src, dst = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    dst[:700], src[700:1400] = 0, 1
    src[-50:], dst[-50:] = src[:50], dst[:50]
    parts = [dt.graph((src, dst), num_nodes=n)]
    for k in (3, 7, 12):
        parts.append(dt.graph((rng.integers(0, k, 3 * k),
                               rng.integers(0, k, 3 * k)), num_nodes=k))
    return dt.batch(parts)


def _layer_cases(dt, g):
    """(name, module, extra inputs, kernel counts that must be > 0) for
    every layer and pooling of the slice, plus GINConv(max); DenseGraphConv
    takes the dense adjacency in place of the graph ("dense")."""
    from dgl_hack_tpu_torch import nn as tnn
    rng = np.random.default_rng(14)
    E = g.num_edges()
    etypes = torch.from_numpy(rng.integers(0, 3, E))
    efeat = torch.from_numpy(rng.normal(size=(E, 3)).astype(np.float32))
    return [
        ("GINConv(max)", tnn.GINConv(aggregator_type="max", learn_eps=True),
         (), ("segment_max.fwd", "segment_max.bwd")),
        ("SGConv", tnn.SGConv(8, k=2), (), ("segment_sum.fwd",)),
        ("APPNPConv", tnn.APPNPConv(3, 0.1), (), ("segment_sum.fwd",)),
        ("TAGConv", tnn.TAGConv(8, k=2), (), ("segment_sum.fwd",)),
        ("ChebConv", tnn.ChebConv(8, k=3), (), ("segment_sum.fwd",)),
        ("AGNNConv", tnn.AGNNConv(), (), ("sddmm.fwd", "sddmm.bwd")),
        ("EdgeConv", tnn.EdgeConv(8), (), ("sddmm.fwd",)),
        ("GatedGraphConv", tnn.GatedGraphConv(16, 2, 3), (etypes,),
         ("segment_sum.rows",)),
        ("NNConv(sum)", tnn.NNConv(8, tnn.Dense(16 * 8), "sum"), (efeat,),
         ("segment_sum.rows",)),
        ("NNConv(mean)", tnn.NNConv(8, tnn.Dense(16 * 8), "mean",
                                    residual=True), (efeat,),
         ("segment_sum.rows",)),
        ("NNConv(max)", tnn.NNConv(8, tnn.Dense(16 * 8), "max"), (efeat,),
         ()),
        ("SumPooling", tnn.SumPooling(), (), ("segment_sum.rows",)),
        ("WeightAndSum", tnn.WeightAndSum(), (), ("segment_sum.rows",)),
        ("AvgPooling", tnn.AvgPooling(), (), ("segment_sum.rows",)),
        ("MaxPooling", tnn.MaxPooling(), (), ()),
        ("SortPooling", tnn.SortPooling(5), (), ()),
        ("GlobalAttentionPooling", tnn.GlobalAttentionPooling(
            tnn.Dense(1), tnn.Dense(8)), (), ("segment_sum.rows",)),
        ("Set2Set", tnn.Set2Set(16, 2), (), ("segment_sum.rows",)),
        ("SetTransformerEncoder(sab)",
         tnn.SetTransformerEncoder(16, 2, 8, 32), (), ()),
        ("SetTransformerEncoder(isab)",
         tnn.SetTransformerEncoder(16, 2, 8, 32, block_type="isab", m=4),
         (), ()),
        ("SetTransformerDecoder", tnn.SetTransformerDecoder(16, 2, 8, 32,
                                                            k=2), (), ()),
        ("Sequential", tnn.Sequential([tnn.GraphConv(8), tnn.GraphConv(4)]),
         (), ("segment_sum.fwd", "segment_sum.rev")),
        ("DenseGraphConv", tnn.DenseGraphConv(8), "dense", ()),
    ]


def _grads_close(checks, name, mod_d, mod_c, x_d=None, x_c=None):
    """The input's (where given) and every parameter's gradient on the card
    within LAYER_TOL of the CPU's, relative to the larger of the tensor's
    max|ref| and 1e-3 of the module's largest gradient: a gradient that is
    0 up to rounding (a softmax's shift invariance: the attention's key
    biases, a gate's bias) is held to 1e-7 of that.  A parameter that no
    output reads (MGCN's last edge update) has no gradient on either side
    and is skipped.  Returns the largest error and the tensor it was found
    in."""
    ref = dict(mod_c.named_parameters())
    pairs = ([] if x_d is None else [("input", x_d.grad, x_c.grad)]) + [
        (n, p.grad, ref[n].grad) for n, p in mod_d.named_parameters()
        if ref[n].grad is not None or p.grad is not None]
    top = max(float(r.abs().max()) for _, _, r in pairs)
    worst = (0.0, "")
    for what, out, ref in pairs:
        scale = max(float(ref.abs().max()), 1e-3 * top, 1e-30)
        err = float((out.cpu() - ref).abs().max()) / scale
        worst = max(worst, (err, what))
        if not err <= LAYER_TOL:
            checks.failures.append(f"{name} d {what}: {err:.3g} > "
                                   f"{LAYER_TOL}")
    return worst


def phase_layers(dt, build, checks, dev):
    """Every layer and pooling of the slice, and GINConv(max), forward
    and backward on the card against the same module (same weights) on
    the CPU, on a batch holding a dst hub and a src hub of 700 edges; each
    module's kernel launches on the card, and no plain path.  torch's
    deterministic algorithms are on for the phase: the gradients that are
    0 up to rounding (``_grads_close``) come out of torch's index_add,
    whose CUDA atomics add in another order on every run; without them,
    on an H100, GlobalAttentionPooling's gate bias read from 5.8e-5 to
    1.1e-4 against LAYER_TOL over seven runs of the same inputs, with
    them 5.8e-5 every time."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _layers(dt, build, checks, dev)
    finally:
        torch.use_deterministic_algorithms(False)


def _layers(dt, build, checks, dev):
    g_c = _layer_graph(dt)
    g_d = g_c.to(dev)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.normal(size=(g_c.num_nodes(), 16))
                         .astype(np.float32))
    res = {}
    src, dst = g_c.edges()
    adj = torch.zeros((g_c.num_nodes(),) * 2).index_put_(
        (dst.long(), src.long()), torch.ones(g_c.num_edges()),
        accumulate=True)
    for name, mod_c, extra, need in _layer_cases(dt, g_c):
        on_c, on_d = (adj, adj.to(dev)) if extra == "dense" else (g_c, g_d)
        extra = () if extra == "dense" else extra
        torch.manual_seed(0)
        x_c = x.clone().requires_grad_()
        out_c = mod_c(on_c, x_c, *extra)        # CPU: materialises params
        mod_d = copy.deepcopy(mod_c).to(dev)
        x_d = x.clone().to(dev).requires_grad_()
        build.LAUNCHES.reset()
        out_d = mod_d(on_d, x_d, *(t.to(dev) for t in extra))
        cot = torch.from_numpy(np.random.default_rng(16).normal(
            size=tuple(out_c.shape)).astype(np.float32))
        fin = torch.isfinite(out_c)
        (torch.where(fin, out_c, 0.0) * cot).sum().backward()
        (torch.where(fin.to(dev), out_d, 0.0) * cot.to(dev)).sum() \
            .backward()
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES.counts)
        fwd = rel_err(torch.where(fin, out_d.detach().cpu(), 0.0),
                      torch.where(fin, out_c.detach(), 0.0))
        if not (fwd <= LAYER_TOL and bool((torch.isfinite(out_d.cpu())
                                           == fin).all())):
            checks.failures.append(f"{name} forward: rel err {fwd:.3g}")
        grad, worst = _grads_close(checks, name, mod_d, mod_c, x_d, x_c)
        missing = [k for k in need if counts.get(k, 0) <= 0]
        plain = {k: v for k, v in counts.items() if k.startswith("plain.")}
        if missing or plain:
            checks.failures.append(f"{name}: launches {counts}")
        res[name] = {"fwd_rel_err": fwd, "grad_rel_err": grad,
                     "worst_grad": worst, "launches": counts}
    from dgl_hack_tpu_torch.nn import WeightBasis
    wb = WeightBasis((4, 5), 2, 6)
    wb_d = copy.deepcopy(wb).to(dev)
    res["WeightBasis"] = {"fwd_rel_err": rel_err(wb_d().detach().cpu(),
                                                 wb().detach())}
    if not res["WeightBasis"]["fwd_rel_err"] <= LAYER_TOL:
        checks.failures.append("WeightBasis forward")
    emit({"phase": "layers", "nodes": g_c.num_nodes(),
          "edges": g_c.num_edges(), "graphs": len(g_c.batch_num_nodes),
          "max_in_degree": int(g_c.in_degrees().max()),
          "max_out_degree": int(g_c.out_degrees().max()), "modules": res})
    checks.raise_if_failed("layers")


# ---------------------------------------------------------------------------
# R-GCN entity classification and heterographs
# ---------------------------------------------------------------------------
AM_HPARAMS = dict(hidden=10, num_bases=40, l2norm=5e-4, lr=1e-2, layers=2)


def _rgcn_k1(sk, plan, x, checks):
    """K1 at the shapes the R-GCN path gives it on this phase's graph,
    each against its plain version in float64, repeated bitwise, timed
    with its plain version, its bound and the library call: the pair
    graph's forward (CSC rows) with no weight and with an (E,) norm
    (``torch.sparse.mm``), its dx over the CSR rows (the first layer's
    embedding gradient; ``torch.sparse.mm`` of the transpose) and the
    second level's edge-row sum over each dst's run of pairs
    (``torch.segment_reduce``)."""
    pg = plan.pair_graph
    E, M, N, F = pg.num_edges(), plan.num_pairs, pg.num_src_nodes, \
        x.shape[1]
    rng = np.random.default_rng(30)
    w = torch.from_numpy(rng.random(E).astype(np.float32)).to(x.device)
    dout = torch.from_numpy(rng.normal(size=(M, F)).astype(np.float32)) \
        .to(x.device)
    seg = plan.dst_segments
    p_csc, p_csr = sk.graph_row_plan(pg, "csc"), sk.graph_row_plan(pg, "csr")
    rev = sk.rev_gidx(pg)
    a_fwd, a_rev = csr_matrix(pg), csr_matrix(pg, reverse=True)
    a_w = torch.sparse_csr_tensor(a_fwd.crow_indices(), a_fwd.col_indices(),
                                  w, size=a_fwd.shape)
    lengths = (seg.indptr[1:] - seg.indptr[:-1]).long()
    cases = {
        "pair_fwd": (dict(indptr=pg.csc_indptr, x=x, gidx=pg.src), p_csc,
                     "fwd", lambda: torch.sparse.mm(a_fwd, x),
                     nbytes(pg.csc_indptr, pg.src, x) + M * F * 4),
        "pair_fwd_norm": (dict(indptr=pg.csc_indptr, x=x, gidx=pg.src, w=w),
                          p_csc, "fwd", lambda: torch.sparse.mm(a_w, x),
                          nbytes(pg.csc_indptr, pg.src, x, w) + M * F * 4),
        "pair_dx": (dict(indptr=pg.csr_indptr, x=dout, gidx=rev,
                         eid=pg.csr_eids), p_csr, "rev",
                    lambda: torch.sparse.mm(a_rev, dout),
                    nbytes(pg.csr_indptr, rev, dout) + N * F * 4),
        "pair_rows": (dict(indptr=seg.indptr, x=dout), seg.plan, "rows",
                      lambda: torch.segment_reduce(dout, "sum",
                                                   lengths=lengths),
                      nbytes(seg.indptr, dout)
                      + (seg.indptr.numel() - 1) * F * 4),
    }
    res = {}
    for name, (args, plan_, site, library, num_bytes) in cases.items():
        out = sk.segment_sum(**args, site=site, plan=plan_)
        again = sk.segment_sum(**args, site=site, plan=plan_)
        rows = args["x"].shape[0] if "gidx" not in args else E
        rel = checks.compare("segment_sum", f"rgcn {name}", out,
                             k1_ref(sk, **args), K1_TOL, again)
        res[name] = timing(
            both_ms(lambda: sk.segment_sum(**args, site=site, plan=plan_)),
            cuda_ms(lambda: sk.segment_sum_plain(**args), reps=3),
            num_bytes, rows * F, f"{name}, F={F}",
            library_ms=cuda_ms(library))
        res[name].update(rel_err=rel, rows=args["indptr"].numel() - 1,
                         pieces=plan_.pieces.shape[0])
        del out, again
    return res


def _relgraphconv_cases(dt, dev, checks):
    """A small RelGraphConv (basis with and without w_comp, each with the
    pair plan and without, bdd; a per-edge norm, self-loop) forward and
    gradients on the card against the same module on the CPU, on a graph
    whose node 0 has 700 in-edges and node 1 700 out-edges, and basis on
    the same graph with every fifth edge padding (the plan over the real
    edges, the composed path through the real-edge view); with the
    launches of each (K1's forward, dx and rows with the plan, its rows
    without, nothing plain)."""
    from dgl_hack_tpu_torch.nn import RelGraphConv
    from dgl_hack_tpu_torch.ops.cuda import build
    rng = np.random.default_rng(31)
    n, e, R = 2048, 12_000, 7
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst[:700], src[700:1400] = 0, 1
    et = torch.from_numpy(rng.integers(0, R, e))
    norm = torch.from_numpy(rng.random((e, 1)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    graphs = {}
    for masked in (False, True):
        g_c = dt.graph((src, dst), num_nodes=n,
                       edge_mask=(np.arange(e) % 5 != 4) if masked else None)
        g_d = g_c.to(dev)
        graphs[masked] = (g_c, g_d, dt.prepare_rgcn(g_c, et, R),
                          dt.prepare_rgcn(g_d, et, R))
    res = {}
    for name, reg, nb, use_plan, masked in (
            ("basis B=3 plan", "basis", 3, True, False),
            ("basis B=3", "basis", 3, False, False),
            ("basis B=R plan", "basis", None, True, False),
            ("basis B=R", "basis", None, False, False),
            ("bdd B=4", "bdd", 4, False, False),
            ("masked basis B=3 plan", "basis", 3, True, True),
            ("masked basis B=3", "basis", 3, False, True)):
        g_c, g_d, plan_c, plan_d = graphs[masked]
        torch.manual_seed(0)
        mod_c = RelGraphConv(8, R, reg, nb, self_loop=True)
        x_c = x.clone().requires_grad_()
        out_c = mod_c(g_c, x_c, et, norm, plan=plan_c if use_plan else None)
        mod_d = copy.deepcopy(mod_c).to(dev)
        x_d = x.clone().to(dev).requires_grad_()
        build.LAUNCHES.reset()
        out_d = mod_d(g_d, x_d, et.to(dev), norm.to(dev),
                      plan=plan_d if use_plan else None)
        cot = torch.from_numpy(rng.normal(size=tuple(out_c.shape)).astype(
            np.float32))
        (out_c * cot).sum().backward()
        (out_d * cot.to(dev)).sum().backward()
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES.counts)
        fwd = rel_err(out_d.detach().cpu(), out_c.detach())
        if not fwd <= LAYER_TOL:
            checks.failures.append(f"RelGraphConv {name} forward: {fwd:.3g}")
        grad, worst = _grads_close(checks, f"RelGraphConv {name}", mod_d,
                                   mod_c, x_d, x_c)
        need = ("segment_sum.fwd", "segment_sum.rev", "segment_sum.rows") \
            if use_plan else ("segment_sum.rows",)
        if any(counts.get(k, 0) <= 0 for k in need) or any(
                k.startswith("plain.") for k in counts):
            checks.failures.append(f"RelGraphConv {name}: launches {counts}")
        res[name] = {"fwd_rel_err": fwd, "grad_rel_err": grad,
                     "worst_grad": worst, "launches": counts}
    return res


def _rgcn_train(dt, build, ds, g, plan, epochs, hp, dev, profile=False):
    """RGCN (the twin's model and trainer, every layer on the pair plan)
    on ``ds``: a warm-up step and ``epochs - 1`` timed ones; with
    ``profile``, one more step under torch.profiler.  Returns the
    trainer's result, the launches and the peak memory."""
    from dgl_hack_tpu_torch.models import RGCN
    from dgl_hack_tpu_torch.models.training import (node_classifier_step,
                                                    train_node_classifier)
    torch.manual_seed(0)
    model = RGCN(num_nodes=g.num_nodes(), hidden_feats=hp["hidden"],
                 out_feats=ds.num_classes, num_rels=ds.num_rels,
                 num_bases=hp["num_bases"], num_layers=hp["layers"])
    etypes = torch.from_numpy(ds.etypes).to(dev)
    reset_peak_memory()
    build.LAUNCHES.reset()
    res = train_node_classifier(
        model, g, None, ds.labels, ds.train_mask, ds.test_mask, ds.test_mask,
        num_epochs=epochs, lr=hp["lr"], weight_decay=hp["l2norm"],
        model_args=(etypes,), model_kwargs={"plan": plan}, device=dev)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    peak = torch.cuda.max_memory_allocated()
    prof = None
    if profile:
        step, _ = node_classifier_step(
            model, g, None, ds.labels, ds.train_mask, lr=hp["lr"],
            weight_decay=hp["l2norm"], model_args=(etypes,),
            model_kwargs={"plan": plan}, device=dev)
        step()
        prof = _profile_step(step, "rgcn_train")
        prof["k1_ms"] = sum(r["ms"] for r in prof["top"]
                            if "segment_sum" in r["name"]
                            or "row_fixup" in r["name"])
    return res, counts, peak, prof


def phase_rgcn_train(dt, build, sk, checks, dev):
    """R-GCN entity classification (examples/train_rgcn_torch.py's model
    and trainer) on synthetic AM at full stats (1,666,764 nodes,
    11,976,642 edges with the inverse relations, 266 relations, 11
    classes) with the AM hyper-parameters of the R-GCN paper (hidden 10,
    40 bases, l2 5e-4; two layers, self-loop, lr 1e-2): the data build and
    prepare_rgcn's seconds, K1 at the path's shapes (``_rgcn_k1``), a
    small RelGraphConv against the CPU (``_relgraphconv_cases``), a
    warm-up step and 5 epochs with peak memory and one profiled step (K1's
    share); then synthetic AIFB at full size (hidden 16, bases -1), 50
    epochs, and its test accuracy."""
    from dgl_hack_tpu_torch.data.rdf import load_rdf_dataset
    t0 = time.perf_counter()
    ds = load_rdf_dataset("am-synth", scale=1.0)
    data_s = time.perf_counter() - t0
    g = ds.graph.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = dt.prepare_rgcn(g, ds.etypes, ds.num_rels)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    hp = AM_HPARAMS
    x = torch.from_numpy(np.random.default_rng(32).normal(
        size=(g.num_nodes(), hp["hidden"])).astype(np.float32)).to(dev)
    k1 = _rgcn_k1(sk, plan, x, checks)
    del x
    layer = _relgraphconv_cases(dt, dev, checks)
    checks.raise_if_failed("rgcn_train (kernels and layer)")
    res, counts, peak, prof = _rgcn_train(dt, build, ds, g, plan, 6, hp, dev,
                                          profile=True)
    epoch_ms = 1e3 * res["train_time_s"] / 5
    am = {"nodes": g.num_nodes(), "edges": g.num_edges(),
          "relations": ds.num_rels, "classes": ds.num_classes,
          "pairs": plan.num_pairs, "data_build_s": data_s,
          "prepare_rgcn_s": plan_s, **hp, "epochs": 6,
          "losses": res["losses"], "epoch_ms": epoch_ms,
          "test_acc": res["test_acc"], "peak_memory_bytes": peak,
          "launches": counts, "profile": prof,
          "k1_share_of_step": prof["k1_ms"] / prof["device_ms"]}
    emit({"phase": "rgcn_train", "k1": k1, "relgraphconv": layer,
          "am": am})
    need = ("segment_sum.fwd", "segment_sum.rev", "segment_sum.rows")
    _check_training("rgcn_train", res, counts, need)
    del plan, g, ds
    torch.cuda.empty_cache()

    ds = load_rdf_dataset("aifb-synth")
    g = ds.graph.to(dev)
    plan = dt.prepare_rgcn(g, ds.etypes, ds.num_rels)
    hp_aifb = dict(hidden=16, num_bases=-1, l2norm=5e-4, lr=1e-2, layers=2)
    res_a, counts_a, peak_a, _ = _rgcn_train(dt, build, ds, g, plan, 50,
                                             hp_aifb, dev)
    aifb = {"nodes": g.num_nodes(), "edges": g.num_edges(),
            "relations": ds.num_rels, "pairs": plan.num_pairs, **hp_aifb,
            "epochs": 50, "first_loss": res_a["losses"][0],
            "last_loss": res_a["losses"][-1],
            "epoch_ms": 1e3 * res_a["train_time_s"] / 49,
            "test_acc": res_a["test_acc"], "peak_memory_bytes": peak_a,
            "launches": counts_a}
    emit({"phase": "rgcn_train_aifb", **aifb})
    _check_training("rgcn_train_aifb", res_a, counts_a, need)
    for k, v in counts_a.items():
        counts[k] = counts.get(k, 0) + v
    return counts


def phase_rgcn_hetero_train(dt, build, checks, dev):
    """The heterograph R-GCN twin (examples/train_rgcn_hetero_torch.py) at
    its defaults (400 papers, embed 16, hidden 24, 4 bases, Adam 1e-2):
    20 epochs on the card, the first 5 losses held against the same twin
    (same seed, same weights) on the CPU; and one multi_update_all with a
    max builtin per relation (K4, with K5 in the backward) and a
    cross-type max, forward and gradients against the CPU."""
    from dgl_hack_tpu_torch import fn
    twin = _load_twin("train_rgcn_hetero_torch")
    hg, labels, tr, te = twin.synthetic_academic()
    build.LAUNCHES.reset()
    res = twin.train(hg, labels, tr, te, epochs=20, device=dev)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    res_c = twin.train(hg, labels, tr, te, epochs=5, device="cpu")
    loss_err = float(np.max(np.abs(np.subtract(res["losses"][:5],
                                               res_c["losses"]))
                            / np.abs(res_c["losses"])))
    if not loss_err <= LAYER_TOL:
        checks.failures.append(f"hetero twin losses vs CPU: {loss_err:.3g}")

    rng = np.random.default_rng(33)
    feats = {nt: torch.from_numpy(rng.normal(size=(hg.num_nodes(nt), 16))
                                  .astype(np.float32))
             for nt in hg.ntypes}
    outs, grads = {}, {}
    for where, h in (("cpu", hg), ("cuda", hg.to(dev))):
        leaves = {nt: f.clone().to(h.device).requires_grad_()
                  for nt, f in feats.items()}
        local = h.local_var()
        for nt, f in leaves.items():
            local.nodes_data(nt)["h"] = f
        if where == "cuda":
            build.LAUNCHES.reset()
        local.multi_update_all(
            {c: (fn.copy_u("h", "m"), fn.max("m", "agg"))
             for c in local.canonical_etypes}, "max")
        out = torch.cat([local.nodes_data(nt)["agg"] for nt in hg.ntypes])
        out.backward(torch.ones_like(out))
        outs[where] = out.detach().cpu()
        grads[where] = torch.cat([leaves[nt].grad.cpu() for nt in hg.ntypes])
    torch.cuda.synchronize()
    max_counts = dict(build.LAUNCHES.counts)
    max_err = {"fwd": rel_err(outs["cuda"], outs["cpu"]),
               "grad": rel_err(grads["cuda"], grads["cpu"])}
    if not all(v <= LAYER_TOL for v in max_err.values()):
        checks.failures.append(f"multi_update_all max vs CPU: {max_err}")
    emit({"phase": "rgcn_hetero_train",
          "nodes": {nt: hg.num_nodes(nt) for nt in hg.ntypes},
          "edges": hg.num_edges(), "relations": len(hg.canonical_etypes),
          "epochs": 20, "losses": res["losses"],
          "losses_cpu": res_c["losses"], "loss_rel_err_vs_cpu": loss_err,
          "train_time_s": res["train_time_s"],
          "epoch_ms": 1e3 * res["train_time_s"] / 20,
          "test_acc": res["test_acc"], "launches": counts,
          "multi_update_all_max": {"rel_err_vs_cpu": max_err,
                                   "launches": max_counts}})
    for what, c, need in (
            ("training", counts, ("segment_sum.fwd", "segment_sum.rev")),
            ("max", max_counts, ("segment_max.fwd", "segment_max.bwd"))):
        if any(c.get(k, 0) <= 0 for k in need) or any(
                k.startswith("plain.") for k in c):
            checks.failures.append(f"rgcn_hetero {what}: launches {c}")
    checks.raise_if_failed("rgcn_hetero_train")
    _check_training("rgcn_hetero_train", res, counts, ())
    for k, v in max_counts.items():
        counts[k] = counts.get(k, 0) + v
    return counts


# ---------------------------------------------------------------------------
# DGL's message-passing API: PageRank, subsets, propagation, Tree-LSTM and
# the sampled GraphSAGE-LSTM
# ---------------------------------------------------------------------------
PR_ITERS, PR_CPU_ITERS, PR_DAMP = 20, 2, 0.85
PR_FORMS = ("twin", "update_all", "pull", "push", "send_and_recv",
            "send_recv")


def _pagerank_step(dt, form, g, deg):
    """One PageRank iteration through one form of the message-passing API
    (``twin``: examples/pagerank_torch.py's own gspmm): pv -> pv'."""
    from dgl_hack_tpu_torch import fn
    n = g.num_nodes()
    nodes = torch.arange(n, device=g.device)
    edges = torch.arange(g.num_edges(), device=g.device)
    msg, red = fn.copy_u("pv", "m"), fn.sum("m", "agg")

    def step(pv):
        if form == "twin":
            agg = dt.gspmm(g, "copy_lhs", "sum", pv / deg)
        else:
            g.ndata["pv"] = pv / deg
            if form == "update_all":
                g.update_all(msg, red)
            elif form == "pull":
                g.pull(nodes, msg, red)
            elif form == "push":
                g.push(nodes, msg, red)
            elif form == "send_and_recv":
                g.send_and_recv(edges, msg, red)
            else:
                g.send(msg)
                g.recv(nodes, red)
            agg = g.ndata["agg"]
        return (1 - PR_DAMP) / n + PR_DAMP * agg
    return step


def _pagerank(dt, form, g, iters=PR_ITERS):
    """(N,) PageRank after ``iters`` iterations of ``form`` on g (on a
    local copy of its frames); the twin's form is its own loop."""
    if form == "twin":
        return _load_twin("pagerank_torch").pagerank(g, iters, PR_DAMP)
    g = g.local_var()
    deg = g.out_degrees().float().clamp(min=1.0)[:, None]
    step = _pagerank_step(dt, form, g, deg)
    pv = torch.full((g.num_nodes(), 1), 1.0 / g.num_nodes(), device=g.device)
    for _ in range(iters):
        pv = step(pv)
    return pv[:, 0]


def _pagerank_plain(g, iters=PR_ITERS):
    """PageRank in float64 by index_add over the graph's edges: the plain
    version every form is held against."""
    n = g.num_nodes()
    src, dst = g.src.long(), g.dst.long()
    deg = g.out_degrees().double().clamp(min=1.0)
    pv = torch.full((n,), 1.0 / n, dtype=torch.float64, device=g.device)
    for _ in range(iters):
        agg = torch.zeros_like(pv).index_add_(0, dst, (pv / deg)[src])
        pv = (1 - PR_DAMP) / n + PR_DAMP * agg
    return pv.float()


def _host_ms(fn, reps=5):
    """Median host milliseconds of fn() ended by a sync, after a warm-up:
    for calls that sync inside (a real-edge view's count)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def phase_pagerank(dt, build, sk, gb, checks, dev, timings):
    """PageRank at bench.py's graph (power-law, N = 1,000,000, in-degree
    16, F = 1), 20 iterations through each form of the message-passing
    API: the twin's loop (examples/pagerank_torch.py), update_all, pull
    and push of all nodes, send_and_recv over all edges, send then recv.
    Each result is held against the float64 index_add version on the card
    (K1_TOL); each form launches K1 and nothing plain.  The same form on
    the CPU runs PR_CPU_ITERS iterations (a CPU iteration takes about a
    second here) and is held against the card's to the CPU's own error
    against the float64 version (its float32 sum over the 173,324-edge
    hub row) plus K1_TOL.  One iteration of each form is timed (CUDA
    events, one call per pair: the masked forms sync inside), and K1 at F
    = 1 over the whole graph beside its bound, its plain version and
    torch.sparse.mm."""
    g_cpu = gb.to("cpu")
    ref = _pagerank_plain(gb)
    ref_short = _pagerank_plain(gb, PR_CPU_ITERS).cpu()
    rec, counts = {}, {}
    t_cpu = 0.0
    deg = gb.out_degrees().float().clamp(min=1.0)[:, None]
    pv0 = torch.full((gb.num_nodes(), 1), 1.0 / gb.num_nodes(), device=dev)
    for form in PR_FORMS:
        build.LAUNCHES.reset()
        pv = _pagerank(dt, form, gb)
        torch.cuda.synchronize()
        c = dict(build.LAUNCHES.counts)
        t0 = time.perf_counter()
        pv_cpu = _pagerank(dt, form, g_cpu, PR_CPU_ITERS)
        t_cpu += time.perf_counter() - t0
        cpu_err = rel_err(pv_cpu, ref_short)
        vs_cpu = rel_err(_pagerank(dt, form, gb, PR_CPU_ITERS).cpu(), pv_cpu)
        step = _pagerank_step(dt, form, gb.local_var(), deg)
        rec[form] = {
            "rel_err_vs_plain": checks.compare(
                "segment_sum", f"pagerank {form} vs plain", pv, ref,
                K1_TOL),
            "rel_err_vs_cpu": vs_cpu, "cpu_rel_err_vs_plain": cpu_err,
            "sum": float(pv.sum()), "iteration_ms": cuda_ms(
                lambda: step(pv0), reps=5, one_launch=True),
            "launches": c}
        if not vs_cpu <= cpu_err + K1_TOL:
            checks.failures.append(f"pagerank {form} vs CPU: {vs_cpu:.3g} "
                                   f"> {cpu_err:.3g} + {K1_TOL}")
        if not any(k.startswith("segment_sum.") and v > 0
                   for k, v in c.items()) or any(
                k.startswith("plain.") for k in c):
            checks.failures.append(f"pagerank {form}: launches {c}")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    x1 = (1.0 / deg).contiguous()
    fwd = (gb.csc_indptr, x1, gb.src)
    p_fwd = sk.graph_row_plan(gb, "csc")
    out = sk.segment_sum(*fwd, plan=p_fwd)
    checks.compare("segment_sum", "bench F=1 fwd", out, k1_ref(sk, *fwd),
                   K1_TOL, sk.segment_sum(*fwd, plan=p_fwd))
    A = csr_matrix(gb)
    timings["k1_bench_F1"] = timing(
        both_ms(lambda: sk.segment_sum(*fwd, plan=p_fwd)),
        cuda_ms(lambda: sk.segment_sum_plain(*fwd), reps=3),
        nbytes(gb.csc_indptr, gb.src, x1, out), gb.num_edges(),
        "bench.py graph, F=1, fwd (PageRank's gspmm)",
        library_ms=cuda_ms(lambda: torch.sparse.mm(A, x1), reps=3))
    del A, out
    emit({"phase": "pagerank", "nodes": gb.num_nodes(),
          "edges": gb.num_edges(), "iters": PR_ITERS,
          "cpu_iters": PR_CPU_ITERS, "forms": rec, "cpu_seconds": t_cpu,
          "k1_F1": timings["k1_bench_F1"]})
    checks.raise_if_failed("pagerank")
    return counts


def _subset_case(dt, build, sk, g, what, call, ref_fn, F, rng, checks,
                 counts):
    """One subset call (send_and_recv or push) of copy_u sum at width F on
    g: its result against ``ref_fn`` (float64 index_add over the chosen
    edges), the end-to-end host time of a call (the calls' launches added
    to ``counts``), and the masked graph's real-edge view and row plans
    built from nothing (host clock), apart from K1's time over that
    view."""
    from dgl_hack_tpu_torch import fn
    x = torch.from_numpy(rng.normal(size=(g.num_src_nodes, F)).astype(
        np.float32)).to(g.device)
    local = g.local_var()
    local.ndata["h"] = x

    def run():
        call(local, fn.copy_u("h", "m"), fn.sum("m", "o"))
        return local.ndata["o"]
    build.LAUNCHES.reset()
    out = run()
    call_ms = _host_ms(run)
    for k, v in build.LAUNCHES.counts.items():
        counts[k] = counts.get(k, 0) + v
    err = checks.compare("segment_sum", f"{what} F={F}", out,
                         ref_fn(x.double()).float(), K1_TOL)
    masked = call.masked(g)
    view_ms = _view_build_ms(sk, masked)
    kg = sk.real_edges(masked).graph
    plan = sk.graph_row_plan(kg, "csc")
    fwd = (kg.csc_indptr, x, kg.src)
    rows_read = int(torch.unique(kg.src).numel())
    kout = sk.segment_sum(*fwd, plan=plan)
    A = csr_matrix(kg)
    t = timing(both_ms(lambda: sk.segment_sum(*fwd, plan=plan)),
               cuda_ms(lambda: sk.segment_sum_plain(*fwd), reps=3),
               nbytes(kg.csc_indptr, kg.src, kout) + 4 * F * rows_read,
               kg.num_edges() * F,
               f"bench.py graph, {what}, {kg.num_edges()} of "
               f"{g.num_edges()} edges through the real-edge view, F={F}",
               library_ms=cuda_ms(lambda: torch.sparse.mm(A, x), reps=3))
    return {"rel_err": err, "edges": kg.num_edges(), "call_ms": call_ms,
            **view_ms, "k1": t}


class _Call:
    """A subset call and the masked graph it builds, for timing the view
    apart."""

    def __init__(self, kind, ids):
        self.kind, self.ids = kind, ids

    def __call__(self, g, mf, rf):
        if self.kind == "send_and_recv":
            g.send_and_recv(self.ids, mf, rf)
        else:
            g.push(self.ids, mf, rf)

    def masked(self, g):
        from dgl_hack_tpu_torch.core.message import _masked_to, _node_mask
        if self.kind == "push":
            sel = _node_mask(g.num_src_nodes, self.ids, g.device)[
                g.src.long()]
        else:
            ids = self.ids if g.int2user is None else g.user2int[self.ids]
            sel = torch.zeros(g.num_edges(), dtype=torch.bool,
                              device=g.device)
            sel[ids.long()] = True
        return _masked_to(g, sel)


def phase_message_subsets(dt, build, sk, gb, checks, dev, timings):
    """send_and_recv over a seeded half of bench.py's graph's edges and
    push from a tenth of its nodes (copy_u sum, F = 1 and 16), each call
    building a masked graph and, on the card, its real-edge view and row
    plans anew: results against float64 references built from the chosen
    edges alone, the host time of a call, the view's and the row plans'
    build time, K1 over the view; and the host time of send_and_recv over
    a frontier of 1,024 edges, what a prop_edges loop pays per frontier
    at this graph's size."""
    rng = np.random.default_rng(41)
    E, N = gb.num_edges(), gb.num_nodes()
    s_user, d_user = (torch.from_numpy(a).to(dev).long()
                      for a in gb.host_edges())
    half = torch.from_numpy(np.sort(rng.choice(E, E // 2, replace=False))
                            ).to(dev)
    tenth = torch.from_numpy(np.sort(rng.choice(N, N // 10, replace=False))
                             ).to(dev)
    src_sel = torch.zeros(N, dtype=torch.bool, device=dev)
    src_sel[tenth] = True
    pushed = torch.nonzero(src_sel[s_user]).squeeze(1)

    def ref_over(eids):
        def ref(x):
            return torch.zeros((N, x.shape[1]), dtype=x.dtype,
                               device=dev).index_add_(
                0, d_user[eids], x[s_user[eids]])
        return ref
    res, counts = {}, {}
    for kind, call, ref in (
            ("send_and_recv_half", _Call("send_and_recv", half),
             ref_over(half)),
            ("push_tenth", _Call("push", tenth), ref_over(pushed))):
        for F in (1, 16):
            res[f"{kind}_F{F}"] = _subset_case(
                dt, build, sk, gb, kind, call, ref, F, rng, checks, counts)
    small = _Call("send_and_recv", half[:1024])
    x = torch.ones((N, 1), device=dev)
    local = gb.local_var()
    local.ndata["h"] = x
    from dgl_hack_tpu_torch import fn
    build.LAUNCHES.reset()
    res["frontier_1024_call_ms"] = _host_ms(
        lambda: small(local, fn.copy_u("h", "m"), fn.sum("m", "o")))
    for k, v in build.LAUNCHES.counts.items():
        counts[k] = counts.get(k, 0) + v
    timings["k1_view_half"] = res["send_and_recv_half_F16"]["k1"]
    emit({"phase": "message_subsets", "nodes": N, "edges": E, **res,
          "launches": counts})
    if any(k.startswith("plain.") for k in counts) or \
            counts.get("segment_sum.fwd", 0) <= 0:
        checks.failures.append(f"message_subsets: launches {counts}")
    checks.raise_if_failed("message_subsets")
    return counts


def phase_reddit_max_subset(dt, build, sm, sk, g, checks, dev, timings):
    """send_and_recv with fn.max over a seeded half of synthetic Reddit's
    edges at F = 602, forward and backward (K4, K5 through the masked
    graph's real-edge view): the output equal to, and dx within K5_TOL
    of, gspmm max on a graph built on the host from the chosen edges
    alone; K4/K5 over the view against their plain versions (exact;
    float64), timed beside them with the view's build time."""
    from dgl_hack_tpu_torch import fn
    rng = np.random.default_rng(51)
    E, N, F = g.num_edges(), g.num_nodes(), 602
    eids = np.sort(rng.choice(E, E // 2, replace=False))
    x = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                            ).to(dev)
    local = g.local_var()
    xg = x.clone().requires_grad_()
    local.ndata["h"] = xg
    build.LAUNCHES.reset()
    local.send_and_recv(torch.from_numpy(eids).to(dev),
                        fn.copy_u("h", "m"), fn.max("m", "o"))
    out = local.ndata["o"]
    out.backward(dout)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    s, d = g.host_edges()
    g_sel = dt.graph((s[eids], d[eids]), num_nodes=N, device=dev)
    xr = x.clone().requires_grad_()
    ref = dt.gspmm(g_sel, "copy_lhs", "max", xr)
    ref.backward(dout)
    res = {"edges": len(eids), "launches": counts,
           "fwd_equal": bool((out == ref).all()),
           "dx_rel_err": rel_err(xg.grad, xr.grad)}
    if not res["fwd_equal"] or not res["dx_rel_err"] <= K5_TOL:
        checks.failures.append(f"reddit max subset vs the chosen edges: {res}")
    del out, ref, xg, xr, local, g_sel
    masked = _Call("send_and_recv", torch.from_numpy(eids).to(dev)).masked(g)
    res.update(_view_build_ms(sk, masked, reps=3))
    kg = sk.real_edges(masked).graph
    Fp = sk.run_width(x, None)
    xp = sk.pad_columns(x, Fp)
    doutp = sk.pad_columns(dout, Fp)
    raw, res["k4k5_rel_err"], _ = _k4k5_case(
        sm, sk, kg, xp, None, doutp, checks,
        f"reddit half F={F} padded to {Fp}", x_bwd=x)
    k4, k5 = _k4k5_timings(sm, sk, kg, xp, doutp, raw,
                           f"synthetic Reddit, send_and_recv over half of "
                           f"the edges ({kg.num_edges()}), F={F} padded to "
                           f"{Fp}", x_bwd=x)
    timings["k4_reddit_half"], timings["k5_reddit_half"] = k4, k5
    del raw, xp, doutp, x, dout, kg, masked
    torch.cuda.empty_cache()
    emit({"phase": "reddit_max_subset", **res, "k4": k4, "k5": k5})
    for k in ("segment_max.fwd", "segment_max.bwd"):
        if counts.get(k, 0) <= 0:
            checks.failures.append(f"reddit max subset: {k} not launched")
    if any(k.startswith("plain.") for k in counts):
        checks.failures.append(f"reddit max subset: launches {counts}")
    checks.raise_if_failed("reddit_max_subset")
    return counts


TOPO_LEVELS, TOPO_WIDTH = 32, 4096


def _topo_dag(dt, rng):
    """A DAG of TOPO_LEVELS levels of TOPO_WIDTH nodes (131,072): each node
    past the first level has an in-edge from the level before and one
    from any earlier level, so its topological frontier is its level;
    edges listed in a shuffled order, with a weight each."""
    W, L = TOPO_WIDTH, TOPO_LEVELS
    v = np.arange(W, L * W)
    lv = v // W
    near = (lv - 1) * W + rng.integers(0, W, v.shape[0])
    far = rng.integers(0, lv * W)
    src, dst = np.concatenate([near, far]), np.concatenate([v, v])
    perm = rng.permutation(src.shape[0])
    g = dt.graph((src[perm], dst[perm]), num_nodes=L * W)
    g.edata["w"] = torch.from_numpy(rng.random(src.shape[0]).astype(
        np.float32))
    return g


def phase_prop_topo(dt, build, checks, dev):
    """prop_nodes_topo on a seeded DAG of 131,072 nodes in 32 levels
    (``_topo_dag``): a UDF message h_u / 2 + w_e and the builtin sum into
    h, one pull a frontier, each a full update_all, whose sum runs K1's
    edge-row mode over the whole graph: against the CPU, with the time
    per level."""
    from dgl_hack_tpu_torch import fn
    from dgl_hack_tpu_torch.core import propagate, traversal
    rng = np.random.default_rng(61)
    g_c = _topo_dag(dt, rng)
    t0 = time.perf_counter()
    fronts = traversal.topological_nodes_generator(g_c)
    gen_s = time.perf_counter() - t0

    def run(g):
        g.ndata["h"] = torch.zeros(g.num_nodes(), 1, device=g.device)
        propagate.prop_nodes(g, fronts, lambda e: {
            "m": e.src["h"] * 0.5 + e.data["w"][:, None]}, fn.sum("m", "h"))
        return g.ndata["h"]
    g_d = g_c.to(dev)
    run(g_d.local_var())                        # warm-up
    build.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(g_d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES.counts)
    ref = run(g_c)
    err = rel_err(out.cpu(), ref)
    emit({"phase": "prop_nodes_topo", "nodes": g_c.num_nodes(),
          "edges": g_c.num_edges(), "levels": len(fronts),
          "generator_s": gen_s, "ms_per_level": 1e3 * wall / len(fronts),
          "rel_err_vs_cpu": err, "max_h": float(ref.max()),
          "launches": counts})
    if len(fronts) != TOPO_LEVELS or not err <= K1_TOL \
            or counts.get("segment_sum.rows", 0) < TOPO_LEVELS \
            or any(k.startswith("plain.") for k in counts):
        raise SystemExit(f"prop_nodes_topo failed: levels {len(fronts)}, "
                         f"rel err {err}, launches {counts}")
    return counts


def phase_tree_lstm(build, checks, dev):
    """The Tree-LSTM twin (examples/train_tree_lstm_torch.py) at hidden
    150, the h_size of DGL's examples/pytorch/tree_lstm, on the JAX
    example's synthetic trees: 3 epochs on the card, the first 5 losses
    against the CPU's from the same parameters (1e-5, relative).  Its
    mailbox and gates are torch: it launches none of the kernels."""
    twin = _load_twin("train_tree_lstm_torch")
    trees = twin.make_trees(60, 6, 3)
    params = twin.init_params(6, 150, 3, seed=0)
    build.LAUNCHES.reset()
    res = twin.train(trees, params, epochs=3, lr=1e-2, device=dev)
    counts = dict(build.LAUNCHES.counts)
    res_c = twin.train(trees, params, epochs=1, lr=1e-2, device="cpu",
                       max_steps=5)
    err = float(np.max(np.abs(np.subtract(res["losses"][:5],
                                          res_c["losses"]))
                       / np.abs(res_c["losses"])))
    steps = res["steps"]
    emit({"phase": "tree_lstm", "hidden": 150, "trees": len(trees),
          "steps": steps, "epoch_losses": res["epoch_losses"],
          "first_losses": res["losses"][:5],
          "first_losses_cpu": res_c["losses"], "loss_rel_err_vs_cpu": err,
          "train_time_s": res["train_time_s"],
          "ms_per_step": 1e3 * res["train_time_s"] / steps,
          "test_acc": res["test_acc"], "launches": counts,
          "note": "mailbox and LSTM gates in torch: no kernel of the "
                  "port is on this path"})
    if not err <= 1e-5 or counts or not \
            res["epoch_losses"][-1] < res["epoch_losses"][0]:
        raise SystemExit(f"tree_lstm failed: loss err {err}, launches "
                         f"{counts}, epoch losses {res['epoch_losses']}")


def _layer0_block(ds, fanouts=(10, 25), batch_size=1024):
    """The first training batch's layer-0 block and input rows, drawn as
    the sampled twin draws them (seed 0)."""
    from dgl_hack_tpu_torch.sampling import (MultiLayerNeighborSampler,
                                             NodeDataLoader)
    loader = NodeDataLoader(
        ds.graph, np.nonzero(ds.train_mask)[0],
        MultiLayerNeighborSampler(fanouts, replace=True, seed=0),
        batch_size, drop_last=True, seed=0)
    input_nodes, _, blocks = next(iter(loader))
    return blocks[0], input_nodes


def phase_sage_lstm_train(build, ds, checks, dev):
    """The sampled GraphSAGE twin with the lstm aggregator on full
    synthetic Reddit at the JAX example's widths (602 features, hidden 16,
    41 classes, fanouts 10,25, batch 1,024): 8 steps, evaluated on 2 test
    batches, with the per-step host sampling / copy / plans / device
    times, peak memory, the device's busy share over steps 3-5 of a run
    of its own (``_busy_share``) and the launches (the mailbox and the LSTM are
    torch: no kernel, nothing plain); then SAGEConv('lstm') at the layer-0
    block of the first batch, forward and gradients on the card against
    the CPU (LAYER_TOL), but for the rows of more in-edges than mailbox
    slots, whose last slot holds an edge the scatter picks."""
    from dgl_hack_tpu_torch.nn import SAGEConv
    twin = _load_twin()
    torch.manual_seed(0)
    reset_peak_memory()
    build.LAUNCHES.reset()
    t0 = time.perf_counter()
    res = twin.train(ds, aggregator="lstm", max_steps=8, eval_batches=2,
                     device=dev, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES.counts)
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    steady = {k: float(np.median(v[1:])) for k, v in res["times"].items()}
    profile = _busy_share(twin, ds, dev, steps=3, aggregator="lstm")
    blk, input_nodes = _layer0_block(ds)
    deg = blk.in_degrees()
    lens = deg.clamp(max=32)
    # a row of more than 32 in-edges (the padded copies of the last seed
    # in the dst set all map to one row) has several edges in its last
    # mailbox slot, and which one is left there is the scatter's choice
    # (build_mailbox): its row is left out of the comparison (its
    # cotangent 0, so it reaches no gradient either)
    over = deg > 32
    x_c = torch.from_numpy(ds.features[input_nodes]).requires_grad_()
    mod_c = SAGEConv(16, "lstm")
    torch.manual_seed(1)
    t1 = time.perf_counter()
    out_c = mod_c(blk, (x_c, x_c[:blk.num_dst_nodes]))
    cot = torch.from_numpy(np.random.default_rng(71).normal(
        size=tuple(out_c.shape)).astype(np.float32))
    cot[over] = 0.0
    (out_c * cot).sum().backward()
    cpu_s = time.perf_counter() - t1
    mod_d = copy.deepcopy(mod_c).to(dev)
    for p in mod_d.parameters():
        p.grad = None
    blk_d = blk.to(dev)
    x_d = x_c.detach().to(dev).requires_grad_()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_d = mod_d(blk_d, (x_d, x_d[:blk.num_dst_nodes]))
    (out_d * cot.to(dev)).sum().backward()
    torch.cuda.synchronize()
    layer_ms = 1e3 * (time.perf_counter() - t1)
    fwd = rel_err(out_d.detach().cpu()[~over], out_c.detach()[~over])
    if not fwd <= LAYER_TOL:
        checks.failures.append(f"SAGEConv(lstm) layer 0 forward: {fwd:.3g}")
    grad, worst = _grads_close(checks, "SAGEConv(lstm) layer 0", mod_d,
                               mod_c, x_d, x_c)
    emit({"phase": "sage_lstm_train", "steps": res["steps"],
          "losses": losses, "test_acc": res["test_acc"],
          "test_nodes": res["test_nodes"], "wall_s": wall,
          "median_ms_after_first": steady,
          "step_total_ms": sum(steady.values()),
          "first_step_ms": {k: v[0] for k, v in res["times"].items()},
          "peak_memory_bytes": peak, "launches": counts,
          "profile": profile,
          "layer0": {"num_src": blk.num_src_nodes,
                     "num_dst": blk.num_dst_nodes, "slots": blk.num_edges(),
                     "longest": int(lens.max()),
                     "empty_rows": int((lens == 0).sum()),
                     "live_slots": int(lens.sum()),
                     "overflow_rows": int(over.sum()),
                     "overflow_row_in_degrees": deg[over].tolist()[:4],
                     "fwd_rel_err_vs_cpu": fwd, "grad_rel_err_vs_cpu": grad,
                     "worst_grad": worst, "cpu_fwd_bwd_s": cpu_s,
                     "card_fwd_bwd_ms": layer_ms}})
    problems = []
    if res["steps"] != 8 or not all(np.isfinite(losses)):
        problems.append(f"{res['steps']} steps, losses {losses}")
    elif not np.mean(losses[-3:]) < np.mean(losses[:3]):
        problems.append(f"loss did not fall: {losses}")
    if any(k.startswith("plain.") for k in counts):
        problems.append(f"plain path ran on CUDA: {counts}")
    if problems:
        raise SystemExit("sage_lstm_train failed: " + "; ".join(problems))
    checks.raise_if_failed("sage_lstm_train")
    return counts


def _sampler_checks(native, csc, seeds, fanout, replace, seed):
    """The native picks of ``seeds`` against what they must be: each a real
    in-edge of its seed, min(fanout, degree) of them without replacement
    (none repeated) and fanout with it (0 for a seed without in-edges),
    the same picks again from the same seed."""
    indptr = csc.indptr
    pos, counts = native.rowwise_sample_native(indptr, csc.src, seeds,
                                               fanout, replace, seed)
    again = native.rowwise_sample_native(indptr, csc.src, seeds, fanout,
                                         replace, seed)
    deg = (indptr[seeds + 1] - indptr[seeds]).astype(np.int64)
    want = np.where(deg > 0, fanout, 0) if replace else np.minimum(deg,
                                                                   fanout)
    rows = np.repeat(np.arange(len(seeds)), counts)
    lo = indptr[seeds].astype(np.int64)[rows]
    hi = indptr[seeds + 1].astype(np.int64)[rows]
    ok = {"counts": bool((counts == want).all()),
          "real_in_edges": bool(((pos >= lo) & (pos < hi)).all()),
          "repeatable": bool(np.array_equal(again[0], pos)
                             and np.array_equal(again[1], counts))}
    if not replace:
        key = rows * np.int64(len(csc.src)) + pos
        ok["no_repeats"] = bool(len(np.unique(key)) == len(pos))
    return ok, int(len(pos)), int((deg == 0).sum())


def phase_native_sampler(ds):
    """The native host sampler (dgl_hack_tpu_torch/native/fastgraph.cpp,
    built with g++ into build/dgl_hack_tpu_torch/ at first use; which
    library, and whether with OpenMP) on full synthetic Reddit at the
    sampled GraphSAGE's two layer shapes: 1,024 training seeds at fanout
    25 (layer 1) and the 32,768 padded src nodes of their block at fanout
    10 (layer 0), with and without replacement.  Each pick must be a real
    in-edge of its seed, the counts min(fanout, degree) without
    replacement (no repeats) and fanout with it (0 for a seed without
    in-edges), and a second call with the seed must repeat the picks.
    The native call's host ms beside the plain numpy version's
    (``neighbor._pick_uniform_plain``).  A library that does not build
    fails the run: there is no other path."""
    from dgl_hack_tpu_torch import native
    from dgl_hack_tpu_torch.core.transform import to_block
    from dgl_hack_tpu_torch.sampling import neighbor
    t0 = time.perf_counter()
    native.get_lib()
    info = dict(native.BUILD_INFO)
    lib = os.path.relpath(info["path"], REPO)
    problems = []
    if not lib.startswith(os.path.join("build", "dgl_hack_tpu_torch", "")):
        problems.append(f"library built outside build/: {info['path']}")
    g = ds.graph
    csc = neighbor._get_csc(g)
    rng = np.random.default_rng(31)
    seeds1 = rng.choice(np.nonzero(ds.train_mask)[0], 1024, replace=False)
    frontier, _ = neighbor.sample_neighbors(g, seeds1, 25, replace=True,
                                            rng=rng)
    cap = len(seeds1) * 25
    _, seeds0, _ = to_block(frontier, seeds1, pad_num_edges=cap,
                            pad_num_src=neighbor._round_up_pow2(
                                len(seeds1) + cap))
    res = {}
    for name, seeds, fanout in (("layer1", seeds1, 25),
                                ("layer0", seeds0, 10)):
        seeds = np.asarray(seeds, np.int64)
        for replace in (True, False):
            key = f"{name}_{'replace' if replace else 'no_replace'}"
            ok, picks, zero = _sampler_checks(native, csc, seeds, fanout,
                                              replace, 12345)
            res[key] = {
                "seeds": len(seeds), "fanout": fanout, "picks": picks,
                "zero_degree_seeds": zero, "checks": ok,
                "native_ms": _host_ms(lambda: native.rowwise_sample_native(
                    csc.indptr, csc.src, seeds, fanout, replace, 7)),
                "plain_ms": _host_ms(lambda: neighbor._pick_uniform_plain(
                    csc, seeds, fanout, replace, np.random.default_rng(7)),
                    reps=3)}
            problems += [f"{key}: {k}" for k, v in ok.items() if not v]
    emit({"phase": "native_sampler", "library": lib,
          "openmp": info["openmp"], "build_s": info["seconds"],
          "host_cpus": os.cpu_count(), **res,
          "seconds": time.perf_counter() - t0})
    if problems:
        raise SystemExit("native_sampler failed: " + "; ".join(problems))


SAGE_BATCH = 1024              # the sampled twin's batch (its default)
POOL_SEEDS = 32 * SAGE_BATCH


def phase_prefetch(build, ds, dev, ref_losses):
    """The sampled GraphSAGE twin's mean loop through the prefetchers
    (``dgl_hack_tpu_torch.distributed``): ``ThreadedPrefetcher`` (capacity
    2) over the same loader as ``sage_sampling_mean``, whose losses it
    must repeat exactly (the same batches in the same order, each copied
    from pinned memory on the worker's stream), then ``PooledPrefetcher``
    with 2 and 4 workers over the first 32,768 training nodes (32
    batches), each worker over its own shard, which must train on every
    one of those nodes.  Per run: the step's parts (``sample_ms`` is the
    wait for the next prefetched batch) and the whole step, medians over
    the second half of the steps (the first drain what the workers
    queued while the model was set up), the device's busy share over
    five steps of a profiled run of its own after as many warm steps
    (2 threaded, 10 pooled), and the launches (K1, nothing plain)."""
    twin = _load_twin()
    train_nid = np.nonzero(ds.train_mask)[0]
    runs = (("thread", dict(prefetch="thread"), len(ref_losses), 2),
            ("pool2", dict(prefetch="pool", num_workers=2,
                           train_nids=train_nid[:POOL_SEEDS]), None, 10),
            ("pool4", dict(prefetch="pool", num_workers=4,
                           train_nids=train_nid[:POOL_SEEDS]), None, 10))
    counts, recs, problems = {}, {}, []
    for name, kw, steps, warm in runs:
        torch.manual_seed(0)
        build.LAUNCHES.reset()
        t0 = time.perf_counter()
        res = twin.train(ds, aggregator="mean", max_steps=steps,
                         eval_batches=0, device=dev, log=None, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = dict(build.LAUNCHES.counts)
        losses = res["losses"]
        per_step = [sum(p) for p in zip(*res["times"].values())]
        half = len(per_step) // 2
        rec = {"steps": res["steps"], "wall_s": wall,
               "median_ms_second_half": {
                   k: float(np.median(v[half:]))
                   for k, v in res["times"].items()},
               "step_ms": float(np.median(per_step[half:])),
               "step_ms_by_step": per_step, "losses": losses,
               "launches": c}
        if name == "thread":
            diff = [abs(a - b) for a, b in zip(losses, ref_losses)]
            rec["max_abs_loss_diff_vs_unprefetched"] = max(diff)
            if losses != ref_losses:
                problems.append(f"thread: losses differ from the "
                                f"unprefetched loop by up to {max(diff)}")
        else:
            rec["distinct_seeds"] = res["distinct_seeds"]
            rec["seeds"] = POOL_SEEDS
            shards = np.array_split(kw["train_nids"], kw["num_workers"])
            if res["distinct_seeds"] != POOL_SEEDS or res["steps"] != sum(
                    -(-len(sh) // SAGE_BATCH) for sh in shards):
                problems.append(f"{name}: {res['distinct_seeds']} of "
                                f"{POOL_SEEDS} seeds in {res['steps']} "
                                "steps")
        if not all(np.isfinite(losses)):
            problems.append(f"{name}: losses {losses}")
        if c.get("segment_sum.fwd", 0) <= 0:
            problems.append(f"{name}: K1 never launched")
        plain = {k: v for k, v in c.items() if k.startswith("plain.")}
        if plain:
            problems.append(f"{name}: plain path ran on CUDA: {plain}")
        rec["profile"] = _busy_share(twin, ds, dev, warm=warm, **kw)
        recs[name] = rec
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    emit({"phase": "prefetch", **recs})
    if problems:
        raise SystemExit("prefetch failed: " + "; ".join(problems))
    return counts


def _nodeflow_run(nf, x, cot, how):
    """prop_flow with copy_u and the ``how`` builtin from the parent
    features ``x`` (requiring grad), then the backward of <out, cot>:
    returns the seed layer's output and x's gradient."""
    from dgl_hack_tpu_torch import fn
    x = x.detach().clone().requires_grad_(True)
    nf.copy_from_parent({"h": x})
    nf.prop_flow(fn.copy_u("h", "m"), getattr(fn, how)("m", "h"))
    out = nf.layers(nf.num_layers - 1)["h"]
    (grad,) = torch.autograd.grad((out * cot).sum(), [x])
    return out.detach(), grad


def phase_nodeflow(build, ds, dev):
    """``NodeFlow`` over the sampled GraphSAGE's blocks on full synthetic
    Reddit (1,024 training seeds, fanouts 10 and 25, drawn with
    replacement by ``NodeFlow.from_sampler`` onto the card) at F = 602:
    ``prop_flow`` with copy_u and mean (K1 forward, K1 dx backward) and
    with max (K4, K5), forward and the gradient of the parent features,
    against the same NodeFlow's blocks on the CPU (<= 1e-4 of max|ref|,
    ``LAYER_TOL``; the max forward exactly), each block's
    ``block_compute`` timed (CUDA events), the launches (no plain path)."""
    from dgl_hack_tpu_torch import fn
    from dgl_hack_tpu_torch.sampling import (MultiLayerNeighborSampler,
                                             NodeFlow)
    seeds = np.nonzero(ds.train_mask)[0][:1024]
    nf = NodeFlow.from_sampler(ds.graph, seeds, MultiLayerNeighborSampler(
        (10, 25), replace=True, seed=0), device=dev)
    ids = [nf.layer_parent_nid(i) for i in range(nf.num_layers)]
    nf_cpu = NodeFlow([b.to("cpu") for b in nf.blocks], ids)
    x = torch.from_numpy(ds.features)
    x_dev = x.to(dev)
    cot = torch.from_numpy(np.random.default_rng(41).normal(
        size=(len(seeds), x.shape[1])).astype(np.float32))
    rec = {"layers": [len(i) for i in ids],
           "block_edges": [b.num_edges() for b in nf.blocks],
           "real_edges": [nf.block_size(i) for i in range(nf.num_blocks)],
           "F": int(x.shape[1])}
    counts, problems = {}, []
    for how in ("mean", "max"):
        build.LAUNCHES.reset()
        out, grad = _nodeflow_run(nf, x_dev, cot.to(dev), how)
        torch.cuda.synchronize()
        c = dict(build.LAUNCHES.counts)
        ref, gref = _nodeflow_run(nf_cpu, x, cot, how)
        err = {"fwd": rel_err(out.cpu(), ref), "dx": rel_err(grad.cpu(),
                                                              gref)}
        tol = 0.0 if how == "max" else LAYER_TOL
        if not (err["fwd"] <= tol and err["dx"] <= LAYER_TOL) or \
                not bool(torch.isfinite(out).all()):
            problems.append(f"{how}: {err} against the CPU")
        need = ("segment_sum.fwd",) if how == "mean" else \
            ("segment_max.fwd", "segment_max.bwd")
        problems += [f"{how}: {k} never launched" for k in need
                     if c.get(k, 0) <= 0]
        plain = {k: v for k, v in c.items() if k.startswith("plain.")}
        if plain:
            problems.append(f"{how}: plain path ran on CUDA: {plain}")
        msg, red = fn.copy_u("h", "m"), getattr(fn, how)("m", "h")
        with torch.no_grad():
            block_ms = [cuda_ms(lambda b=b: nf.block_compute(b, msg, red),
                                reps=5) for b in range(nf.num_blocks)]
        rec[how] = {"rel_err_vs_cpu": err, "launches": c,
                    "block_ms": block_ms}
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    del nf, nf_cpu, x_dev
    torch.cuda.empty_cache()
    emit({"phase": "nodeflow", **rec})
    if problems:
        raise SystemExit("nodeflow failed: " + "; ".join(problems))
    return counts


def _twin_checks(name, losses, c, need=("segment_sum.fwd",), window=3):
    """Problems of a twin's run: losses not finite or not falling (the
    mean of the last ``window`` below the first's), a kernel of ``need``
    never launched, a plain path on the card."""
    problems = []
    if not losses or not all(np.isfinite(losses)):
        problems.append(f"losses {losses}")
    elif not np.mean(losses[-window:]) < np.mean(losses[:window]):
        problems.append(f"loss did not fall: {losses}")
    problems += [f"{k} never launched" for k in need if c.get(k, 0) <= 0]
    plain = {k: v for k, v in c.items() if k.startswith("plain.")}
    if plain:
        problems.append(f"plain path ran on CUDA: {plain}")
    if problems:
        raise SystemExit(f"{name} failed: " + "; ".join(problems))


def phase_pinsage_rec(build, dev):
    """The PinSAGE recommendation twin (examples/train_pinsage_rec_torch.py)
    at MovieLens-1M's counts (6,040 users, 3,706 items; the twin's
    latent-factor stand-in, 12 items a user) and its other defaults
    (hidden 64, 20 walks, 8 neighbors, 60 epochs, lr 3e-2): the
    PinSAGESampler's host seconds, the epoch ms (gspmm u_mul_e with an
    (E, 1) weight and copy_rhs, both K1), the loss falling, HITS@10 and
    MRR, peak memory and the launches."""
    twin = _load_twin("train_pinsage_rec_torch")
    t0 = time.perf_counter()
    data = twin.synth_movielens(6040, 3706)
    data_s = time.perf_counter() - t0
    built = twin.build(data, num_walks=20, num_neighbors=8)
    reset_peak_memory()
    build.LAUNCHES.reset()
    res = twin.train(built, twin.init_params(built["num_items"], 64),
                     epochs=60, lr=3e-2,
                     num_negs=4, device=dev, log=None)
    torch.cuda.synchronize()
    c = dict(build.LAUNCHES.counts)
    hits10, mrr = twin.evaluate(built, res, data[2], data[3], 100)
    losses = res["losses"]
    emit({"phase": "pinsage_rec", "users": 6040, "items": 3706,
          "train_pairs": int(len(data[0])),
          "item_graph_edges": built["gi"].num_edges(), "data_s": data_s,
          "sampler_s": built["sample_s"],
          "epoch_ms_median_after_first": float(np.median(
              res["epoch_ms"][1:])), "first_epoch_ms": res["epoch_ms"][0],
          "losses_every_10": losses[::10] + [losses[-1]], "hits10": hits10,
          "mrr": mrr, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": c})
    _twin_checks("pinsage_rec", losses, c, window=5)
    return c


def phase_sage_cv(build, dev):
    """The GraphSAGE control-variate twin (examples/train_sage_cv_torch.py)
    at its CLI defaults on the card: a 2,000-node planted partition, fanouts
    (2, 2), batches of 128, hidden 16, 15 epochs; gspmm mean over padded
    blocks (K1 through the real-edge view) and full-graph inference (K1);
    per-step host (sampling, exact history means) and device ms, the
    losses, test accuracy and the launches."""
    from dgl_hack_tpu_torch.data import planted_partition
    twin = _load_twin("train_sage_cv_torch")
    ds = planted_partition(2000, 5, 32, avg_degree=10.0, homophily=0.85,
                           feat_noise=1.5, seed=0, train_per_class=60,
                           num_val=100, num_test=400)
    build.LAUNCHES.reset()
    res = twin.train(ds, twin.init_params([32, 16, ds.num_classes], 0),
                     device=dev)
    torch.cuda.synchronize()
    c = dict(build.LAUNCHES.counts)
    losses = res["losses"]
    emit({"phase": "sage_cv", "steps": len(losses),
          "losses_first_last": [losses[:3], losses[-3:]],
          "test_acc": res["test_acc"],
          "median_ms_after_first": {k: float(np.median(v[1:]))
                                    for k, v in res["times"].items()},
          "launches": c})
    _twin_checks("sage_cv", losses, c)
    return c


def phase_adaptive_sampling(build, dev):
    """The adaptive-sampling GCN twin
    (examples/train_adaptive_sampling_torch.py) at its CLI defaults on the
    card: synthetic Cora, 150 epochs of batches of 256 with 256 sampled
    nodes a layer, hidden 32; the sampled layers a segment_reduce sum
    (torch's index_add, as the JAX example's segment sum is XLA's), the
    full-graph evaluation gspmm mean (K1); per-epoch host and device ms,
    the losses, test accuracy and the launches."""
    from dgl_hack_tpu_torch.data import synthetic_cora
    twin = _load_twin("train_adaptive_sampling_torch")
    build.LAUNCHES.reset()
    res = twin.train(synthetic_cora(), device=dev, log=None)
    torch.cuda.synchronize()
    c = dict(build.LAUNCHES.counts)
    losses = res["losses"]
    emit({"phase": "adaptive_sampling", "epochs": len(losses),
          "losses_first_last": [losses[:5], losses[-5:]],
          "test_acc": res["test_acc"], "train_s": res["train_s"],
          "median_ms_after_first": {k: float(np.median(v[1:]))
                                    for k, v in res["times"].items()},
          "launches": c})
    _twin_checks("adaptive_sampling", losses, c, window=10)
    return c


# ---------------------------------------------------------------------------
# bf16 storage (K1, K4, K5) and the dense-hub hybrid
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16


def bf16_ulp(v):
    """One bf16 ulp (8 significant bits) at each |v|, in float64."""
    a = v.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bf16_err(out, ref, tol=K1_TOL):
    """max over elements of |out - ref| / (one bf16 ulp at the larger of
    the two + tol * max|ref|): <= 1 is ``BF16_ULPS``'s pass."""
    if not ref.numel():
        return 0.0
    o, r = out.double(), ref.double()
    allow = bf16_ulp(torch.maximum(o.abs(), r.abs())) + tol * float(
        r.abs().max())
    return float(((o - r).abs() / allow).max())


def bf16_check(checks, kernel, what, out, ref, again, tol=K1_TOL):
    """A bf16 result rounded once (``BF16_ULPS``): within one bf16 ulp of
    the float64 result of the same bf16 values, plus the float32 kernel's
    own tolerance (``tol`` of max|ref|: K1_TOL for the order of the
    float32 sums; GAT_TOL, K6_DOT_TOL, K6_BWD_TOL for K2/K3 and K6);
    repeated bitwise."""
    out, ref = out.detach(), ref.detach()
    err = bf16_err(out, ref, tol)
    checks.max_abs[kernel] = max(checks.max_abs.get(kernel, 0.0),
                                 abs_err(out.double(), ref.double()))
    if not (err <= BF16_ULPS) or not bool(out.isfinite().all()):
        checks.failures.append(f"{kernel} {what}: {err:.3g} bf16 ulps")
    if not bool((out == again).all()):
        checks.failures.append(f"{kernel} {what}: not bitwise repeatable")
    return err


def bf16_library_ms(call):
    """ms of a library call on bf16 data, or torch's message where it does
    not take bf16 (timed only)."""
    try:
        return cuda_ms(call, reps=5)
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        return f"torch raised: {str(exc).splitlines()[0][:160]}"


def bf16_csr_mm_ms(A32, x):
    """torch.sparse.mm over a bf16 copy of the CSR matrix A32 and bf16 x
    (``bf16_library_ms``)."""
    A = torch.sparse_csr_tensor(A32.crow_indices(), A32.col_indices(),
                                A32.values().to(BF16), size=A32.shape)
    return bf16_library_ms(lambda: torch.sparse.mm(A, x))


def _bf16_k1_cases(sk, g, F, checks, tag, rng, modes=("fwd", "rev", "edge"),
                   weights=True):
    """K1 over bf16 x in each mode, with no weight, an (E,) and an (E, F)
    float32 weight and an (E,) bf16 one, against its plain version in
    float64 (``bf16_check``), and with a float32 result (out_dtype)
    against it within K1_TOL."""
    dev, E = g.device, g.num_edges()
    ins = {"fwd": (g.num_src_nodes, dict(indptr=g.csc_indptr, gidx=g.src)),
           "rev": (g.num_dst_nodes, dict(indptr=g.csr_indptr,
                                         gidx=sk.rev_gidx(g),
                                         eid=g.csr_eids)),
           "edge": (E, dict(indptr=g.csc_indptr))}
    ws = [("none", None)]
    if weights:
        w1 = torch.from_numpy(rng.normal(size=(E,)).astype(np.float32))
        ws += [("scalar", w1.to(dev)), ("scalar_bf16", w1.to(dev, BF16)),
               ("full", torch.from_numpy(rng.normal(size=(E, F)).astype(
                   np.float32)).to(dev))]
    errs = {}
    for d in modes:
        rows, args = ins[d]
        x = torch.from_numpy(rng.normal(size=(rows, F)).astype(np.float32)
                             ).to(dev, BF16)
        for kind, w in ws:
            out = sk.segment_sum(x=x, w=w, site=d, **args)
            ref = sk.segment_sum_plain(x=x.double(), w=None if w is None
                                       else w.double(), **args)
            errs[f"{d}.{kind}"] = bf16_check(
                checks, "segment_sum_bf16", f"{tag} F={F} {d} w={kind}", out,
                ref, sk.segment_sum(x=x, w=w, site=d, **args))
            if kind == "none":
                o32 = sk.segment_sum(x=x, site=d, out_dtype=torch.float32,
                                     **args)
                errs[f"{d}.f32_out"] = checks.compare(
                    "segment_sum_bf16", f"{tag} F={F} {d} f32 out", o32,
                    ref.float(), K1_TOL,
                    sk.segment_sum(x=x, site=d, out_dtype=torch.float32,
                                   **args))
                if o32.dtype != torch.float32:
                    checks.failures.append(f"{tag}: out_dtype not float32")
    return errs


def _bf16_k4k5_case(sm, sk, g, x, w, gout, checks, what, x_bwd=None):
    """K4 over bf16 x against its plain version, exactly; K5 against its
    plain version: exactly where gout holds small integers and there is
    no weight (every sum exact), else ``bf16_check`` against the float64
    plain version (dw against it within K5_TOL).  Returns raw."""
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    fwd = (g.csc_indptr, x, g.src, w)
    raw = sm.segment_max(*fwd, plan=p_fwd)
    checks.exact("segment_max_bf16", what, raw, sm.segment_max_plain(*fwd),
                 sm.segment_max(*fwd, plan=p_fwd))
    args = (g.csr_indptr, sk.rev_gidx(g), g.csr_eids,
            x if x_bwd is None else x_bwd, w, raw, gout)
    dx, dw = sm.segment_max_bwd(*args, plan=p_rev)
    dx2, dw2 = sm.segment_max_bwd(*args, plan=p_rev)
    if w is None:
        checks.exact("segment_max_bwd_bf16", f"{what} dx", dx,
                     sm.segment_max_bwd_plain(*args)[0], dx2)
    else:
        rdx, rdw = sm.segment_max_bwd_plain(*args, acc_dtype=torch.float64)
        bf16_check(checks, "segment_max_bwd_bf16", f"{what} dx", dx, rdx,
                   dx2)
        checks.compare("segment_max_bwd_bf16", f"{what} dw", dw, rdw.float(),
                       K5_TOL, dw2)
    return raw


def _int_cotangent(rng, shape, dev):
    """A bf16 cotangent of small integers: K5's sums of it are exact."""
    return torch.from_numpy(rng.integers(-4, 5, size=shape).astype(
        np.float32)).to(dev, BF16)


def _bf16_sweeps(sk, sm, g, x, gout, raw, xb, vecs=(), slices=()):
    """ms of K1 forward and dx, K4 and K5 over bf16 rows at each load width
    of ``vecs`` (values a lane loads; at the rule's slice width) and at
    each slice width of ``slices`` (at the rule's load width): what
    ``SUM_MAX_VALUES`` and ``SLICE_MIN_REUSE`` rest on."""
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    dst_csr = sk.rev_gidx(g)
    launchers = {
        "k1": sk.segment_sum_launcher(g.csc_indptr, x, g.src, plan=p_fwd),
        "k1_dx": sk.segment_sum_launcher(g.csr_indptr, gout, dst_csr,
                                         g.csr_eids, plan=p_rev),
        "k4": sm.segment_max_launcher(g.csc_indptr, x, g.src, plan=p_fwd),
        "k5": sm.segment_max_bwd_launcher(g.csr_indptr, dst_csr, g.csr_eids,
                                          xb, None, raw, gout, plan=p_rev)}
    res = {}
    for name, launch in launchers.items():
        rec = {f"vec{v}": cuda_ms(lambda: launch(None, v), reps=5)
               for v in vecs}
        rec.update({f"slice{c}": cuda_ms(lambda: launch(c), reps=5)
                    for c in slices})
        res[name] = rec
    return res


def _bf16_timings(sk, sm, g, x, gout, shape, cols=None):
    """K1 forward and dx, K4 and K5 over bf16 x on g, each timed beside
    its plain version and the float32 kernel on the same shape (float32
    copies of x and gout), with its bound at bf16 widths (``cols``: the
    function's columns where x is padded) and, for K1,
    torch.sparse.mm on a bf16 CSR."""
    E, F = g.num_edges(), x.shape[1]
    cols = cols or F
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    dst_csr = sk.rev_gidx(g)
    x32, g32 = x.float(), gout.float()
    rows = lambda *a: sum(2 * t.shape[0] * cols for t in a)    # noqa: E731
    res = {}
    fwd = (g.csc_indptr, x, g.src)
    rev = (g.csr_indptr, gout, dst_csr, g.csr_eids)
    for name, args, f32args, plan, idx, arrays in (
            ("k1_fwd", fwd, (g.csc_indptr, x32, g.src), p_fwd,
             (g.csc_indptr, g.src), (x, gout)),
            ("k1_dx", rev, (g.csr_indptr, g32, dst_csr, g.csr_eids), p_rev,
             (g.csr_indptr, dst_csr), (gout, x))):
        site = "fwd" if name == "k1_fwd" else "rev"
        rec = timing(
            both_ms(lambda: sk.segment_sum(*args, site=site, plan=plan)),
            cuda_ms(lambda: sk.segment_sum_plain(*args), reps=3),
            nbytes(*idx) + rows(*arrays), E * cols, shape + f", {name}")
        rec["f32_ms"] = cuda_ms(lambda: sk.segment_sum(*f32args, site=site,
                                                       plan=plan))
        A = csr_matrix(g, reverse=name == "k1_dx")
        rec["library_ms"] = bf16_csr_mm_ms(A, args[1])
        rec["library_f32_ms"] = cuda_ms(
            lambda: torch.sparse.mm(A, f32args[1]), reps=5)
        del A
        res[name] = rec
    raw = sm.segment_max(g.csc_indptr, x, g.src, plan=p_fwd)
    raw32 = sm.segment_max(g.csc_indptr, x32, g.src, plan=p_fwd)
    xb = x[:, :cols].contiguous() if cols < F else x
    k4 = timing(
        both_ms(lambda: sm.segment_max(g.csc_indptr, x, g.src, plan=p_fwd)),
        cuda_ms(lambda: sm.segment_max_plain(g.csc_indptr, x, g.src),
                reps=3),
        nbytes(g.csc_indptr, g.src) + rows(x, raw), E * cols,
        shape + ", k4")
    k4["f32_ms"] = cuda_ms(lambda: sm.segment_max(g.csc_indptr, x32, g.src,
                                                  plan=p_fwd))
    rev5 = (g.csr_indptr, dst_csr, g.csr_eids, xb, None, raw, gout)
    rev5_32 = (g.csr_indptr, dst_csr, g.csr_eids, xb.float(), None, raw32,
               g32)
    k5 = timing(
        both_ms(lambda: sm.segment_max_bwd(*rev5, plan=p_rev)),
        cuda_ms(lambda: sm.segment_max_bwd_plain(*rev5), reps=3),
        nbytes(g.csr_indptr, dst_csr) + rows(xb, raw, gout, xb),
        2 * E * cols, shape + ", k5")
    k5["f32_ms"] = cuda_ms(lambda: sm.segment_max_bwd(*rev5_32, plan=p_rev))
    res.update(k4=k4, k5=k5)
    if F % 8 == 0:
        res["vec_sweep"] = _bf16_sweeps(sk, sm, g, x, gout, raw, xb,
                                        vecs=(8, 4, 2))
    return res


def _launched(counts, name):
    """Launches of kernel ``name`` in a LAUNCHES snapshot, over its sites
    (``name`` itself or ``name.<site>``)."""
    return sum(v for k, v in counts.items()
               if k == name or k.startswith(name + "."))


def _bf16_reaches_kernels(dt, build, g, rng):
    """K2/K3 (GAT) and K6 (gSDDMM) take bf16 rows: a bf16 gat_attention
    forward and backward and a bf16 gsddmm dot forward and backward on the
    card raise nothing and reach the bf16 kernels.  Returns each kernel's
    launches in those calls, and the plain launches (none expected)."""
    from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk
    N, H, D = g.num_src_nodes, 2, 8
    z = torch.from_numpy(rng.normal(size=(N, H, D)).astype(np.float32)).to(
        g.device, BF16).requires_grad_(True)
    a = torch.zeros((N, H), device=g.device, dtype=BF16)
    before = dict(build.LAUNCHES.counts)
    gk.gat_attention_fused(g, z, a, a).float().sum().backward()
    dt.gsddmm(g, "dot", z, z.detach(), "u", "v").float().sum().backward()
    torch.cuda.synchronize()
    after = build.LAUNCHES.counts
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    res = {n: _launched(delta, n)
           for n in ("gat_fwd_bf16", "gat_bwd_bf16", "sddmm_bf16")}
    res["plain"] = sum(v for k, v in delta.items() if k.startswith("plain."))
    return res


def phase_bf16_kernels(dt, build, sk, sm, g_small, gb, checks, dev,
                       timings):
    """K1, K4 and K5 over bf16 rows (``bf16_kernels``): every K1 mode and
    weight kind at F = 7 and 1 on the small graph (hub in pieces) and at
    bench.py's graph (F = 128) with its times; K4/K5 at both, exact; K1's
    edge-row mode at the GIN readout (1,024 graphs of 24 nodes, F = 32);
    and every kernel on the masked layer-0 block through the real-edge
    view (F = 602, as the sampled GraphSAGE runs it); and that bf16 calls
    of K2/K3 and K6 reach their bf16 kernels (``_bf16_reaches_kernels``)."""
    rng = np.random.default_rng(21)
    errs = {}
    for F in (7, 1):
        errs[f"small.F{F}"] = _bf16_k1_cases(sk, g_small, F, checks, "small",
                                             rng)
        x = torch.from_numpy(rng.normal(size=(g_small.num_src_nodes, F))
                             .astype(np.float32)).to(dev, BF16)
        for kind, w in _k4k5_weights(g_small, F, rng):
            gout = _int_cotangent(rng, (g_small.num_dst_nodes, F), dev)
            _bf16_k4k5_case(sm, sk, g_small, x, w, gout, checks,
                            f"small F={F} w={kind}")
    errs["bench.F128"] = _bf16_k1_cases(sk, gb, 128, checks, "bench", rng,
                                        modes=("fwd", "rev"), weights=False)
    x = torch.from_numpy(rng.normal(size=(gb.num_src_nodes, 128)).astype(
        np.float32)).to(dev, BF16)
    gout = _int_cotangent(rng, (gb.num_dst_nodes, 128), dev)
    _bf16_k4k5_case(sm, sk, gb, x, None, gout, checks, "bench F=128")
    t_bench = _bf16_timings(sk, sm, gb, x, gout, "bench.py graph, F=128")
    timings["segment_sum_bf16"] = t_bench["k1_fwd"]
    del x, gout
    seg = sk.segments([24] * 1024, dev)
    xr = torch.from_numpy(rng.normal(size=(seg.ids.numel(), 32)).astype(
        np.float32)).to(dev, BF16)
    out = sk.segment_sum_rows(xr, seg)
    errs["rows.gin_readout"] = bf16_check(
        checks, "segment_sum_bf16", "GIN readout rows", out,
        sk.segment_sum_plain(seg.indptr, xr.double()),
        sk.segment_sum_rows(xr, seg))
    lengths = (seg.indptr[1:] - seg.indptr[:-1]).long()
    rows_t = timing(
        both_ms(lambda: sk.segment_sum_rows(xr, seg)),
        cuda_ms(lambda: sk.segment_sum_plain(seg.indptr, xr), reps=3),
        nbytes(seg.indptr, xr, out), xr.numel(),
        "readout 1,024 x 24, F=32, bf16",
        library_ms=bf16_library_ms(lambda: torch.segment_reduce(
            xr, "sum", lengths=lengths)))
    rows_t["f32_ms"] = cuda_ms(lambda: sk.segment_sum_rows(xr.float(), seg))
    mb = _masked_block(dt, dev, np.random.default_rng(22))
    view = sk.real_edges(mb).graph
    xm = torch.relu(torch.from_numpy(rng.normal(size=(
        view.num_src_nodes, 602)).astype(np.float32))).to(dev, BF16)
    gm = _int_cotangent(rng, (view.num_dst_nodes, 602), dev)
    errs["masked"] = _bf16_k1_cases(sk, view, 602, checks, "masked", rng,
                                    modes=("fwd", "rev"), weights=False)
    _bf16_k4k5_case(sm, sk, view, xm, None, gm, checks, "masked F=602")
    t_masked = _bf16_timings(sk, sm, view, xm, gm,
                             "masked layer-0 block, F=602")
    t_masked["slice_sweep"] = _bf16_sweeps(
        sk, sm, view, xm, gm, sm.segment_max(view.csc_indptr, xm, view.src),
        xm, slices=(16, 64, 602))
    reached = _bf16_reaches_kernels(dt, build, g_small, rng)
    if reached["plain"] or not all(reached[k] > 0 for k in (
            "gat_fwd_bf16", "gat_bwd_bf16", "sddmm_bf16")):
        checks.failures.append(f"bf16 on K2/K3/K6 did not reach the bf16 "
                               f"kernels: {reached}")
    emit({"phase": "bf16_kernels", "err": errs, "bench": t_bench,
          "gin_readout_rows": rows_t, "masked": t_masked,
          "k2_k3_k6_bf16_launches": reached,
          "ulp_rule": "bf16 sums within 1 ulp + K1_TOL*max|ref| of float64"})
    del xm, gm, mb, view
    checks.raise_if_failed("bf16_kernels")


def phase_bf16_reddit(dt, sk, sm, g, checks, dev, timings):
    """K1, K4 and K5 over bf16 rows at synthetic Reddit's F = 602 as
    GspmmSum and GspmmMax run them: x and the cotangent padded to 640
    columns (64 bf16 columns a line), K5's x and dx at 602; checked,
    timed beside the float32 kernels at the same padded width; then the
    main path of K4/K5 in bf16: gspmm max (GraphSAGE-pool's aggregation at
    layer 0) forward and backward through ``dt.gspmm``, launches
    counted."""
    rng = np.random.default_rng(23)
    N, F = g.num_src_nodes, 602
    Fp = sk.padded_width(N, F, None, 2)
    x = torch.relu(torch.from_numpy(rng.normal(size=(N, F)).astype(
        np.float32))).to(dev, BF16)
    gout = _int_cotangent(rng, (N, F), dev)
    xp, gp = sk.pad_columns(x, Fp), sk.pad_columns(gout, Fp)
    _bf16_k4k5_case(sm, sk, g, xp, None, gp, checks,
                    f"reddit F={F} padded to {Fp}", x_bwd=x)
    fwd = (g.csc_indptr, xp, g.src)
    plan = sk.graph_row_plan(g, "csc")
    err = bf16_check(checks, "segment_sum_bf16", f"reddit F={Fp} fwd",
                     sk.segment_sum(*fwd, plan=plan),
                     sk.segment_sum_plain(g.csc_indptr, xp.double(), g.src),
                     sk.segment_sum(*fwd, plan=plan))
    t = _bf16_timings(sk, sm, g, xp, gp,
                      f"synthetic Reddit, F={F} padded to {Fp}", cols=F)
    t["slice_width_rule"] = sk.slice_width(N, F, False, 2)
    timings["segment_max_bf16"], timings["segment_max_bwd_bf16"] = \
        t["k4"], t["k5"]
    del xp, gp
    torch.cuda.empty_cache()
    reset_peak_memory()
    xg = x.clone().requires_grad_()
    sk.LAUNCHES.reset()
    out = dt.gspmm(g, "copy_lhs", "max", xg)
    (out.float() * gout.float()).sum().backward()
    torch.cuda.synchronize()
    counts = dict(sk.LAUNCHES.counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if counts.get("segment_max_bf16.fwd", 0) < 1 or \
            counts.get("segment_max_bf16.bwd", 0) < 1 or \
            any(k.startswith("plain.") for k in counts) or \
            out.dtype != BF16 or xg.grad.dtype != BF16 or \
            not bool(out.isfinite().all()):
        checks.failures.append(f"bf16 gspmm max main path: launches {counts}"
                               f", dtypes {out.dtype} {xg.grad.dtype}")
    emit({"phase": "bf16_reddit", "padded_width": Fp, "k1_fwd_err": err,
          "timings": t, "gspmm_max_launches": counts, "peak_gb": peak,
          "hybrid_default_reddit": default_windows(sk, g)})
    del x, gout, xg, out
    torch.cuda.empty_cache()
    checks.raise_if_failed("bf16_reddit")
    return counts


HEADLINE_KNOBS = dict(te=64, weighted=False, flat=True,
                      dense_threshold=28_000, dense_budget=6 << 30,
                      bucket_rows=None)      # bench.py's prepare_spmm
HEADLINE_K = (2, 12)


def _headline_loop(dt, g, x, iters):
    """bench.py's loop: ``iters`` chained gspmm(copy_lhs, sum) * 1e-3,
    ending in one readback; host seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = x
    for _ in range(iters):
        h = dt.gspmm(g, "copy_lhs", "sum", h) * 1e-3
    float(h[0, 0])
    return time.perf_counter() - t0


def _headline_ms(dt, g, x):
    """bench.py's timing: the best of 3 runs at K = 12 and at K = 2 after
    a warm run each, and their difference over 10 iterations; ms an
    iteration."""
    best = {}
    for k in HEADLINE_K:
        _headline_loop(dt, g, x, k)
        best[k] = min(_headline_loop(dt, g, x, k) for _ in range(3))
    lo, hi = HEADLINE_K
    return 1e3 * (best[hi] - best[lo]) / (hi - lo)


def phase_headline(dt, sk, gb, checks, dev):
    """bench.py's headline loop on the port (``headline``): the graph of
    bench.py (random_power_law_graph(1M, 16, alpha 2.1, seed 0)) prepared
    as bench.py prepares it (the dense-hub hybrid at threshold 28,000,
    budget 6 GB), with the port's default threshold (when it picks a
    window) and with dense_hub=False (K1 alone), each in float32 and with
    a bf16 carry: edges/s, the share of the compulsory-byte bound (x read
    and the result written once an iteration, the CSC indices) at 3.35
    TB/s, dense windows and rows, C's bytes and build ms, and peak memory
    (``loop_gb``: above what was resident before the loop); one iteration
    of each hybrid held against K1 alone."""
    E, N, F = gb.num_edges(), gb.num_src_nodes, 128
    preps = {"k1": dt.prepare_spmm(gb, dense_hub=False)}
    info = {}
    for name, knobs in (("hybrid", HEADLINE_KNOBS), ("default", {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = dt.prepare_spmm(gb, **knobs)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        hyb = g.derived.get("hybrid")
        if hyb is None:
            info[name] = {"dense_windows": 0}
            continue
        t0 = time.perf_counter()
        sk._build_dense_C(gb, hyb.windows.cpu().numpy(), hyb.tr)
        torch.cuda.synchronize()
        info[name] = {"dense_windows": int(hyb.windows.numel()),
                      "dense_rows": int(hyb.rows.numel()),
                      "dense_edges": E - hyb.rem.num_edges(),
                      "C_bytes": nbytes(hyb.C),
                      "C_build_ms": 1e3 * (time.perf_counter() - t0),
                      "prepare_s": prep_s}
        preps[name] = g
    if "hybrid" not in preps:
        raise SystemExit("headline failed: bench.py's knobs built no hybrid")
    x32 = torch.from_numpy(np.random.default_rng(0).normal(size=(N, F))
                           .astype(np.float32)).to(dev)
    res, launches = {}, {}
    for dtype in (torch.float32, BF16):
        x = x32.to(dtype)
        tag = "f32" if dtype == torch.float32 else "bf16"
        with torch.no_grad():
            one_k1 = dt.gspmm(preps["k1"], "copy_lhs", "sum", x)
            for name, g in preps.items():
                if name == "k1":
                    continue
                one = dt.gspmm(g, "copy_lhs", "sum", x)
                if dtype == torch.float32:
                    err = rel_err(one.double(), one_k1.double())
                    ok = err <= HYBRID_TOL
                else:
                    err = bf16_err(one, one_k1.double())
                    ok = err <= BF16_ULPS
                res[f"one_iter_err.{name}.{tag}"] = err
                if not ok or one.dtype != dtype:
                    checks.failures.append(
                        f"headline {name} {tag}: vs K1 alone {err:.3g}")
                del one
        del one_k1
        bound_ms = bound(2 * N * F * x.element_size()
                         + nbytes(gb.csc_indptr, gb.src), E * F)[0]
        for name, g in preps.items():
            reset_peak_memory()
            base = torch.cuda.memory_allocated()
            sk.LAUNCHES.reset()
            with torch.no_grad():
                ms = _headline_ms(dt, g, x)
            launches[f"{name}.{tag}"] = dict(sk.LAUNCHES.counts)
            res[f"{name}.{tag}"] = {
                "ms_per_iter": ms, "edges_per_s": E / (ms * 1e-3),
                "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "loop_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    emit({"phase": "headline", "nodes": N, "edges": E, "F": F,
          "knobs": dict(HEADLINE_KNOBS), "prepared": info, "runs": res,
          "launches": launches,
          "err_rule": "f32: rel 1e-5; bf16: 1 ulp + K1_TOL*max"})
    checks.raise_if_failed("headline")
    for key, counts in launches.items():
        name = "segment_sum_bf16" if key.endswith("bf16") else "segment_sum"
        if counts.get(f"{name}.fwd", 0) < 1 or any(
                k.startswith("plain.") for k in counts):
            raise SystemExit(f"headline {key}: launches {counts}")
    return preps["hybrid"], launches


def default_windows(sk, g, tr=128):
    """The port's default breakeven on g: its threshold, the windows it
    picks and the most edges any window of ``tr`` dst rows holds."""
    ip = g.host("csc_indptr")
    W = -(-g.num_dst_nodes // tr)
    b = np.minimum(np.arange(W + 1) * tr, g.num_dst_nodes)
    return {"threshold": sk._dense_breakeven(g.num_src_nodes, tr),
            "windows": int(sk.select_dense_windows(
                ip, g.num_src_nodes, g.num_dst_nodes, tr).size),
            "max_window_edges": int(np.max(ip[b[1:]] - ip[b[:-1]]))}


def phase_hybrid(dt, sk, gb, gh, checks, dev):
    """gspmm_hybrid forward and backward against K1 alone at bench.py's
    shape (``hybrid``), in float32 and bf16, with each part's ms: the
    remainder's K1, the dense product, the add at the dense rows; in the
    backward the remainder's K1 dx, Cᵀ g and the add.  Then the inputs of
    the port's default breakeven (K1's ns an edge, the float32 product's
    rate) as this run measured them, and the windows the default picks on
    this graph (``bf16_reddit`` prints synthetic Reddit's)."""
    hyb = gh.derived["hybrid"]
    rem = hyb.rem
    N, F, E = gb.num_src_nodes, 128, gb.num_edges()
    rng = np.random.default_rng(24)
    x32 = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                           ).to(dev)
    t32 = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                           ).to(dev)
    res = {}
    for dtype in (torch.float32, BF16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        x, t = x32.to(dtype), t32.to(dtype)
        acc = sk.accumulate_dtype(dtype)
        p_fwd = sk.graph_row_plan(rem, "csc")
        p_rev = sk.graph_row_plan(rem, "csr")
        dst_csr = sk.rev_gidx(rem)
        parts = {
            "rem_k1_fwd_ms": cuda_ms(lambda: sk.segment_sum(
                rem.csc_indptr, x, rem.src, plan=p_fwd)),
            "dense_fwd_ms": cuda_ms(lambda: sk._dense_matmul(hyb.C, x)),
            "rem_k1_dx_ms": cuda_ms(lambda: sk.segment_sum(
                rem.csr_indptr, t, dst_csr, site="rev", plan=p_rev,
                out_dtype=acc)),
            "dense_bwd_ms": cuda_ms(lambda: sk._dense_matmul_t(
                hyb.C, t[hyb.rows])),
        }
        out = sk.segment_sum(rem.csc_indptr, x, rem.src, plan=p_fwd)
        d = sk._dense_matmul(hyb.C, x)

        def add():
            out[hyb.rows] = (out[hyb.rows].to(acc) + d).to(out.dtype)
        parts["add_fwd_ms"] = cuda_ms(add)
        dx = sk.segment_sum(rem.csr_indptr, t, dst_csr, site="rev",
                            plan=p_rev, out_dtype=acc)
        dd = sk._dense_matmul_t(hyb.C, t[hyb.rows])
        parts["add_bwd_ms"] = cuda_ms(lambda: (dx + dd).to(dtype))
        del out, d, dx, dd
        xg = x.clone().requires_grad_()

        def fwd_bwd(g):
            xg.grad = None
            y = dt.gspmm(g, "copy_lhs", "sum", xg)
            (y.float() * t.float()).sum().backward()
            return y.detach(), xg.grad
        gk = dt.prepare_spmm(gb, dense_hub=False)
        y_h, dx_h = fwd_bwd(gh)
        y_k, dx_k = fwd_bwd(gk)
        if dtype == torch.float32:
            errs = {"fwd": rel_err(y_h.double(), y_k.double()),
                    "dx": rel_err(dx_h.double(), dx_k.double())}
            bad = max(errs.values()) > HYBRID_TOL
        else:
            errs = {"fwd": bf16_err(y_h, y_k.double()),
                    "dx": bf16_err(dx_h, dx_k.double())}
            bad = max(errs.values()) > BF16_ULPS
        if bad:
            checks.failures.append(f"hybrid {tag}: {errs}")
        del y_h, dx_h, y_k, dx_k
        with torch.no_grad():
            parts["hybrid_fwd_ms"] = cuda_ms(
                lambda: dt.gspmm(gh, "copy_lhs", "sum", x))
            parts["k1_fwd_ms"] = cuda_ms(
                lambda: dt.gspmm(gk, "copy_lhs", "sum", x))
        parts["hybrid_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(gh))
        parts["k1_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(gk))
        parts["err"] = errs
        res[tag] = parts
        del xg
    R = hyb.rows.numel()
    emit({"phase": "hybrid", "dense_rows": R, "parts": res,
          "measured_k1_ns_per_edge_f32": res["f32"]["k1_fwd_ms"] * 1e6 / E,
          "measured_dense_fp32_ops_per_s":
              2.0 * R * N * F / (res["f32"]["dense_fwd_ms"] * 1e-3),
          "constants": {"K1_NS_PER_EDGE": sk.K1_NS_PER_EDGE,
                        "DENSE_FP32_OPS_PER_S": sk.DENSE_FP32_OPS_PER_S},
          "default_bench": default_windows(sk, gb, hyb.tr)})
    checks.raise_if_failed("hybrid")


# ---------------------------------------------------------------------------
# bf16 rows and the packed z in K2/K3 and K6; the attention twins
# ---------------------------------------------------------------------------
# The first packed loss against the unpacked one, relative: the packed
# hidden layer reads each feature rounded to nearest bf16, at most 2^-9 of
# itself away, with the same weights and dropout draws at the first step;
# the loss moves by less than 2^-8 of itself (relative changes of the
# logits times a softmax cross-entropy's sensitivity, below 2 at
# initialisation).  Later steps' weights drift apart: reported only.
PACKED_LOSS_TOL = 2.0 ** -8
# A packed GATConv on the card against the CPU: both round the same float32
# features, which their float32 matmuls may give one ulp apart, so an
# element may round to the neighbouring bf16 value (2^-8 of the largest
# feature) beyond the float32 tolerance.
PACKED_LAYER_TOL = 2.0 ** -8 + GAT_TOL


def _bf16(rng, shape, dev, scale=1.0):
    """Standard normal values (times ``scale``) rounded to bf16."""
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).to(dev, BF16)


def _bf16_gat_case(gk, g, H, D, mode, checks, rng, tag, view=None):
    """gat_attention_fused over bf16 fsrc, el, er and attn_w: the bf16
    result and gradients (float32 sums rounded once) against the composed
    plain version in float64 over the same bf16 values (``bf16_check``
    with GAT_TOL), each repeated bitwise.  ``view``: a masked g's
    real-edge view, over which the reference runs."""
    dev = g.device
    N, Nd, E = g.num_src_nodes, g.num_dst_nodes, g.num_edges()
    keep = (rng.random((E, H)) > 0.3).astype(np.float32) / 0.7
    ins = [_bf16(rng, (N, H, D), dev), _bf16(rng, (N, H), dev),
           _bf16(rng, (Nd, H), dev), torch.from_numpy(keep).to(dev, BF16)]
    dout = _bf16(rng, (Nd, H, D), dev)
    runs = []
    for _ in range(2):
        kin = [v.clone().requires_grad_(True) for v in ins]
        out = gk.gat_attention_fused(g, *kin[:3], 0.2, kin[3], softmax=mode)
        runs.append((out, torch.autograd.grad(out, kin, dout)))
    ins64 = [v.double().requires_grad_(True) for v in ins]
    kg, w64 = (g, ins64[3]) if view is None else (view.graph,
                                                  ins64[3][view.eid])
    ref = composed_gat(kg, *ins64[:3], w64, 0.2)
    grefs = torch.autograd.grad(ref, ins64, dout.double())
    (out, grads), (out2, grads2) = runs
    what = f"{tag} H={H} D={D} {mode}"
    if out.dtype != BF16 or any(x.dtype != BF16 for x in grads):
        checks.failures.append(f"gat bf16 {what}: result or gradient "
                               "not bf16")
    errs = {"fwd": bf16_check(checks, "gat_fwd_bf16", what, out, ref, out2,
                              tol=GAT_TOL)}
    for name, a, b, r in zip(("dfsrc", "del", "der", "dattn_w"), grads,
                             grads2, grefs):
        errs[name] = bf16_check(checks, "gat_bwd_bf16", f"{what} {name}", a,
                                r, b, tol=GAT_TOL)
    return errs


def _bf16_k6_cases(k6, g, checks, tag, rng):
    """K6 over bf16 operands: the elementwise ops with an 'u' and an 'e'
    lhs at F = 7 and 41 equal to the plain version bitwise (both take the
    float32 op and round once); dot at (H, D) in (1, 16), (4, 16), (2, 7),
    (1, 41), (1, 128) against the plain version in float64 (``bf16_check``
    with K6_DOT_TOL); GsddmmFn's bf16 gradients (K6 and K1 in float32,
    rounded once) against autograd through the plain version in float64
    (``bf16_check`` with K6_BWD_TOL); each repeated bitwise."""
    dev = g.device
    Ns, Nd, E = g.num_src_nodes, g.num_dst_nodes, g.num_edges()

    def sg(shape):
        return _signed(rng, shape, dev).to(BF16)
    errs = {}
    for F in (7, 41):
        lhs_u, lhs_e, rhs = sg((Ns, F)), sg((E, F)), sg((Nd, F))
        for op in K6_ELEM_OPS:
            for kind in (("u",) if op == "copy_rhs" else ("u", "e")):
                lhs, src = _k6_lhs(g, kind, lhs_u, lhs_e)
                args = (op, g.dst, rhs, lhs, src)
                out = k6.sddmm(*args)
                if out.dtype != BF16:
                    checks.failures.append(f"sddmm bf16 {op}: {out.dtype}")
                checks.exact("sddmm_bf16", f"{tag} F={F} {op} {kind}", out,
                             k6.sddmm_plain(*args), k6.sddmm(*args))
    for H, D in ((1, 16), (4, 16), (2, 7), (1, 41), (1, 128)):
        for kind in ("u", "e"):
            lhs, src = _k6_lhs(g, kind, sg((Ns, H * D)), sg((E, H * D))
                               if kind == "e" else None)
            rhs = sg((Nd, H * D))
            errs[f"dot.H{H}D{D}.{kind}"] = bf16_check(
                checks, "sddmm_bf16", f"{tag} dot H={H} D={D} {kind}",
                k6.sddmm("dot", g.dst, rhs, lhs, src, D),
                k6.sddmm_plain("dot", g.dst, rhs.double(), lhs.double(),
                               src, D),
                k6.sddmm("dot", g.dst, rhs, lhs, src, D), tol=K6_DOT_TOL)
    for op, F, D in [(op, 7, 0) for op in K6_ELEM_OPS] + [("dot", 64, 16)]:
        for kind in (("u",) if op == "copy_rhs" else ("u", "e")):
            lhs, src = _k6_lhs(g, kind, sg((Ns, F)), sg((E, F)))
            lhs = None if op == "copy_rhs" else lhs
            rhs = sg((Nd, F))
            gout = sg((E, F // D if op == "dot" else F))
            ins = [t for t in (lhs, rhs) if t is not None]
            ins64 = [t.double().requires_grad_() for t in ins]
            ref = k6.sddmm_plain(op, g.dst, ins64[-1], ins64[0]
                                 if lhs is not None else None, src, D)
            grefs = torch.autograd.grad(ref, ins64, gout.double())
            runs = []
            for _ in range(2):
                a = [t.clone().requires_grad_() for t in ins]
                out = k6.GsddmmFn.apply(a[0] if lhs is not None else None,
                                        a[-1], g, op, kind, D)
                runs.append(torch.autograd.grad(out, a, gout))
            names = ("dlhs", "drhs") if lhs is not None else ("drhs",)
            for n, r1, r2, r in zip(names, *runs, grefs):
                if r1.dtype != BF16:
                    checks.failures.append(f"sddmm bf16 {op} {n}: "
                                           f"{r1.dtype}")
                errs[f"bwd.{op}.{kind}.{n}"] = bf16_check(
                    checks, "sddmm_bf16", f"{tag} bwd {op} {kind} {n}", r1,
                    r, r2, tol=K6_BWD_TOL)
    return errs


def bf16_sddmm_lib_ms(g, lhs, rhs):
    """``sampled_addmm`` over a bf16 CSR and bf16 operands (u_dot_v, one
    head): its ms, or torch's message where it does not take bf16 (timed
    only)."""
    A32 = csr_matrix(g)
    A = torch.sparse_csr_tensor(A32.crow_indices(), A32.col_indices(),
                                A32.values().to(BF16), size=A32.shape)
    return bf16_library_ms(lambda: torch.sparse.sampled_addmm(
        A, rhs, lhs.t(), beta=0.0))


def phase_bf16_attention(dt, build, gk, k6, sk, gb, checks, dev, timings):
    """K2/K3 and K6 over bf16 rows (``bf16_attention``): gat_attention_fused
    over bf16 operands on phase 3's graph (a dst hub and a src hub, both
    softmax modes) and on the masked layer-0 block (through its real-edge
    view); K6 on that graph in every op, dot shape and gradient; K6 at
    bench.py's graph (u_dot_v and u_sub_v, F = 128) checked and timed
    beside the float32 kernel on the same shape, its plain version and
    ``sampled_addmm`` in bf16; then bf16 gsddmm through ``dt.gsddmm`` at
    bench.py's graph (H = 8, D = 16, forward and backward; u_sub_v forward)
    with the launches counted: K6's bf16 main path."""
    rng = np.random.default_rng(31)
    g = _gat_hub_graph(dt, dev, rng)
    errs = {f"gat.H{H}D{D}.{mode}": _bf16_gat_case(gk, g, H, D, mode,
                                                   checks, rng, "hub graph")
            for H, D in ((8, 8), (1, 7)) for mode in ("shift", "exact")}
    errs["k6"] = _bf16_k6_cases(k6, g, checks, "hub graph", rng)
    del g
    mb = _masked_block(dt, dev, np.random.default_rng(22))
    errs["gat.masked"] = _bf16_gat_case(gk, mb, 8, 8, "shift", checks, rng,
                                        "masked", view=sk.real_edges(mb))
    del mb
    torch.cuda.empty_cache()
    F, E = 128, gb.num_edges()
    lhs = _signed(rng, (gb.num_src_nodes, F), dev).to(BF16)
    rhs = _signed(rng, (gb.num_dst_nodes, F), dev).to(BF16)
    args = (gb.dst, rhs, lhs, gb.src)
    out = k6.sddmm("dot", *args, F)
    errs["bench.dot"] = bf16_check(
        checks, "sddmm_bf16", "bench dot F=128", out,
        k6.sddmm_plain("dot", gb.dst, rhs.double(), lhs.double(), gb.src,
                       F), k6.sddmm("dot", *args, F), tol=K6_DOT_TOL)
    # read behind a queue, as their float32 forms beside them
    bench = {"dot": timing(
        cuda_ms(lambda: k6.sddmm("dot", *args, F), queued=True),
        cuda_ms(lambda: k6.sddmm_plain("dot", *args, F), reps=3),
        nbytes(gb.src, gb.dst, lhs, rhs, out), 2 * E * F,
        "bench.py graph, u_dot_v, F=128, bf16",
        library_ms=bf16_sddmm_lib_ms(gb, lhs, rhs))}
    l32, r32 = lhs.float(), rhs.float()
    bench["dot"]["f32_ms"] = cuda_ms(
        lambda: k6.sddmm("dot", gb.dst, r32, l32, gb.src, F), queued=True)
    del out
    out = k6.sddmm("sub", *args)
    checks.exact("sddmm_bf16", "bench sub F=128", out,
                 k6.sddmm_plain("sub", *args), k6.sddmm("sub", *args))
    bench["sub"] = timing(
        cuda_ms(lambda: k6.sddmm("sub", *args), queued=True),
        cuda_ms(lambda: k6.sddmm_plain("sub", *args), reps=3),
        nbytes(gb.src, gb.dst, lhs, rhs, out), E * F,
        "bench.py graph, u_sub_v, F=128, bf16")
    bench["sub"]["f32_ms"] = cuda_ms(
        lambda: k6.sddmm("sub", gb.dst, r32, l32, gb.src), queued=True)
    timings["sddmm_bf16"] = bench["dot"]
    del out, l32, r32
    torch.cuda.empty_cache()
    # K6's bf16 main path: gsddmm through the public entry point
    lh = lhs.view(-1, 8, 16).detach().requires_grad_(True)
    rh = rhs.view(-1, 8, 16).detach().requires_grad_(True)
    build.LAUNCHES.reset()
    dot = dt.gsddmm(gb, "dot", lh, rh, "u", "v")
    dot.float().sum().backward()
    with torch.no_grad():
        sub = dt.gsddmm(gb, "sub", lhs, rhs, "u", "v")
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    if dot.dtype != BF16 or sub.dtype != BF16 or lh.grad.dtype != BF16 \
            or not (bool(dot.isfinite().all())
                    and bool(lh.grad.isfinite().all())):
        checks.failures.append("bf16 gsddmm main path: dtypes or values")
    plain = {k: v for k, v in counts.items() if k.startswith("plain.")}
    if plain or not _launched(counts, "sddmm_bf16"):
        checks.failures.append(f"bf16 gsddmm main path launches: {counts}")
    del lh, rh, dot, sub, lhs, rhs
    torch.cuda.empty_cache()
    emit({"phase": "bf16_attention", "err": errs, "bench": bench,
          "main_path_launches": counts,
          "rule": "bf16 results within 1 bf16 ulp + the float32 kernel's "
                  "tolerance of float64; K6's elementwise ops equal"})
    checks.raise_if_failed("bf16_attention")
    return counts


def phase_bf16_gat_reddit(dt, build, gk, sk, g, checks, dev, timings):
    """K2/K3 over bf16 Wh (the packed GAT's rows) at synthetic Reddit's
    two GAT layer shapes (H = 8, D = 8 and H = 1, D = 41, attn_w), against
    their plain versions in float64, timed beside the float32 kernels on
    the same shapes and swept over floats per lane and values per load;
    then a bf16 gat_attention forward and backward through
    ``dt.gat_attention`` at H = 8, D = 8 (launches counted)."""
    rng = np.random.default_rng(32)
    hidden = _gat_kernels_at(gk, sk, g, 8, 8, checks, rng,
                             "synthetic Reddit", timed=True, sweep=True,
                             bf16=True)
    timings["gat_fwd_bf16"] = hidden["gat_fwd"]
    timings["gat_bwd_bf16"] = hidden["gat_bwd"]
    out = _gat_kernels_at(gk, sk, g, 1, 41, checks, rng, "synthetic Reddit",
                          timed=True, sweep=True, bf16=True)
    N, H, D = g.num_src_nodes, 8, 8
    ins = [_bf16(rng, (N, H, D), dev), _bf16(rng, (N, H), dev),
           _bf16(rng, (N, H), dev)]
    ins = [v.requires_grad_(True) for v in ins]
    build.LAUNCHES.reset()
    res = dt.gat_attention(g, *ins, 0.2)
    res.float().sum().backward()
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    if res.dtype != BF16 or not all(v.grad.dtype == BF16 and bool(
            v.grad.isfinite().all()) for v in ins) \
            or not bool(res.isfinite().all()):
        checks.failures.append("bf16 gat_attention on Reddit: dtypes or "
                               "values")
    if _launched(counts, "plain") or not (
            _launched(counts, "gat_fwd_bf16") and _launched(counts,
                                                            "gat_bwd_bf16")):
        checks.failures.append(f"bf16 gat_attention launches: {counts}")
    del ins, res
    torch.cuda.empty_cache()
    emit({"phase": "bf16_attention_reddit", "k2_H8D8": hidden["gat_fwd"],
          "k3_H8D8": hidden["gat_bwd"], "k2_H1D41": out["gat_fwd"],
          "k3_H1D41": out["gat_bwd"], "sweep_H8D8": hidden["lane_sweep"],
          "sweep_H1D41": out["lane_sweep"],
          "gat_attention_launches": counts})
    checks.raise_if_failed("bf16_attention_reddit")
    return counts


def _packed_gatconv_vs_cpu(dt, rng, dev):
    """One forward and backward of GATConv(8, 8) with packing on, on the
    card against the same module on the CPU (phase 3's graph, 64 input
    features): the output within ``PACKED_LAYER_TOL`` of the largest
    projected feature, every gradient within it of its own max|ref|.
    Returns the errors and the card's launches."""
    from dgl_hack_tpu_torch.nn import GATConv
    from dgl_hack_tpu_torch.ops.cuda import build
    g = _gat_hub_graph(dt, "cpu", rng)
    x = torch.from_numpy(rng.normal(size=(g.num_src_nodes, 64)).astype(
        np.float32))
    t = torch.from_numpy(rng.normal(size=(g.num_dst_nodes, 8, 8)).astype(
        np.float32))
    torch.manual_seed(5)
    mod_c = GATConv(8, 8)
    with torch.no_grad():
        mod_c(g, x)                                 # materialise fc
        scale = float(mod_c.fc(x).abs().max())
    mod_d = copy.deepcopy(mod_c).to(dev)
    x_c, x_d = x.clone().requires_grad_(True), x.to(dev).requires_grad_(True)
    out_c = mod_c(g, x_c)
    (out_c * t).sum().backward()
    build.LAUNCHES.reset()
    out_d = mod_d(g.to(dev), x_d)
    (out_d * t.to(dev)).sum().backward()
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    errs = {"out": float((out_d.detach().cpu() - out_c.detach()).abs().max())
            / scale}
    pairs = [("x", x_d.grad, x_c.grad)] + [
        (n, p.grad, dict(mod_c.named_parameters())[n].grad)
        for n, p in mod_d.named_parameters()]
    for n, a, r in pairs:
        errs[n] = float((a.cpu() - r).abs().max()) / max(
            float(r.abs().max()), 1e-30)
    return errs, counts


def phase_gat_train_packed(dt, build, ds, g, checks, dev, ref_losses):
    """GAT training with ``DGL_TPU_GAT_PACKED=1`` (``gat_train_packed``):
    the model, seed and steps of phase 5 on full synthetic Reddit; the
    hidden layer (H * D = 64) reads a bf16 Wh (K2/K3 bf16), the output
    layer (H * D = 41, odd) runs unpacked (K2/K3 float32).  The epoch ms,
    peak memory, the first loss against phase 5's (``PACKED_LOSS_TOL``),
    the launches (both forms at least once a step), and one packed
    GATConv on the card against the CPU."""
    from dgl_hack_tpu_torch.models import GAT
    os.environ["DGL_TPU_GAT_PACKED"] = "1"
    try:
        torch.manual_seed(0)
        model = GAT(hidden_feats=8, out_feats=ds.num_classes, heads=(8, 1),
                    feat_drop=0.6, attn_drop=0.6)
        reset_peak_memory()
        res, counts = _train(build, model, ds, g, 5, 5e-3, dev)
        peak = torch.cuda.max_memory_allocated()
        layer, layer_counts = _packed_gatconv_vs_cpu(
            dt, np.random.default_rng(33), dev)
    finally:
        del os.environ["DGL_TPU_GAT_PACKED"]
    losses = res["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    emit({"phase": "gat_train_packed", "nodes": g.num_src_nodes,
          "edges": g.num_edges(), "heads": [8, 1], "hidden": 8, "epochs": 5,
          "losses": losses, "unpacked_losses": ref_losses,
          "loss_rel_diff": rel, "train_time_s": res["train_time_s"],
          "epoch_ms": 1e3 * res["train_time_s"] / 4,
          "test_acc": res["test_acc"], "peak_memory_bytes": peak,
          "launches": counts, "gatconv_vs_cpu": layer,
          "gatconv_launches": layer_counts})
    problems = []
    if not rel[0] <= PACKED_LOSS_TOL:
        problems.append(f"first loss {rel[0]:.3g} from the unpacked one")
    steps = len(losses)
    for name in ("gat_fwd_bf16", "gat_bwd_bf16", "gat_fwd", "gat_bwd"):
        if _launched(counts, name) < steps:
            problems.append(f"{name}: {_launched(counts, name)} launches in "
                            f"{steps} steps")
    if not all(v <= PACKED_LAYER_TOL for v in layer.values()):
        problems.append(f"packed GATConv against the CPU: {layer}")
    if not _launched(layer_counts, "gat_fwd_bf16"):
        problems.append(f"packed GATConv launches: {layer_counts}")
    if problems:
        raise SystemExit("gat_train_packed failed: " + "; ".join(problems))
    _check_training("gat_train_packed", res, counts,
                    ("gat_fwd_bf16", "gat_bwd_bf16", "gat_fwd", "gat_bwd",
                     "segment_sum.edge"))
    return counts


def _twin_first_loss(name, losses, cpu_losses, checks):
    """The card's first loss within LAYER_TOL of the CPU's (same data and
    parameters); the relative difference."""
    rel = abs(losses[0] - cpu_losses[0]) / max(abs(cpu_losses[0]), 1e-30)
    if not rel <= LAYER_TOL:
        checks.failures.append(f"{name}: first loss {losses[0]} vs the "
                               f"CPU's {cpu_losses[0]}")
    return rel


def phase_han(build, checks, dev):
    """The HAN twin (examples/train_han_torch.py) at its CLI defaults (300
    papers, hidden 16, 4 heads, lr 5e-3), 40 epochs on the card: a GATConv
    per metapath graph (K2, K3 + K1's edge rows), the first loss against
    the CPU's from the same initial parameters, epoch ms, launches."""
    twin = _load_twin("train_han_torch")
    graphs, feats, labels, mask = twin.make_data()
    torch.manual_seed(0)
    model = twin.HAN(len(graphs), 16, 4, int(labels.max()) + 1)
    with torch.no_grad():
        model(graphs, torch.from_numpy(feats))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    cpu = twin.train(graphs, feats, labels, mask, epochs=2, device="cpu",
                     state=state)
    build.LAUNCHES.reset()
    res = twin.train(graphs, feats, labels, mask, epochs=40, device=dev,
                     state=state)
    torch.cuda.synchronize()
    c = dict(build.LAUNCHES.counts)
    losses = res["losses"]
    emit({"phase": "han", "papers": int(feats.shape[0]),
          "metapath_edges": [gm.num_edges() for gm in graphs],
          "epochs": len(losses), "losses_first_last": [losses[:3],
                                                       losses[-3:]],
          "first_loss_rel_vs_cpu": _twin_first_loss("han", losses,
                                                    cpu["losses"], checks),
          "test_acc": res["test_acc"],
          "epoch_ms_median_after_first": float(np.median(
              res["epoch_ms"][1:])), "launches": c})
    checks.raise_if_failed("han")
    _twin_checks("han", losses, c, need=("gat_fwd", "gat_bwd",
                                         "segment_sum.edge"))
    return c


def phase_capsule(build, checks, dev):
    """The capsule twin (examples/train_capsule_torch.py) at its CLI
    defaults (1,024 training digits, 16 -> 10 capsules of 8 -> 16, 3
    routing iterations, lr 3e-3), 20 epochs on the card: copy_e sums over
    (E, B, OD) edge data (K1's rows route) and the e-dot-v agreement (K6,
    its gradient K6 + K1), the first loss against the CPU's, epoch ms,
    test accuracy, launches."""
    twin = _load_twin("train_capsule_torch")
    xtr, ytr = twin.synthetic_digits(1024, seed=0)
    xte, yte = twin.synthetic_digits(256, seed=1)
    params = twin.init_params(16, 10, 8, 16, 0)
    cpu = twin.train(params, xtr, ytr, epochs=1, device="cpu")
    build.LAUNCHES.reset()
    res = twin.train(params, xtr, ytr, epochs=20, device=dev, xte=xte,
                     yte=yte)
    torch.cuda.synchronize()
    c = dict(build.LAUNCHES.counts)
    losses = res["losses"]
    emit({"phase": "capsule", "train": 1024, "epochs": len(losses),
          "losses_first_last": [losses[:3], losses[-3:]],
          "first_loss_rel_vs_cpu": _twin_first_loss("capsule", losses,
                                                    cpu["losses"], checks),
          "test_acc": res["test_acc"],
          "epoch_ms_median_after_first": float(np.median(
              res["epoch_ms"][1:])), "launches": c})
    checks.raise_if_failed("capsule")
    _twin_checks("capsule", losses, c, need=(
        "sddmm.fwd", "sddmm.bwd", "segment_sum.rows", "segment_sum.edge"))
    return c


def phase_graphwriter(build, checks, dev):
    """The GraphWriter twin (examples/train_graphwriter_torch.py) at its
    CLI defaults (512 training KGs of 8 entities, dim 64, 4 heads, lr
    3e-3), 20 epochs on the card: u_dot_v gsddmm (K6 dot, D = 16; its
    gradient K6 + K1), edge_softmax and u_mul_e gspmm with an (E, H, 1)
    weight (K1), the first loss against the CPU's, epoch ms, launches."""
    twin = _load_twin("train_graphwriter_torch")
    params = twin.init_params(64, 4, 0)
    kgs = twin.make_kgs(512, seed=0)
    cpu = twin.train(params, kgs, epochs=1, device="cpu")
    build.LAUNCHES.reset()
    res = twin.train(params, kgs, epochs=20, device=dev,
                     test_kgs=twin.make_kgs(128, seed=1))
    torch.cuda.synchronize()
    c = dict(build.LAUNCHES.counts)
    losses = res["losses"]
    emit({"phase": "graphwriter", "train": 512, "epochs": len(losses),
          "losses_first_last": [losses[:3], losses[-3:]],
          "first_loss_rel_vs_cpu": _twin_first_loss(
              "graphwriter", losses, cpu["losses"], checks),
          "test_token_acc": res["test_token_acc"],
          "epoch_ms_median_after_first": float(np.median(
              res["epoch_ms"][1:])), "launches": c})
    checks.raise_if_failed("graphwriter")
    _twin_checks("graphwriter", losses, c, need=(
        "sddmm.fwd", "sddmm.bwd", "segment_sum.fwd", "segment_sum.rev"))
    return c


# ---------------------------------------------------------------------------
# chemistry (nn/conv_extra, models/chem, data/chem) and the last twins
# ---------------------------------------------------------------------------
CHEM_MOLS = 1024
CHEM_MODELS = ("schnet", "mgcn", "mpnn", "attentivefp", "gcn", "gat",
               "weave", "wln")
# kernels each chemistry model must launch on the card in a training step
# (copy_e sums and sum readouts launch K1 at its ``rows`` site)
CHEM_NEED = {
    "schnet": ("segment_sum.fwd", "segment_sum.rows"),
    "mgcn": ("segment_sum.fwd", "segment_sum.rows"),
    "mpnn": ("segment_sum.rows",),
    "attentivefp": ("segment_sum.fwd", "segment_sum.rows"),
    "gcn": ("segment_sum.fwd", "segment_sum.rev", "segment_sum.rows"),
    "gat": ("gat_fwd", "gat_bwd", "segment_sum.rows"),
    "weave": ("segment_sum.rows", "sddmm.fwd"),
    "wln": ("segment_sum.fwd", "segment_sum.rows")}
# the gathers the JAX dispatch composes too: a copy of a node operand onto
# the edges with no other operand (AttentiveFP's src and dst copies, WLN's
# src copy: gsddmm copy_lhs with the rhs target left at 'v')
CHEM_COMPOSED = {"attentivefp": "plain.gsddmm_composed",
                 "wln": "plain.gsddmm_composed"}


def _kernel_families(step):
    """Device ms of one ``step()`` from torch.profiler (CUDA activity), in
    total and by kernel family: the port's K1 (``segment_sum``), K2/K3
    (``gat_``), K6 (``sddmm``) and the rest (torch's)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    fam = {"k1": 0.0, "k2_k3": 0.0, "k6": 0.0, "other": 0.0}
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if not str(e.device_type).endswith("CUDA") or ms <= 0:
            continue
        key = ("k1" if "segment_sum" in e.key else
               "k2_k3" if "gat_" in e.key else
               "k6" if "sddmm" in e.key else "other")
        fam[key] += ms
    return {"device_ms": sum(fam.values()), **fam}


class _ReluGates:
    """``F.relu`` for one forward, with each call's gate (x > 0):
    ``use(record=True)`` keeps the gates in call order; ``use(record=False)``
    applies them in the same order in place of the input's own sign (every
    one must be used) and keeps in ``flips`` the inputs whose own sign
    differs (up to 8 a call).  The CPU copy replays the card's gates, so
    that a pre-activation within rounding of 0 takes the same side of the
    kink on both and the two gradients are of one function (MPNN at 1,024
    molecules has one such element; the phase prints it, and the gradient
    error without the replay).  Leaky relus (AttentiveFP's, and GAT's
    inside K2/K3) are not replayed."""

    def __init__(self):
        self.gates, self.flips = [], []

    @contextlib.contextmanager
    def use(self, record):
        fn = F.relu
        it = iter(self.gates)

        def relu(x, inplace=False):
            if record:
                self.gates.append((x > 0).cpu())
                return fn(x, inplace)
            gate = next(it).to(x.device)
            self.flips += x[(x > 0) != gate][:8].tolist()
            return x * gate
        F.relu = relu
        try:
            yield
        finally:
            F.relu = fn
        if not record and next(it, None) is not None:
            raise RuntimeError("relu gates: the CPU run called F.relu "
                               "fewer times than the card's")


def _chem_batch_data(n, seed):
    """``n`` synthetic molecules from ``np.random.default_rng(seed)`` (the
    port's generator, not the datasets' seeds: Alchemy's salts its seed
    with hash(mode)), their graphs and both label kinds: standardised
    regression targets (12 Alchemy tasks) and binary targets with a 15%
    missing mask (12 Tox21 tasks)."""
    from dgl_hack_tpu_torch.data import chem as cd
    rng = np.random.default_rng(seed)
    mols = [cd._synthetic_molecule(rng) for _ in range(n)]
    graphs = [cd._mol_to_graph(m) for m in mols]
    reg = np.stack([cd._structure_labels(m, 12, "reg", rng) for m in mols])
    reg = ((reg - reg.mean(0)) / (reg.std(0) + 1e-8)).astype(np.float32)
    binary = np.stack([cd._structure_labels(m, 12, "binary", rng)
                       for m in mols])
    mask = (rng.random(binary.shape) >= 0.15).astype(np.float32)
    return graphs, {"reg": (reg, np.ones_like(reg)),
                    "binary": (binary * mask, mask)}


def _chem_plans_ms(sk, g):
    """Milliseconds to build every plan a chemistry step reads on the
    card graph: K1's row plans of both directions, the dx gather index and
    the readout segments of the nodes and edges."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk.graph_row_plan(g, "csc")
    sk.graph_row_plan(g, "csr")
    sk.rev_gidx(g)
    sk.graph_segments(g, "nodes")
    sk.graph_segments(g, "edges")
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def phase_chem_train(dt, build, sk, checks, dev):
    """The chemistry model zoo at the JAX classes' default widths (DGL
    0.4's model_zoo/chem: SchNet 64 x 3 convs, MGCN 128 x 3, MPNN 64/128
    with 6 + 6 steps, AttentiveFP 200, the GCN classifier (64, 64), the GAT
    classifier (32, 32) x 4 heads, Weave 2 x 32, WLN 32 x 2), each trained
    through examples/train_chem_torch.py's pieces on one batch of
    CHEM_MOLS synthetic molecules: the batch's host build, copy and plan
    build apart, 2 warm-up and 5 timed Adam steps (lr 3e-3) on the squared
    error of standardised Alchemy-style targets (SchNet, MGCN, MPNN) or the
    masked sigmoid cross-entropy of Tox21-style ones, peak memory, the
    launches of each kernel, one more step's device ms by kernel family
    (torch.profiler) and the busy share, the first and last loss, and the
    first step's forward and gradients on the whole batch against a CPU
    copy of the same model made just before it (plain versions, the card's
    relu gates, ``_ReluGates``; LAYER_TOL of max|ref|, gradients as
    ``_grads_close``)."""
    twin = _load_twin("train_chem_torch")
    t0 = time.perf_counter()
    graphs, labels = _chem_batch_data(CHEM_MOLS, seed=0)
    data_s = time.perf_counter() - t0
    total = {}
    res = {}
    for name in CHEM_MODELS:
        kind = "reg" if name in twin.REGRESSION else "binary"
        reset_peak_memory()
        t0 = time.perf_counter()
        bg_c = dt.batch(graphs)
        t1 = time.perf_counter()
        bg = bg_c.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        plans_ms = _chem_plans_ms(sk, bg)
        y_c, w_c = (torch.from_numpy(a) for a in labels[kind])
        y, w = y_c.to(dev), w_c.to(dev)
        torch.manual_seed(0)
        model_c = twin.build_model(name, 12, full_width=True)
        with torch.no_grad():
            model_c(*twin.model_inputs(name, bg_c))  # materialise on the CPU
        model = copy.deepcopy(model_c).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)

        def step():
            loss = twin.loss_of(name, model(*twin.model_inputs(name, bg)),
                                y, w)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()
        build.LAUNCHES.reset()
        gates = _ReluGates()
        with gates.use(record=True):                 # the first step, checked
            out = model(*twin.model_inputs(name, bg))
        loss = twin.loss_of(name, out, y, w)
        loss.backward()
        with gates.use(record=False):
            out_c = model_c(*twin.model_inputs(name, bg_c))
        twin.loss_of(name, out_c, y_c, w_c).backward()
        out_rel = rel_err(out.detach().cpu(), out_c.detach())
        grad_rel, worst = _grads_close(checks, f"chem {name}", model, model_c)
        own_gates = None           # the gradient error with the CPU's gates
        if gates.flips:
            model_c.zero_grad(set_to_none=True)
            twin.loss_of(name, model_c(*twin.model_inputs(name, bg_c)),
                         y_c, w_c).backward()
            own_gates = _grads_close(Checks(), "", model, model_c)
        flips = gates.flips
        opt.step()
        losses = [loss.detach(), step()]
        if not out_rel <= LAYER_TOL:
            checks.failures.append(f"chem {name} forward vs CPU: "
                                   f"{out_rel:.3g}")
        del out, out_c, model_c, bg_c, gates
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        losses += [step() for _ in range(5)]
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t3) / 5
        counts = dict(build.LAUNCHES.counts)
        peak = torch.cuda.max_memory_allocated()
        device = _kernel_families(step)
        losses = [float(v) for v in losses]
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        res[name] = {"params": sum(p.numel() for p in model.parameters()),
                     "step_ms": step_ms, "host_batch_ms": 1e3 * (t1 - t0),
                     "copy_ms": 1e3 * (t2 - t1), "plans_ms": plans_ms,
                     "peak_memory_bytes": peak, "device": device,
                     "device_busy_share": device["device_ms"] / step_ms,
                     "loss_first": losses[0],
                     "loss_last": losses[-1], "losses": losses,
                     "launches": counts, "fwd_rel_err_vs_cpu": out_rel,
                     "grad_rel_err_vs_cpu": grad_rel,
                     "worst_grad": worst, "relu_gate_flips": flips,
                     "grad_rel_err_vs_cpu_own_gates": own_gates}
        allowed = CHEM_COMPOSED.get(name)
        plain = {k: v for k, v in counts.items()
                 if k.startswith("plain.") and k != allowed}
        missing = [k for k in CHEM_NEED[name] if _launched(counts, k) <= 0]
        if not all(np.isfinite(losses)) or plain or missing:
            checks.failures.append(f"chem {name}: losses {losses}, plain "
                                   f"{plain}, never launched {missing}")
        del model, opt, bg
    emit({"phase": "chem_train", "molecules": CHEM_MOLS,
          "atoms": sum(g.num_nodes() for g in graphs),
          "bonds_directed": sum(g.num_edges() for g in graphs),
          "data_s": data_s,
          "tolerance": LAYER_TOL, "models": res})
    checks.raise_if_failed("chem_train")
    return total


def _twin_record(name, res, counts, rel, extra=None):
    losses = res["losses"]
    times = res.get("step_ms") or res.get("epoch_ms")
    return {"steps": len(losses), "losses_first_last": [losses[:3],
                                                        losses[-3:]],
            "first_loss_rel_vs_cpu": rel,
            "ms_median_after_first": float(np.median(times[1:])),
            "launches": counts, **(extra or {}),
            **{k: res[k] for k in ("test_acc", "test_mse", "cell_acc",
                                   "test_rmse") if k in res}}


def _run_twin(build, name, run, need, checks, dev, window=3):
    """``run(device, first_only)`` on the card (launches counted) and its
    first step on the CPU; the twin's checks (losses finite and falling,
    ``need`` launched, no plain path)."""
    cpu = run("cpu", True)
    build.LAUNCHES.reset()
    res = run(dev, False)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    rel = _twin_first_loss(name, res["losses"], cpu["losses"], checks)
    _twin_checks(name, res["losses"], counts, need=need, window=window)
    return res, counts, rel


def _initial_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_chem_twins(build, checks, dev):
    """The chem twin (examples/train_chem_torch.py) at its CLI defaults (128
    molecules, batches of 32, 30 epochs, lr 3e-3, the example's narrow
    widths) for gcn and schnet, as tools/regression.py runs them, with the
    Alchemy molecules drawn from a fixed seed in place of the dataset's
    hashed one; MoNet (train_monet_torch.py: two GMMConvs, K1's rows
    route) and DiffPool (train_diffpool_torch.py: dense batched matmuls, no
    sparse kernel, as in its JAX example) at their CLI defaults.  Each
    from parameters made on the CPU: the first loss against the CPU's,
    the losses falling, the step ms and the launches."""
    twin = _load_twin("train_chem_torch")
    graphs, labels = _chem_batch_data(128, seed=0)
    total, rec = {}, {}
    for name in ("gcn", "schnet"):
        if name in twin.REGRESSION:
            graphs_n, (lab, mask) = graphs, labels["reg"]
        else:
            graphs_n, lab, mask = twin.load_data(name, 128)
        batches = twin.make_batches(graphs_n, lab, mask, 0, 102, 32)
        state = _initial_state(twin.train(name, batches, epochs=0,
                                          device="cpu")["model"])

        def run(device, first, name=name, batches=batches, state=state):
            return twin.train(name, batches[:1] if first else batches,
                              epochs=1 if first else 30, params=state,
                              device=device)
        res, counts, rel = _run_twin(build, f"chem {name}", run,
                                     ("segment_sum.fwd",
                                      "segment_sum.rows"), checks, dev)
        rec[f"chem_{name}"] = _twin_record(name, res, counts, rel, {
            "host_ms_median": float(np.median(res["host_ms"]))})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    monet = _load_twin("train_monet_torch")
    data = monet.make_data()
    state = _initial_state(monet.train(data, epochs=0, device="cpu")["model"])
    res, counts, rel = _run_twin(
        build, "monet", lambda d, first: monet.train(
            data, epochs=1 if first else 60, params=state, device=d),
        ("segment_sum.rows",), checks, dev)
    rec["monet"] = _twin_record("monet", res, counts, rel,
                                {"edges": data[0].num_edges()})
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    diff = _load_twin("train_diffpool_torch")
    batches, classes = diff.make_batches()
    state = _initial_state(diff.train(batches, classes, epochs=0,
                                      device="cpu")["model"])
    res, counts, rel = _run_twin(
        build, "diffpool", lambda d, first: diff.train(
            batches, classes, epochs=1 if first else 25, n_train=4,
            params=state, device=d), (), checks, dev)
    rec["diffpool"] = _twin_record("diffpool", res, counts, rel)
    emit({"phase": "chem_twins", **rec})
    checks.raise_if_failed("chem_twins")
    return total


SMALL_LGNN = dict(graphs=10, nodes=200, epochs=5)


def phase_small_twins(build, checks, dev):
    """The GGNN, DGI, GCMC, RRN and point-cloud twins at their CLI
    defaults, and LGNN at 200 nodes a graph (its line graph then carries
    real work for K1; 10 graphs, 5 epochs), each from parameters made on
    the CPU: the first loss against the CPU's, the losses falling, the
    step ms and the launches (GGNN and RRN: K1's rows route; DGI, GCMC and
    LGNN: K1; point cloud: K6's u_sub_v)."""
    total, rec = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    ggnn = _load_twin("train_ggnn_torch")
    task = ggnn.make_task(60, 24, 3, 4, 0)
    state = _initial_state(ggnn.train(task, epochs=0, device="cpu")["model"])
    res, counts, rel = _run_twin(
        build, "ggnn", lambda d, first: ggnn.train(
            task, epochs=1 if first else 30, n_train=1 if first else None,
            params=state, device=d), ("segment_sum.rows",), checks, dev,
        window=48)
    rec["ggnn"] = _twin_record("ggnn", res, counts, rel)
    add(counts)

    dgi = _load_twin("train_dgi_torch")
    data = dgi.make_data()
    state = _initial_state(dgi.train(data, epochs=0, device="cpu")["model"])
    res, counts, rel = _run_twin(
        build, "dgi", lambda d, first: dgi.train(
            data, epochs=1 if first else 60, params=state, device=d),
        ("segment_sum.fwd",), checks, dev)
    acc = dgi.probe(res["embeddings"], *data[2:])
    rec["dgi"] = _twin_record("dgi", res, counts, rel,
                              {"probe_test_acc": acc})
    add(counts)

    gcmc = _load_twin("train_gcmc_torch")
    data = gcmc.make_data()
    state = _initial_state(gcmc.train(data, epochs=0, device="cpu")["model"])
    res, counts, rel = _run_twin(
        build, "gcmc", lambda d, first: gcmc.train(
            data, epochs=1 if first else 60, params=state, device=d),
        ("segment_sum.fwd",), checks, dev)
    rec["gcmc"] = _twin_record("gcmc", res, counts, rel)
    add(counts)

    rrn = _load_twin("train_rrn_torch")
    params = rrn.init_params(np.random.default_rng(0), 64)

    def rrn_run(d, first):
        rng = np.random.default_rng(0)
        rrn.init_params(rng, 64)          # the draws the CLI makes first
        return rrn.train(params, rng, epochs=1 if first else 300,
                         device=d, log=None)
    res, counts, rel = _run_twin(build, "rrn", rrn_run,
                                 ("segment_sum.rows",), checks, dev,
                                 window=20)
    rec["rrn"] = _twin_record("rrn", res, counts, rel)
    add(counts)

    lgnn = _load_twin("train_lgnn_torch")
    t0 = time.perf_counter()
    data = lgnn.make_data(SMALL_LGNN["graphs"], SMALL_LGNN["nodes"])
    data_s = time.perf_counter() - t0
    state = _initial_state(lgnn.train(data, epochs=0, device="cpu")["model"])
    res, counts, rel = _run_twin(
        build, "lgnn", lambda d, first: lgnn.train(
            data, epochs=1 if first else SMALL_LGNN["epochs"],
            n_train=1 if first else None,
            params=state, device=d), ("segment_sum.fwd",), checks, dev,
        window=8)
    rec["lgnn"] = _twin_record("lgnn", res, counts, rel, {
        **SMALL_LGNN, "data_s": data_s,
        "graph_edges": [g.num_edges() for g, *_ in data[:3]],
        "line_graph_edges": [lg.num_edges() for _, lg, *_ in data[:3]]})
    add(counts)

    pc = _load_twin("train_pointcloud_torch")
    data = pc.make_data()
    state = _initial_state(pc.train(data, epochs=0, device="cpu")["model"])
    res, counts, rel = _run_twin(
        build, "pointcloud", lambda d, first: pc.train(
            data, epochs=1 if first else 20, n_train=1 if first else None,
            params=state, device=d), ("sddmm.fwd",), checks, dev,
        window=72)
    rec["pointcloud"] = _twin_record("pointcloud", res, counts, rel)
    add(counts)
    emit({"phase": "small_twins", **rec})
    checks.raise_if_failed("small_twins")
    return total


# ---------------------------------------------------------------------------
# slice 15: datasets, checkpoints, profiling, partitioning and Cluster-GCN
# ---------------------------------------------------------------------------
def phase_profiling(sk, g, checks, dev):
    """``utils.profiling.timed_loop`` at bench.py's shape (N = 1 M, F =
    128): K1's forward chained ``h = K1(h) * 0.9999`` at 2 and 6 links,
    the difference per link, against ``cuda_ms`` of one link (the same
    work) and of K1 alone; fails if the two timers differ by over 25%."""
    from dgl_hack_tpu_torch.utils import timed_loop
    rng = np.random.default_rng(9)
    x = torch.from_numpy((1e-3 * rng.normal(size=(g.num_src_nodes, 128)))
                         .astype(np.float32)).to(dev)
    plan = sk.graph_row_plan(g, "csc")

    def k1(h):
        return sk.segment_sum(g.csc_indptr, h, g.src, plan=plan)
    loop_ms = 1e3 * timed_loop(k1, x, k_lo=2, k_hi=6, repeats=3)
    link_ms = cuda_ms(lambda: k1(x) * 0.9999)
    k1_ms = cuda_ms(lambda: k1(x))
    diff = abs(loop_ms - link_ms) / link_ms
    emit({"phase": "profiling", "shape": "bench.py graph, F=128, fwd",
          "timed_loop_ms": loop_ms, "cuda_ms_link": link_ms,
          "cuda_ms_k1": k1_ms, "rel_diff": diff, "limit": 0.25})
    if not diff <= 0.25:
        raise SystemExit(f"profiling failed: timed_loop {loop_ms:.4g} ms "
                         f"against cuda_ms {link_ms:.4g} ms")


DATASET_DIR = os.path.join(REPO, "tests", "fixtures", "data")


def _fixture_datasets():
    """Every dataset of tests/fixtures/data parsed on the host, with
    DGL_DOWNLOAD_DIR pointing there for the call alone: (node
    classification datasets by name, the other datasets by name, parse
    seconds, the synthetic warnings raised)."""
    import warnings
    from dgl_hack_tpu_torch import data
    old = os.environ.get("DGL_DOWNLOAD_DIR")
    os.environ["DGL_DOWNLOAD_DIR"] = DATASET_DIR
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            node = {"cora": data.CoraGraphDataset(),
                    "citeseer": data.CiteseerGraphDataset(),
                    "reddit": data.RedditDataset(),
                    "amazon_co_buy_computer":
                        data.AmazonCoBuyComputerDataset()}
            other = {"ppi": data.load_ppi("train"),
                     "tu": data.TUDataset("MINI"),
                     "gin": data.GINDataset("MINI", degree_as_nlabel=True),
                     "bitcoinotc": data.load_bitcoinotc(),
                     "qm7b": data.load_qm7b(),
                     "gdelt": data.GDELTDataset("train"),
                     "icews18": data.ICEWS18Dataset("train")}
            seconds = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["DGL_DOWNLOAD_DIR"]
        else:
            os.environ["DGL_DOWNLOAD_DIR"] = old
    synth = [str(w.message) for w in rec if "synthetic" in str(w.message)]
    return node, other, seconds, synth


def phase_datasets(dt, build, checks, dev):
    """The fixture datasets parsed on the host (no synthetic stand-in);
    each node-classification graph (and each PPI graph) on the card through
    gspmm copy_u sum (K1) against K1's plain version on the host in
    float64; a card graph with node and edge features and a card
    heterograph through save_graphs/load_graphs and
    save_heterograph/load_heterograph."""
    from dgl_hack_tpu_torch.data import (load_graphs, load_heterograph,
                                         save_graphs, save_heterograph)
    node, other, parse_s, synth = _fixture_datasets()
    if synth:
        checks.failures.append(f"datasets: synthetic stand-ins {synth}")
    graphs = [(name, ds.graph, ds.features) for name, ds in node.items()]
    graphs += [(f"ppi[{i}]", g, x) for i, (g, x, _)
               in enumerate(other["ppi"])]
    rec = {}
    for name, g, x in graphs:
        xt = torch.from_numpy(np.asarray(x, np.float32))
        build.LAUNCHES.reset()
        out = dt.gspmm(g.to(dev), "copy_lhs", "sum", xt.to(dev))
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES.counts)
        ref = dt.gspmm(g, "copy_lhs", "sum", xt.double()).float()
        rec[name] = {"nodes": g.num_nodes(), "edges": g.num_edges(),
                     "features": int(xt.shape[1]), "launches": counts,
                     "rel_err": checks.compare(
                         "segment_sum", f"datasets {name}", out.cpu(), ref,
                         K1_TOL)}
        if counts.get("segment_sum.fwd", 0) < 1 or any(
                k.startswith("plain.") for k in counts):
            checks.failures.append(f"datasets {name}: launches {counts}")
    io_dir = os.path.join(REPO, "build", "chip_smoke_io")
    os.makedirs(io_dir, exist_ok=True)
    cora = node["cora"]
    g = cora.graph.to(dev)
    g.ndata["feat"] = torch.from_numpy(cora.features).to(dev)
    g.edata["w"] = torch.arange(g.num_edges(), dtype=torch.float32,
                                device=dev)
    path = os.path.join(io_dir, "cora.npz")
    save_graphs(path, [g], {"labels": cora.labels})
    (back,), labels = load_graphs(path)
    io_ok = (back.device.type == "cpu"
             and all(np.array_equal(a, b) for a, b in
                     zip(back.host_edges(), cora.graph.host_edges()))
             and torch.equal(back.ndata["feat"], g.ndata["feat"].cpu())
             and torch.equal(back.edata["w"], g.edata["w"].cpu())
             and np.array_equal(labels["labels"], cora.labels))
    rng = np.random.default_rng(4)
    hg = dt.heterograph({("user", "follows", "user"): (
        rng.integers(0, 50, 300), rng.integers(0, 50, 300)),
        ("user", "plays", "game"): (rng.integers(0, 50, 200),
                                    rng.integers(0, 9, 200))},
        num_nodes_dict={"user": 50, "game": 9}).to(dev)
    hg.nodes_data("user")["x"] = torch.ones(50, 3, device=dev)
    path = os.path.join(io_dir, "hetero.npz")
    save_heterograph(path, hg)
    hb = load_heterograph(path)
    hetero_ok = (sorted(hb.canonical_etypes) == sorted(hg.canonical_etypes)
                 and all(np.array_equal(a, b) for c in hg.canonical_etypes
                         for a, b in zip(hb.relations[c].host_edges(),
                                         hg.relations[c].host_edges()))
                 and torch.equal(hb.nodes_data("user")["x"],
                                 torch.ones(50, 3)))
    if not (io_ok and hetero_ok):
        checks.failures.append(f"datasets: graph files round trip "
                               f"{io_ok}, heterograph {hetero_ok}")
    emit({"phase": "datasets", "parse_s": parse_s, "graphs": rec,
          "others": {k: len(v.graphs) if hasattr(v, "graphs")
                     else len(v.triplets) for k, v in other.items()},
          "graph_file_round_trip": io_ok, "heterograph_round_trip":
          hetero_ok})
    checks.raise_if_failed("datasets")


def phase_checkpoint_resume(dt, build, dev):
    """GCN (hidden 16, no dropout) on synthetic Cora on the card, Adam
    lr 1e-2: 3 steps, ``save_checkpoint`` of the model's and Adam's state,
    a fresh model and Adam loaded through ``load_checkpoint``, 2 more
    steps; the 5 losses must equal those of 5 uninterrupted steps bit for
    bit (K1 sums in a fixed order)."""
    from dgl_hack_tpu_torch.data import synthetic_cora
    from dgl_hack_tpu_torch.models import GCN
    from dgl_hack_tpu_torch.models.training import masked_cross_entropy
    from dgl_hack_tpu_torch.utils import load_checkpoint, save_checkpoint
    ds = synthetic_cora(seed=0)
    g = dt.prepare_spmm(ds.graph, device=dev)
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels).long().to(dev)
    m = torch.from_numpy(ds.train_mask).to(dev)

    def fresh():
        torch.manual_seed(0)
        model = GCN(16, ds.num_classes).to(dev)
        with torch.no_grad():
            model(g, x, deterministic=True)
        return model, torch.optim.Adam(model.parameters(), lr=1e-2)

    def steps(model, opt, n):
        out = []
        for _ in range(n):
            loss = masked_cross_entropy(model(g, x, deterministic=True), y,
                                        m)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            out.append(float(loss.detach()))
        return out
    ref = steps(*fresh(), 5)
    build.LAUNCHES.reset()
    model, opt = fresh()
    first = steps(model, opt, 3)
    ck_dir = os.path.join(REPO, "build", "chip_smoke_ckpt")
    fname = save_checkpoint(os.path.join(ck_dir, "gcn"),
                            {"model": model.state_dict(),
                             "opt": opt.state_dict()}, step=3)
    ck = load_checkpoint(ck_dir)
    model, opt = fresh()
    model.load_state_dict(ck["state"]["model"])
    opt.load_state_dict(ck["state"]["opt"])
    resumed = first + steps(model, opt, 2)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    emit({"phase": "checkpoint_resume", "file": os.path.basename(fname),
          "step": ck["step"], "losses": resumed, "uninterrupted": ref,
          "bitwise_equal": resumed == ref,
          "max_abs_diff": max(abs(a - b) for a, b in zip(resumed, ref)),
          "launches": counts})
    _check_training("checkpoint_resume", {"losses": resumed}, counts,
                    ("segment_sum.fwd", "segment_sum.rev"))
    if resumed != ref or ck["step"] != 3:
        raise SystemExit(f"checkpoint_resume failed: {resumed} != {ref}")
    return counts


CLUSTER = dict(parts=8, hidden=32, lr=1e-2, warm_epochs=2, epochs=5)


def _cluster_first_step(twin, ds, batch, state, checks, dev, tag):
    """The first part step on the card against a CPU copy of the same
    part and parameters, the CPU replaying the card's relu gates: the
    loss and every gradient within LAYER_TOL; returns the card's loss."""
    from dgl_hack_tpu_torch.models.training import masked_cross_entropy
    h = CLUSTER["hidden"]
    losses, models = [], []
    gates = _ReluGates()
    for device, b, record in (
            (dev, twin.to_device([batch], dev)[0], True),
            ("cpu", twin.to_device([batch], "cpu")[0], False)):
        model = twin.build_model(h, ds.num_classes, device, b, state)
        model.layer0.activation = lambda t: F.relu(t)   # seen by _ReluGates
        with gates.use(record=record):
            loss = masked_cross_entropy(model(b[0], b[1],
                                              deterministic=True),
                                        b[2], b[3])
        loss.backward()
        losses.append(loss.detach().cpu())
        models.append(model)
    rel = rel_err(losses[0], losses[1])
    if not rel <= LAYER_TOL:
        checks.failures.append(f"{tag} first loss vs CPU: {rel:.3g}")
    worst = _grads_close(checks, tag, models[0], models[1])
    return {"loss": float(losses[0]), "loss_rel_vs_cpu": rel,
            "grad_rel_vs_cpu": worst, "relu_gate_flips": gates.flips}


def _k1_on_part(sk, sub, checks, tag):
    """K1 forward at the part step's aggregation width (32) on a part
    graph, against its plain version in float64, timed beside its bound,
    its plain version and torch.sparse.mm."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(sub.num_src_nodes, 32))
                         .astype(np.float32)).to(sub.device)
    args = (sub.csc_indptr, x, sub.src)
    plan = sk.graph_row_plan(sub, "csc")
    out = sk.segment_sum(*args, plan=plan)
    checks.compare("segment_sum", f"{tag} F=32 fwd", out, k1_ref(sk, *args),
                   K1_TOL, sk.segment_sum(*args, plan=plan))
    A = csr_matrix(sub)
    rec = timing(both_ms(lambda: sk.segment_sum(*args, plan=plan)),
                 cuda_ms(lambda: sk.segment_sum_plain(*args), reps=3),
                 nbytes(sub.csc_indptr, sub.src, x, out),
                 sub.num_edges() * 32,
                 f"{tag}: {sub.num_dst_nodes} rows, {sub.num_edges()} "
                 "edges, F=32, fwd",
                 library_ms=cuda_ms(lambda: torch.sparse.mm(A, x)))
    rec["edges_per_row"] = sub.num_edges() / max(sub.num_dst_nodes, 1)
    return rec


def _cluster_run(twin, sk, build, ds, batches, state, checks, dev, tag):
    """The twin's loop over ``batches``: the first step against the CPU,
    then 2 + 5 epochs (launches counted; median step over the last 5
    epochs; peak memory), one step of the third epoch profiled (device ms
    by kernel and the busy share of that step)."""
    first = _cluster_first_step(twin, ds, batches[0], state, checks, dev,
                                tag)
    n_parts = len(batches)
    warm = CLUSTER["warm_epochs"] * n_parts
    win = _Window(warm, warm + 1)
    reset_peak_memory()
    build.LAUNCHES.reset()
    res = twin.train(ds, batches, hidden=CLUSTER["hidden"],
                     lr=CLUSTER["lr"], params=state,
                     epochs=CLUSTER["warm_epochs"] + CLUSTER["epochs"],
                     device=dev, on_step=win.on_step)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    rec = {"steps": len(losses), "first_step": first,
           "first_loss_equal_to_checked": losses[0] == first["loss"],
           "losses_first_last": [losses[:3], losses[-3:]],
           "step_ms_median": float(np.median(res["step_ms"][warm:])),
           "step_ms_min_max": [min(res["step_ms"][warm:]),
                               max(res["step_ms"][warm:])],
           "peak_memory_bytes": peak, "launches": counts,
           "profiled_step": win.stats(tag)}
    _check_training(tag, {"losses": losses[::n_parts]}, counts,
                    ("segment_sum.fwd", "segment_sum.rev"))
    return res, counts, rec


def phase_cluster_gcn_train(dt, build, sk, ds, checks, dev, timings):
    """examples/train_cluster_gcn_torch.py on full synthetic Reddit
    (``RedditDataset(scale=1.0)``: 232,965 nodes, 602 features,
    23,526,213 edges) at the CLI's --parts 8 and --hidden 32: Fennel's
    seconds and the halo build's at 0 hops (``metis_partition`` as the
    CLI calls it; parts of self loops only) and 1 hop (each part's
    in-edges and halo), each part's nodes, edges and inner edges; K1 on a
    part of each kind against its plain version and timed beside its bound
    (at 0 hops one edge a row); then at each depth the first step against
    the CPU and 2 + 5 epochs (``_cluster_run``); the full-graph evaluation
    of the last model through K1 at the end."""
    twin = _load_twin("train_cluster_gcn_torch")
    import importlib
    pp = importlib.import_module("dgl_hack_tpu_torch.partition.partition")
    g, k = ds.graph, CLUSTER["parts"]
    t0 = time.perf_counter()
    assign = pp.partition(g, k, method="fennel")
    fennel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts0 = pp.metis_partition(g, k, extra_cached_hops=0)
    metis0_s = time.perf_counter() - t0
    same = all(np.array_equal(p.node_map, np.nonzero(assign == p.part_id)[0])
               for p in parts0)
    t0 = time.perf_counter()
    parts1 = pp.partition_graph_with_halo(g, assign, num_hops=1)
    halo1_s = time.perf_counter() - t0
    rec = {"nodes": g.num_nodes(), "edges": g.num_edges(),
           "features": int(ds.features.shape[1]), **CLUSTER,
           "fennel_s": fennel_s, "metis_partition_hops0_s": metis0_s,
           "halo_hops1_s": halo1_s, "metis_parts_equal_fennel": same}
    if not same:
        checks.failures.append("cluster_gcn: metis_partition's parts differ "
                               "from partition()'s")
    total = {}
    res = None
    for hops, parts in ((0, parts0), (1, parts1)):
        t0 = time.perf_counter()
        batches = twin.batches_of(ds, parts)
        batch_s = time.perf_counter() - t0
        tag = f"cluster_gcn hops={hops}"
        t0 = time.perf_counter()
        sub = twin.to_device(batches[:1], dev)[0][0]
        torch.cuda.synchronize()
        copy_plan_ms = 1e3 * (time.perf_counter() - t0)
        k1 = _k1_on_part(sk, sub, checks, tag)
        state = _initial_state(twin.build_model(
            CLUSTER["hidden"], ds.num_classes, "cpu",
            twin.to_device(batches[:1], "cpu")[0]))
        res, counts, run = _cluster_run(twin, sk, build, ds, batches, state,
                                        checks, dev, tag)
        rec[f"hops{hops}"] = {
            "batches_s": batch_s, "part0_copy_plan_ms": copy_plan_ms,
            "part_nodes": [p.graph.num_nodes() for p in parts],
            "part_edges": [p.graph.num_edges() for p in parts],
            "part_inner_edges": [int(p.inner_edge.sum()) for p in parts],
            "k1_part0": k1, **run}
        if hops == 0:
            timings["segment_sum"]["cluster_one_edge_rows"] = k1
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        del batches
    t0 = time.perf_counter()
    full = twin.full_graph(ds, dev)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    build.LAUNCHES.reset()
    acc = twin.evaluate(res["model"], full, ds)
    eval_counts = dict(build.LAUNCHES.counts)
    for key, v in eval_counts.items():
        total[key] = total.get(key, 0) + v
    rec["eval"] = {"graph_build_s": full_s, "test_acc": acc,
                   "launches": eval_counts}
    emit({"phase": "cluster_gcn_train", **rec})
    if eval_counts.get("segment_sum.fwd", 0) < 1 or not 0.0 <= acc <= 1.0:
        checks.failures.append(f"cluster_gcn eval: acc {acc}, launches "
                               f"{eval_counts}")
    checks.raise_if_failed("cluster_gcn_train")
    return total


# ---------------------------------------------------------------------------
# slice 16: segment ids, knowledge-graph embeddings, the distributed stack
# and DGMG
# ---------------------------------------------------------------------------
def phase_segment_ids(dev):
    """The plain segment reductions and ``bincount`` on the card with ids
    outside [0, n): the re-anchor's probe (ids [0, 2, 3, -1] into 3
    segments) and ids -1 and n among real ones, every reducer, each equal
    to the CPU's result (which the tests hold to the JAX package's).
    Without the repair an out-of-range index is a device-side assert that
    ends the CUDA context."""
    from dgl_hack_tpu_torch.ops import segment as seg
    rng = np.random.default_rng(16)
    ids = rng.integers(0, 5, 40).astype(np.int32)
    ids[[1, 7]] = -1
    ids[[3, 9]] = 5
    cases = {"probe": (np.array([1.0, 2.0, 3.0, 4.0], np.float32),
                       np.array([0, 2, 3, -1], np.int32), 3),
             "mixed": (rng.uniform(0.5, 1.5, (40, 6)).astype(np.float32),
                       ids, 5)}
    out, bad = {}, []
    for name, (data, idx, n) in cases.items():
        for reducer in ("sum", "mean", "max", "min", "prod"):
            ref = seg.segment_reduce(reducer, torch.from_numpy(data),
                                     torch.from_numpy(idx), n)
            got = seg.segment_reduce(
                reducer, torch.from_numpy(data).to(dev),
                torch.from_numpy(idx).to(dev), n).cpu()
            err = rel_err(got, ref)
            out[f"{name}.{reducer}"] = err
            if not err <= 1e-6:
                bad.append(f"{name} {reducer}: rel err {err}")
        ref = seg.bincount(torch.from_numpy(idx), None, n)
        got = seg.bincount(torch.from_numpy(idx).to(dev), None, n).cpu()
        out[f"{name}.bincount"] = got.tolist() if name == "probe" else \
            rel_err(got, ref)
        if not torch.equal(got, ref):
            bad.append(f"{name} bincount: {got.tolist()}")
    torch.cuda.synchronize()
    emit({"phase": "segment_ids", "rel_err_vs_cpu": out})
    if bad or out["probe.bincount"] != [1.0, 0.0, 1.0]:
        raise SystemExit("segment_ids failed: " + "; ".join(bad))


KG = dict(model="TransE_l2", hidden=400, batch=1024, neg=256, chunk=64,
          gamma=19.9, lr=0.25, scale=0.1, steps=50, warm=10, window=10,
          eval_triples=500, check_batch=256)
KG_FULL = dict(entities=14951, relations=1345, triples=512,
               train_triples=483142)


def _kg_args(ds, mode):
    """The KG twin's ``train`` arguments at DGL-KE's FB15k widths for one
    trainer (``mode``: dense, sparse or async)."""
    return ((ds, KG["model"], KG["hidden"], KG["gamma"], KG["lr"],
             KG["batch"], KG["neg"], KG["chunk"]),
            dict(sparse_emb=mode == "sparse", async_update=mode == "async",
                 log=None))


def _kg_timed(twin, ds, mode, dev, phase):
    """``KG['steps']`` steps of one trainer of the KG twin on the card: a
    profiled window (``_Window``: busy share, launches), the median step
    after that window from CUDA events recorded after each step (device
    time between steps) and from the host clock (the loop's pace), and
    peak memory.  Returns the twin's result and that record."""
    args, kw = _kg_args(ds, mode)
    win = _Window(KG["warm"] - 1, KG["warm"] + KG["window"] - 1)
    events, host = [], []

    def on_step(n):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        host.append(time.perf_counter())
        win.on_step(n)
    reset_peak_memory()
    res = twin.train(*args, KG["steps"], device=dev, on_step=on_step, **kw)
    peak = torch.cuda.max_memory_allocated()
    after = KG["warm"] + KG["window"]          # past the profiled window
    gaps = [a.elapsed_time(b) for a, b in zip(events[after:],
                                               events[after + 1:])]
    return res, {"step_ms_median_events": float(np.median(gaps)),
                 "step_ms_median_host":
                     float(np.median(1e3 * np.diff(host[after:]))),
                 "train_time_s": res["train_time_s"],
                 "window": win.stats(phase), "peak_memory_bytes": peak}


def _kg_mode(build, twin, ds, mode, checks, dev):
    """One trainer of the KG twin at DGL-KE's FB15k widths: the first 5
    losses against a CPU copy (same tables: ``KEModel`` draws on the CPU;
    same batches), ``KG['steps']`` timed steps on the card
    (``_kg_timed``; the loss must fall) and the MRR."""
    from dgl_hack_tpu_torch.models.kg import eval_ranks
    args, kw = _kg_args(ds, mode)
    cpu = twin.train(*args, 5, device="cpu", **kw)
    res, rec = _kg_timed(twin, ds, mode, dev, "kg_train")
    _twin_checks(f"kg_train {mode}", res["losses"],
                 dict(build.LAUNCHES.counts), need=(), window=3)
    first = res["losses"][:5]
    rel = float(np.max(np.abs(np.subtract(first, cpu["losses"]))
                       / np.abs(cpu["losses"])))
    checks.compare("kg", f"{mode} first losses", torch.tensor(first),
                   torch.tensor(cpu["losses"]), LAYER_TOL)
    te = ds.test
    k = KG["eval_triples"]
    t0 = time.perf_counter()
    metrics = eval_ranks(res["model"], res["params"], te[0][:k], te[1][:k],
                         te[2][:k])
    return {"first_losses_rel_vs_cpu": rel,
            "losses_first_last": [first[:3], res["losses"][-3:]], **rec,
            "MRR": metrics["MRR"], "HITS@10": metrics["HITS@10"],
            "eval_s": time.perf_counter() - t0}


def _kg_full_steps(build, twin, dev):
    """The three trainers' timed steps (``_kg_timed``) on tables at
    FB15k's full counts (14,951 entities, 1,345 relations: the dense step
    updates every row of both) with FB15k's 483,142 training triples drawn
    at random over those ids: the data are random, so only finite losses
    are asked of them."""
    from dgl_hack_tpu_torch.data import KGDataset
    rng = np.random.default_rng(8)
    E, R = KG_FULL["entities"], KG_FULL["relations"]

    def triples(n):
        return (rng.integers(0, E, n), rng.integers(0, R, n),
                rng.integers(0, E, n))
    ds = KGDataset(E, R, triples(KG_FULL["train_triples"]), triples(0),
                   triples(0), "FB15k-counts-random")
    out = {}
    for mode in ("dense", "sparse", "async"):
        build.LAUNCHES.reset()
        res, out[mode] = _kg_timed(twin, ds, mode, dev, "kg_train")
        plain = {k: v for k, v in build.LAUNCHES.counts.items()
                 if k.startswith("plain.")}
        if plain or not np.isfinite(res["losses"]).all():
            raise SystemExit(f"kg_train failed: full counts {mode}: losses "
                             f"{res['losses']}, plain paths {plain}")
        out[mode]["losses_first_last"] = [res["losses"][:3],
                                          res["losses"][-3:]]
        del res
        torch.cuda.empty_cache()
    return out


def _kg_other_scores(ds, checks, dev):
    """One dense Adagrad step of each other score function at hidden 400
    (ComplEx and RotatE 800-wide entities, RESCAL's relation 400², TransR's
    400 + 400·400): timed at the full batch on the card (CUDA events: a
    step alone, the host's launches included, and queued behind a busy
    card, its device time alone), and
    the loss and both updated tables at ``check_batch`` triples against
    the same step on the CPU from the same tables."""
    from dgl_hack_tpu_torch.models import kg
    out = {}
    rng = np.random.default_rng(5)
    h, r, t = ds.train
    for name in ("TransE_l1", "DistMult", "ComplEx", "RESCAL", "RotatE",
                 "TransR"):
        rec = {}
        for B in (KG["batch"], KG["check_batch"]):
            sel = rng.integers(0, len(h), B)
            neg = rng.integers(0, ds.num_entities,
                               (B // KG["chunk"], KG["neg"]))
            batch = [torch.from_numpy(np.asarray(x)) for x in
                     (h[sel], r[sel], t[sel], neg)]
            runs = {}
            for device in ((dev, "cpu") if B == KG["check_batch"]
                           else (dev,)):
                model = kg.KEModel(ds.num_entities, ds.num_relations,
                                   KG["hidden"], name, gamma=KG["gamma"],
                                   device=device)
                tx = kg.adagrad(KG["lr"])
                state = tx.init(model.params)
                step = kg.make_train_step(model, tx, KG["chunk"])
                b = [x.to(device) for x in batch]
                if B == KG["batch"]:
                    def one():
                        step(model.params, state, *b, False)
                    rec["ms"] = cuda_ms(one, reps=5, one_launch=True)
                    rec["device_ms"] = cuda_ms(one, reps=5, queued=True)
                    rec["relation_width"] = model.params["relation"].shape[1]
                    break
                p, _, loss = step(model.params, state, *b, True)
                runs[device if device == "cpu" else "cuda"] = (p, loss)
            if runs:
                (pc, lc), (pd, ld) = runs["cpu"], runs["cuda"]
                rec["loss_rel_vs_cpu"] = checks.compare(
                    "kg", f"{name} loss", ld.cpu(), lc, LAYER_TOL)
                rec["tables_rel_vs_cpu"] = max(
                    checks.compare("kg", f"{name} {k}", pd[k].cpu(), pc[k],
                                   LAYER_TOL) for k in pc)
            del runs
        out[name] = rec
        torch.cuda.empty_cache()
    return out


def _kg_full_eval(checks, dev):
    """``eval_ranks`` of KG_FULL['triples'] random triples on random tables
    at FB15k's full counts (hidden 400): TransE_l2 (one product against the
    unbroadcast table) and TransE_l1 (chunks of entities), each timed
    (host clock, ending in the ranking on the host) with its peak memory,
    and the first 64 rows' scores against the CPU's."""
    from dgl_hack_tpu_torch.models import kg
    rng = np.random.default_rng(6)
    n = KG_FULL["triples"]
    trip = [rng.integers(0, KG_FULL["entities"], n),
            rng.integers(0, KG_FULL["relations"], n),
            rng.integers(0, KG_FULL["entities"], n)]
    out = {}
    for name in ("TransE_l2", "TransE_l1"):
        model = kg.KEModel(KG_FULL["entities"], KG_FULL["relations"],
                           KG["hidden"], name, gamma=KG["gamma"], device=dev)
        eval_ranks = kg.eval_ranks
        eval_ranks(model, model.params, *(x[:8] for x in trip))   # warm-up
        torch.cuda.synchronize()
        reset_peak_memory()
        t0 = time.perf_counter()
        m = eval_ranks(model, model.params, *trip, batch=512)
        s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        cpu = {k: v.cpu() for k, v in model.params.items()}
        hr = [torch.from_numpy(x[:64]) for x in trip[:2]]
        with torch.no_grad():
            ref = model.predict_all_tails(cpu, *hr)
            got = model.predict_all_tails(model.params,
                                          *(x.to(dev) for x in hr)).cpu()
        out[name] = {"seconds": s, "peak_memory_bytes": peak,
                     "MRR": m["MRR"],
                     "scores_rel_vs_cpu": checks.compare(
                         "kg", f"{name} all tails", got, ref, LAYER_TOL)}
        del model
        torch.cuda.empty_cache()
    return out


def phase_kg_train(build, checks, dev):
    """examples/train_kg_torch.py at DGL-KE's published FB15k widths
    (examples/train_kg.py:3-4: TransE_l2, hidden 400, batch 1,024, 256
    negatives in chunks of 64, gamma 19.9, lr 0.25) on synthetic FB15k at
    the example's default scale 0.1: dense (optax's Adagrad), --sparse_emb
    and --async_update, 50 steps each (``_kg_mode``); the same three
    trainers timed on tables at FB15k's full counts (``_kg_full_steps``);
    one step of each other score function (``_kg_other_scores``);
    ``eval_ranks`` at FB15k's full counts (``_kg_full_eval``).  No hand-written kernel is on these
    paths; no plain path may run on the card."""
    from dgl_hack_tpu_torch.data import load_kg_dataset
    twin = _load_twin("train_kg_torch")
    t0 = time.perf_counter()
    ds = load_kg_dataset("FB15k-synth", scale=KG["scale"])
    data_s = time.perf_counter() - t0
    build.LAUNCHES.reset()
    rec = {mode: _kg_mode(build, twin, ds, mode, checks, dev)
           for mode in ("dense", "sparse", "async")}
    counts = dict(build.LAUNCHES.counts)
    rec["full_counts_steps"] = _kg_full_steps(build, twin, dev)
    rec["other_scores"] = _kg_other_scores(ds, checks, dev)
    rec["full_counts_eval"] = _kg_full_eval(checks, dev)
    emit({"phase": "kg_train", **{k: KG[k] for k in ("model", "hidden",
                                                      "batch", "neg", "chunk",
                                                      "steps")},
          "entities": ds.num_entities, "relations": ds.num_relations,
          "train_triples": len(ds.train[0]), "data_s": data_s,
          "launches": counts, "tolerance": LAYER_TOL, **rec})
    checks.raise_if_failed("kg_train")
    for mode in ("dense", "sparse", "async"):
        if not rec[mode]["MRR"] > 0:
            raise SystemExit(f"kg_train failed: {mode} MRR {rec[mode]['MRR']}")
    return ds


def _free_port_pair(gap, tries=64):
    """A local port ``p`` that the OS hands out with ``p + gap`` free
    too (``make_transports`` listens on both): each is bound once to
    prove it."""
    import socket
    for _ in range(tries):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            base = a.getsockname()[1]
            if base + gap > 65535:
                continue
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", base + gap))
                except OSError:
                    continue
        return base
    raise SystemExit(f"kg_dist failed: no free local ports p and p + {gap} "
                     f"in {tries} tries")


def _native_round_trip(rows=1024, width=400):
    """One push and one pull of ``rows`` rows over NativeTransport on two
    local ports (the port's netcomm.cpp, built here with g++): the pulled
    rows equal the pushed sums, with the build's and the round trip's
    seconds."""
    import threading
    from dgl_hack_tpu_torch import native
    from dgl_hack_tpu_torch.distributed import (KVClient, KVServer,
                                                make_transports)
    t0 = time.perf_counter()
    native.get_net_lib()
    build_s = time.perf_counter() - t0
    base = _free_port_pair(100)
    st, ct = make_transports(1, 1, base_port=base)
    box = {}

    def serve():
        sv = KVServer(0, 1, transport=st(0))
        sv.init_data("emb", np.zeros((4 * rows, width), np.float32))
        sv.start()
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    c = KVClient(0, 1, transport=ct(0))
    c.set_partition_book("emb", np.zeros(4 * rows, np.int64))
    ids = np.arange(0, 4 * rows, 4)
    vals = np.random.default_rng(0).normal(size=(rows, width)).astype(
        np.float32)
    t0 = time.perf_counter()
    c.push("emb", ids, vals)
    box["got"] = c.pull("emb", ids)
    rt_s = time.perf_counter() - t0
    c.shutdown()
    th.join(30)
    ok = (not th.is_alive()) and np.array_equal(box["got"], vals)
    return {"transport": type(c.net).__name__, "ports": [base, base + 100],
            "library": native.NET_BUILD_INFO.get("path"),
            "build_s": build_s, "round_trip_s": rt_s,
            "bytes_each_way": int(vals.nbytes), "equal": ok}


def phase_kg_dist(build, ds, dev):
    """examples/train_kg_dist_torch.py's loop (2 servers and 2 clients,
    threads over the loopback transport, the twin's widths: hidden 64,
    batch 512, 64 negatives) on ``kg_train``'s dataset, 20 steps a client,
    the row gradients on the card: the losses, the step ms and the MRR;
    then a round trip over NativeTransport (``_native_round_trip``)."""
    from dgl_hack_tpu_torch.models.kg import eval_ranks
    twin = _load_twin("train_kg_dist_torch")
    build.LAUNCHES.reset()
    res = twin.train(ds, steps=20, device=dev)
    counts = dict(build.LAUNCHES.counts)
    for losses in res["losses"]:
        _twin_checks("kg_dist", losses, counts, need=(), window=5)
    te = ds.test
    m = eval_ranks(res["model"], res["params"], te[0][:500], te[1][:500],
                   te[2][:500])
    tcp = _native_round_trip()
    emit({"phase": "kg_dist", "servers": 2, "clients": 2, "steps": 20,
          "losses_first_last": [[l[:3], l[-3:]] for l in res["losses"]],
          "train_time_s": res["train_time_s"],
          "ms_per_client_step": 1e3 * res["train_time_s"] / 20,
          "MRR": m["MRR"], "launches": counts, "native_tcp": tcp})
    if not tcp["equal"]:
        raise SystemExit(f"kg_dist failed: NativeTransport round trip {tcp}")


DGMG = dict(hidden=128, rounds=2, max_nodes=32, max_edges=64, traces=48,
            steps=5, held_steps=3, lr=3e-3, samples=8, prop_scale=0.5,
            nudge=1e-12)


def _full_trace(V, E):
    """A molecule of exactly V atoms and E bonds: a path, then bonds
    (i, i + 2), then (i, i + 3), until E."""
    bonds = [(i, i + 1) for i in range(V - 1)]
    bonds += [(i, i + k) for k in (2, 3, 4) for i in range(V - k)]
    src, dst = np.array(bonds[:E]).T
    rng = np.random.default_rng(7)
    return rng.integers(0, 2, V), src, dst, rng.integers(0, 2, E)


def _dgmg_nll_grads(model, st, lb, device, dtype, scale=1.0):
    """The NLL of one trace and every parameter's gradient, on ``device``
    in ``dtype``, the model's weights multiplied by ``scale`` (a float or
    a name -> factor function)."""
    m = copy.deepcopy(model).to(device=device, dtype=dtype)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.mul_(scale(k) if callable(scale) else scale)
    nll = m(torch.from_numpy(st).to(device), torch.from_numpy(lb).to(device))
    nll.backward()
    return nll.detach().cpu(), {k: p.grad.cpu()
                                for k, p in m.named_parameters()}


def _dgmg_full_trace(model, dev, checks):
    """One trace that fills 32 nodes and 64 bonds exactly (every write at
    capacity dropped, every read clamped).  At the class's init its NLL is
    chaotic: the record shows the card's float64 NLL moved by weights
    nudged by DGMG['nudge'] (relative) and its float32 NLL's distance from
    float64; there it must be finite with finite gradients.  With the
    propagation weights (msg_fns, upd_fns) scaled by DGMG['prop_scale']
    the trace is well conditioned, and the card's float32 NLL and every
    gradient are held to the CPU's within LAYER_TOL (of the largest
    gradient)."""
    from dgl_hack_tpu_torch.models.dgmg import build_action_trace
    V, E = DGMG["max_nodes"], DGMG["max_edges"]
    st, lb = build_action_trace(*_full_trace(V, E), 2 * V + 2 * E + 2)
    n64, g64 = _dgmg_nll_grads(model, st, lb, dev, torch.float64)
    n_nudged, _ = _dgmg_nll_grads(model, st, lb, dev, torch.float64,
                                  1.0 + DGMG["nudge"])
    n32, g32 = _dgmg_nll_grads(model, st, lb, dev, torch.float32)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (n64, n32, *g64.values(), *g32.values()))
    if not finite:
        checks.failures.append("dgmg full trace at init: not finite")

    def prop(k):
        return DGMG["prop_scale"] if k.startswith(("msg_fns", "upd_fns")) \
            and "weight" in k else 1.0
    nd, gd = _dgmg_nll_grads(model, st, lb, dev, torch.float32, prop)
    nc, gc = _dgmg_nll_grads(model, st, lb, "cpu", torch.float32, prop)
    nll_rel = checks.compare("dgmg", "full trace nll", nd, nc, LAYER_TOL)
    scale = max(float(g.abs().max()) for g in gc.values())
    grad_rel = max(float((gd[k] - gc[k]).abs().max()) for k in gc) / scale
    if not (grad_rel <= LAYER_TOL and bool(torch.isfinite(nd))):
        checks.failures.append(f"dgmg full trace: grad rel err {grad_rel}")
    return {"steps": int((st != 3).sum()),
            "at_init": {"float64_nll": float(n64),
                        "float64_nll_moved_by_nudge":
                            abs(float(n_nudged) - float(n64))
                            / abs(float(n64)),
                        "float32_nll_rel_vs_float64":
                            abs(float(n32) - float(n64)) / abs(float(n64)),
                        "finite": finite},
            "prop_scaled": {"nll": float(nd), "nll_rel_vs_cpu": nll_rel,
                            "grad_rel_vs_cpu": grad_rel}}


def _dgmg_held_steps(init, snaps, losses, st, lb, dev, checks):
    """The first DGMG['held_steps'] Adam steps of the card's float32 run,
    each held to float64 on the card from the same parameters (the run's
    own, captured after each step): the loss within LAYER_TOL and every
    gradient within LAYER_TOL of the largest.  Beside them, how far a
    float64 nudge of DGMG['nudge'] (relative) of those parameters moves
    the loss: the conditioning that the tolerance leans on."""
    out = []
    params = [dict(init.named_parameters())] + [p for _, p in snaps[:-1]]
    for k, (grads, _) in enumerate(snaps):
        m = copy.deepcopy(init).to(dev, torch.float64)
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(params[k][name])
        loss = m(st, lb).mean()
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1.0 + DGMG["nudge"])
            nudged = float(m(st, lb).mean())
        scale = max(float(p.grad.abs().max()) for p in m.parameters())
        grad_rel = max(float((grads[name].double() - p.grad).abs().max())
                       for name, p in m.named_parameters()) / scale
        loss_rel = checks.compare("dgmg", f"Adam step {k + 1} loss vs "
                                  "float64", torch.tensor([losses[k]]),
                                  loss.cpu()[None], LAYER_TOL)
        if not grad_rel <= LAYER_TOL:
            checks.failures.append(f"dgmg Adam step {k + 1} gradients vs "
                                   f"float64: rel err {grad_rel}")
        out.append({"loss_rel_vs_float64": loss_rel,
                    "grad_rel_vs_float64": grad_rel,
                    "float64_loss_moved_by_nudge":
                        abs(nudged - float(loss)) / abs(float(loss))})
        del m
    return out


def phase_dgmg_train(build, checks, dev):
    """examples/train_dgmg_torch.py's model at the DGMG class's default
    widths (hidden 128, 2 propagation rounds, 32 nodes, 64 bonds), 2 node
    and 2 bond types: the twin's traces for 48 molecules of up to 30 atoms
    (the twin's toy world at these capacities), 5 full-batch Adam steps
    (the first loss against a CPU copy's forward from the same
    parameters; the first DGMG['held_steps'] steps against float64 from
    the same parameters, ``_dgmg_held_steps``; step ms; a profiled step:
    busy share and launches); the same 5 steps run on in float64 from the
    same init (recorded: past the first step the two runs part, the
    witness of what the later steps do); the trace that fills both
    capacities (``_dgmg_full_trace``); 8 samples from ``generate`` and the
    share that is structurally valid."""
    twin = _load_twin("train_dgmg_torch")
    V, E = DGMG["max_nodes"], DGMG["max_edges"]
    sts, lbs = twin.make_traces(DGMG["traces"], V, E)
    live = int((sts != 3).sum(1).max())
    init = twin.make_model(DGMG["hidden"], V, E, device="cpu")
    t_sts, t_lbs = (torch.from_numpy(x) for x in twin.trim(sts, lbs))
    with torch.no_grad():
        cpu_loss = init(t_sts, t_lbs).mean()
    win = _Window(DGMG["held_steps"], DGMG["held_steps"] + 1)
    card = copy.deepcopy(init).to(dev)
    snaps = []          # (gradients of step k, parameters after step k)

    def on_step(n):
        torch.cuda.synchronize()
        if n < DGMG["held_steps"]:
            snaps.append(tuple({k: getattr(p, what).detach().clone()
                                for k, p in card.named_parameters()}
                               for what in ("grad", "data")))
        win.on_step(n)
    build.LAUNCHES.reset()
    reset_peak_memory()
    res = twin.train(card, sts, lbs, DGMG["steps"], DGMG["lr"], device=dev,
                     on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    counts = dict(build.LAUNCHES.counts)
    losses = res["losses"]
    rel = checks.compare("dgmg", "first loss", torch.tensor(losses[:1]),
                         cpu_loss[None], LAYER_TOL)
    held = _dgmg_held_steps(init, snaps, losses, t_sts.to(dev),
                            t_lbs.to(dev), dev, checks)
    del snaps
    res64 = twin.train(copy.deepcopy(init).to(dev, torch.float64), sts, lbs,
                       DGMG["steps"], DGMG["lr"], device=dev)
    l32, l64 = np.array(losses), np.array(res64["losses"])
    # the example's lr (3e-3) at the class widths: the first Adam step
    # lowers the NLL; what later steps do, float64 witnesses
    if not (np.isfinite(losses).all() and losses[1] < losses[0]):
        checks.failures.append(f"dgmg losses {losses}")
    plain = {k: v for k, v in counts.items() if k.startswith("plain.")}
    if plain:
        checks.failures.append(f"dgmg: plain path ran on CUDA: {plain}")
    full = _dgmg_full_trace(init, dev, checks)
    t0 = time.perf_counter()
    out, frac = twin.sample(card, DGMG["samples"])
    gen_s = time.perf_counter() - t0
    emit({"phase": "dgmg_train", **DGMG, "live_steps_max": live,
          "trace_steps": int(sts.shape[1]), "losses": losses,
          "first_loss_rel_vs_cpu": rel, "held_steps_vs_float64": held,
          "float64_run_losses": res64["losses"],
          "float32_run_rel_vs_float64_run":
              (np.abs(l32 - l64) / np.abs(l64)).tolist(),
          "step_ms": res["step_ms"],
          "step_ms_median_after_first": float(np.median(res["step_ms"][1:])),
          "float64_step_ms_median_after_first":
              float(np.median(res64["step_ms"][1:])),
          "profiled_step": win.stats("dgmg_train"),
          "peak_memory_bytes": peak, "launches": counts,
          "full_trace": full,
          "generate": {"seconds": gen_s, "valid_frac": frac,
                       "num_nodes": out["num_nodes"].tolist(),
                       "num_edges": out["num_edges"].tolist()}})
    checks.raise_if_failed("dgmg_train")


# ---------------------------------------------------------------------------
# slice 17: multi-GPU (parallel/): spatial training over a halo exchange,
# the halo gspmm's every form, the dry-run twin and a one-rank NCCL group.
# The ranks are spawned processes that share the one card over gloo
# (RankPool); they load the kernel library phase 1 built.  No number of
# these phases is a multi-GPU scaling number.
# ---------------------------------------------------------------------------
SPATIAL = dict(parts=4, hub_k=64, gcn_hidden=16, gat_hidden=8,
               gat_heads=(8, 1), gcn_steps=3, gat_steps=2, lr=1e-2)
SPATIAL_DIR = os.path.join(REPO, "build", "spatial_reddit")


def _rank_counts(build):
    """This rank's launch counts, and the names of any plain path that ran
    on the card."""
    counts = dict(build.LAUNCHES.counts)
    return counts, sorted(k for k in counts if k.startswith("plain."))


def _events_ms(fn) -> float:
    """fn()'s device milliseconds between two CUDA events (the ranks time
    their own calls; every rank of the group calls together)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def _spatial_reddit_rank(device, sizes, num_classes, cfg):
    """One rank of ``spatial_reddit``: its slice of the plan and its rows
    of the features from the files the parent wrote, the block graphs
    readied once, then spatial GCN and spatial GAT: the forward before
    training (returned for the check), ``gcn_steps`` / ``gat_steps`` Adam
    steps with their host-clock ms, the halo exchange at each model's
    widths timed with CUDA events, launches and peak memory."""
    import gc
    import torch.distributed as dist
    from dgl_hack_tpu_torch.ops.cuda import build
    from dgl_hack_tpu_torch.parallel import halo as H
    r = dist.get_rank()
    torch.cuda.reset_peak_memory_stats(device)
    arrs = torch.load(os.path.join(SPATIAL_DIR, f"rank{r}.pt"),
                      map_location=device)
    x, y, m = arrs.pop("x"), arrs.pop("y"), arrs.pop("m")
    t0 = time.perf_counter()
    H.prepare_rank(sizes, arrs)
    torch.cuda.synchronize(device)
    out = {"ready_s": time.perf_counter() - t0}

    def exchange_ms(width):
        h = torch.ones((sizes.n_owned_max, width), device=device)
        ms = []
        for _ in range(3):
            dist.barrier()
            ms.append(_events_ms(lambda: H.halo_exchange(
                h, arrs["send_idx"], arrs["send_mask"], None,
                arrs["hub_idx"], arrs["hub_mask"])))
        return float(np.median(ms))

    def train(name, fwd, params, plist, steps):
        build.LAUNCHES.reset()
        with torch.no_grad():
            logits = fwd(params, x, arrs)
        step = H.spatial_train_step(fwd, torch.optim.Adam(plist,
                                                          lr=cfg["lr"]))
        losses, ms = [], []
        for _ in range(steps):
            dist.barrier()
            t = time.perf_counter()
            losses.append(float(step(params, x, arrs, y, m)))
            torch.cuda.synchronize(device)
            ms.append(1e3 * (time.perf_counter() - t))
        counts, plain = _rank_counts(build)
        out[name] = {"logits": logits.cpu().numpy(), "losses": losses,
                     "step_ms": ms, "launches": counts, "plain": plain}

    init, fwd = H.make_spatial_gcn(sizes, None, hidden=cfg["gcn_hidden"],
                                   out_feats=num_classes)
    p = init(0, x.shape[1], device)
    train("gcn", fwd, p, list(p.values()), cfg["gcn_steps"])
    out["gcn"]["exchange_ms"] = exchange_ms(cfg["gcn_hidden"])
    ginit, gfwd = H.make_spatial_gat(sizes, None, hidden=cfg["gat_hidden"],
                                     out_feats=num_classes,
                                     heads=cfg["gat_heads"])
    model = ginit(1, x.shape[1], device)
    train("gat", gfwd, model, list(model.parameters()), cfg["gat_steps"])
    out["gat"]["exchange_ms"] = {
        "layer0": exchange_ms(x.shape[1]),
        "layer1": exchange_ms(cfg["gat_hidden"] * cfg["gat_heads"][0])}
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    del arrs, x, y, m, p, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _gcn_ref(g, x, p, num_classes, dev):
    """GraphConv x2 (norm 'both') over the whole graph ``g`` with the
    spatial GCN's raw weights ``p`` {W1, b1, W2, b2}: the single-process
    forward that a spatial GCN's rows are held against."""
    from dgl_hack_tpu_torch.nn import GraphConv
    l1 = GraphConv(p["W1"].shape[1], activation=F.relu).to(dev)
    l2 = GraphConv(num_classes).to(dev)
    with torch.no_grad():
        for layer, W, b in ((l1, p["W1"], p["b1"]), (l2, p["W2"], p["b2"])):
            layer.weight = torch.nn.Parameter(W.detach().clone())
            layer.bias.copy_(b)
        return l2(g, l1(g, x))


def _spatial_refs(dt, sizes, g, x, num_classes, dev):
    """The single-process forwards over the whole graph on the card, with
    the parameters each rank draws: GraphConv x2 (norm 'both', the
    spatial GCN's weights) and the GAT pair on (x, x)."""
    from dgl_hack_tpu_torch.parallel import halo as H
    init, _ = H.make_spatial_gcn(sizes, None, hidden=SPATIAL["gcn_hidden"],
                                 out_feats=num_classes)
    gcn = _gcn_ref(g, x, init(0, x.shape[1], dev), num_classes, dev)
    with torch.no_grad():
        ginit, _ = H.make_spatial_gat(sizes, None,
                                      hidden=SPATIAL["gat_hidden"],
                                      out_feats=num_classes,
                                      heads=SPATIAL["gat_heads"])
        gm = ginit(1, x.shape[1], dev)
        h = F.elu(gm.l1(g, (x, x))).reshape(x.shape[0], -1)
        gat = gm.l2(g, (h, h)).mean(1)
    return gcn.cpu(), gat.cpu()


def _exchange_bytes(plan, width, itemsize=4):
    """Bytes one rank sends in one halo exchange at ``width`` columns: the
    padded (P, s_max) all_to_all buffer and its hub rows in the
    all_gather."""
    return (plan.num_parts * plan.s_max + plan.hk_max) * width * itemsize


def phase_spatial_reddit(dt, build, pool, ds, g, checks, dev):
    """Spatial GCN (602 -> 16 -> 41) and spatial GAT (H = 8, D = 8, then
    one head) over a Fennel plan of full synthetic Reddit in
    ``SPATIAL["parts"]`` parts with hub replication (the dense hub off:
    at Reddit's degrees its C would reach the 4 GB budget per part), on
    that many ranks sharing the card over gloo.  The parent builds the
    plan once and writes each rank its slice; each rank's forward rows are
    held against the single-process forward over the whole graph (GCN
    within LAYER_TOL of max|ref|, GAT within GAT_TOL), K1 and K2/K3 must
    launch on every rank and no plain path.  Records the plan's build
    seconds and stats, the all_to_all bytes a step, step ms, the
    exchange's ms and peak memory per rank: ranks sharing one card over
    gloo, not a multi-GPU scaling number."""
    from dgl_hack_tpu_torch.parallel import halo as H
    P = SPATIAL["parts"]
    t0 = time.perf_counter()
    plan = H.build_spatial_plan(ds.graph, P, method="fennel", seed=0,
                                hub_k=SPATIAL["hub_k"])
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(SPATIAL_DIR, exist_ok=True)
    shards = {k: H.shard_features(plan, np.asarray(a)) for k, a in
              (("x", ds.features), ("y", ds.labels), ("m", ds.train_mask))}
    for r in range(P):
        arrs = plan.device_arrays(r, "cpu")
        arrs.update({k: torch.from_numpy(v[r]) for k, v in shards.items()})
        torch.save(arrs, os.path.join(SPATIAL_DIR, f"rank{r}.pt"))
    del shards, arrs
    handoff_s = time.perf_counter() - t0
    x = torch.from_numpy(ds.features).to(dev)
    C = ds.num_classes
    gcn_ref, gat_ref = _spatial_refs(dt, plan.sizes(), g, x, C, dev)
    del x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = pool.run(_spatial_reddit_rank, plan.sizes(), C, SPATIAL)
    ranks_s = time.perf_counter() - t0
    rec = {"plan_build_s": plan_s, "handoff_s": handoff_s,
           "ranks_s": ranks_s, "stats": plan.stats(),
           "sizes": {k: getattr(plan, k) for k in (
               "n_owned_max", "halo_max", "s_max", "hk_max", "e_max",
               "el_max", "er_max")},
           "setting": "ranks sharing one card over gloo", **SPATIAL}
    counts = {}
    for name, ref, tol, need in (
            ("gcn", gcn_ref, LAYER_TOL, ("segment_sum.fwd",
                                         "segment_sum.rev")),
            ("gat", gat_ref, GAT_TOL, ("gat_fwd", "gat_bwd"))):
        out = H.unshard_rows(plan, np.stack([r_[name]["logits"]
                                             for r_ in res]),
                             g.num_dst_nodes)
        err = rel_err(torch.from_numpy(out), ref)
        width = {"gcn": [SPATIAL["gcn_hidden"]] * 2,
                 "gat": [ds.features.shape[1],
                         SPATIAL["gat_hidden"] * SPATIAL["gat_heads"][0]]}
        # forward of every layer's exchange, and the backward of those
        # whose input takes a gradient (all but GAT's first: the features)
        fwd_b = sum(_exchange_bytes(plan, w_) for w_ in width[name])
        bwd_b = sum(_exchange_bytes(plan, w_) for w_ in (
            width[name] if name == "gcn" else width[name][1:]))
        rec[name] = {
            "rel_err_vs_single": err, "tol": tol,
            "losses": res[0][name]["losses"],
            "step_ms": [r_[name]["step_ms"] for r_ in res],
            "exchange_ms": [r_[name]["exchange_ms"] for r_ in res],
            "a2a_bytes_per_step_per_rank": fwd_b + bwd_b,
            "launches": [r_[name]["launches"] for r_ in res]}
        if not err <= tol:
            checks.failures.append(f"spatial_reddit {name}: rel err {err:.3g}"
                                   f" > {tol}")
        for i, r_ in enumerate(res):
            c = r_[name]["launches"]
            if r_[name]["plain"] or any(_launched(c, k) < 1 for k in need):
                checks.failures.append(f"spatial_reddit {name} rank {i}: "
                                       f"launches {c}")
            if not all(np.isfinite(r_[name]["losses"])):
                checks.failures.append(f"spatial_reddit {name} rank {i}: "
                                       "loss not finite")
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
    rec["ready_s"] = [r_["ready_s"] for r_ in res]
    rec["peak_gb_per_rank"] = [r_["peak_gb"] for r_ in res]
    emit({"phase": "spatial_reddit", **rec})
    checks.raise_if_failed("spatial_reddit")
    return counts, plan


SPATIAL_KERNEL_CASES = (
    # (plan, reduce_op, overlap, weighted, wire dtype)
    *(("plain", red, ov, False, None) for red in ("sum", "mean", "max",
                                                  "min")
      for ov in (True, False)),
    ("plain", "sum", True, True, None), ("plain", "sum", False, True, None),
    ("hub", "sum", True, False, None), ("hub", "max", True, False, None),
    ("dense", "sum", True, False, None), ("dense", "mean", True, False,
                                          None),
    ("plain", "sum", True, False, "bf16"))


def _spatial_kernels_rank(device, plans, x, w, cot):
    """Every case of ``SPATIAL_KERNEL_CASES`` on this rank: its output rows
    and the gradient of sum(out * cot) with respect to its rows of x (the
    weights' too where weighted), with its launches."""
    import torch.distributed as dist
    from dgl_hack_tpu_torch.ops.cuda import build
    from dgl_hack_tpu_torch.parallel import halo as H
    r = dist.get_rank()
    devs = {k: p.device_arrays(r, device) for k, p in plans.items()}
    build.LAUNCHES.reset()
    res = []
    for key, red, ov, weighted, wire in SPATIAL_KERNEL_CASES:
        plan, dev = plans[key], devs[key]
        xs = torch.from_numpy(H.shard_features(plan, x)[r]).to(
            device).requires_grad_()
        cs = torch.from_numpy(H.shard_features(plan, cot)[r]).to(device)
        ws = () if not weighted else tuple(
            torch.from_numpy(a[r]).to(device).requires_grad_()
            for a in H.shard_edata(plan, w, layout="split"))
        f = H.make_halo_gspmm(plan, None, reduce_op=red, overlap=ov,
                              weighted=weighted,
                              comm_dtype=torch.bfloat16 if wire else None)
        out = f(xs, dev, *ws)
        (out * cs).sum().backward()
        res.append([out.detach().cpu().numpy(), xs.grad.cpu().numpy()])
    torch.cuda.synchronize(device)
    counts, plain = _rank_counts(build)
    return res, counts, plain


def phase_spatial_kernels(dt, build, pool, checks, dev):
    """The halo gspmm at the dry run's size (planted partition, 512 nodes a
    rank, F = 32) on ``SPATIAL["parts"]`` ranks sharing the card over
    gloo: sum, mean, max and min with overlap on and off, weighted
    u_mul_e (both), hub replication (sum, max), the distributed dense hub
    (sum, mean) and bf16 on the wire.  The forward and dx of every case
    are held against the single-graph gspmm on the card (K1, K4/K5):
    within LAYER_TOL of max|ref|, and the bf16 wire's within 2^-8 of each
    row's sum of |terms| (each shipped value or returning partial sum is
    rounded once)."""
    from dgl_hack_tpu_torch.data import planted_partition
    from dgl_hack_tpu_torch.parallel import halo as H
    P = SPATIAL["parts"]
    ds = planted_partition(512 * P, 4, 32, avg_degree=4.0, seed=0,
                           train_per_class=4, num_val=8, num_test=8)
    gh = ds.graph
    plans = {"plain": H.build_spatial_plan(gh, P, "fennel", seed=0),
             "hub": H.build_spatial_plan(gh, P, "fennel", seed=0, hub_k=16),
             "dense": H.attach_spmm_plans(H.build_spatial_plan(
                 gh, P, "fennel", seed=0, hub_k=8, dense_threshold=16))}
    rng = np.random.default_rng(17)
    n, E = gh.num_nodes(), gh.num_edges()
    x = rng.standard_normal((n, 32)).astype(np.float32)
    w = rng.standard_normal(E).astype(np.float32)
    cot = rng.standard_normal((n, 32)).astype(np.float32)
    t0 = time.perf_counter()
    out = pool.run(_spatial_kernels_rank, plans, x, w, cot)
    ranks_s = time.perf_counter() - t0
    g = gh.to(dev)
    w_int = torch.from_numpy(w).to(dev)
    if g.int2user is not None:
        w_int = w_int[g.int2user.long()]
    cot_d = torch.from_numpy(cot).to(dev)
    cases = []
    for i, (key, red, ov, weighted, wire) in enumerate(SPATIAL_KERNEL_CASES):
        plan = plans[key]
        got = [H.unshard_rows(plan, np.stack([o[0][i][j] for o in out]), n)
               for j in (0, 1)]
        xd = torch.from_numpy(x).to(dev).requires_grad_()
        if weighted:
            ref = dt.gspmm(g, "mul", red, xd, w_int[:, None], "u", "e")
        else:
            ref = dt.gspmm(g, "copy_lhs", red, xd)
        (ref * cot_d).sum().backward()
        errs = [rel_err(torch.from_numpy(got[0]), ref.detach().cpu()),
                rel_err(torch.from_numpy(got[1]), xd.grad.cpu())]
        ok = all(e_ <= LAYER_TOL for e_ in errs)
        if wire:
            # each cut edge's value (forward) and each returning partial
            # sum (dx) rounded once to bf16: |err| <= 2^-8 sum |terms|
            xa = torch.from_numpy(np.abs(x)).to(dev).requires_grad_()
            fb = dt.gspmm(g, "copy_lhs", "sum", xa)
            (fb * cot_d.abs()).sum().backward()
            lim = [2.0 ** -8 * fb.detach().cpu() + 1e-6,
                   2.0 ** -8 * xa.grad.cpu() + 1e-6]
            ok = all(bool((torch.from_numpy(got[j]) - r_.cpu()).abs().le(
                lim[j]).all()) for j, r_ in ((0, ref.detach()),
                                             (1, xd.grad)))
        cases.append({"plan": key, "reduce": red, "overlap": ov,
                      "weighted": weighted, "wire": wire or "float32",
                      "rel_err": errs, "ok": ok})
        if not ok:
            checks.failures.append(f"spatial_kernels {cases[-1]}")
    counts = {}
    for i, (_, c, plain) in enumerate(out):
        if plain or _launched(c, "segment_sum") < 1 or \
                _launched(c, "segment_max") < 1:
            checks.failures.append(f"spatial_kernels rank {i}: launches {c}"
                                   f", plain {plain}")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    emit({"phase": "spatial_kernels", "ranks_s": ranks_s, "nodes": n,
          "edges": E, "cases": cases,
          "stats": {k: p.stats() for k, p in plans.items()},
          "launches": [o[1] for o in out],
          "setting": "ranks sharing one card over gloo"})
    checks.raise_if_failed("spatial_kernels")
    return counts


def _dryrun_rank_counted(device, inputs, phases, on_cpu):
    """The dry-run twin's phases on this rank (on the CPU where
    ``on_cpu``), with its launches."""
    from dgl_hack_tpu_torch.ops.cuda import build
    from dgl_hack_tpu_torch.parallel import dryrun
    build.LAUNCHES.reset()
    losses = dryrun.dryrun_rank(torch.device("cpu") if on_cpu else device,
                                inputs, None, phases)
    if not on_cpu:
        torch.cuda.synchronize(device)
    return losses, _rank_counts(build)


def phase_multichip_dryrun(pool, checks):
    """The twin of ``__graft_entry__.dryrun_multichip`` (parallel/dryrun.py)
    at ``SPATIAL["parts"]`` ranks on the card (mesh node 2 x tp 2), gloo
    between ranks that share the card: its line, every loss finite, the
    five dropout-free losses within 1e-4 of the same ranks running the
    twin on the CPU, and the gspmd loss at dropout 0 too (a dropout mask
    drawn on the card is not the CPU's).  K1 and K2/K3 launch on every
    rank, no plain path."""
    from dgl_hack_tpu_torch.parallel import dryrun
    P = SPATIAL["parts"]
    inputs = dryrun.prepare(P)
    t0 = time.perf_counter()
    card = pool.run(_dryrun_rank_counted, inputs, dryrun.PHASES, False)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = pool.run(_dryrun_rank_counted, inputs, dryrun.PHASES, True)
    cpu_s = time.perf_counter() - t0
    inputs0 = dryrun.prepare(P, gspmd_dropout=0.0)
    g0 = [pool.run(_dryrun_rank_counted, inputs0, ("gspmd",), on)[0][0]
          ["gspmd"] for on in (False, True)]
    line = dryrun.format_line(P, card[0][0])
    print(line, flush=True)
    errs = {k: abs(card[0][0][k] - cpu[0][0][k])
            / max(1.0, abs(cpu[0][0][k])) for k in dryrun.PHASES
            if k != "gspmd"}
    errs["gspmd_dropout0"] = abs(g0[0] - g0[1]) / max(1.0, abs(g0[1]))
    counts = {}
    for i, (losses, (c, plain)) in enumerate(card):
        if not all(np.isfinite(losses[k]) for k in dryrun.PHASES):
            checks.failures.append(f"multichip_dryrun rank {i}: {losses}")
        if any(losses[k] != card[0][0][k] for k in dryrun.PHASES):
            checks.failures.append(f"multichip_dryrun: rank {i} differs")
        if plain or _launched(c, "segment_sum") < 1 or \
                _launched(c, "gat_fwd") < 1 or _launched(c, "gat_bwd") < 1:
            checks.failures.append(f"multichip_dryrun rank {i}: launches "
                                   f"{c}, plain {plain}")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    for k, e_ in errs.items():
        if not e_ <= 1e-4:
            checks.failures.append(f"multichip_dryrun {k}: card vs CPU "
                                   f"{e_:.3g} > 1e-4")
    emit({"phase": "multichip_dryrun", "line": line,
          "card": {k: card[0][0][k] for k in dryrun.PHASES},
          "cpu": {k: cpu[0][0][k] for k in dryrun.PHASES},
          "gspmd_dropout0": g0, "rel_err_card_vs_cpu": errs,
          "card_s": card_s, "cpu_s": cpu_s, "launches": card[0][1][0],
          "setting": "ranks sharing one card over gloo"})
    checks.raise_if_failed("multichip_dryrun")
    return counts


def _nccl_one_rank(device):
    """Spatial GCN over a one-part plan of the dry run's graph in a
    one-rank NCCL group, against GraphConv x2 over the whole graph with the
    same weights."""
    import torch.distributed as dist
    from dgl_hack_tpu_torch.data import planted_partition
    from dgl_hack_tpu_torch.ops.cuda import build
    from dgl_hack_tpu_torch.parallel import halo as H
    ds = planted_partition(2048, 4, 32, avg_degree=4.0, seed=0,
                           train_per_class=4, num_val=8, num_test=8)
    plan = H.build_spatial_plan(ds.graph, 1)
    dev = plan.device_arrays(0, device)
    init, fwd = H.make_spatial_gcn(plan, None, hidden=16,
                                   out_feats=ds.num_classes)
    p = init(0, 32, device)
    x = torch.from_numpy(ds.features).to(device)
    build.LAUNCHES.reset()
    with torch.no_grad():
        out = fwd(p, x[torch.from_numpy(plan.owned_ids[0]).long().to(
            device)], dev)
    torch.cuda.synchronize(device)
    counts, plain = _rank_counts(build)
    ref = _gcn_ref(ds.graph.to(device), x, p, ds.num_classes, device)
    got = H.unshard_rows(plan, out.cpu().numpy()[None], ds.graph.num_nodes())
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "rel_err": rel_err(torch.from_numpy(got), ref.cpu()),
            "launches": counts, "plain": plain}


def phase_nccl_one_rank(checks):
    """A one-rank NCCL group on the card (the only NCCL group one card
    allows): spatial GCN over a one-part plan equals the single-graph
    forward within LAYER_TOL; K1 launched, no plain path."""
    from dgl_hack_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    with RankPool(1, "nccl", "cuda", timeout=300) as pool:
        start_s = time.perf_counter() - t0
        res = pool.run(_nccl_one_rank)[0]
    emit({"phase": "nccl_one_rank", "start_s": start_s, **res})
    if res["backend"] != "nccl" or not res["rel_err"] <= LAYER_TOL or \
            res["plain"] or _launched(res["launches"], "segment_sum") < 1:
        checks.failures.append(f"nccl_one_rank: {res}")
    checks.raise_if_failed("nccl_one_rank")
    return res["launches"]


TOOL_DIR = os.path.join(REPO, "build", "tools")
# the tools phase's grid points of tools/tune_hybrid_torch.py: the port's
# default breakeven and the JAX grid's first threshold, both at 3 GB
TUNE_POINTS = ((None, 3), (66_000, 3))


def _start_tool(procs, name, argv, env=None):
    """Start python3 tools/<argv> with its output in TOOL_DIR/<name>.out
    and .err; appended to ``procs``."""
    with open(os.path.join(TOOL_DIR, name + ".out"), "w") as out, \
            open(os.path.join(TOOL_DIR, name + ".err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", argv[0])]
            + argv[1:], cwd=REPO, stdout=out, stderr=err, env=env)
    procs.append((name, argv, proc, time.perf_counter()))


def _wait_tools(procs, timeout):
    """Wait for every started tool: {name: (stdout, host seconds)}.  A
    tool that exits non-zero, or runs past ``timeout`` seconds from now,
    fails the run."""
    deadline = time.perf_counter() + timeout
    out = {}
    for name, argv, proc, t0 in procs:
        rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        s = time.perf_counter() - t0
        with open(os.path.join(TOOL_DIR, name + ".out")) as f:
            text = f.read()
        if rc != 0:
            with open(os.path.join(TOOL_DIR, name + ".err")) as f:
                err = f.read()
            raise SystemExit(f"tools {argv}: rc {rc}\n{text[-3000:]}\n"
                             f"{err[-3000:]}")
        out[name] = (text, s)
    return out


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def phase_tools(dt, gb, checks, dev):
    """The port's tools on the card (``tools``): tools/tune_hybrid_torch.py's
    sweep at ``TUNE_POINTS`` in float32 and bf16 (F = 128) on bench.py's
    graph ``gb`` (the one ``headline`` built, in this process, with the
    card to itself); then, all started together, tools/regression_torch.py
    on three rows of its matrix (train_gcn, train_gat, pagerank: a
    process each), each row ok; tools/scaling_torch.py at P = 1 and 2
    over gloo (ranks sharing the card) with spatial GAT at P = 2 on 20,000
    nodes, every row ok and its all_to_all bytes equal to tools/
    scaling.py's formula (P^2 s_max + P^2 hk_max rows a layer at the
    wire's bytes); and tools/partition_torch.py on the cora stand-in (4
    parts, a file a part; host only).  The tools share the card and the
    host here, so their times are a smoke reading, not a measurement (the
    tools alone are, e.g. the sweep in PERF.md).  A tool that fails fails
    the run; no tool outlives the phase."""
    os.makedirs(TOOL_DIR, exist_ok=True)
    rec = {}
    # tune_hybrid_torch.py's sweep on this process's bench.py graph
    tune = _load_twin("tune_hybrid_torch", "tools")
    x32 = torch.from_numpy(np.random.default_rng(0).normal(
        size=(gb.num_src_nodes, 128)).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    rec["tune_hybrid"] = []
    for dtype in (torch.float32, BF16):
        rec["tune_hybrid"] += tune.sweep(gb, x32.to(dtype), TUNE_POINTS)
    rec["tune_hybrid_s"] = time.perf_counter() - t0
    del x32
    torch.cuda.empty_cache()
    for r_ in rec["tune_hybrid"]:
        if not (np.isfinite(r_["ms"]) and r_["ms"] > 0):
            checks.failures.append(f"tools tune_hybrid: {r_}")
    procs = []
    try:
        # the other tools together: three rows of regression_torch.py's
        # matrix, scaling_torch.py (P = 1, 2 over gloo, spatial GAT at
        # P = 2) and the partition tool (host only)
        rows_wanted = ("train_gcn", "train_gat", "pagerank")
        t0 = time.perf_counter()
        for row in rows_wanted:
            _start_tool(procs, f"regression_{row}", [
                "regression_torch.py", "--only", row, "--out",
                os.path.join(TOOL_DIR, f"regression_{row}.json")])
        _start_tool(procs, "scaling", [
            "scaling_torch.py", "--backend", "gloo", "--parts", "1", "2",
            "--nodes", "20000", "--models", "gat", "--model-nodes", "20000",
            "--model-parts", "2", "--clustered-nodes", "4000"])
        prefix = os.path.join(TOOL_DIR, "parts", "cora")
        _start_tool(procs, "partition", [
            "partition_torch.py", "--dataset", "cora", "--num-parts", "4",
            "--output", prefix], env=dict(
                os.environ, DGL_DOWNLOAD_DIR=os.path.join(TOOL_DIR,
                                                          "nodata")))
        done = _wait_tools(procs, timeout=600)
        rec["tools_s"] = time.perf_counter() - t0
    finally:
        for _, _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rows, device = [], None
    for row in rows_wanted:
        with open(os.path.join(TOOL_DIR, f"regression_{row}.json")) as f:
            rep = json.load(f)
        rows += rep["runs"]
        device = rep["device"]
    for r_ in rows:
        print(json.dumps(r_), flush=True)
    if sorted(r_["script"] for r_ in rows) != [
            "pagerank_torch.py", "train_gat_torch.py",
            "train_gcn_torch.py"] or not all(r_["ok"] for r_ in rows):
        checks.failures.append(f"tools regression: {rows}")
    rec["regression"] = {"device": device, "rows": [
        {k: r_[k] for k in ("script", "ok", "wall_s", "result")}
        for r_ in rows]}
    out, rec["scaling_s"] = done["scaling"]
    lines = _json_lines(out)
    rec["scaling"] = lines
    wire = {"f32": 4, "bf16": 2}
    seen = set()
    for r_ in lines:
        if "compare" in r_:
            continue
        P = r_["P"]
        # padded rows an exchange: P^2 s_max pairwise + P^2 hk_max hubs
        rows_ = r_["halo_rows_padded"] + P * r_["hub_rows_padded"]
        nb = wire[r_["comm_dtype"]]
        if "model" in r_:
            # spatial GAT: F = 128 in, 4 heads x 32 hidden out of layer 1
            want_layer = [rows_ * w_ * nb for w_ in (128, 4 * 32)]
            ok = r_["a2a_bytes_per_layer_fwd"] == want_layer and \
                r_["a2a_bytes_per_step"] == 2 * sum(want_layer)
            seen.add(("gat", P))
        else:
            ok = r_["a2a_bytes_per_step"] == rows_ * 128 * nb
            seen.add(("copy", P))
        if not (ok and r_["ok"] and r_["backend"] == "gloo"
                and r_["ranks_share_card"] == (P > 1)):
            checks.failures.append(f"tools scaling: {r_}")
    if seen != {("copy", 1), ("copy", 2), ("gat", 2)}:
        checks.failures.append(f"tools scaling: rows {sorted(seen)}")
    out, rec["partition_s"] = done["partition"]
    rec["partition"] = [ln for ln in out.splitlines()
                        if ln.startswith("part ")]
    if len(rec["partition"]) != 4 or not all(
            os.path.exists(f"{prefix}.part{i}.npz") for i in range(4)):
        checks.failures.append(f"tools partition: {out}")
    emit({"phase": "tools", **rec})
    checks.raise_if_failed("tools")


def phase_dispatch(dt, build, checks, dev):
    """``DGL_TPU_DEBUG_DISPATCH=1`` on the card (``dispatch``): gspmm sum
    (K1), max (K4/K5), a hybrid (dense hub + K1), a masked block (K1
    through the real-edge view), gsddmm (K6) and gat_attention (K2), each
    called twice: every expected line printed exactly once, no composed
    route, each kernel launched."""
    import contextlib as _cl
    import io
    from dgl_hack_tpu_torch.utils import env
    rng = np.random.default_rng(31)
    n, e = 4096, 40_000
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.8, rng.integers(0, 40, e),
                   rng.integers(0, n, e))
    g = dt.graph((src, dst), num_nodes=n).to(dev)
    gh = dt.prepare_spmm(g, dense_threshold=512)
    ms, md = rng.integers(0, 2048, 20_000), np.sort(rng.integers(0, 512,
                                                                 20_000))
    gm = dt.block((ms, md), 2048, 512, edge_mask=rng.random(20_000) < 0.7
                  ).to(dev)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)
    x, xm = t(n, 16), t(2048, 16)
    fs, el, er = t(n, 4, 4), t(n, 4), t(n, 4)
    calls = (
        (lambda: dt.gspmm(g, "copy_lhs", "sum", x),
         "gspmm: kernel (copy_lhs.sum, K1, cuda)"),
        (lambda: dt.gspmm(g, "copy_lhs", "max", x),
         "gspmm: kernel (copy_lhs.max, K4/K5, cuda)"),
        (lambda: dt.gspmm(gh, "copy_lhs", "sum", x),
         "gspmm: hybrid (copy_lhs.sum, cuda)"),
        (lambda: dt.gspmm(gm, "copy_lhs", "sum", xm),
         "gspmm: kernel (copy_lhs.sum, K1, real-edge-view, cuda)"),
        (lambda: dt.gsddmm(g, "dot", x, x),
         "gsddmm: kernel (dot u-op-v, K6, cuda)"),
        (lambda: dt.gat_attention(g, fs, el, er),
         "gat: kernel (K2/K3, H=4 D=4 softmax=shift packed=False)"))
    if "hybrid" not in gh.derived:
        raise SystemExit("dispatch failed: no hybrid built")
    old = os.environ.get("DGL_TPU_DEBUG_DISPATCH")
    os.environ["DGL_TPU_DEBUG_DISPATCH"] = "1"
    env._PRINTED.clear()
    build.LAUNCHES.reset()
    buf = io.StringIO()
    with _cl.redirect_stdout(buf), torch.no_grad():
        for _ in range(2):
            for call, _ in calls:
                call()
        torch.cuda.synchronize()
    if old is None:
        del os.environ["DGL_TPU_DEBUG_DISPATCH"]
    else:
        os.environ["DGL_TPU_DEBUG_DISPATCH"] = old
    counts = dict(build.LAUNCHES.counts)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[dgl-tpu dispatch] ")]
    want = ["[dgl-tpu dispatch] " + w for _, w in calls]
    seen = {w: lines.count(w) for w in want}
    emit({"phase": "dispatch", "lines": lines, "counts": seen,
          "launches": counts})
    if any(c != 1 for c in seen.values()) or any(
            "composed" in ln for ln in lines) or any(
            _launched(counts, k) < 1 for k in (
                "segment_sum", "segment_max", "sddmm", "gat_fwd")) or any(
            k.startswith("plain.") for k in counts):
        raise SystemExit(f"dispatch failed: {seen}, {lines}, {counts}")


def _rank_k1(sk, g, F, checks, rng, tag):
    """K1's forward and dx over a rank's split graph ``g`` (masked) through
    its real-edge view at gspmm's run width, each against the plain
    version in float64, timed beside it and torch.sparse.mm, with the
    bound of what the real edges need."""
    kg = sk.real_edges(g).graph
    Ns, Nd, R = kg.num_src_nodes, kg.num_dst_nodes, kg.num_edges()
    rows_read = int(torch.unique(kg.src).numel())
    dst_rows = int((kg.in_degrees() > 0).sum())
    x = torch.from_numpy(rng.normal(size=(Ns, F)).astype(np.float32)).to(
        kg.device)
    Fp = sk.run_width(x, None, kg)
    xp = sk.pad_columns(x, Fp)
    p_fwd, p_rev = sk.graph_row_plan(kg, "csc"), sk.graph_row_plan(kg, "csr")
    fwd = (kg.csc_indptr, xp, kg.src)
    err = {"fwd": checks.compare(
        "segment_sum", f"{tag} F={F} fwd", sk.segment_sum(*fwd, plan=p_fwd),
        k1_ref(sk, *fwd), K1_TOL, sk.segment_sum(*fwd, plan=p_fwd))}
    shape = (f"{tag}: {Ns} src rows, {Nd} dst rows, {R} real of "
             f"{g.num_edges()} slots, F={F}" + (f" padded to {Fp}"
                                                if Fp != F else ""))
    A = csr_matrix(kg)
    out = {"k1_fwd": timing(
        both_ms(lambda: sk.segment_sum(*fwd, plan=p_fwd)),
        cuda_ms(lambda: sk.segment_sum_plain(*fwd), reps=3),
        nbytes(kg.csc_indptr, kg.src) + 4 * F * (rows_read + Nd), R * F,
        shape + ", fwd",
        library_ms=cuda_ms(lambda: torch.sparse.mm(A, xp), reps=3))}
    dout = torch.from_numpy(rng.normal(size=(Nd, Fp)).astype(np.float32)
                            ).to(kg.device)
    rev = (kg.csr_indptr, dout, sk.rev_gidx(kg), kg.csr_eids)
    err["dx"] = checks.compare(
        "segment_sum", f"{tag} F={F} dx", sk.segment_sum(*rev, plan=p_rev),
        k1_ref(sk, *rev), K1_TOL, sk.segment_sum(*rev, plan=p_rev))
    At = csr_matrix(kg, reverse=True)
    out["k1_dx"] = timing(
        both_ms(lambda: sk.segment_sum(*rev, plan=p_rev)),
        cuda_ms(lambda: sk.segment_sum_plain(*rev), reps=3),
        nbytes(kg.csr_indptr, rev[2]) + 4 * F * (dst_rows + Ns), R * F,
        shape + ", dx",
        library_ms=cuda_ms(lambda: torch.sparse.mm(At, dout), reps=3))
    out["rel_err"] = err
    return out


def _rank_gat(gk, sk, kg, H, D, checks, rng, tag):
    """K2 and K3 (and K1's der) over a rank's partition view ``kg`` (an
    unmasked block: src rows [own || halo || hubs], dst rows the owned) at
    head shape (H, D) with attn_w, each against its plain version within
    GAT_TOL and repeated bitwise; timed beside it (K3 with no dw, as the
    main path runs it), each input and output counted once in the
    bound."""
    dev = kg.device
    Ns, Nd, E = kg.num_src_nodes, kg.num_dst_nodes, kg.num_edges()

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)
    wh, el, er, dout = t(Ns, H * D), t(Ns, H), t(Nd, H), t(Nd, H * D)
    w = torch.from_numpy((rng.random((E, H)) > 0.6).astype(np.float32)
                         / 0.4).to(dev)
    shift = gk.shift_bound(el, er, 0.2).contiguous()
    p_fwd, p_rev = sk.graph_row_plan(kg, "csc"), sk.graph_row_plan(kg, "csr")
    fwd_args = (kg.csc_indptr, kg.src, wh, el, er, w, shift, 0.2, False)
    rst, den, sh = gk.gat_fwd(*fwd_args, plan=p_fwd)
    again = gk.gat_fwd(*fwd_args, plan=p_fwd)
    ref = gk.gat_fwd_plain(*fwd_args)
    err = {}
    for i, name in enumerate(("rst", "den")):
        err[name] = checks.compare("gat_fwd", f"{tag} H={H} D={D} {name}",
                                   (rst, den)[i], ref[i], GAT_TOL, again[i])
    sds = (rst.view(Nd, H, D) * dout.view(Nd, H, D)).sum(-1).contiguous()
    bwd_args = (kg.csr_indptr, kg.csr_eids, sk.rev_gidx(kg), wh, el, er, sh,
                den, sds, dout, w, 0.2)
    outs = gk.gat_bwd(*bwd_args, plan=p_rev)
    outs2 = gk.gat_bwd(*bwd_args, plan=p_rev)
    refs = gk.gat_bwd_plain(*bwd_args)
    for name, a, b, r in zip(("dwh", "del", "draw", "dw"), outs, outs2,
                             refs):
        err[name] = checks.compare("gat_bwd", f"{tag} H={H} D={D} {name}",
                                   a, r, GAT_TOL, b)
    shape = (f"{tag}: {Ns} src rows, {Nd} dst rows, {E} edges, H={H}, "
             f"D={D}, attn_w")
    res = {"rel_err": err, "gat_fwd": timing(
        both_ms(lambda: gk.gat_fwd(*fwd_args, plan=p_fwd)),
        cuda_ms(lambda: gk.gat_fwd_plain(*fwd_args), reps=3),
        nbytes(kg.csc_indptr, kg.src, wh, el, er, w, shift, rst, den),
        E * H * (8 + 2 * D), shape + ", shift mode")}
    res["gat_bwd"] = timing(
        both_ms(lambda: gk.gat_bwd(*bwd_args, False, plan=p_rev)),
        cuda_ms(lambda: gk.gat_bwd_plain(*bwd_args, False), reps=3),
        nbytes(*bwd_args[:11], *outs[:3]), E * H * (12 + 4 * D),
        shape + ", no dw")
    del ref, refs, outs, outs2, fwd_args, bwd_args
    torch.cuda.empty_cache()
    return res


def phase_rank_kernels(dt, sk, sm, gk, plan, checks, dev):
    """The kernels as the ranks of ``parallel/`` run them, in this one
    process (``rank_kernels``): K1's forward and dx over rank 0's local
    and remote split graphs of ``spatial_reddit``'s plan (Reddit in 4
    Fennel parts, hubs replicated) at the spatial GCN's F = 16; K2/K3 over
    rank 0's partition through its real-edge view at the spatial GAT's
    H = 8, D = 8 and H = 1, D = 41; K4/K5 over rank 0's splits of the dry
    run's graph (``spatial_kernels``' plan: 2,048 nodes in 4 parts) at
    F = 32.  Each against its plain version (K1, K5 in float64; K4
    exactly; K2/K3 within GAT_TOL), timed with ``cuda_ms`` beside it,
    its bound and the library call (``torch.sparse.mm`` for K1; none for
    K2/K3 and K4/K5: no single PyTorch call computes either)."""
    from dgl_hack_tpu_torch.data import planted_partition
    from dgl_hack_tpu_torch.parallel import halo as H
    rng = np.random.default_rng(41)
    t0 = time.perf_counter()
    d0 = plan.device_arrays(0, dev)
    res = {"device_arrays_s": time.perf_counter() - t0}
    for split in ("local", "remote"):
        res[f"k1_{split}"] = _rank_k1(
            sk, H.split_graph(plan, d0, split), SPATIAL["gcn_hidden"],
            checks, rng, f"Reddit rank 0 {split} split")
    view = sk.real_edges(H.local_graph(plan, d0))
    kg = view.graph
    res["partition"] = {"src_rows": kg.num_src_nodes,
                        "dst_rows": kg.num_dst_nodes,
                        "real_edges": kg.num_edges(),
                        "slots": H.local_graph(plan, d0).num_edges()}
    for Hh, D in ((SPATIAL["gat_heads"][0], SPATIAL["gat_hidden"]),
                  (1, 41)):
        res[f"gat_H{Hh}_D{D}"] = _rank_gat(
            gk, sk, kg, Hh, D, checks, rng,
            "Reddit rank 0 partition (real-edge view)")
    del d0, view, kg
    torch.cuda.empty_cache()
    P = SPATIAL["parts"]
    ds = planted_partition(512 * P, 4, 32, avg_degree=4.0, seed=0,
                           train_per_class=4, num_val=8, num_test=8)
    dry = H.build_spatial_plan(ds.graph, P, "fennel", seed=0)
    d0 = dry.device_arrays(0, dev)
    for split in ("local", "remote"):
        kg = sk.real_edges(H.split_graph(dry, d0, split)).graph
        x = torch.relu(torch.from_numpy(rng.normal(
            size=(kg.num_src_nodes, 32)).astype(np.float32)).to(dev))
        gout = torch.from_numpy(rng.normal(
            size=(kg.num_dst_nodes, 32)).astype(np.float32)).to(dev)
        tag = (f"dry run's graph, rank 0 {split} split: "
               f"{kg.num_src_nodes} src rows, {kg.num_dst_nodes} dst rows, "
               f"{kg.num_edges()} edges, F=32")
        raw, errs, _ = _k4k5_case(sm, sk, kg, x, None, gout, checks, tag)
        k4, k5 = _k4k5_timings(sm, sk, kg, x, gout, raw, tag)
        res[f"k4k5_{split}"] = {"rel_err": errs, "k4": k4, "k5": k5}
    emit({"phase": "rank_kernels", **res,
          "library": "torch.sparse.mm for K1; none for K2/K3 and K4/K5 "
                     "(no single PyTorch call computes them)"})
    checks.raise_if_failed("rank_kernels")


def phase_entry(dt, dev):
    """Twin of __graft_entry__.entry(): GAT forward on a 512-node graph,
    held against the same model on the CPU (plain path)."""
    from dgl_hack_tpu_torch.data import planted_partition
    from dgl_hack_tpu_torch.models import GAT
    ds = planted_partition(512, 5, 64, avg_degree=8.0, seed=0,
                           train_per_class=20, num_val=64, num_test=128)
    torch.manual_seed(0)
    model = GAT(hidden_feats=16, out_feats=ds.num_classes, heads=(4, 1),
                feat_drop=0.0, attn_drop=0.0).eval()
    x = torch.from_numpy(ds.features)
    with torch.no_grad():
        ref = model(ds.graph, x)                 # CPU: materialises params
        out = model.to(dev)(ds.graph.to(dev), x.to(dev))
    rel = rel_err(out.cpu(), ref)
    emit({"phase": "entry_forward", "shape": list(out.shape),
          "rel_err_vs_cpu": rel})
    if tuple(out.shape) != (512, ds.num_classes) or not rel <= GAT_TOL \
            or not torch.isfinite(out).all():
        raise SystemExit(f"entry_forward failed: shape {tuple(out.shape)}, "
                         f"rel err {rel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        print(__doc__.split("Phases")[0], file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.ops.cuda import build
    from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk
    from dgl_hack_tpu_torch.ops.cuda import sddmm_kernel as k6
    from dgl_hack_tpu_torch.ops.cuda import segment_max_kernel as sm
    from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    card = phase_build(build)
    phase_segment_ids(dev)
    checks = Checks()
    timings = {}
    g_small, g_bench, plan_edges = phase_k1(dt, sk, checks, dev)
    phase_profiling(sk, g_bench, checks, dev)
    phase_datasets(dt, build, checks, dev)
    c_ckpt = phase_checkpoint_resume(dt, build, dev)
    c_pr = phase_pagerank(dt, build, sk, g_bench, checks, dev, timings)
    c_sub = phase_message_subsets(dt, build, sk, g_bench, checks, dev,
                                  timings)
    phase_k6_bench(k6, g_bench, checks)
    phase_k4k5_bench(sm, sk, g_bench, checks)
    phase_gat_bench(gk, sk, g_bench, checks)
    phase_bf16_kernels(dt, build, sk, sm, g_small, g_bench, checks, dev,
                       timings)
    c_bf16_sddmm = phase_bf16_attention(dt, build, gk, k6, sk, g_bench,
                                        checks, dev, timings)
    g_hybrid, c_headline = phase_headline(dt, sk, g_bench, checks, dev)
    phase_hybrid(dt, sk, g_bench, g_hybrid, checks, dev)
    del g_hybrid
    torch.cuda.empty_cache()
    phase_tools(dt, g_bench, checks, dev)
    phase_dispatch(dt, build, checks, dev)
    del g_bench
    torch.cuda.empty_cache()
    phase_k4k5_small(sm, sk, g_small, checks)
    phase_k4k5_plan(dt, sm, sk, plan_edges, checks, dev)
    phase_k6_small(k6, g_small, checks)
    del g_small
    phase_gat(dt, gk, sk, checks, dev)
    phase_masked_kernels(dt, sk, sm, gk, k6, checks, dev)
    ds, g, data_s = _reddit(dt, dev)
    emit({"phase": "reddit_data", "nodes": g.num_src_nodes,
          "edges": g.num_edges(), "seconds": data_s,
          "plan_build_ms": plan_build_ms(sk, g)})
    c_gcn = phase_gcn(dt, build, sk, ds, g, checks, dev, timings)
    c_gat, gat_losses = phase_gat_train(dt, build, gk, sk, ds, g, checks,
                                        dev, timings)
    c_bf16_gat = phase_bf16_gat_reddit(dt, build, gk, sk, g, checks, dev,
                                       timings)
    c_packed = phase_gat_train_packed(dt, build, ds, g, checks, dev,
                                      gat_losses)
    phase_sage_kernels(sm, sk, g, checks, dev, timings)
    c_max_bf16 = phase_bf16_reddit(dt, sk, sm, g, checks, dev, timings)
    c_sage = phase_sage_train(build, ds, g, dev)
    phase_native_sampler(ds)
    c_sampled, mean_losses = phase_sage_sampling_train(build, ds, dev)
    c_prefetch = phase_prefetch(build, ds, dev, mean_losses)
    c_nodeflow = phase_nodeflow(build, ds, dev)
    c_lstm = phase_sage_lstm_train(build, ds, checks, dev)
    c_rmax = phase_reddit_max_subset(dt, build, sm, sk, g, checks, dev,
                                     timings)
    c_prop = phase_propagation_train(build, ds, g, dev)
    phase_k1_rows(sk, g, ds, checks, dev, timings)
    c_cluster = phase_cluster_gcn_train(dt, build, sk, ds, checks, dev,
                                        timings)
    from dgl_hack_tpu_torch.parallel.launch import RankPool
    t0 = time.perf_counter()
    with RankPool(SPATIAL["parts"], "gloo", "cuda", timeout=300) as pool:
        emit({"phase": "rank_pool", "ranks": SPATIAL["parts"],
              "backend": "gloo", "start_s": time.perf_counter() - t0})
        c_spatial, reddit_plan = phase_spatial_reddit(dt, build, pool, ds, g,
                                                      checks, dev)
        del ds, g
        torch.cuda.empty_cache()
        c_skern = phase_spatial_kernels(dt, build, pool, checks, dev)
        c_mdry = phase_multichip_dryrun(pool, checks)
    c_nccl = phase_nccl_one_rank(checks)
    phase_rank_kernels(dt, sk, sm, gk, reddit_plan, checks, dev)
    del reddit_plan
    torch.cuda.empty_cache()
    c_tf = phase_transformer(build, k6, checks, dev, timings)
    c_gin = phase_gin_train(build, checks, dev)
    phase_layers(dt, build, checks, dev)
    c_rgcn = phase_rgcn_train(dt, build, sk, checks, dev)
    c_hetero = phase_rgcn_hetero_train(dt, build, checks, dev)
    c_topo = phase_prop_topo(dt, build, checks, dev)
    phase_tree_lstm(build, checks, dev)
    c_pinsage = phase_pinsage_rec(build, dev)
    c_cv = phase_sage_cv(build, dev)
    c_adaptive = phase_adaptive_sampling(build, dev)
    c_han = phase_han(build, checks, dev)
    c_capsule = phase_capsule(build, checks, dev)
    c_writer = phase_graphwriter(build, checks, dev)
    c_chem = phase_chem_train(dt, build, sk, checks, dev)
    c_chem_twins = phase_chem_twins(build, checks, dev)
    c_small = phase_small_twins(build, checks, dev)
    kg_ds = phase_kg_train(build, checks, dev)
    phase_kg_dist(build, kg_ds, dev)
    phase_dgmg_train(build, checks, dev)
    phase_entry(dt, dev)

    runs = (c_gcn, c_gat, c_sage, c_tf, c_prop, c_gin, c_sampled, c_rgcn,
            c_hetero, c_pr, c_sub, c_lstm, c_rmax, c_topo, c_prefetch,
            c_nodeflow, c_pinsage, c_cv, c_adaptive, c_packed, c_han,
            c_capsule, c_writer, c_chem, c_chem_twins, c_small, c_ckpt,
            c_cluster, c_spatial, c_skern, c_mdry, c_nccl,
            *c_headline.values())
    max_runs = (c_sage, c_sampled, c_hetero, c_rmax, c_nodeflow, c_skern)
    gat_runs = (c_gat, c_packed, c_han, c_chem, c_spatial, c_mdry)
    sddmm_runs = (c_tf, c_capsule, c_writer, c_chem, c_small)
    launches = {
        "segment_sum": sum(v for c in runs for k, v in c.items()
                           if k.startswith("segment_sum.")),
        "gat_fwd": sum(_launched(c, "gat_fwd") for c in gat_runs),
        "gat_bwd": sum(_launched(c, "gat_bwd") for c in gat_runs),
        "segment_max": sum(c.get("segment_max.fwd", 0) for c in max_runs),
        "segment_max_bwd": sum(c.get("segment_max.bwd", 0)
                               for c in max_runs),
        "sddmm": sum(_launched(c, "sddmm") for c in sddmm_runs),
        "segment_sum_bf16": sum(v for c in c_headline.values()
                                for k, v in c.items()
                                if k.startswith("segment_sum_bf16.")),
        "segment_max_bf16": c_max_bf16.get("segment_max_bf16.fwd", 0),
        "segment_max_bwd_bf16": c_max_bf16.get("segment_max_bf16.bwd", 0),
        "gat_fwd_bf16": sum(_launched(c, "gat_fwd_bf16")
                            for c in (c_packed, c_bf16_gat)),
        "gat_bwd_bf16": sum(_launched(c, "gat_bwd_bf16")
                            for c in (c_packed, c_bf16_gat)),
        "sddmm_bf16": _launched(c_bf16_sddmm, "sddmm_bf16")}
    tpu = "dgl_hack_tpu/ops/pallas/"
    meta = {
        "segment_sum": ("dgl_hack_tpu_torch/csrc/segment_sum.cu",
                        tpu + "spmm_kernel.py:541"),
        "gat_fwd": ("dgl_hack_tpu_torch/csrc/gat_fwd.cu",
                    tpu + "gat_kernel.py:222"),
        "gat_bwd": ("dgl_hack_tpu_torch/csrc/gat_bwd.cu",
                    tpu + "gat_kernel.py:446"),
        "segment_max": ("dgl_hack_tpu_torch/csrc/segment_max.cu",
                        tpu + "spmm_kernel.py:675"),
        "segment_max_bwd": ("dgl_hack_tpu_torch/csrc/segment_max.cu",
                            tpu + "spmm_kernel.py:1109"),
        "sddmm": ("dgl_hack_tpu_torch/csrc/sddmm.cu",
                  tpu + "sddmm_kernel.py:160"),
        "segment_sum_bf16": ("dgl_hack_tpu_torch/csrc/segment_sum.cu",
                             tpu + "spmm_kernel.py:489"),
        "segment_max_bf16": ("dgl_hack_tpu_torch/csrc/segment_max.cu",
                             tpu + "spmm_kernel.py:632"),
        "segment_max_bwd_bf16": ("dgl_hack_tpu_torch/csrc/segment_max.cu",
                                 tpu + "spmm_kernel.py:1109"),
        "gat_fwd_bf16": ("dgl_hack_tpu_torch/csrc/gat_fwd.cu",
                         tpu + "gat_kernel.py:246"),
        "gat_bwd_bf16": ("dgl_hack_tpu_torch/csrc/gat_bwd.cu",
                         tpu + "gat_kernel.py:446"),
        "sddmm_bf16": ("dgl_hack_tpu_torch/csrc/sddmm.cu",
                       tpu + "sddmm_kernel.py:178")}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": n, "route": "cuda", "source": s, "replaces": r,
                "launches": launches[n], "max_abs_err": checks.max_abs[n],
                **{k: timings[n][k] for k in keys}}
               for n, (s, r) in meta.items()]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
