#!/usr/bin/env python3
"""Smoke run of graphembedding_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one or more lines each:
  1. card: the name and power limit (nvidia-smi); no card -> exit 1;
  2. build: compiles the CUDA kernels from graphembedding_tpu_torch/csrc;
  3. kernels: K1 (SGNS block gradients), K2 (row scatter-add) and K3 (row
     gather) against their plain PyTorch versions at the shapes of the
     DeepWalk-on-Wiki step, with device times (CUDA events around calls
     queued while the card spins, so that host launch time does not show;
     median of 20 runs; K1 in turns with its plain version, K2 in turns
     with a bare `index_add_` on the in-range ids: other, kernel, kernel,
     other), each kernel's bound (section "Bounds" below), K1's achieved
     GB/s and useful TFLOP/s, K1's and K2's run-to-run bit identity, and
     the device launches of one K2 call (torch.profiler);
  4. step parity: four SGNS steps through the kernels against four
     through the plain versions, from the same table and draws;
  5. main path: load_dataset('wiki') -> DeepWalk(walk_length=10,
     num_walks=80, device='cuda') -> train(embed_size=128, window_size=5,
     iter=3) -> get_embeddings -> Classifier (0.8 split, seed 0); checks
     that every kernel launched, the corpus by one launch of K6, and
     micro-F1 >= 0.93;
  6. K4 (small-V row scatter-add) against its plain version, K2 and a
     bare `index_add_` (in turns) at the shapes of the LINE-on-Wiki step:
     1,024 rows into emb and 6,144 into ctx, V = 2405, C = 128;
  7. K5 (row gather by bulk copies): the `dma_gather` benchmark at its
     default shapes (a 1M x 256 table, 65,536 ids, B = 8/16/32) against
     the plain gather, `index_select` and K3, counting K5's launches; K5's
     time is that of its fastest B in turns with `index_select`;
  8. `scatter_bench --quick`: K2 against index_add_ at V = 1M, K4, K2 and
     K3 against their plain versions at V = 2405;
  9. four LINE steps through the kernels against four plain ones;
 10. LINE path: load_dataset('wiki') -> LINE(embedding_size=128,
     order='second', device='cuda') -> train(batch_size=1024, epochs=50)
     -> get_embeddings -> Classifier; checks that K3 and K4 launched and
     micro-F1 >= 0.70;
 11. Node2Vec path: load_dataset('wiki') -> Node2Vec(walk_length=10,
     num_walks=80, p=0.25, q=4, device='cuda') -> train(embed_size=128,
     window_size=5, iter=3) -> get_embeddings -> Classifier; checks that the
     exact sampler was chosen, the corpus by one launch of K7, that K1, K2 and
     K3 launched, and micro-F1 >= 0.90; prints walk and train seconds and
     rates, and the walks' share of the two from a warm walk (the graph's views
     built) against a warm train, each the faster of two;
 12. walk modes on the card: simulate_walks on the Wiki graph by the
     exact sampler, dense and CSR rejection and weighted walks, each on a
     fresh copy of the graph so that its cold run builds the views it
     reads (one launch of its kernel, K7, K8 or K6 by alias, a corpus;
     every hop an edge, two runs from one seed bit-identical, cold
     and warm seconds, walked edges/s, the device's busy time in one warm
     run by torch.profiler), then exact against dense rejection on a
     512-out-regular graph of 20,000 nodes (p = 0.25, q = 4, one walk of
     10 a node);
 13. four hierarchical-softmax steps through the kernels (K10, and K4
     by `ops.rows.scatter_add_table`) against four through the plain
     versions, from the same tables and draws, at the DeepWalk hs=1 Wiki
     shapes (Bw = 504: G = 42 groups of PL = 120, Huffman depth T, the
     tree table [V - 1, 128]); then the step's two scatters, the tokens'
     [G*PL, 128] into [V, 128] and the tree's [G*PL*T, 128] into
     [V - 1, 128], each by K4 (its plan by `ops.rows.small_plan`) bit-equal
     to K2 and to the CPU plain version and run to run, timed in turns
     with a bare `index_add_` and with K2, beside its bound; and the tree
     gather of the plain version's products (which the mesh's
     tensor-parallel HS step runs) by K3 and `index_select` in turns;
 14. DeepWalk hs=1 path: load_dataset('wiki') -> DeepWalk(walk_length=10,
     num_walks=80, device='cuda') -> train(embed_size=128, window_size=5,
     iter=3, hs=1) -> get_embeddings -> Classifier; checks that K10
     launched 1,152 times (once a step) and K4 2,304 (twice a step), K1,
     K2 and K3 never, and micro-F1 >= 0.93; prints train s, trained
     pairs/s, and the device time and busy share of one warm train
     (torch.profiler);
 15. Struc2Vec path: load_dataset('flight-brazil') -> Struc2Vec(
     walk_length=10, num_walks=80, workers=4, temp_path=<a temporary
     directory>, device='cuda') -> train(embed_size=128, window_size=5, iter=5)
     (hs='auto' -> hs=1) -> get_embeddings -> Classifier; checks the HS route,
     K10 launched 320 times and K4 640, every emitted hop an edge of a layer of
     the context graph or a stay at a vertex with no edge in some layer,
     micro-F1 >= 0.80, and that a second model with reuse=True loads the cache
     and walks the same corpus from the same seed, each model's corpus one
     launch of K9 (a walk of at most 64 device events); prints context-graph,
     layer-CSR, cold and warm walk and train seconds, K, E_max, the walk's
     device events, and the device time and busy share of one warm train
     (torch.profiler).

 16. SDNE parity, card against CPU: on the Wiki graph with hidden [256,
     128], three full-batch steps (train(batch_size=3000, epochs=3)),
     three minibatch steps (train(batch_size=1024, epochs=1)) and three
     train_sparse steps (row_chunk=512), each from the same initial
     parameters and permutation (both drawn on the CPU): the losses within
     rtol 1e-5 of the CPU run, each parameter's update within 1e-3 of the
     CPU's in L2 norm, and two card runs bit-identical;
 17. SDNE Wiki paths: load_dataset('wiki') -> SDNE(hidden_size=[256,
     128], device='cuda') -> train(batch_size=3000, epochs=40) (full
     batch), train(batch_size=1024, epochs=40) (minibatch) or
     train_sparse(epochs=40) -> get_embeddings -> Classifier; micro-F1 >=
     0.72 each; cold train s (the chunk graph captured), rows/s (V *
     epochs / train s), the graphs' capture s and reserved memory; warm
     trains, device time and busy share in phase 29;
 18. SDNE sparse at scale: synthetic_wiki(num_nodes=100_000,
     avg_degree=10.0) -> SDNE([256, 128]) -> train_sparse(epochs=2,
     row_chunk=512) through a chunk graph, then once more warm: A and L
     never built, losses finite, torch.cuda.max_memory_allocated() under
     8 GiB with the graph's buffers and pool (a dense [V, V] alone is 40
     GB), s an epoch warm; then 2 epochs timed again and 2 under
     torch.profiler (device time and busy share);
 19. dense trainers on Wiki: DeepWalk(walk_length=10, num_walks=80) ->
     train(embed_size=128, window_size=5, trainer='dense') (micro-F1 >=
     0.93) and LINE(embedding_size=128, order='second') ->
     train(trainer='dense') (micro-F1 >= 0.70); cold train s with its
     capture, one warm train s and its tables equal to the cold one's.
Phases 16-19 run none of K1-K5 and K10 (their products are cuBLAS calls
and plain PyTorch); the run fails if any kernel's count moves in them. Their
trains run each chunk of steps as one CUDA graph.
 20. restartable training: each run below is cut by an exception raised
     inside it (a metrics logger that raises on its n-th line, or a
     wrapped chunk or step function), then trained again in a fresh model
     from the same checkpoint_dir; the resumed tables must equal those of
     an uninterrupted train bit for bit (torch.equal), and the resumed
     run's K1-K4 and K10 launches must be the steps it still had to train times
     the per-step counts of phases 5, 10 and 14. DeepWalk SGNS on Wiki (3
     chunks, a checkpoint every chunk, cut after chunk 2), DeepWalk hs=1
     (18 chunks, every 4, cut at chunk 7), LINE order 'all' (cut in order
     'second''s second chunk), SDNE full batch, minibatch and train_sparse
     through the chunk graphs (40 epochs, every 10, cut as the chunk of
     epochs 11-20 starts; held against the uninterrupted train with the
     same cadence and the train without checkpoints); prints each
     checkpoint's bytes and its save and restore seconds;
 21. metrics: DeepWalk and DeepWalk hs=1 trains with a MetricsLogger write
     3 and 18 JSONL lines whose (kind, epoch, step) are the JAX package's
     (tests/test_torch_checkpoint.py holds them against it on the CPU),
     and their tables equal a train without metrics bit for bit;
 22. LINE on BlogCatalog through graphembedding_tpu_torch.examples.
     line_blogcatalog at its defaults (order 'all', 50 epochs, batch
     1024, on the BlogCatalog-scale synthetic graph): K3 and K4 launched,
     K1 and K2 never; train s, sampled edges/s, micro-F1 >= 0.95; then
     `python -m graphembedding_tpu_torch.examples.deepwalk_wiki --json` in
     a process of its own (micro-F1 >= 0.93 on the card);
 23. most_similar on a 1,000,000 x 128 table on the card (one matmul and
     top-k) against the numpy path on the same table: the same top-10
     names apart from ties within 1e-5, scores within 1e-5; warm ms a
     query for both.
 24. the mesh at world size 1 over NCCL (one spawned rank on the card):
     `rowsharded_sgns_chunk` against `sgns_block_chunk_cat` for 4 steps on
     the DeepWalk-on-Wiki shapes (the corpus of phase 5, D = 128), tables,
     losses and pair counts equal (torch.equal), with K3 once, K1 once and
     K2 twice a step; then each mesh trainer on Wiki with mesh=: DeepWalk
     rowshard (prefetch off and on), dp and hs=1 (dp), LINE order 'second'
     (batch 1024, 50 epochs) and SDNE [256, 128] full batch and
     train_sparse (40 epochs), each through its chunk graphs (one CUDA
     graph a chunk, the NCCL exchanges inside it) and through the step
     loop, in turns: tables torch.equal, micro-F1 equal and >= its gate,
     K1-K4 launches equal and = steps x the per-step counts; for each way
     the capture s, cold and warm train s, device time and busy share of
     one warm train (torch.profiler), peak allocated and reserved memory;
     the rowshard train's s, trained pairs/s and launches;
 25. the mesh at world size 2 over gloo, both ranks on the card (two
     spawned ranks; every exchange staged through host memory, so the
     steps run one by one: a CUDA graph cannot capture the copies): the
     rowshard chunk, the dp chunk at mesh (2, 1) and (1, 2), the HS dp
     chunk, the LINE dp chunk and SDNE's full-batch and sparse mesh
     trainers, each on the card against the same chunk at world size 2 on
     the CPU from the same weights and draws, within the tolerances of
     phases 4, 13, 9 and 16; then, on the card, DeepWalk (walk_length=10,
     num_walks=80) trained with mesh= in rowshard and dp mode and with
     hs=1, LINE order 'second' (batch 1024, 50 epochs) and SDNE [256, 128]
     (full batch, 40 epochs), each with micro-F1 >= its gate, train s, its
     rate and each kernel's launches on each rank;
 26. restart over the mesh: the rowshard DeepWalk fit of phase 25 cut by an
     exception after its second chunk (a checkpoint a chunk, a file a
     rank) and resumed in the same ranks: tables torch.equal to phase 25's
     uninterrupted fit, and the resumed run's launches = the one remaining
     chunk's steps x the per-step counts.
 27. the distributed walks (`parallel/walks.py`) at world size 1 over NCCL (one
     spawned rank on the card): the all-gather engine at slack 1 torch.equal to
     `ops.walk.uniform_walks_plain` (the lockstep walk) from a generator in the
     same state, on Wiki with a self-loop at each of its 74 vertices without
     out-edges (no walk stops, so no slot is compacted away); every kind on
     Wiki (uniform, weighted, batched with hop_batch 4, a2a uniform and
     weighted, node2vec exact and rejection at p = 0.25, q = 4) and on
     flight-brazil's Struc2Vec layers (multilayer, multilayer a2a), 80 walks of
     10 a node, each with overflow 0, every hop an edge (of a layer, or a
     stay), two runs from one seed torch.equal, warm walked edges/s (rounds and
     crossed rows where the engine counts them) beside the one-card sampler's;
     DeepWalk(G, mesh=m).train(embed_size=128, window_size=5, iter=3), the
     constructor's mesh in rowshard mode (micro-F1 >= its gate, launches as in
     phase 24); at V = 100,000 (phase 18's graph) one walk of 10 a node by the
     all-gather engine, the a2a engine and `uniform_walks`;
 28. the same at world size 2 over gloo (both ranks on the card): every
     kind with overflow 0 at slack 4; the a2a engine's corpus through the
     ragged exchange torch.equal to the dense frame's (the JAX package's)
     at the default bucket cap and at 64 (backpressure rounds); DeepWalk(
     mesh=) trained in dp and rowshard mode, DeepWalk(mesh=,
     walk_exchange='a2a'), Node2Vec(mesh=, p=0.25, q=4) (dp) and
     Struc2Vec(mesh=) on flight-brazil (hs=1), each with walk s, train s,
     launches on each rank and micro-F1 >= its gate, the ranks agreeing;
     then `examples/deepwalk_multihost` as two processes on cuda:0 over
     gloo (rank 0's JSON line: 2 processes, overflow 0, micro-F1 >= 0.9).
Phases 27-28 run none of K1-K5 in the walks; the trains launch them.
 29. chunk graphs against the step loop: the single-device trainers run
     each chunk of steps as one replayed CUDA graph (train/chunk_graph.py;
     phases 4-23 go through them); here DeepWalk and DeepWalk hs=1 on
     Wiki, Struc2Vec on flight-brazil and LINE order 'second' on Wiki each
     train through the graphs (the cache emptied first, so the cold train
     captures) and through the loop of steps launched one by one, in this
     run: tables torch.equal, micro-F1 equal and at its gate, K1-K4
     launches equal and those of phases 5, 14, 15 and 10; for each way the
     capture s, cold and warm train s, device time and busy share of one
     warm train (torch.profiler), peak allocated and reserved memory with
     the graph pools held; then the same for SDNE full batch,
     minibatch and train_sparse on Wiki (40 epochs, micro-F1 >= 0.72) and
     DeepWalk and LINE trainer='dense' (>= 0.93, >= 0.70), with none of
     K1-K5 launched; then LINE 'all' on BlogCatalog through the loop
     against phase 22's train through the graphs (tables, micro-F1,
     launches).
 30. the large-V path: benchmarks.million.synthetic_graph(1,000,000, 10)
     -> DeepWalk(walk_length=10, num_walks=5, device='cuda') ->
     train(embed_size=128, window_size=5, iter=1) with cap_mode 'auto'
     (the sparse cap at this V) and then 'dense', each cold (its chunk
     graphs captured) and warm, counts from 0 before the walks: the corpus
     one launch of K6, then K6 at this corpus as in phase 33 (its record
     `uniform_walks[V=1M]`); K1, K2 and K3 launched, embeddings finite,
     the loss falling; build s, walked
     edges/s cold and warm (every hop an edge), train s and trained
     pairs/s, the device time and busy share of a warm train
     (torch.profiler), reserved memory after each train and after a
     release; the chunk-graph cache within its budget
     (`train/chunk_graph.py::BUDGET_BYTES`) after every train (and, in
     main, after each group of phases 6-30); a chunk of 4 sparse-cap steps
     at V = 1M through K1-K3 against the plain versions (rtol 1e-4, atol
     1e-6) and through its graph torch.equal to the loop, launches equal;
     K2 at the sparse step's token call bit-equal to the CPU plain version,
     in turns with `index_add_`, beside its bound; then `table_scale
     --nodes 1000000` and `pq_crossover --degrees 512` once each.
 31. hierarchical softmax at V = 1M: phase 30's graph -> DeepWalk(
     walk_length=10, num_walks=1, device='cuda') -> train(embed_size=128,
     window_size=5, iter=1, hs=1) ('auto': the sparse cap at this V), then
     the same fit in the dense form (HSTrainer(cap_mode='dense'), the same
     seed), each cold (its chunk graphs captured) and warm, the graphs
     released between, counts from 0 before the walks: K10 and K2 launched,
     K1, K3 and K4 never, embeddings finite, the loss falling; the Huffman
     build's host s, train s and trained pairs/s, the device time and busy
     share of a warm train, reserved memory after each train; the two
     forms' tables within rtol 1e-4, atol 1e-6; a chunk of 4 sparse steps
     through K10 and K2 against the plain versions (the same tolerance) and
     through its graph torch.equal to the loop, launches equal; K2 at the
     sparse step's token and tree calls (the tree's hot Huffman runs)
     bit-equal to the CPU plain version, in turns with `index_add_`, and K3
     at its tree gather in turns with `index_select`, beside their bounds;
     then on Wiki a chunk of 4 sparse-cap steps through K10 and K4 (K4 into
     the live tables) against 4 dense-cap ones (the same tolerance), and
     HSTrainer(cap_mode='sparse') and 'dense' fits (K4 2 a step, their
     difference printed), micro-F1 >= 0.93;
 32. `benchmarks/scaling.py --world 1 --backend nccl --chunks 2 --reps 1`
     (one spawned rank): its dp, rowshard and distributed-walk rows.
World size 2 on one card measures correctness and the exchanges' cost, not
scaling: both ranks share the card, and gloo moves every exchange through
host memory.
 33. (run after phase 12) the walk kernels of csrc/walk.cu, each one
     launch a corpus, replacing the JAX package's lockstep `lax.scan`s (no
     pallas_call): K6 (first order, uniform and by alias), K7 (exact
     (p,q)), K8 (rejection (p,q): the envelope with CSR membership, the
     envelope with dense membership and uniform row slots, the upper bound
     with CSR membership) on Wiki's corpus (80 walks of 10 a node, p =
     0.25, q = 4), K9 (the multilayer walk) on flight-brazil's layers (80
     walks of 10 a node): each on the uniforms its plain version draws
     (`ops.walk.record_draws`, `draws=`) torch.equal to that version (K7:
     at most 1e-5 of the hops may differ, counted and explained), one
     launch from a seed, two runs from one seed bit-identical, every hop an
     edge (K9: a layer's, or a stay); device ms in turns with the plain
     version, the bound from the kernel's own corpus (bytes, or for K7 its
     logarithms and products at the float32 peak) and the chain of L - 1
     dependent hops (`chain_ms`: one walker's hop measured by K6 on Wiki
     with self-loops at its dead ends, 1,001 hops against 1, a measured
     latency and not a figure of the card's); then each kernel's third-hop
     law from Philox draws on the weighted triangle with a tail (atol
     0.03).
 34. (run after phase 13) K10, the hs=1 step's scoring over the window's
     pairs (`ops.hs.hs_block_grads`, csrc/hs.cu), at the DeepWalk hs=1
     step on Wiki's corpus and on the benchmark cells' graphs
     (BlogCatalog: 10,312 nodes of mean degree 65; YouTube: 1,138,499 of
     mean degree 5; `benchmarks.million.synthetic_graph`, one walk of 10
     a node, its Huffman tree over the corpus' counts, a block of 504 of
     the walks): against its plain version (rtol 1e-5, atol 1e-6), the
     same bits run to run, one launch a call; device ms in turns with the
     plain version, the bound (bytes: d_yin and d_tree written, the rows
     and paths the scored pairs touch read, once; operations: 6 D a
     scored (pair, level) at the float32 peak) and `library_ms`, the
     plain version's three batched products (`torch.bmm` in full float32)
     together.
In phases 5, 11, 12, 15 and 30 a plain walk given a CUDA tensor fails the
run (`walks_through_kernels`), and each corpus is counted as one launch of
its kernel. Each walk kernel record's `launches` is its main path's count
(`walk_path_launches`): DeepWalk's (phase 5), Node2Vec's (11), the weighted
and rejection modes on Wiki (12), the two Struc2Vec models (15), DeepWalk
at V = 1M (30); 0 for the rejection walk's upper-bound form, which no main
path runs. Phase 27's oracle is the plain uniform walk, whose draws the
slack-1 engine repeats.

The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}. Any failure exits non-zero before them.
Phase 2 also builds Struc2Vec's C++ library with g++ (a missing compiler
fails the run there).

Bounds: `bound_ms` is the least time the card could take for a kernel's
work on this run's inputs: the larger of its bytes (each input read once,
each output written once; for the row kernels only the rows this run's ids
touch; for the walk kernels the rows the kernel's corpus leaves, their real
entries and no padding, and K9's layer tables whole) over 3.35 TB/s of
HBM3, and its operations over the card's peak for their type (K1: its
split-TF32 products, three per useful product, at 495 TFLOP/s; the walk
kernels: float32 operations on the hops the corpus moves and, for K7, the
real candidates of each row it leaves, a logarithm counted as one, at 67
TFLOP/s). The chain of dependent hops is not in `bound_ms` (bytes and
operations only); each walk kernel's line prints its share of the larger
of the two. `library_ms` is one PyTorch call that computes the
same function (`index_add_` on the in-range ids for K2 and K4,
`index_select` for K3 and K5; none for K1 and the walk kernels; for K10
the three `torch.bmm` of its plain version), which the port's kernels
replace. The walk kernels' records also carry `chain_ms`.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MIN_MICRO_F1 = 0.93  # expected of DeepWalk on the Wiki-scale graph
# LINE order 'second' on it: the JAX package gives 0.748-0.761 on the CPU
# over seeds 0-2, and the port's random streams differ from its
LINE_MIN_MICRO_F1 = 0.70
N2V_MIN_MICRO_F1 = 0.90  # Node2Vec (p = 0.25, q = 4) on the same graph
# DeepWalk hs=1 on the same graph: the JAX package gives 0.9667 on the CPU
# (seed 0); the gate is DeepWalk's SGNS gate
HS_MIN_MICRO_F1 = 0.93
# Struc2Vec on flight-brazil: the JAX package gives 0.8889 on the CPU (seed
# 0); its test split holds 27 nodes, so one node is 0.037
S2V_MIN_MICRO_F1 = 0.80
# four HS steps, kernels against plain versions: the plain scatter on the
# card sums with atomics, in another order (tests/test_torch_card.py)
HS_RTOL, HS_ATOL = 1e-5, 1e-6
# SDNE on the Wiki graph, each trainer: the JAX package gives 0.7547-0.7817
# (full batch), 0.7651-0.7796 (minibatch) and 0.7568-0.7817 (sparse) on the
# CPU over seeds 0-2 (tools/reference_f1.py)
SDNE_MIN_MICRO_F1 = 0.72
# trainer='dense': DeepWalk 0.9563-0.9688, LINE order 'second' 0.7443-0.7651
# (the same tool)
DENSE_DW_MIN_MICRO_F1 = 0.93
DENSE_LINE_MIN_MICRO_F1 = 0.70
# SDNE steps on the card against the CPU: the losses within rtol 1e-5, and
# each parameter's update (its value minus the shared initial value) within
# 1e-3 of the CPU's in L2 norm. Not elementwise: Adam's step is about
# lr * grad / (|grad| + eps), so an element whose gradient is near zero
# turns its last-bit differences (the card sums in another order)
# into a step of up to lr (measured: 4.4e-5 on 1 of 1.3M elements)
SDNE_LOSS_RTOL, SDNE_UPDATE_RTOL = 1e-5, 1e-3
# train_sparse at V = 100,000: parameters, Adam state and gradients take
# about 0.8 GB, one chunk's [512, V] tensors about 0.2 GB each
SDNE_SPARSE_MAX_BYTES = 8 << 30
# LINE order 'all' on the BlogCatalog-scale graph (the example's defaults):
# the JAX package gives 0.9995 on the CPU (seed 0, tools/reference_f1.py);
# the port's random streams differ from its
BC_MIN_MICRO_F1 = 0.95
# the mesh phases: the JAX package's CPU micro-F1 over a (2, 1) mesh of two
# virtual devices, seeds 0-2 (tools/reference_f1.py, mesh_*), less 0.04
# and rounded down to 0.01, as the gates above keep 0.03-0.05 below theirs:
# rowshard 0.9543-0.9688, dp 0.9397-0.9459, hs=1 0.9647-0.9709, LINE
# 0.7464-0.7568, SDNE full batch 0.7547-0.7817, rowshard with prefetch
# (rowshard_prefetch=True: one step of row staleness) 0.7588-0.8295
# The models built with mesh= (phases 27-28, mesh_walks_*, the same rule):
# DeepWalk rowshard 0.9501-0.9605, dp 0.9480-0.9563, a2a (dp) 0.9397-0.9626,
# Node2Vec (p = 0.25, q = 4, dp) 0.9335-0.9563, Struc2Vec on flight-brazil
# (hs=1) 0.8519-0.9259
MESH_MIN_MICRO_F1 = {"rowshard": 0.91, "rowshard_prefetch": 0.71,
                     "dp": 0.89, "hs": 0.92, "line": 0.70,
                     "sdne": 0.71, "walks_rowshard": 0.91, "walks_dp": 0.90,
                     "walks_a2a": 0.89, "walks_node2vec": 0.89,
                     "walks_struc2vec": 0.81}
MESH_SGNS_TOL = (1e-4, 1e-6)  # phase 4's tolerance
MESH_ROW_TOL = (1e-5, 1e-6)  # phases 9 and 13's: LINE and HS steps
DEVICE = "cuda"


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


HBM_BYTES_PER_S = 3.35e12  # H100 SXM
TF32_FLOP_PER_S = 495e12  # H100 SXM, dense tensor cores


def rows_bound_ms(ids, V, C, out_rows):
    """Bound of a row kernel on these ids: the ids, the touched table rows
    (read, and written back when out_rows is None), and out_rows rows of
    gradients read (scatter) or of output written (gather)."""
    kept = ids[(ids >= 0) & (ids < V)]
    rows = kept.unique().numel()
    scatter = out_rows is None
    nbytes = 4 * (ids.numel() + rows * C * (2 if scatter else 1)
                  + (kept.numel() if scatter else out_rows) * C)
    return nbytes / HBM_BYTES_PER_S * 1e3


def device_events(fn):
    """(name, us) of each device kernel (and copy) one call of fn ran, by
    torch.profiler (user annotations left out); None where the trace holds
    no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    return events or None


def device_launches(fn):
    """Names of the device kernels one call of fn ran, or None."""
    events = device_events(fn)
    return events and [name for name, _ in events]


def sgns_work(G, G2, PL, D, K):
    """(bytes through device memory, useful FLOP) of one K1 call: every
    input read once, every output written once; six products."""
    r = G // G2
    floats = (4 * G * PL * D + G * PL * PL + G2 * r * PL * K + 2 * G2 * K * D
              + G)
    return 4 * floats, 2 * G * D * (3 * PL * PL + 3 * PL * K)


def max_err(got, want, rtol, atol, what):
    """Max |got - want|; fails unless allclose(rtol, atol)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
             f"atol={atol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def main():
    import torch

    # 1. card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    try:
        import graphembedding_tpu_torch as pkg
    except ImportError as e:
        fail(f"graphembedding_tpu_torch not importable beside this "
             f"script: {e}")
    if not os.path.abspath(pkg.__file__).startswith(HERE + os.sep):
        fail(f"graphembedding_tpu_torch comes from {pkg.__file__}, not "
             f"from this checkout")
    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.kernels import build as kb
    from graphembedding_tpu_torch.ops.rows import (
        gather_rows, gather_rows_plain, scatter_add_rows,
        scatter_add_rows_plain)
    from graphembedding_tpu_torch.ops.sgns import (
        sgns_block_grads, sgns_block_grads_plain)
    from graphembedding_tpu_torch.ops.walk import simulate_walks
    from graphembedding_tpu_torch.train import skipgram as sg

    # 2. build
    t0 = time.perf_counter()
    kb.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{kb.build_log['seconds']} s) -> {kb.library_path()}",
          flush=True)
    for line in kb.build_log["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    from graphembedding_tpu_torch import native
    t0 = time.perf_counter()
    try:
        native.library()
    except (RuntimeError, OSError) as e:
        fail(f"Struc2Vec's native library did not build: {e}")
    print(f"build: native library {time.perf_counter() - t0:.2f} s (g++) "
          f"-> {native.library_path()}", flush=True)

    # 3. kernels against plain versions at the slice's shapes
    ds = load_dataset("wiki")
    V, D, L, W, K, nsp = ds.graph.num_nodes, 128, 10, 5, 64, 4
    NW = 80 * V
    gen = torch.Generator(device=dev).manual_seed(1)
    walks = simulate_walks(ds.graph, 80, L, generator=gen)
    if tuple(walks.shape) != (NW, L):
        fail(f"corpus shape {tuple(walks.shape)}")
    geo = sg.block_geometry(NW, L, 4032, nsp)
    w_cat = (torch.rand((V, 2 * D), generator=gen, device=dev) - 0.5) / D
    w_cat[:, D:] = torch.randn((V, D), generator=gen, device=dev) * 0.05
    eff = W - (torch.rand((4, geo.G, geo.PL), generator=gen, device=dev)
               * W).to(torch.int32).clamp(0, W - 1)
    negs = torch.randint(0, V, (4, geo.G2, K), generator=gen, device=dev,
                         dtype=torch.int32)
    window_ok, dm = sg.window_geometry(L, geo.PL, W, dev)
    tok = walks[:geo.Bw].reshape(geo.G, geo.PL)
    tok_safe, y, vn, mask, neg_ok = sg.step_inputs(
        w_cat, tok, eff[0], negs[0], window_ok, dm, nsp, ops=sg.PLAIN)
    # the gather reads pads as row 0; the scatter drops them (-1)
    flat, nflat = tok_safe.reshape(-1), negs[0].reshape(-1)
    sflat = tok.reshape(-1)
    neg_w = 5.0 / K
    print(f"shapes: V={V} NW={NW} Bw={geo.Bw} G={geo.G} PL={geo.PL} D={D} "
          f"K={K} G2={geo.G2} tokens={flat.numel()} negatives="
          f"{nflat.numel()}", flush=True)

    records = []

    def record(name, source, replaces, err, ms, plain_ms, bound_ms,
               library_ms, bound_by="bytes"):
        records.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=None,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms))
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"kernel {name}: max_abs_err {err:.3e}, {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"library {lib} [{card}]", flush=True)

    # K3: bit-exact
    got = gather_rows(w_cat, flat)
    got_n = gather_rows(w_cat[:, D:], nflat)
    torch.cuda.synchronize()
    if not (torch.equal(got, gather_rows_plain(w_cat, flat))
            and torch.equal(got_n, gather_rows_plain(w_cat[:, D:], nflat))):
        fail("gather_rows differs from table[ids]")
    flat_l = flat.long()
    record("gather_rows", "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:261", 0.0,
           median_ms(lambda: gather_rows(w_cat, flat)),
           median_ms(lambda: gather_rows_plain(w_cat, flat)),
           rows_bound_ms(flat, V, 2 * D, flat.numel()),
           median_ms(lambda: torch.index_select(w_cat, 0, flat_l)))
    ms_n = median_ms(lambda: gather_rows(w_cat[:, D:], nflat))
    pl_n = median_ms(lambda: gather_rows_plain(w_cat[:, D:], nflat))
    print(f"  gather_rows negatives [{nflat.numel()}, {D}]: {ms_n:.4f} ms "
          f"vs plain {pl_n:.4f} ms")

    # K1: within rtol 2e-4 / atol 1e-5 of the plain version, the same bits
    # on a second launch, timed in turns with the plain version
    args = (y[..., :D], y[..., D:], vn, mask, neg_ok, neg_w)
    got = sgns_block_grads(*args)
    again = sgns_block_grads(*args)
    want = sgns_block_grads_plain(*args)
    torch.cuda.synchronize()
    err = max(max_err(g, w, 2e-4, 1e-5, f"sgns_block_grads {n}")
              for g, w, n in zip(got, want, ("d_yin", "d_yout", "d_vn",
                                             "loss")))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("sgns_block_grads: two launches on the same inputs differ")
    ms, plain_ms = turns_ms(lambda: sgns_block_grads(*args),
                            lambda: sgns_block_grads_plain(*args))
    nbytes, flop = sgns_work(geo.G, geo.G2, geo.PL, D, K)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 3 * flop / TF32_FLOP_PER_S * 1e3
    record("sgns_block_grads", "graphembedding_tpu_torch/csrc/sgns.cu",
           "graphembedding_tpu/ops/pallas_sgns.py:42", err, ms, plain_ms,
           max(byte_ms, op_ms), None,
           "operations" if op_ms >= byte_ms else "bytes")
    print(f"  sgns_block_grads: run-to-run bit-identical; "
          f"{nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} MB a call, "
          f"{flop / ms / 1e9:.2f} useful TFLOP/s of {flop / 1e9:.2f} GFLOP "
          f"(plain: {nbytes / plain_ms / 1e6:.1f} GB/s, "
          f"{flop / plain_ms / 1e9:.2f} TFLOP/s) [{card}]", flush=True)

    # K2: held against the plain version's sequential sum on the CPU, which
    # sums each row in the same order (the plain version on the card sums
    # with atomics, in an order that changes from run to run); timed in
    # turns with a bare index_add_ on the in-range ids
    d_yin, d_yout, d_vn, _ = want
    ones = torch.ones((flat.numel(), 1), device=dev)
    d_tok = torch.cat([d_yin.reshape(-1, D), d_yout.reshape(-1, D), ones], 1)
    d_neg = torch.cat([d_vn.reshape(-1, D), ones[:nflat.numel()]], 1)
    k2 = {}
    for call, ids, grads in (("tokens", sflat, d_tok),
                             ("negatives", nflat, d_neg)):
        C = grads.shape[1]
        buf = torch.zeros((V, C), device=dev)
        got = scatter_add_rows(buf.clone(), ids, grads)
        again = scatter_add_rows(buf.clone(), ids, grads)
        want_s = scatter_add_rows_plain(buf.cpu(), ids.cpu(), grads.cpu())
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want_s) or not torch.equal(got, again):
            fail(f"scatter_add_rows {call} [{ids.numel()}, {C}]: not "
                 f"bit-equal to the CPU plain version or not run-to-run "
                 f"identical")
        keep = (ids >= 0) & (ids < V)
        ids_in, grads_in = ids[keep].long(), grads[keep].contiguous()
        ms, lib_ms = turns_ms(lambda: scatter_add_rows(buf, ids, grads),
                              lambda: buf.index_add_(0, ids_in, grads_in))
        plain_ms = median_ms(lambda: scatter_add_rows_plain(buf, ids, grads))
        launched = device_launches(lambda: scatter_add_rows(buf, ids, grads))
        launched = ("not measured" if launched is None
                    else f"{len(launched)} {launched}")
        k2[call] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=rows_bound_ms(ids, V, C, None))
        print(f"  scatter_add_rows {call} [{ids.numel()}, {C}] into "
              f"[{V}, {C}]: bit-equal to the CPU plain version, run to run "
              f"identical; {ms:.4f} ms vs index_add_ {lib_ms:.4f} ms in "
              f"turns, plain {plain_ms:.4f} ms, bound "
              f"{k2[call]['bound_ms']:.4f} ms; device launches a call: "
              f"{launched} [{card}]", flush=True)
    record("scatter_add_rows", "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:67", 0.0,
           k2["tokens"]["ms"], k2["tokens"]["plain_ms"],
           k2["tokens"]["bound_ms"], k2["tokens"]["library_ms"])

    # 4. four steps through the kernels against four plain steps
    kw = dict(block_walks=4032, window=W, negative=5, neg_share_packs=nsp)
    a, la, pa = sg.sgns_block_chunk_cat(w_cat.clone(), walks, eff, negs,
                                        0.025, 1e-4, 0, 192.0, **kw)
    b, lb, pb = sg.sgns_block_chunk_cat(w_cat.clone(), walks, eff, negs,
                                        0.025, 1e-4, 0, 192.0, ops=sg.PLAIN,
                                        **kw)
    torch.cuda.synchronize()
    step_err = max_err(a, b, 1e-4, 1e-6, "four steps: table")
    max_err(la, lb, 1e-4, 1e-6, "four steps: loss")
    if not torch.equal(pa, pb):
        fail("four steps: pair counts differ")
    print(f"step parity: 4 steps, table max abs err {step_err:.3e}, "
          f"moved by {float((a - w_cat).abs().max()):.3e}", flush=True)

    # 5. the main path, counting launches
    kernels = (sgns_block_grads, scatter_add_rows, gather_rows)
    for k in kernels:
        k.launches = 0
    reset_walk_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = load_dataset("wiki")
    t1 = time.perf_counter()
    with walks_through_kernels():
        model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model.train(embed_size=128, window_size=5, iter=3)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    emb = model.get_embeddings()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
    t4 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} never launched on the main path")
    check_walk_launches("main path", {"uniform_walks": 1},
                        keep={"uniform_walks": "uniform_walks"})
    for r in records:
        r["launches"] = launches[r["name"]]

    table = model.embedding_table.clone()
    if tuple(table.shape) != (V, 128) or not torch.isfinite(table).all():
        fail(f"embeddings: shape {tuple(table.shape)} or non-finite")
    if len(emb) != V:
        fail(f"get_embeddings gave {len(emb)} nodes, want {V}")
    edges = int((model.walks[:, 1:] >= 0).sum())
    walk_s, train_s = t2 - t1, t3 - t2
    print(f"main path: dataset {t1 - t0:.3f} s, walks {walk_s:.4f} s, "
          f"train {train_s:.4f} s, classify {t4 - t3:.3f} s; "
          f"final loss {float(model.losses[-1]):.4f}", flush=True)
    print(f"walked edges/s: {edges / walk_s:.4e} ({edges} edges) [{card}]")
    print(f"trained pairs/s: {model.trained_pairs / train_s:.4e} "
          f"({model.trained_pairs:.0f} pairs) [{card}]")
    print(f"micro-F1: {res['micro']:.4f}, macro-F1: {res['macro']:.4f} "
          f"[{card}]", flush=True)
    if not res["micro"] >= MIN_MICRO_F1:
        fail(f"micro-F1 {res['micro']:.4f} < {MIN_MICRO_F1}")
    if "jax" in sys.modules:
        fail("jax was imported")

    # each group of phases, then the chunk graphs it left held, which must
    # fit the cache's budget (phase 30 checks after each of its trains)
    done = {}
    for name, phases in (
            ("line_phases", lambda: line_phases(dev, card, records, record)),
            ("node2vec_phases", lambda: node2vec_phases(dev, card)),
            ("walk_kernel_phase", lambda: walk_kernel_phase(
                dev, card, records, record)),
            ("hs_phases", lambda: hs_phases(dev, card, records, record)),
            ("struc2vec_phase", lambda: struc2vec_phase(dev, card)),
            ("sdne_phases", lambda: sdne_phases(dev, card)),
            ("dense_phase", lambda: dense_phase(dev, card)),
            ("restart_phases", lambda: restart_phases(dev, card)),
            ("blogcatalog_phase", lambda: blogcatalog_phase(dev, card)),
            ("simquery_phase", lambda: simquery_phase(dev, card)),
            ("mesh_phases", lambda: mesh_phases(card)),
            ("mesh_walk_phases", lambda: mesh_walk_phases(card)),
            ("chunk_graph_phase", lambda: chunk_graph_phase(
                dev, card, done["blogcatalog_phase"])),
            ("large_v_phase", lambda: large_v_phase(dev, card, records,
                                                    record)),
            ("large_v_hs_phase", lambda: large_v_hs_phase(
                dev, card, records, record, done["large_v_phase"])),
            ("scaling_phase", lambda: scaling_phase(card))):
        done[name] = phases()
        print(f"after {name}: {check_cache_bound(dev, name)}", flush=True)
    if "jax" in sys.modules or "graphembedding_tpu" in sys.modules:
        fail("jax or the JAX package was imported")

    walk_path_launches(records)
    print(json.dumps({"kernels": records}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def line_phases(dev, card, records, record):
    """Phases 6-10: K4, K5, the scatter benchmark, LINE step parity and
    the LINE path; appends the K4 and K5 records."""
    import torch

    from graphembedding_tpu_torch import LINE
    from graphembedding_tpu_torch.benchmarks import dma_gather, scatter_bench
    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.models import line
    from graphembedding_tpu_torch.ops.rows import (
        dma_gather_rows, gather_rows, scatter_add_rows,
        scatter_add_rows_plain, scatter_add_small, small_plan)

    # 6. K4 at the LINE step's shapes, on the step's own draws
    ds = load_dataset("wiki")
    V, D, B, K = ds.graph.num_nodes, 128, 1024, 5
    model = LINE(ds.graph, embedding_size=D, order="second", device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    h, tpos, tneg, lrs = line.line_bulk_samples(
        model._edge_src, model._edge_dst, model._edge_accept,
        model._edge_alias, model._neg_table, gen, 0.025, 0, 796.0,
        chunk_steps=4, batch_size=B, negative=K, k_shared=0)
    cases = [("emb", model.second_emb, h[0]),
             ("ctx", model.context_emb,
              torch.cat([tpos[0], tneg[0].reshape(-1)]))]
    k4 = {}
    for name, table, ids in cases:
        grads = torch.randn((ids.numel(), D), generator=gen,
                            device=dev) * 1e-3
        got = scatter_add_small(table.clone(), ids, grads)
        again = scatter_add_small(table.clone(), ids, grads)
        k2 = scatter_add_rows(table.clone(), ids, grads)
        want = scatter_add_rows_plain(table.cpu(), ids.cpu(), grads.cpu())
        torch.cuda.synchronize()
        if not (torch.equal(got.cpu(), want) and torch.equal(got, again)
                and torch.equal(got, k2)):
            fail(f"scatter_add_small [{ids.numel()}, {D}]: not bit-equal to "
                 f"the plain version on the CPU and to K2, or not run-to-run "
                 f"identical")
        buf = table.clone()
        keep = (ids >= 0) & (ids < V)
        ids_in, grads_in = ids[keep].long(), grads[keep].contiguous()
        ms, lib_ms = turns_ms(lambda: scatter_add_small(buf, ids, grads),
                              lambda: buf.index_add_(0, ids_in, grads_in))
        k4[name] = dict(
            ms=ms, library_ms=lib_ms,
            plain_ms=median_ms(lambda: scatter_add_rows_plain(buf, ids,
                                                              grads)),
            k2_ms=median_ms(lambda: scatter_add_rows(buf, ids, grads)),
            bound_ms=rows_bound_ms(ids, V, D, None))
        launched = device_launches(lambda: scatter_add_small(buf, ids, grads))
        print(f"  scatter_add_small {name} [{ids.numel()}, {D}] into "
              f"[{V}, {D}] ({small_plan(ids.numel(), V)} plan): bit-equal to "
              f"the CPU plain version and to K2; "
              f"{ms:.4f} ms vs index_add_ {lib_ms:.4f} ms in turns, plain "
              f"{k4[name]['plain_ms']:.4f} ms, K2 {k4[name]['k2_ms']:.4f} "
              f"ms, bound {k4[name]['bound_ms']:.4f} ms; device launches a "
              f"call: {'not measured' if launched is None else len(launched)}"
              f" [{card}]", flush=True)
    record("scatter_add_small",
           "graphembedding_tpu_torch/csrc/scatter_small.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:315", 0.0,
           k4["ctx"]["ms"], k4["ctx"]["plain_ms"], k4["ctx"]["bound_ms"],
           k4["ctx"]["library_ms"])

    # 7. K5 through the ported dma_gather entry
    dma_gather_rows.launches = 0
    rows = dma_gather.main([])
    k5_launches = dma_gather_rows.launches
    if k5_launches == 0:
        fail("dma_gather_rows never launched in the dma_gather benchmark")
    if not all(r.get("equal_to_plain", True) for r in rows):
        fail("dma_gather: a variant differs from table[ids]")
    by = {r["variant"]: r for r in rows}
    # the fastest B in turns with index_select on the same ids
    k5 = min((r for r in rows if r["variant"].startswith("k5")),
             key=lambda r: r["turns_ms"])
    # ids, the distinct rows read, the output written
    k5_bytes = 4 * (k5["rows_gathered"] * (1 + k5["width"])
                    + k5["unique_rows"] * k5["width"])
    record("dma_gather_rows", "graphembedding_tpu_torch/csrc/dma_gather.cu",
           "benchmarks/dma_gather.py:43", 0.0, k5["turns_ms"],
           by["plain"]["turns_ms"], k5_bytes / HBM_BYTES_PER_S * 1e3,
           k5["index_select_ms"])
    print(f"  dma_gather_rows: fastest {k5['variant']} (plan: stages, grid, "
          f"shared bytes {k5['plan']}); launches {k5_launches}", flush=True)

    # 8. the scatter benchmark, quick form
    for r in scatter_bench.main(["--quick"]):
        if r.get("k4_equal_k2") is False or r.get("k3_equal") is False:
            fail(f"scatter_bench: K4/K2 or K3 disagree: {r}")
        if r.get("k2_max_abs_err", 0.0) > 1e-5:
            fail(f"scatter_bench: K2 off by {r['k2_max_abs_err']}")

    # 9. four LINE steps through the kernels against four plain ones
    outs = [line.line_steps(model.second_emb.clone(),
                            model.context_emb.clone(), h, tpos, tneg, lrs,
                            negative=K, ops=ops)
            for ops in (line.KERNELS, line.PLAIN)]
    torch.cuda.synchronize()
    errs = [max_err(a, b, 1e-5, 1e-6, f"four LINE steps: {n}")
            for a, b, n in zip(outs[0], outs[1], ("emb", "ctx", "loss"))]
    print(f"LINE step parity: 4 steps, max abs err {max(errs):.3e}, ctx "
          f"moved by "
          f"{float((outs[0][1] - model.context_emb).abs().max()):.3e}",
          flush=True)

    # 10. the LINE path, counting launches
    kernels = (gather_rows, scatter_add_small, scatter_add_rows)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = load_dataset("wiki")
    model = LINE(ds.graph, embedding_size=D, order="second", device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.train(batch_size=B, epochs=50)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    emb = model.get_embeddings()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
    t3 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"LINE path launches: {launches}", flush=True)
    for name in ("gather_rows", "scatter_add_small"):
        if launches[name] == 0:
            fail(f"kernel {name} never launched on the LINE path")
    by_name = {r["name"]: r for r in records}
    by_name["scatter_add_small"]["launches"] = launches["scatter_add_small"]
    by_name["dma_gather_rows"]["launches"] = k5_launches
    table = model.embedding_table
    if tuple(table.shape) != (V, D) or not torch.isfinite(table).all():
        fail(f"LINE embeddings: shape {tuple(table.shape)} or non-finite")
    if len(emb) != V or not torch.isfinite(model.losses).all():
        fail("LINE: embeddings missing or losses non-finite")
    steps = model.losses.shape[0]
    print(f"LINE path: setup {t1 - t0:.3f} s, train {t2 - t1:.4f} s "
          f"({steps} steps of {B} edges), classify {t3 - t2:.3f} s; "
          f"final loss {float(model.losses[-1]):.4f}", flush=True)
    print(f"LINE sampled edges/s: {model.sampled_edges / (t2 - t1):.4e} "
          f"[{card}]")
    print(f"LINE micro-F1: {res['micro']:.4f}, macro-F1: "
          f"{res['macro']:.4f} [{card}]", flush=True)
    if not res["micro"] >= LINE_MIN_MICRO_F1:
        fail(f"LINE micro-F1 {res['micro']:.4f} < {LINE_MIN_MICRO_F1}")


def walk_hops(walks):
    """(u, v) of every hop taken in walks [B, L] (host int64 arrays)."""
    w = walks.cpu().numpy().astype(np.int64)
    u, v = w[:, :-1].ravel(), w[:, 1:].ravel()
    return u[v >= 0], v[v >= 0]


def check_hops(walks, graph, what):
    """Fails unless every hop of walks follows an edge of graph."""
    u, v = walk_hops(walks)
    V = graph.num_nodes
    src, dst, _ = graph.edges()
    if not np.isin(u * V + v, src * V + dst).all():
        fail(f"{what}: a hop follows no edge of the graph")
    return u.size


def check_layer_hops(walks, layers, what):
    """Fails unless every hop of walks (a Struc2Vec corpus, no -1) follows
    an edge of a layer of `layers` (`build_layer_csr`'s arrays) or stays at
    a vertex without an edge in some layer; returns the stays."""
    V = layers["gamma"].shape[1]
    rp = layers["row_ptr"].astype(np.int64)
    deg = np.diff(rp, axis=1)
    keys = np.concatenate([np.repeat(np.arange(V), deg[k]) * V
                           + layers["col_idx"][k, :rp[k, -1]]
                           for k in range(rp.shape[0])])
    w = walks.cpu().numpy().astype(np.int64)
    u, v = w[:, :-1].ravel(), w[:, 1:].ravel()
    edge = np.isin(u * V + v, keys)
    stay = (u == v) & (deg[:, u] == 0).any(0)
    if not (edge | stay).all():
        fail(f"{what}: {int((~(edge | stay)).sum())} hops follow no "
             f"layer's edge")
    return int(stay.sum())


def busy_text(fn):
    """The device's busy time in one call of fn: the sum of its device
    events' intervals (one stream, so none overlap)."""
    events = device_events(fn)
    if events is None:
        return "device busy not measured"
    busy = sum(us for _, us in events) / 1e3
    return f"device busy {busy:.4f} ms in {len(events)} device events"


def timed_walks(fn):
    """(walks, host seconds) of fn(), synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walks = fn()
    torch.cuda.synchronize()
    return walks, time.perf_counter() - t0


def node2vec_phases(dev, card):
    """Phases 11-12: the Node2Vec path and the walk modes on the card."""
    import torch

    from graphembedding_tpu_torch import Graph, Node2Vec
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.ops.rows import (
        gather_rows, scatter_add_rows)
    from graphembedding_tpu_torch.ops.sgns import sgns_block_grads
    from graphembedding_tpu_torch.ops.walk import simulate_walks

    # 11. the Node2Vec path, counting launches
    kernels = (sgns_block_grads, scatter_add_rows, gather_rows)
    for k in kernels:
        k.launches = 0
    reset_walk_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = load_dataset("wiki")
    t1 = time.perf_counter()
    with walks_through_kernels():
        model = Node2Vec(ds.graph, walk_length=10, num_walks=80, p=0.25,
                         q=4, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model.train(embed_size=128, window_size=5, iter=3)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    emb = model.get_embeddings()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
    t4 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"Node2Vec path launches: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} never launched on the Node2Vec path")
    check_walk_launches("Node2Vec path", {"node2vec_walks": 1},
                        keep={"node2vec_walks": "node2vec_walks"})
    print(f"Node2Vec sampler: {model.sampler} (max out-degree "
          f"{ds.graph.max_degree}) [{card}]", flush=True)
    if model.sampler != "exact":
        fail(f"Node2Vec on Wiki chose {model.sampler!r}, not 'exact'")
    V = ds.graph.num_nodes
    table = model.embedding_table.clone()
    if tuple(table.shape) != (V, 128) or not torch.isfinite(table).all():
        fail(f"Node2Vec embeddings: shape {tuple(table.shape)} or "
             f"non-finite")
    if len(emb) != V or not torch.isfinite(model.losses).all():
        fail("Node2Vec: embeddings missing or losses non-finite")
    edges = check_hops(model.walks, ds.graph, "Node2Vec corpus")
    # the constructor's walk is cold: it builds the graph's views on the
    # card on its way. The share compares warm walks, from the model's
    # seed over the views now built, with warm trains on those walks.

    def walk():
        gen = torch.Generator(device=dev).manual_seed(model.seed)
        return simulate_walks(ds.graph, 80, 10, generator=gen,
                              kind="node2vec", p=0.25, q=4.0,
                              sampler=model.sampler)

    def train():
        model.train(embed_size=128, window_size=5, iter=3)

    walks, walk_s = min((timed_walks(walk) for _ in range(2)),
                        key=lambda r: r[1])
    if not torch.equal(walks, model.walks):
        fail("Node2Vec: a walk from the model's seed differs from its own")
    train_s = min(timed_walks(train)[1] for _ in range(2))
    retrain_diff = float((model.embedding_table - table).abs().max())
    print(f"Node2Vec path: dataset {t1 - t0:.3f} s, constructor (views "
          f"and walks, cold) {t2 - t1:.4f} s, train {t3 - t2:.4f} s, "
          f"classify {t4 - t3:.3f} s; final loss "
          f"{float(model.losses[-1]):.4f}; a warm train's table against "
          f"the first: max abs diff {retrain_diff:.3e}", flush=True)
    print(f"Node2Vec walks (warm): {walk_s:.4f} s, {edges / walk_s:.4e} "
          f"walked edges/s ({edges} edges) [{card}]")
    print(f"Node2Vec train (warm): {train_s:.4f} s, "
          f"{model.trained_pairs / train_s:.4e} trained pairs/s "
          f"({model.trained_pairs:.0f} pairs) [{card}]")
    print(f"Node2Vec walks' share of walk + train, warm: "
          f"{walk_s / (walk_s + train_s):.4f} [{card}]")
    print(f"Node2Vec micro-F1: {res['micro']:.4f}, macro-F1: "
          f"{res['macro']:.4f} [{card}]", flush=True)
    if not res["micro"] >= N2V_MIN_MICRO_F1:
        fail(f"Node2Vec micro-F1 {res['micro']:.4f} < {N2V_MIN_MICRO_F1}")

    # 12. the walk modes on the Wiki graph: cold, on a fresh copy of the
    # graph whose views are not built yet, then two warm runs from one
    # seed that must agree bit for bit
    modes = [("node2vec", "exact"), ("node2vec", "rejection_dense"),
             ("node2vec", "rejection"), ("weighted", None)]
    for kind, sampler in modes:
        g = Graph(*ds.graph.edges(), num_nodes=V)

        def run():
            gen = torch.Generator(device=dev).manual_seed(5)
            return simulate_walks(g, 80, 10, generator=gen, kind=kind,
                                  p=0.25, q=4.0, sampler=sampler)
        reset_walk_counts()
        with walks_through_kernels():
            _, cold = timed_walks(run)
        kernel = WALK_KERNEL_OF[sampler or kind]
        rec = WALK_RECORD_OF.get(sampler or kind)
        check_walk_launches(f"walks {kind}/{sampler or 'alias'}",
                            {kernel: 1}, keep=rec and {rec: kernel})
        a, s_a = timed_walks(run)
        b, s_b = timed_walks(run)
        if not torch.equal(a, b):
            fail(f"walks {kind}/{sampler}: two runs from one seed differ")
        edges = check_hops(a, g, f"walks {kind}/{sampler}")
        warm = min(s_a, s_b)
        print(f"walks {kind}/{sampler or 'alias'} on Wiki [{a.shape[0]}, "
              f"{a.shape[1]}]: every hop an edge, bit-identical from one "
              f"seed; cold {cold:.4f} s, warm {warm:.4f} s, "
              f"{edges / warm:.4e} walked edges/s; {busy_text(run)} "
              f"[{card}]", flush=True)

    # exact against dense rejection where the JAX package's rule sends a
    # graph to rejection (a TPU crossover, not re-measured here)
    V, d = 20_000, 512
    rng = np.random.default_rng(0)
    g = Graph(np.repeat(np.arange(V, dtype=np.int64), d),
              rng.integers(0, V, V * d), num_nodes=V)
    for sampler in ("exact", "rejection_dense"):
        def run():
            gen = torch.Generator(device=dev).manual_seed(7)
            return simulate_walks(g, 1, 10, generator=gen, kind="node2vec",
                                  p=0.25, q=4.0, sampler=sampler)
        reset_walk_counts()
        with walks_through_kernels():
            _, cold = timed_walks(run)
        check_walk_launches(f"{d}-regular {sampler}",
                            {WALK_KERNEL_OF[sampler]: 1})
        walks, warm = min((timed_walks(run) for _ in range(2)),
                          key=lambda r: r[1])
        edges = check_hops(walks, g, f"{d}-regular {sampler}")
        print(f"walks node2vec/{sampler} on a {d}-out-regular graph of {V} "
              f"nodes [{walks.shape[0]}, {walks.shape[1]}]: cold "
              f"{cold:.4f} s, warm {warm:.4f} s, {edges / warm:.4e} walked "
              f"edges/s; {busy_text(run)} [{card}]", flush=True)


# ---- the walk kernels (K6-K9, csrc/walk.cu) ----------------------------

WALK_SOURCE = "graphembedding_tpu_torch/csrc/walk.cu"
# what each walk kernel replaces: an XLA `lax.scan` of the JAX package
# (no pallas_call)
WALK_REPLACES = {
    "uniform_walks": "graphembedding_tpu/ops/walk.py:84",
    "weighted_walks": "graphembedding_tpu/ops/walk.py:111",
    "node2vec_walks": "graphembedding_tpu/ops/walk.py:141",
    "node2vec_walks_rejection": "graphembedding_tpu/ops/walk.py:248",
    "multilayer_walks": "graphembedding_tpu/models/struc2vec.py:485",
}
# the walk kernel that each kind or (p,q) sampler of simulate_walks runs
WALK_KERNEL_OF = {"uniform": "uniform_walks", "weighted": "weighted_walks",
                  "exact": "node2vec_walks",
                  "rejection_dense": "node2vec_walks_rejection",
                  "rejection": "node2vec_walks_rejection"}
# the kernels-line record whose launches phase 12's walk mode on Wiki gives
# (the exact sampler's record takes phase 11's Node2Vec model instead)
WALK_RECORD_OF = {"weighted": "weighted_walks",
                  "rejection_dense": "node2vec_walks_rejection[dense]",
                  "rejection": "node2vec_walks_rejection[csr]"}
# K7's hops that may differ from its plain version on shared draws: a
# score's last bit (logf in the kernel and in torch.log) can flip an
# argmax between two columns whose scores nearly tie
EXACT_MAX_DIFF_SHARE = 1e-5
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def walk_counts():
    """The wrappers of the walk kernels K6-K9 by name."""
    from graphembedding_tpu_torch.models import struc2vec as s2v
    from graphembedding_tpu_torch.ops import walk

    return {**walk.walk_kernels(), "multilayer_walks": s2v.multilayer_walks}


def reset_walk_counts():
    for k in walk_counts().values():
        k.launches = 0


# the launches of each walk kernel record on its main path: record name ->
# (count, path), kept by `check_walk_launches` and written into the
# kernels line by `walk_path_launches`
PATH_WALK_LAUNCHES = {}


def check_walk_launches(what, want, keep=None):
    """Fails unless the walk kernels launched `want` times each (any other
    never) since `reset_walk_counts`; prints the counts. `keep` maps a
    kernels-line record to the kernel whose count it takes from this
    path."""
    got = {name: k.launches for name, k in walk_counts().items()}
    print(f"{what} walk kernel launches: {got}", flush=True)
    if got != {name: want.get(name, 0) for name in got}:
        fail(f"{what}: walk kernel launches {got}, want {want}")
    for rec, kernel in (keep or {}).items():
        PATH_WALK_LAUNCHES[rec] = (got[kernel], what)


# the walk kernel records that no main path runs: simulate_walks always
# passes the weight sums, so its rejection walk is the envelope form
OFF_PATH_WALKS = {"node2vec_walks_rejection[bound]"}


def walk_path_launches(records):
    """Each walk kernel record's `launches`: its main path's count; 0 for
    a form that no main path runs (`OFF_PATH_WALKS`)."""
    for r in records:
        if r["source"] != WALK_SOURCE:
            continue
        name = r["name"]
        if name in OFF_PATH_WALKS:
            r["launches"] = 0
            print(f"kernel {name}: 0 launches, no main path runs this form "
                  f"(simulate_walks passes the weight sums: the envelope)",
                  flush=True)
            continue
        if name not in PATH_WALK_LAUNCHES:
            fail(f"kernel {name}: no main path counted its launches")
        r["launches"], what = PATH_WALK_LAUNCHES[name]
        print(f"kernel {name}: {r['launches']} launches on the {what}",
              flush=True)


PLAIN_WALKS = (("ops.walk", "uniform_walks_plain"),
               ("ops.walk", "weighted_walks_plain"),
               ("ops.walk", "node2vec_walks_plain"),
               ("ops.walk", "node2vec_walks_rejection_plain"),
               ("models.struc2vec", "multilayer_walks_plain"))


@contextlib.contextmanager
def walks_through_kernels():
    """Inside, a plain walk given a CUDA tensor fails the run: every walk
    path on the card must reach its kernel."""
    import importlib

    import torch

    saved = []
    for mod_name, name in PLAIN_WALKS:
        mod = importlib.import_module(f"graphembedding_tpu_torch.{mod_name}")
        fn = getattr(mod, name)

        def guard(*args, _fn=fn, _name=name, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kw.values())):
                fail(f"{_name} ran on CUDA tensors: a walk path on the card "
                     f"skipped its kernel")
            return _fn(*args, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, guard)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def hop_latency_ms(dev, g):
    """Device ms of one hop of one walker's chain of dependent reads: K6
    with a single walker on g (no vertex without out-edges, so it never
    stops) for 1,001 hops against 1 (CUDA events, medians), the difference
    over 1,000. A walk of L can take no less than (L - 1) of these, however
    many walkers run beside it."""
    import torch

    from graphembedding_tpu_torch.benchmarks.common import median_ms
    from graphembedding_tpu_torch.ops.walk import uniform_walks

    dg = g.to(dev)
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(length):
        return median_ms(lambda: uniform_walks(
            dg.row_ptr, dg.col_idx, dg.degree, one, length=length,
            generator=gen))
    return (run(1001) - run(1)) / 1000


def visited_rows_work(walks, row_bytes, entry_bytes, entries):
    """What a walk corpus needs of a graph's tables: `bytes`, each row that
    a hop leaves read once, `row_bytes` a row plus `entry_bytes` for each
    of its `entries` (int [V]: the real ones, no padding); the hops that
    moved (`hops`, `first_hops` of them the first); and the candidates a
    row-scoring kernel weighs, `entries` summed over the vertices the
    first hop (`first`) and the later ones (`rest`) leave."""
    import torch

    cur = walks[:, :-1].long()
    live = cur >= 0
    deg = torch.where(live, entries.long()[cur.clamp(min=0)], 0)
    visited = cur[live].unique()
    return dict(bytes=(visited.numel() * row_bytes
                       + int(entries[visited].long().sum()) * entry_bytes),
                hops=int(walks[:, 1:].ge(0).sum()),
                first_hops=int(walks[:, 1].ge(0).sum()),
                first=int(deg[:, 0].sum()), rest=int(deg[:, 1:].sum()))


def walk_kernel_case(name, kernel, plain, shapes, check, work, dev, card,
                     records, record, chain_ms, max_diff_share=0.0,
                     timing=(3, 2)):
    """One walk kernel at one shape: its corpus on shared draws against the
    plain version's (torch.equal, or at most max_diff_share of the hops
    differing, counted and explained), one launch a corpus from a seed,
    two runs from one seed bit-identical, `check` (every hop an edge) on
    the kernel's corpus, device ms in turns with the plain version, and
    the record (bound: the bytes `work(corpus)` reads plus the corpus
    written, or its operations at the float32 peak, whichever is larger,
    from the kernel's Philox corpus; `chain_ms` beside it). The record's
    launches are its main path's (`walk_path_launches`)."""
    import torch

    from graphembedding_tpu_torch.benchmarks.common import turns_ms
    from graphembedding_tpu_torch.ops import walk

    kern = walk_counts()[name.split("[")[0]]
    gen = torch.Generator(device=dev).manual_seed(11)
    draws = walk.record_draws(shapes, gen)
    got, want = kernel(draws=draws), plain(draws=draws)
    torch.cuda.synchronize()
    del draws
    hops = got[:, 1:].numel()
    diff = int((got[:, 1:] != want[:, 1:]).sum())
    err = float((got.long() - want.long()).abs().max()) if diff else 0.0
    note = "torch.equal to the plain version on shared draws"
    if diff:
        rows = int((got != want).any(1).sum())
        note = (f"{diff} of {hops} hops ({diff / hops:.2e}) in {rows} "
                f"walks differ from the plain version on shared draws: the "
                f"first differing hop of a walk is a Gumbel argmax between "
                f"scores that tie to the last bit (logf in the kernel and in "
                f"torch.log), the rest of the walk follows it")
        if diff > max_diff_share * hops:
            fail(f"{name}: {note}; at most {max_diff_share} allowed")
    del want
    kern.launches = 0
    a = kernel(generator=torch.Generator(device=dev).manual_seed(12))
    launches = kern.launches
    b = kernel(generator=torch.Generator(device=dev).manual_seed(12))
    torch.cuda.synchronize()
    if launches != 1:
        fail(f"{name}: {launches} launches for one corpus, want 1")
    if not torch.equal(a, b):
        fail(f"{name}: two runs from one seed differ")
    checked = check(a, name)
    g1 = torch.Generator(device=dev).manual_seed(13)
    g2 = torch.Generator(device=dev).manual_seed(13)
    ms, plain_ms = turns_ms(lambda: kernel(generator=g1),
                            lambda: plain(generator=g2), rounds=timing[0],
                            reps=timing[1])
    in_bytes, ops = work(a)
    byte_ms = (in_bytes + nbytes(a)) / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_FLOP_PER_S * 1e3
    bound = max(byte_ms, op_ms)
    record(name, WALK_SOURCE, WALK_REPLACES[name.split("[")[0]], err, ms,
           plain_ms, bound, None,
           "operations" if op_ms > byte_ms else "bytes")
    records[-1].update(chain_ms=chain_ms)
    print(f"  {name} [{a.shape[0]}, {a.shape[1]}]: {note}; one launch a "
          f"corpus; bit-identical from one seed; {checked}; {ms:.4f} ms "
          f"against plain {plain_ms:.4f} ms in turns ({plain_ms / ms:.1f}x), "
          f"bound {bound:.4f} ms (bytes {byte_ms:.4f} of {in_bytes} B "
          f"read, operations {op_ms:.4f} of {ops}), chain of "
          f"{a.shape[1] - 1} hops {chain_ms:.4f} ms, so "
          f"{max(bound, chain_ms) / ms:.2%} of the larger "
          f"({'chain' if chain_ms > bound else 'bound'}); "
          f"{int(a[:, 1:].ge(0).sum()) / ms * 1e3:.4e} walked edges/s "
          f"[{card}]", flush=True)
    return a


def walk_law(name, kernel_on, dev):
    """The third hop from 0 through 1 on the weighted triangle with a tail
    (kernel_on(graph, starts, length) -> corpus), from Philox draws:
    returns (freq of 0, freq of 2, walkers through 1)."""
    import torch

    from graphembedding_tpu_torch import Graph

    unweighted = name == "node2vec_walks_rejection[dense]"
    w = None if unweighted else np.array([3.0, 1.0, 2.0, 0.5], np.float32)
    g = Graph(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]), w,
              directed=False)
    starts = torch.zeros(30000, dtype=torch.int64, device=dev)
    walks = kernel_on(g, starts, 3).cpu().numpy()
    sel = walks[(walks[:, 0] == 0) & (walks[:, 1] == 1)]
    freq = np.bincount(sel[:, 2], minlength=4)[[0, 2]] / max(len(sel), 1)
    return freq, len(sel)


def walk_kernel_phase(dev, card, records, record):
    """Phase 33: the walk kernels K6-K9 at the main paths' shapes (module
    docstring)."""
    import torch

    from graphembedding_tpu_torch import Graph
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.models import struc2vec as s2v
    from graphembedding_tpu_torch.ops import walk

    ds = load_dataset("wiki")
    g, V, L, p, q = ds.graph, ds.graph.num_nodes, 10, 0.25, 4.0
    src, dst, _ = g.edges()
    dead = np.flatnonzero(g.degree == 0)
    loops = Graph(np.concatenate([src, dead]), np.concatenate([dst, dead]),
                  num_nodes=V)
    hop_ms = hop_latency_ms(dev, loops)
    chain_ms = (L - 1) * hop_ms
    print(f"walk kernels: one hop of one walker's dependent chain "
          f"{hop_ms * 1e3:.3f} us on Wiki (K6, 1,001 hops against 1), so a "
          f"walk of {L} takes at least {chain_ms:.4f} ms [{card}]",
          flush=True)
    dg = g.to(dev)
    B = 80 * V
    starts = torch.arange(V, dtype=torch.int64, device=dev).repeat(80)
    accept, alias = g.alias_tables(dev)
    nbr, nbr_w = g.neighbor_matrix(dev)
    wsum = g.weight_sums(dev)
    D = nbr.shape[1]
    csr = (dg.row_ptr, dg.col_idx, dg.degree)

    def edges_of(w, what):
        return f"{check_hops(w, g, what)} hops, every one an edge"

    def case(name, fn, plain_fn, shapes, work, **kw):
        walk_kernel_case(
            name, functools.partial(fn, length=L),
            functools.partial(plain_fn, length=L), shapes, edges_of,
            work, dev, card, records, record, chain_ms, **kw)

    def rows_read(row_bytes, entry_bytes, entries, ops):
        """work(corpus): the rows it leaves read whole (whatever share of
        a row its hops draw) and the starts; ops(visited_rows_work)."""
        def work(a):
            w = visited_rows_work(a, row_bytes, entry_bytes, entries)
            return w["bytes"] + nbytes(starts), ops(w)
        return work

    print(f"walk kernels on Wiki (V={V}, E={g.num_edges}, max degree {D}), "
          f"{B} walkers of {L}, p={p}, q={q}:", flush=True)
    # a row: row_ptr and degree; an entry: col_idx (and accept, alias)
    case("uniform_walks",
         functools.partial(walk.uniform_walks, *csr, starts),
         functools.partial(walk.uniform_walks_plain, *csr, starts),
         walk.uniform_draw_shapes(B, L),
         rows_read(12, 4, dg.degree, lambda w: w["hops"]), timing=(10, 5))
    case("weighted_walks",
         functools.partial(walk.weighted_walks, *csr, accept, alias, starts),
         functools.partial(walk.weighted_walks_plain, *csr, accept, alias,
                           starts),
         walk.weighted_draw_shapes(B, L),
         rows_read(12, 12, dg.degree, lambda w: 2 * w["hops"]),
         timing=(10, 5))
    # only the real columns of cur's padded row: degree, each id and
    # weight; per candidate the factor (not on the first hop), three
    # logarithms, an add and a compare
    case("node2vec_walks",
         functools.partial(walk.node2vec_walks, dg.degree, nbr, nbr_w,
                           starts, p, q),
         functools.partial(walk.node2vec_walks_plain, dg.degree, nbr, nbr_w,
                           starts, p, q),
         walk.node2vec_draw_shapes(B, L, D),
         rows_read(4, 8, nbr.ge(0).sum(1),
                   lambda w: 5 * w["first"] + 6 * w["rest"]),
         max_diff_share=EXACT_MAX_DIFF_SHARE)
    ids = g.neighbor_ids(dev)
    # a row: row_ptr, degree (and the envelope's wsum); an entry: col_idx,
    # accept, alias (the dense form's slots come from its resident ids,
    # the first hop's alias draw left out) and the envelope's edge_weight
    for form, kw, row_bytes, entry_bytes in (
            ("csr", dict(edge_weight=dg.edge_weight, wsum=wsum), 16, 16),
            ("dense", dict(edge_weight=dg.edge_weight, wsum=wsum, nbr=ids,
                           uniform_rows=True), 16, 12),
            ("bound", dict(envelope=False), 12, 12)):
        kw.update(max_degree=max(dg.max_degree, 1))
        args = (*csr, accept, alias, starts, p, q)
        # the first hop a weighted draw (slot and coin); every later hop
        # at least one proposal: its slot, coin and acceptance
        case(f"node2vec_walks_rejection[{form}]",
             functools.partial(walk.node2vec_walks_rejection, *args, **kw),
             functools.partial(walk.node2vec_walks_rejection_plain, *args,
                               **kw),
             walk.rejection_draw_shapes(B, L, p, q,
                                        envelope=form != "bound",
                                        row_slots=form == "dense"),
             rows_read(row_bytes, entry_bytes, dg.degree,
                       lambda w: 2 * w["first_hops"]
                       + 4 * (w["hops"] - w["first_hops"])))

    # K9 on flight-brazil's layers
    fl, layers = flight_layers()
    ly = s2v.layers_to(layers, dev)
    Vf = fl.graph.num_nodes
    K, E = ly["col_idx"].shape
    s_fl = torch.arange(Vf, dtype=torch.int32, device=dev).repeat(80)
    lay = (ly["row_ptr"], ly["col_idx"], ly["accept"], ly["alias"],
           ly["gamma"], s_fl)

    def multilayer(fn):
        return lambda generator=None, draws=None: fn(
            *lay, generator, 0.3, length=L, draws=draws)

    def layer_hops(w, what):
        stays = check_layer_hops(w, layers, what)
        return (f"{w[:, 1:].numel()} hops, every one a layer edge or a "
                f"stay ({stays} stays)")
    tables = s2v.layer_tables(ly["row_ptr"], ly["gamma"], E)
    print(f"walk kernels on flight-brazil's layers (V={Vf}, K={K}, "
          f"E_max={E}), {80 * Vf} walkers of {L}:", flush=True)
    # the layer tables whole: a corpus does not say which layer each hop
    # left from
    layer_bytes = nbytes(*tables, ly["col_idx"], ly["accept"], ly["alias"],
                         s_fl)
    walk_kernel_case(
        "multilayer_walks", multilayer(s2v.multilayer_walks),
        multilayer(s2v.multilayer_walks_plain),
        s2v.multilayer_draw_shapes(80 * Vf, L), layer_hops,
        lambda a: (layer_bytes, 4 * int(a[:, 1:].ge(0).sum())), dev, card,
        records, record, chain_ms)

    # the law of each kernel on the weighted triangle with a tail
    def on_graph(name):
        def run(tg, st, length):
            gen = torch.Generator(device=dev).manual_seed(4)
            tdg = tg.to(dev)
            c = (tdg.row_ptr, tdg.col_idx, tdg.degree)
            if name == "uniform_walks":
                return walk.uniform_walks(*c, st, length=length,
                                          generator=gen)
            if name == "weighted_walks":
                return walk.weighted_walks(*c, *tg.alias_tables(dev), st,
                                           length=length, generator=gen)
            if name == "node2vec_walks":
                return walk.node2vec_walks(tdg.degree,
                                           *tg.neighbor_matrix(dev), st, p,
                                           q, length=length, generator=gen)
            if name == "multilayer_walks":
                acc, ali = tg.host_alias()
                one = s2v.layers_to(dict(
                    row_ptr=tg.row_ptr[None], col_idx=tg.col_idx[None],
                    accept=acc[None], alias=ali[None],
                    gamma=np.zeros((1, tg.num_nodes), np.float32)), dev)
                return s2v.multilayer_walks(
                    one["row_ptr"], one["col_idx"], one["accept"],
                    one["alias"], one["gamma"], st, gen, 0.3,
                    length=length)
            form = name[len("node2vec_walks_rejection["):-1]
            kw = dict(max_degree=tdg.max_degree)
            if form != "bound":
                kw.update(edge_weight=tdg.edge_weight,
                          wsum=tg.weight_sums(dev))
            else:
                kw.update(envelope=False)
            if form == "dense":
                kw.update(nbr=tg.neighbor_ids(dev), uniform_rows=True)
            return walk.node2vec_walks_rejection(
                *c, *tg.alias_tables(dev), st, p, q, length=length,
                generator=gen, **kw)
        return run

    laws = []
    for r in records:
        name = r["name"]
        if r["source"] != WALK_SOURCE or name.endswith("M]"):
            continue
        freq, n = walk_law(name, on_graph(name), dev)
        target = {"uniform_walks": [1.0, 1.0],
                  "weighted_walks": [3.0, 1.0],
                  "multilayer_walks": [3.0, 1.0],
                  "node2vec_walks_rejection[dense]": [1.0 / p, 1.0]}.get(
                      name, [3.0 / p, 1.0])
        target = np.array(target) / sum(target)
        if n < 2000 or not np.allclose(freq, target, atol=0.03):
            fail(f"{name}: third hop from 0 through 1 {freq} over {n} "
                 f"walkers, want {target} (atol 0.03)")
        laws.append(f"{name} {freq[0]:.4f}/{freq[1]:.4f} (want "
                    f"{target[0]:.4f}/{target[1]:.4f}, {n} walkers)")
    print("walk kernels' third-hop law on the triangle with a tail, Philox "
          "draws, to 0 / to 2: " + "; ".join(laws), flush=True)


def hs_scatter_phase(call, V, C, ids, grads, dev, card, record):
    """Phase 13's check and times of one scatter of the HS step (the
    tokens' or the tree's, [N, C] into [V, C]): K4 bit-equal to the CPU
    plain version and to K2 and the same from run to run; K4 in turns with
    a bare index_add_ on the kept ids and with K2; appends its record."""
    import torch

    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.ops.rows import (
        scatter_add_rows, scatter_add_rows_plain, scatter_add_small,
        small_plan)

    kept = ids[(ids >= 0) & (ids < V)]
    runs = torch.bincount(kept.long(), minlength=V)
    plan = small_plan(ids.numel(), V)
    print(f"  {call} scatter [{ids.numel()}, {C}] into [{V}, {C}]: "
          f"{kept.numel()} kept ids, {int((runs > 0).sum())} rows, the "
          f"longest run {int(runs.max())}; K4's {plan} plan", flush=True)
    buf = torch.zeros((V, C), device=dev)
    k4 = scatter_add_small(buf.clone(), ids, grads)
    k2 = scatter_add_rows(buf.clone(), ids, grads)
    again = scatter_add_small(buf.clone(), ids, grads)
    want = scatter_add_rows_plain(buf.cpu(), ids.cpu(), grads.cpu())
    torch.cuda.synchronize()
    if not (torch.equal(k4.cpu(), want) and torch.equal(k4, k2)
            and torch.equal(k4, again)):
        fail(f"HS {call} scatter: K4 not bit-equal to the CPU plain "
             f"version and to K2, or not run-to-run identical")
    keep = (ids >= 0) & (ids < V)
    ids_in, grads_in = ids[keep].long(), grads[keep].contiguous()
    k4_ms, lib_ms = turns_ms(lambda: scatter_add_small(buf, ids, grads),
                             lambda: buf.index_add_(0, ids_in, grads_in))
    k4_again, k2_ms = turns_ms(
        lambda: scatter_add_small(buf, ids, grads),
        lambda: scatter_add_rows(buf, ids, grads))
    plain_ms = median_ms(lambda: scatter_add_rows_plain(buf, ids, grads))
    bound = rows_bound_ms(ids, V, C, None)
    print(f"  HS {call} scatter in turns: K4 {k4_ms:.4f} ms vs index_add_ "
          f"{lib_ms:.4f}; K4 {k4_again:.4f} vs K2 {k2_ms:.4f}; plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms [{card}]", flush=True)
    if k4_ms > lib_ms:
        print(f"  note: index_add_ beats K4 at the HS {call} scatter",
              flush=True)
    record(f"scatter_add_small[hs {call}]",
           "graphembedding_tpu_torch/csrc/scatter_small.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:315", 0.0, k4_ms,
           plain_ms, bound, lib_ms)


def tree_gather_ids(tok, points):
    """The tree gather of the HS step's plain products: each context's
    path ids, -1 levels and pads read as row 0, [G * PL * T] int32."""
    import torch

    tok_ok = tok >= 0
    pts = points[torch.where(tok_ok, tok, 0)]
    pts_ok = (pts >= 0) & tok_ok[:, :, None]
    return torch.where(pts_ok, pts, 0).reshape(-1).contiguous()


def hs_kernel_work(tok, eff, points, window_ok, dm, D):
    """(bytes, FLOPs, scored (pair, level) entries) of K10 on one block:
    d_yin and d_tree written once; the w_in rows of the pairs' centers,
    the w_tree rows of their contexts' paths, those paths' points and
    codes, and tok and eff read once; 6 D FLOPs (a dot product and two
    row updates) a scored entry."""
    import torch

    G, PL = tok.shape
    T = points.shape[1]
    tok_ok = tok >= 0
    safe = torch.where(tok_ok, tok, 0)
    mask = (window_ok[None] & (dm[None] <= eff[:, :, None])
            & tok_ok[:, :, None] & tok_ok[:, None, :])
    pts = points[safe]
    depth = ((pts >= 0) & tok_ok[:, :, None]).sum(2)  # [G, PL] contexts
    scored = int((mask * depth[:, None, :]).sum())
    ctx = mask.any(1)  # contexts with a pair
    centers = torch.unique(tok[mask.any(2)]).numel()
    live = pts[ctx]
    rows = torch.unique(live[live >= 0]).numel()
    paths = torch.unique(tok[ctx]).numel()
    nbytes = 4 * ((G * PL * T + G * PL) * D + (centers + rows) * D
                  + 2 * T * paths + 2 * G * PL)
    return nbytes, 6 * D * scored, scored


# phase 34's graphs: name, nodes and mean degree (the benchmark cells')
HS_KERNEL_GRAPHS = (("blogcatalog", 10_312, 65), ("youtube", 1_138_499, 5))


def hs_kernel_phase(dev, card, record, wiki_walks, wiki_V,
                    graphs=HS_KERNEL_GRAPHS):
    """Phase 34: K10 at the DeepWalk hs=1 step on Wiki's corpus and on
    `graphs`, against its plain version, in turns with it, beside its
    bound and the plain version's three products."""
    import torch

    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.benchmarks.million import synthetic_graph
    from graphembedding_tpu_torch.ops.hs import (
        hs_block_grads, hs_block_grads_plain)
    from graphembedding_tpu_torch.ops.walk import simulate_walks
    from graphembedding_tpu_torch.train import hsoftmax as hs
    from graphembedding_tpu_torch.train import skipgram as sg
    from graphembedding_tpu_torch.utils.precision import f32_matmul

    D, L, W = 128, 10, 5
    gen = torch.Generator(device=dev).manual_seed(34)
    for name, V, degree in (("wiki", wiki_V, None), *graphs):
        if degree is None:
            walks = wiki_walks
        else:
            g = synthetic_graph(V, degree, seed=34, device=dev)
            walks = simulate_walks(g, 1, L, generator=gen)
            del g
        points, codes, T = hs.build_huffman(sg.corpus_counts(walks, V))
        points = torch.as_tensor(points, device=dev)
        codes = torch.as_tensor(codes, device=dev)
        geo = sg.block_geometry(walks.shape[0], L, 504, 1)
        pick = torch.randperm(walks.shape[0], generator=gen, device=dev)
        tok = walks[pick[:geo.Bw]].reshape(geo.G, geo.PL).contiguous()
        eff = sg.window_draws(gen, (geo.G, geo.PL), W)
        window_ok, dm = sg.window_geometry(L, geo.PL, W, dev)
        w_in = (torch.rand((V, D), generator=gen, device=dev) - 0.5) / D
        w_tree = torch.randn((V - 1, D), generator=gen, device=dev) * 0.05
        args = (w_in, w_tree, tok, eff, points, codes, window_ok, dm)
        before = hs_block_grads.launches
        got = hs_block_grads(*args)
        again = hs_block_grads(*args)
        if hs_block_grads.launches != before + 2:
            fail(f"K10 {name}: {hs_block_grads.launches - before} launches "
                 f"for 2 calls")
        with f32_matmul():
            want = hs_block_grads_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K10 {name}: not the same bits from run to run")
        err = max(max_err(a, b, HS_RTOL, HS_ATOL, f"K10 {name}: {what}")
                  for a, b, what in zip(got, want,
                                        ("d_yin", "d_tree", "loss")))
        # the plain version's three products at these shapes
        G, PL = tok.shape
        yin = torch.randn((G, PL, D), generator=gen, device=dev)
        ptv = torch.randn((G, PL * T, D), generator=gen, device=dev)
        gmat = torch.randn((G, PL, PL * T), generator=gen, device=dev)

        def products():
            torch.bmm(yin, ptv.transpose(1, 2))
            torch.bmm(gmat, ptv)
            torch.bmm(gmat.transpose(1, 2), yin)

        with f32_matmul():
            k_ms, plain_ms = turns_ms(lambda: hs_block_grads(*args),
                                      lambda: hs_block_grads_plain(*args))
            lib_ms = median_ms(products)
        nbytes, flops, scored = hs_kernel_work(tok, eff, points, window_ok,
                                               dm, D)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / FP32_FLOP_PER_S * 1e3
        bound = max(by_bytes, by_ops)
        print(f"K10 {name}: V={V} G={G} PL={PL} T={T} D={D}, {scored} "
              f"scored (pair, level) entries ({scored / (G * PL * PL * T):.4f}"
              f" of the dense grid), {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP; in turns K10 {k_ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms; three bmm {lib_ms:.4f} ms; bound "
              f"{bound:.4f} ms ({'bytes' if by_bytes >= by_ops else 'operations'}"
              f"; {100 * bound / k_ms:.1f}% of it) [{card}]", flush=True)
        record(f"hs_block_grads[hs step {name}]",
               "graphembedding_tpu_torch/csrc/hs.cu",
               "none (XLA einsums of graphembedding_tpu/train/hsoftmax.py)",
               err, k_ms, plain_ms, bound, lib_ms,
               "bytes" if by_bytes >= by_ops else "operations")
        del args, got, again, want, yin, ptv, gmat, w_in, w_tree
    torch.cuda.empty_cache()


def hs_phases(dev, card, records, record):
    """Phases 13-14: four HS steps against plain ones with the tree scatter
    and gather timed, then the DeepWalk hs=1 path; appends the HS-shape K3
    and K4 records with the path's launches."""
    import torch

    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.benchmarks.train_profile import (
        breakdown, device_events as profile_events)
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.ops.hs import hs_block_grads
    from graphembedding_tpu_torch.ops.rows import (
        gather_rows, gather_rows_plain, scatter_add_rows,
        scatter_add_rows_plain, scatter_add_small)
    from graphembedding_tpu_torch.ops.sgns import sgns_block_grads
    from graphembedding_tpu_torch.ops.walk import simulate_walks
    from graphembedding_tpu_torch.train import hsoftmax as hs
    from graphembedding_tpu_torch.train import skipgram as sg

    # 13. four HS steps at the DeepWalk hs=1 Wiki shapes
    ds = load_dataset("wiki")
    V, D, L, W = ds.graph.num_nodes, 128, 10, 5
    gen = torch.Generator(device=dev).manual_seed(13)
    walks = simulate_walks(ds.graph, 80, L, generator=gen)
    NW = walks.shape[0]
    bw = sg.fit_block_walks(NW, L, 504)
    geo = sg.block_geometry(NW, L, bw, 1)
    points, codes, T = hs.build_huffman(sg.corpus_counts(walks, V))
    points = torch.as_tensor(points, device=dev)
    codes = torch.as_tensor(codes, device=dev)
    w_in = (torch.rand((V, D), generator=gen, device=dev) - 0.5) / D
    w_tree = torch.randn((V - 1, D), generator=gen, device=dev) * 0.05
    eff = W - (torch.rand((4, geo.G, geo.PL), generator=gen, device=dev)
               * W).to(torch.int32).clamp(0, W - 1)
    print(f"HS shapes: V={V} NW={NW} Bw={geo.Bw} G={geo.G} PL={geo.PL} "
          f"T={T} D={D}: tokens {geo.G * geo.PL}, tree rows "
          f"{geo.G * geo.PL * T} a step", flush=True)
    for k in (hs_block_grads, gather_rows, scatter_add_small,
              scatter_add_rows):
        k.launches = 0
    outs = [hs.hs_block_chunk(w_in.clone(), w_tree.clone(), walks, points,
                              codes, eff, 0.025, 1e-4, 0, 1152.0,
                              block_walks=bw, window=W, ops=ops)
            for ops in (hs.KERNELS, hs.PLAIN)]
    torch.cuda.synchronize()
    print(f"  launches in the four kernel steps: K10 "
          f"{hs_block_grads.launches}, K3 {gather_rows.launches}, K4 "
          f"{scatter_add_small.launches}, K2 {scatter_add_rows.launches}",
          flush=True)
    if (hs_block_grads.launches, gather_rows.launches,
            scatter_add_small.launches, scatter_add_rows.launches) != (
                4, 0, 8, 0):
        fail("four HS steps: K10 should launch 4 times, K4 8, K3 and K2 "
             "never")
    errs = [max_err(a, b, HS_RTOL, HS_ATOL, f"four HS steps: {n}")
            for a, b, n in zip(outs[0], outs[1],
                               ("w_in", "w_tree", "loss"))]
    if not torch.equal(outs[0][3], outs[1][3]):
        fail("four HS steps: pair counts differ")
    print(f"HS step parity: 4 steps, max abs err {max(errs):.3e} (rtol "
          f"{HS_RTOL}, atol {HS_ATOL}); w_tree moved by "
          f"{float((outs[0][1] - w_tree).abs().max()):.3e}", flush=True)

    # the first step's scatters, as the step makes them, and the tree
    # gather of its plain version's products
    seen = {}

    def keep(name, fn):
        def wrapped(table, ids, *rest):
            seen.setdefault(name, []).append((table.shape, ids.clone(),
                                              *(r.clone() for r in rest)))
            return fn(table, ids, *rest)
        return wrapped

    window_ok, dm = sg.window_geometry(L, geo.PL, W, dev)
    tok = walks[:geo.Bw].reshape(geo.G, geo.PL)
    hs.hs_step(w_in.clone(), w_tree.clone(), tok, eff[0], points, codes,
               0.025, window_ok=window_ok, dm=dm, update_cap=8.0,
               ops=hs.PLAIN._replace(
                   scatter_add=keep("scatter", scatter_add_rows_plain)))
    g_ids = tree_gather_ids(tok, points)
    n_inner = seen["scatter"][1][0][0]
    for call, ((rows, C), s_ids, s_grads) in zip(("token", "tree"),
                                                 seen["scatter"]):
        hs_scatter_phase(call, rows, C, s_ids, s_grads, dev, card, record)

    w_tree_c = w_tree.contiguous()
    got = gather_rows(w_tree_c, g_ids)
    torch.cuda.synchronize()
    if not torch.equal(got, gather_rows_plain(w_tree_c, g_ids)):
        fail("HS tree gather: K3 differs from table[ids]")
    g_long = g_ids.long()
    k3_ms, sel_ms = turns_ms(lambda: gather_rows(w_tree_c, g_ids),
                             lambda: torch.index_select(w_tree_c, 0, g_long))
    g_bound = rows_bound_ms(g_ids, n_inner, D, g_ids.numel())
    record("gather_rows[hs tree]", "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:261", 0.0, k3_ms,
           median_ms(lambda: gather_rows_plain(w_tree_c, g_ids)), g_bound,
           sel_ms)
    print(f"  HS tree gather [{g_ids.numel()}, {D}] of [{n_inner}, {D}]: "
          f"{int(torch.unique(g_ids).numel())} distinct rows", flush=True)

    # 34. K10 at the DeepWalk hs=1 step's shapes
    hs_kernel_phase(dev, card, record, walks, V)

    # 14. the DeepWalk hs=1 path, counting launches
    kernels = (hs_block_grads, gather_rows, scatter_add_small,
               scatter_add_rows, sgns_block_grads)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = load_dataset("wiki")
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.train(embed_size=128, window_size=5, iter=3, hs=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    emb = model.get_embeddings()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
    t3 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"DeepWalk hs=1 path launches: {launches}", flush=True)
    steps = model.losses.shape[0]
    want = {"hs_block_grads": steps, "gather_rows": 0,
            "scatter_add_small": 2 * steps, "scatter_add_rows": 0,
            "sgns_block_grads": 0}
    if steps != 1152 or launches != want:
        fail(f"DeepWalk hs=1: {steps} steps and launches {launches}, want "
             f"1152 steps and {want}")
    for r in records:
        if "[hs " in r["name"]:
            r["launches"] = launches[r["name"].split("[")[0]]
    if tuple(model.w_out.shape) != (V - 1, 128):
        fail(f"DeepWalk hs=1: tree table {tuple(model.w_out.shape)}")
    table = model.embedding_table
    if tuple(table.shape) != (V, 128) or not torch.isfinite(table).all():
        fail(f"DeepWalk hs=1 embeddings: shape {tuple(table.shape)} or "
             f"non-finite")
    if len(emb) != V or not torch.isfinite(model.losses).all():
        fail("DeepWalk hs=1: embeddings missing or losses non-finite")
    train_s = t2 - t1
    print(f"DeepWalk hs=1 path: constructor {t1 - t0:.3f} s, train "
          f"{train_s:.4f} s ({steps} steps), classify {t3 - t2:.3f} s; "
          f"final loss {float(model.losses[-1]):.4f}", flush=True)
    print(f"DeepWalk hs=1 trained pairs/s: "
          f"{model.trained_pairs / train_s:.4e} ({model.trained_pairs:.0f} "
          f"pairs) [{card}]")

    def train():
        model.train(embed_size=128, window_size=5, iter=3, hs=1)

    warm_s = min(timed_walks(train)[1] for _ in range(2))
    prof = breakdown(profile_events(train), 6)
    print(f"DeepWalk hs=1 warm train {warm_s:.4f} s "
          f"({model.trained_pairs / warm_s:.4e} pairs/s); one warm train "
          f"under torch.profiler: device {prof['device_ms']:.2f} ms, busy "
          f"{prof['busy_ms']:.2f} ms in {prof['device_events']} device "
          f"events, busy share of the warm train "
          f"{prof['busy_ms'] / 1e3 / warm_s:.4f} [{card}]", flush=True)
    for k in prof["kernels"]:
        print(f"  {k['name'][:70]}: {k['calls']} calls, {k['ms']:.2f} ms "
              f"({k['share']:.3f})")
    print(f"DeepWalk hs=1 micro-F1: {res['micro']:.4f}, macro-F1: "
          f"{res['macro']:.4f} [{card}]", flush=True)
    if not res["micro"] >= HS_MIN_MICRO_F1:
        fail(f"DeepWalk hs=1 micro-F1 {res['micro']:.4f} < "
             f"{HS_MIN_MICRO_F1}")


def struc2vec_phase(dev, card):
    """Phase 15: Struc2Vec on flight-brazil through the model's entry
    points, its host stages and walk timed on their own."""
    import tempfile

    import torch

    from graphembedding_tpu_torch import Struc2Vec
    from graphembedding_tpu_torch.benchmarks.train_profile import (
        breakdown, device_events as profile_events)
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.models import struc2vec as s2v
    from graphembedding_tpu_torch.ops.hs import hs_block_grads
    from graphembedding_tpu_torch.ops.rows import (
        gather_rows, scatter_add_rows, scatter_add_small)
    from graphembedding_tpu_torch.ops.sgns import sgns_block_grads

    # the stages on their own: the context graph and the layer CSRs on the
    # host, then the walk on the card (its first run cold)
    ds = load_dataset("flight-brazil")
    V = ds.graph.num_nodes
    t0 = time.perf_counter()
    edges, K = s2v.build_context_graph(ds.graph, workers=4)
    t1 = time.perf_counter()
    layers = s2v.build_layer_csr(edges, V)
    t2 = time.perf_counter()
    e_max = layers["col_idx"].shape[1]
    print(f"Struc2Vec context graph of {ds.name} (V={V}, "
          f"{ds.graph.num_edges} directed edges): {t1 - t0:.4f} s, K={K} "
          f"layers of {[len(e[0]) for e in edges]} undirected edges; layer "
          f"CSR {t2 - t1:.4f} s, E_max={e_max} (host)", flush=True)
    ly = s2v.layers_to(layers, dev)
    starts = torch.arange(V, dtype=torch.int32, device=dev).repeat(80)

    def run():
        gen = torch.Generator(device=dev).manual_seed(0)
        return s2v.multilayer_walks(ly["row_ptr"], ly["col_idx"],
                                    ly["accept"], ly["alias"], ly["gamma"],
                                    starts, gen, 0.3, length=10)
    _, cold = timed_walks(run)
    warm = min(timed_walks(run)[1] for _ in range(2))

    # the main path, counting launches
    kernels = (hs_block_grads, gather_rows, scatter_add_small,
               scatter_add_rows, sgns_block_grads)
    with tempfile.TemporaryDirectory() as tmp, walks_through_kernels():
        for k in kernels:
            k.launches = 0
        reset_walk_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = load_dataset("flight-brazil")
        model = Struc2Vec(ds.graph, walk_length=10, num_walks=80, workers=4,
                          temp_path=tmp, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.train(embed_size=128, window_size=5, iter=5)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        emb = model.get_embeddings()
        res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
        t3 = time.perf_counter()
        launches = {k.__name__: k.launches for k in kernels}
        again = Struc2Vec(ds.graph, walk_length=10, num_walks=80, workers=4,
                          temp_path=tmp, reuse=True, device=dev)
        if not again.cache_hit or model.cache_hit:
            fail("Struc2Vec: the second model did not load the cache")
        if not torch.equal(again.walks, model.walks):
            fail("Struc2Vec: the cached context graph walks another corpus "
                 "from the same seed")
    print(f"Struc2Vec path launches: {launches}", flush=True)
    check_walk_launches("Struc2Vec path (two models)",
                        {"multilayer_walks": 2},
                        keep={"multilayer_walks": "multilayer_walks"})
    steps = model.losses.shape[0]
    want = {"hs_block_grads": steps, "gather_rows": 0,
            "scatter_add_small": 2 * steps, "scatter_add_rows": 0,
            "sgns_block_grads": 0}
    if steps != 320 or launches != want:
        fail(f"Struc2Vec: {steps} steps and launches {launches}, want 320 "
             f"HS steps and {want}")
    if tuple(model.w_out.shape) != (V - 1, 128):
        fail(f"Struc2Vec: hs='auto' did not train HS (w_out "
             f"{tuple(model.w_out.shape)})")
    table = model.embedding_table
    if tuple(table.shape) != (V, 128) or not torch.isfinite(table).all():
        fail(f"Struc2Vec embeddings: shape {tuple(table.shape)} or "
             f"non-finite")
    if len(emb) != V or not torch.isfinite(model.losses).all():
        fail("Struc2Vec: embeddings missing or losses non-finite")

    if tuple(model.walks.shape) != (80 * V, 10):
        fail(f"Struc2Vec corpus shape {tuple(model.walks.shape)}")
    stays = check_layer_hops(model.walks, layers, "Struc2Vec")
    events = device_events(lambda: model.simulate_walks())
    busy = ("not measured" if events is None else
            f"{len(events)} device events, busy "
            f"{sum(us for _, us in events) / 1e3:.4f} ms")
    # one launch of K9 and the few ops that build its tables and seed,
    # where the lockstep loop of torch ops ran some 6,460
    if events is not None and len(events) > 64:
        fail(f"Struc2Vec walk: {len(events)} device events, want a handful")
    print(f"Struc2Vec walks [{80 * V}, 10]: every hop a layer edge "
          f"({stays} stays); cold {cold:.4f} s, warm {warm:.4f} "
          f"s; one warm walk: {busy} [{card}]", flush=True)
    print(f"Struc2Vec path: constructor (context graph, layer CSR, walks) "
          f"{t1 - t0:.4f} s, train {t2 - t1:.4f} s ({steps} HS steps, "
          f"{model.trained_pairs / (t2 - t1):.4e} trained pairs/s), "
          f"classify {t3 - t2:.3f} s; final loss "
          f"{float(model.losses[-1]):.4f}; cache reused, same corpus "
          f"[{card}]", flush=True)
    print(f"Struc2Vec micro-F1: {res['micro']:.4f}, macro-F1: "
          f"{res['macro']:.4f} [{card}]", flush=True)

    def train():
        model.train(embed_size=128, window_size=5, iter=5)

    warm_s = min(timed_walks(train)[1] for _ in range(2))
    prof = breakdown(profile_events(train), 4)
    print(f"Struc2Vec warm train {warm_s:.4f} s; one warm train under "
          f"torch.profiler: device {prof['device_ms']:.2f} ms, busy "
          f"{prof['busy_ms']:.2f} ms in {prof['device_events']} device "
          f"events, busy share of the warm train "
          f"{prof['busy_ms'] / 1e3 / warm_s:.4f} [{card}]", flush=True)
    for k in prof["kernels"]:
        print(f"  {k['name'][:70]}: {k['calls']} calls, {k['ms']:.2f} ms "
              f"({k['share']:.3f})")
    if not res["micro"] >= S2V_MIN_MICRO_F1:
        fail(f"Struc2Vec micro-F1 {res['micro']:.4f} < {S2V_MIN_MICRO_F1}")


def no_kernel_launched(what, fn):
    """fn(), failing if it launched any of K1-K5 or K10."""
    from graphembedding_tpu_torch.ops.hs import hs_block_grads
    from graphembedding_tpu_torch.ops.rows import (
        dma_gather_rows, gather_rows, scatter_add_rows, scatter_add_small)
    from graphembedding_tpu_torch.ops.sgns import sgns_block_grads

    kernels = (sgns_block_grads, scatter_add_rows, gather_rows,
               scatter_add_small, dma_gather_rows, hs_block_grads)
    for k in kernels:
        k.launches = 0
    out = fn()
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    if launched:
        fail(f"{what} launched {launched}; it runs none of K1-K5, K10")
    return out


def profiled_text(fn, seconds, what="train"):
    """Device time and busy share of one call of fn (a `what`) that took
    `seconds` warm (torch.profiler)."""
    from graphembedding_tpu_torch.benchmarks.train_profile import (
        breakdown, device_events as profile_events)

    prof = breakdown(profile_events(fn), 3)
    heavy = "; ".join(f"{k['name'][:48]} {k['ms']:.2f} ms ({k['share']:.3f})"
                      for k in prof["kernels"])
    return (f"one warm {what} under torch.profiler: device "
            f"{prof['device_ms']:.2f} ms, busy {prof['busy_ms']:.2f} ms in "
            f"{prof['device_events']} device events, busy share "
            f"{prof['busy_ms'] / 1e3 / seconds:.4f}; heaviest: {heavy}")


def graphs_text(dev):
    """The chunk graphs held on dev: their count, capture seconds and the
    reserved memory with their pools."""
    import torch

    from graphembedding_tpu_torch.train import chunk_graph

    graphs = chunk_graph.held(dev)
    return (f"{len(graphs)} chunk graphs captured in "
            f"{sum(g.seconds for g in graphs):.4f} s, reserved "
            f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB with their "
            f"pools held")


def sdne_phases(dev, card):
    """Phases 16-18: SDNE steps on the card against the CPU, the three
    trainers on Wiki, and train_sparse at V = 100,000."""
    import torch

    from graphembedding_tpu_torch import SDNE
    from graphembedding_tpu_torch.data import load_dataset, synthetic_wiki
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.train import chunk_graph

    # 16. three steps of each trainer, card against CPU, from the same
    # initial parameters and permutation (the port draws both on the CPU)
    ds = load_dataset("wiki")
    V = ds.graph.num_nodes
    trains = {
        "full": lambda m, e: m.train(batch_size=3000, epochs=e),
        "minibatch": lambda m, e: m.train(batch_size=1024, epochs=e),
        "sparse": lambda m, e: m.train_sparse(epochs=e, row_chunk=512),
    }

    def three_steps(mode, device):
        """(initial parameters, parameters after three steps, losses), on
        the CPU."""
        m = SDNE(ds.graph, hidden_size=[256, 128], device=device)
        init = [p.detach().cpu().clone() for p in m.net.parameters()]
        trains[mode](m, 1 if mode == "minibatch" else 3)
        if m.losses.shape != (3,):
            fail(f"SDNE {mode}: {tuple(m.losses.shape)} losses, want 3")
        return init, [p.detach().cpu() for p in m.net.parameters()], \
            m.losses.cpu()

    for mode in trains:
        init, want, want_loss = three_steps(mode, "cpu")
        runs = no_kernel_launched(
            f"SDNE {mode} steps",
            lambda: [three_steps(mode, dev) for _ in range(2)])
        (init_c, got, loss), (_, again, loss_again) = runs
        if not (all(torch.equal(a, b) for a, b in zip(got, again))
                and torch.equal(loss, loss_again)):
            fail(f"SDNE {mode}: two runs on the card differ")
        if not all(torch.equal(a, b) for a, b in zip(init, init_c)):
            fail(f"SDNE {mode}: the card started from other parameters")
        loss_err = max_err(loss, want_loss, SDNE_LOSS_RTOL, 0.0,
                           f"SDNE {mode} losses, card against CPU")
        ratios = [float((a - b).norm() / (b - p0).norm())
                  for a, b, p0 in zip(got, want, init)]
        if not max(ratios) <= SDNE_UPDATE_RTOL:
            fail(f"SDNE {mode}: the card's updates differ from the CPU's by "
                 f"{ratios} (L2, relative)")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        print(f"SDNE {mode} parity: 3 steps on the card against the CPU: "
              f"losses max abs err {loss_err:.3e} (rtol {SDNE_LOSS_RTOL}); "
              f"updates' relative L2 error at most {max(ratios):.3e} "
              f"(bound {SDNE_UPDATE_RTOL}); parameters max abs err "
              f"{err:.3e}; two card runs bit-identical", flush=True)

    # 17. the three trainers on Wiki through the model's entry points
    for mode, train in trains.items():
        def path():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = SDNE(ds.graph, hidden_size=[256, 128], device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            train(model, 40)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = Classifier(model.get_embeddings()).split_train_evaluate(
                ds.X, ds.Y, 0.8, seed=0)
            return model, res, t1 - t0, t2 - t1

        chunk_graph.release(dev)  # the cold train captures
        model, res, init_s, cold_s = no_kernel_launched(f"SDNE {mode}", path)
        table = model.embedding_table
        n_loss = 3 * 40 if mode == "minibatch" else 40
        if (tuple(table.shape) != (V, 128) or not torch.isfinite(table).all()
                or model.losses.shape != (n_loss,)
                or not torch.isfinite(model.losses).all()):
            fail(f"SDNE {mode}: embeddings {tuple(table.shape)} or losses "
                 f"{tuple(model.losses.shape)} wrong or non-finite")
        if mode == "sparse" and not (model._A is None and model._L is None):
            fail("SDNE sparse: the dense A or L was built")
        # warm trains, their device time and busy share: phase 29, against
        # the step loop
        print(f"SDNE {mode} on Wiki: constructor {init_s:.4f} s, train 40 "
              f"epochs cold {cold_s:.4f} s ({V * 40 / cold_s:.4e} rows/s, "
              f"{graphs_text(dev)}); final loss "
              f"{float(model.losses[-1]):.4f} [{card}]", flush=True)
        print(f"SDNE {mode} micro-F1: {res['micro']:.4f}, macro-F1: "
              f"{res['macro']:.4f} [{card}]", flush=True)
        if not res["micro"] >= SDNE_MIN_MICRO_F1:
            fail(f"SDNE {mode} micro-F1 {res['micro']:.4f} < "
                 f"{SDNE_MIN_MICRO_F1}")

    # 18. train_sparse at V = 100,000: no [V, V], a bounded peak
    t0 = time.perf_counter()
    big = synthetic_wiki(num_nodes=100_000, avg_degree=10.0).graph
    t1 = time.perf_counter()
    chunk_graph.release(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = SDNE(big, hidden_size=[256, 128], device=dev)
    _, cold_s = timed_walks(lambda: no_kernel_launched(
        "SDNE sparse at 100k", lambda: model.train_sparse(epochs=2,
                                                          row_chunk=512)))
    _, warm_s = timed_walks(lambda: model.train_sparse(epochs=2,
                                                       row_chunk=512))
    peak = torch.cuda.max_memory_allocated()
    held = graphs_text(dev)
    if not (model._A is None and model._L is None):
        fail("SDNE sparse at 100k: the dense A or L was built")
    if model.losses.shape != (2,) or not torch.isfinite(model.losses).all():
        fail(f"SDNE sparse at 100k: losses {model.losses.tolist()}")
    nbr_width = big.neighbor_ids(dev).shape[1]
    losses = [round(x, 2) for x in model.losses.tolist()]
    # a train of another epoch count would capture another graph: the
    # profile is of the 2-epoch graph's replay
    _, again_s = timed_walks(lambda: model.train_sparse(epochs=2,
                                                        row_chunk=512))
    profiled = profiled_text(
        lambda: model.train_sparse(epochs=2, row_chunk=512), again_s,
        "2-epoch train")
    print(f"SDNE sparse at V={big.num_nodes} ({big.num_edges} edges, "
          f"neighbor matrix [{big.num_nodes}, {nbr_width}], "
          f"{-(-big.num_nodes // 512)} chunks of [512, {big.num_nodes}]): "
          f"graph {t1 - t0:.2f} s (host); 2 epochs cold {cold_s:.4f} s, "
          f"warm {warm_s:.4f} s = {warm_s / 2:.4f} s an epoch ({held}); "
          f"losses {losses}; A and L never built; peak allocated "
          f"{peak / 2**30:.3f} GiB (bound "
          f"{SDNE_SPARSE_MAX_BYTES / 2**30:.0f} GiB; a dense [V, V] is "
          f"{4 * big.num_nodes ** 2 / 1e9:.0f} GB); 2 epochs again "
          f"{again_s:.4f} s, {profiled} [{card}]",
          flush=True)
    if peak >= SDNE_SPARSE_MAX_BYTES:
        fail(f"SDNE sparse at 100k: peak {peak} bytes over the bound")
    chunk_graph.release(dev)  # their pools hold some GiB


def dense_phase(dev, card):
    """Phase 19: trainer='dense' for DeepWalk and LINE on Wiki."""
    import torch

    from graphembedding_tpu_torch import LINE, DeepWalk
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.train import chunk_graph

    ds = load_dataset("wiki")
    V = ds.graph.num_nodes
    cases = [
        ("DeepWalk", lambda: DeepWalk(ds.graph, walk_length=10,
                                      num_walks=80, device=dev),
         lambda m: m.train(embed_size=128, window_size=5, trainer="dense"),
         DENSE_DW_MIN_MICRO_F1),
        ("LINE", lambda: LINE(ds.graph, embedding_size=128, order="second",
                              device=dev),
         lambda m: m.train(trainer="dense"), DENSE_LINE_MIN_MICRO_F1),
    ]
    for name, make, train, gate in cases:
        def path():
            model = make()
            _, cold_s = timed_walks(lambda: train(model))
            return model, cold_s

        chunk_graph.release(dev)  # the cold train captures
        model, cold_s = no_kernel_launched(f"{name} dense", path)
        table = model.embedding_table.clone()
        if (tuple(table.shape) != (V, 128) or not torch.isfinite(table).all()
                or not torch.isfinite(model.losses).all()):
            fail(f"{name} dense: embeddings {tuple(table.shape)} or losses "
                 f"non-finite")
        res = Classifier(model.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8, seed=0)
        _, warm_s = timed_walks(lambda: train(model))
        if not torch.equal(model.embedding_table, table):
            fail(f"{name} dense: a second train gave other tables")
        # its device time and busy share: phase 29, against the step loop
        print(f"{name} trainer='dense' on Wiki (300 Adam steps): train cold "
              f"{cold_s:.4f} s ({graphs_text(dev)}), warm {warm_s:.4f} s, "
              f"bit-identical on a second train; final loss "
              f"{float(model.losses[-1]):.4f} [{card}]", flush=True)
        print(f"{name} dense micro-F1: {res['micro']:.4f}, macro-F1: "
              f"{res['macro']:.4f} [{card}]", flush=True)
        if not res["micro"] >= gate:
            fail(f"{name} dense micro-F1 {res['micro']:.4f} < {gate}")


class Interrupt(Exception):
    """Raised inside a train to cut it, as a lost machine would."""


def kernel_counts():
    """The wrappers of K1-K4 and K10 by name."""
    from graphembedding_tpu_torch.ops.hs import hs_block_grads
    from graphembedding_tpu_torch.ops.rows import (
        gather_rows, scatter_add_rows, scatter_add_small)
    from graphembedding_tpu_torch.ops.sgns import sgns_block_grads

    return {k.__name__: k for k in (sgns_block_grads, scatter_add_rows,
                                    gather_rows, scatter_add_small,
                                    hs_block_grads)}


def counted(fn):
    """(fn(), {kernel: launches in fn}) over K1-K4 and K10, counts set to 0
    first."""
    kernels = kernel_counts()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in kernels.items()}


def checkpoint_timer():
    """Wraps `utils.checkpoint`'s save and load (and SDNE's reference to
    the save) to record each call's seconds (lists "save" and "load");
    returns (times, undo)."""
    from graphembedding_tpu_torch.models import sdne as sdne_mod
    from graphembedding_tpu_torch.utils import checkpoint as ck

    times = {"save": [], "load": []}
    save, load = ck.save_state, ck.load_state

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    ck.save_state, ck.load_state = timed(save, "save"), timed(load, "load")
    sdne_mod.save_state = ck.save_state

    def undo():
        ck.save_state, ck.load_state = save, load
        sdne_mod.save_state = save
    return times, undo


def report_resumed(card, what, d, times, resumed_steps, launches,
                   extra=""):
    """Phase 20's line for a resumed train: its checkpoint's bytes, the
    saves' and the restore's seconds."""
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(d) for f in fs)
    print(f"{what}: resumed train bit-identical to the uninterrupted "
          f"one; {resumed_steps} steps resumed, launches {launches}; "
          f"checkpoint {nbytes} bytes, {len(times['save'])} saves "
          f"{min(times['save']):.4f}-{max(times['save']):.4f} s, "
          f"restore {times['load'][-1]:.4f} s{extra} [{card}]",
          flush=True)


def sdne_restart_phase(dev, card, ds, tmp):
    """Phase 20's SDNE trains on the Wiki dataset ds, checkpoints under
    tmp."""
    import torch

    from graphembedding_tpu_torch import SDNE
    from graphembedding_tpu_torch.models import sdne as sdne_mod

    report = functools.partial(report_resumed, card)
    # SDNE: 40 epochs, a checkpoint every 10, cut as the chunk of epochs
    # 11-20 starts (each chunk one CUDA graph); the chunks' graphs of the
    # train without checkpoints (40 steps) and with them (10) stay cached
    trains = {
        "full batch": (lambda m, **k: m.train(batch_size=3000, epochs=40,
                                              **k), 1),
        "minibatch": (lambda m, **k: m.train(batch_size=1024, epochs=40,
                                             **k), 3),
        "sparse": (lambda m, **k: m.train_sparse(epochs=40, row_chunk=512,
                                                 **k), 1),
    }
    chunk_fn = sdne_mod.adam_chunk

    def params(m):
        return [p.detach().clone() for p in m.net.parameters()]

    for mode, (train, per_epoch) in trains.items():
        def sdne_run():
            plain = SDNE(ds.graph, hidden_size=[256, 128], device=dev)
            train(plain)
            d = os.path.join(tmp, f"sdne_{mode.replace(' ', '_')}")
            cadence = SDNE(ds.graph, hidden_size=[256, 128], device=dev)
            train(cadence, checkpoint_dir=d + "_full", checkpoint_every=10)
            calls = []

            def cut_chunk(*a, **k):
                calls.append(1)
                if len(calls) == 2:
                    raise Interrupt
                return chunk_fn(*a, **k)

            times, undo = checkpoint_timer()
            sdne_mod.adam_chunk = cut_chunk
            try:
                train(SDNE(ds.graph, hidden_size=[256, 128], device=dev),
                      checkpoint_dir=d, checkpoint_every=10)
                fail(f"SDNE {mode}: the interrupt did not fire")
            except Interrupt:
                pass
            finally:
                sdne_mod.adam_chunk = chunk_fn
            m = SDNE(ds.graph, hidden_size=[256, 128], device=dev)
            train(m, checkpoint_dir=d, checkpoint_every=10)
            torch.cuda.synchronize()
            undo()
            return plain, cadence, m, d, times

        plain, cadence, m, d, times = no_kernel_launched(
            f"SDNE {mode} resume", sdne_run)
        got = params(m)
        if not (all(torch.equal(a, b) for a, b in zip(got, params(cadence)))
                and torch.equal(m.losses, cadence.losses[10 * per_epoch:])):
            fail(f"SDNE {mode}: the resumed train differs from the "
                 f"uninterrupted one with the same cadence")
        same_plain = all(torch.equal(a, b)
                         for a, b in zip(got, params(plain)))
        if not same_plain:
            fail(f"SDNE {mode}: the resumed train differs from the train "
                 f"without checkpoints")
        report(f"SDNE {mode} on Wiki cut as epochs 11-20 of 40 start (a "
               f"checkpoint every 10, resumed from epoch 10; "
               f"{graphs_text(dev)})", d, times,
               m.losses.shape[0],
               {k: 0 for k in kernel_counts()},
               "; also bit-identical to the train without checkpoints")



def restart_phases(dev, card):
    """Phases 20-21: interrupted and resumed trains bit-identical to
    uninterrupted ones, with the kernels launched for the steps that
    remained; the metrics lines."""
    import tempfile

    import torch

    from graphembedding_tpu_torch import LINE, DeepWalk
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.models import line as line_mod
    from graphembedding_tpu_torch.utils import checkpoint as ck
    from graphembedding_tpu_torch.utils.metrics import MetricsLogger

    class StopAt(MetricsLogger):
        def __init__(self, n, path=None):
            super().__init__(path, quiet=True)
            self.n, self.lines = n, []

        def log(self, **fields):
            super().log(**fields)
            self.lines.append((fields["kind"], fields["epoch"],
                               fields["step"]))
            if len(self.lines) == self.n:
                raise Interrupt

    ds = load_dataset("wiki")
    tmp = tempfile.mkdtemp(prefix="ge_ckpt_")
    report = functools.partial(report_resumed, card)

    # 20. DeepWalk SGNS (3 chunks, a checkpoint every chunk, cut after
    # chunk 2) and hs=1 (18 chunks, every 4, cut at chunk 7)
    walk_models = {}
    for hs, every, stop, per_step in ((0, 1, 2, {
            "sgns_block_grads": 1, "scatter_add_rows": 2, "gather_rows": 2,
            "scatter_add_small": 0, "hs_block_grads": 0}), (1, 4, 7, {
            "sgns_block_grads": 0, "scatter_add_rows": 0, "gather_rows": 0,
            "scatter_add_small": 2, "hs_block_grads": 1})):
        kw = dict(embed_size=128, window_size=5, iter=3, hs=hs)
        want = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
        want.train(**kw)
        walk_models[hs] = want
        d = os.path.join(tmp, f"deepwalk_hs{hs}")
        times, undo = checkpoint_timer()
        m = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
        try:
            m.train(checkpoint_dir=d, checkpoint_every=every,
                    metrics=StopAt(stop), **kw)
            fail(f"DeepWalk hs={hs}: the interrupt did not fire")
        except Interrupt:
            pass
        saved = ck.load_state(d)["step"]
        m = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
        _, launches = counted(lambda: m.train(
            checkpoint_dir=d, checkpoint_every=every, **kw))
        torch.cuda.synchronize()
        undo()
        steps = want.losses.shape[0] - saved
        if m.losses.shape[0] != steps or not (
                torch.equal(m.w_in, want.w_in)
                and torch.equal(m.w_out, want.w_out)):
            fail(f"DeepWalk hs={hs} resumed from step {saved}: "
                 f"{m.losses.shape[0]} steps, want {steps}, or tables "
                 f"differ from the uninterrupted train")
        expect = {k: n * steps for k, n in per_step.items()}
        if launches != expect:
            fail(f"DeepWalk hs={hs} resumed: launches {launches}, want "
                 f"{expect}")
        report(f"DeepWalk hs={hs} on Wiki cut after chunk {stop} (a "
               f"checkpoint every {every}, resumed from step {saved} of "
               f"{want.losses.shape[0]})", d, times, steps, launches)

    # LINE order 'all': 2 chunks an order, cut inside order 'second'
    B = 1024
    want = LINE(ds.graph, embedding_size=128, order="all", device=dev)
    want.train(batch_size=B, epochs=50)
    d = os.path.join(tmp, "line")
    chunk, calls = line_mod.line_train_chunk, []

    def cut(*a, **k):
        calls.append(1)
        if len(calls) == 4:
            raise Interrupt
        return chunk(*a, **k)

    times, undo = checkpoint_timer()
    line_mod.line_train_chunk = cut
    try:
        LINE(ds.graph, embedding_size=128, order="all", device=dev).train(
            batch_size=B, epochs=50, checkpoint_dir=d, checkpoint_every=1)
        fail("LINE: the interrupt did not fire")
    except Interrupt:
        pass
    finally:
        line_mod.line_train_chunk = chunk
    m = LINE(ds.graph, embedding_size=128, order="all", device=dev)
    _, launches = counted(lambda: m.train(
        batch_size=B, epochs=50, checkpoint_dir=d, checkpoint_every=1))
    torch.cuda.synchronize()
    undo()
    steps = m.losses.shape[0]
    expect = {"sgns_block_grads": 0, "scatter_add_rows": 0,
              "gather_rows": 2 * steps, "scatter_add_small": 2 * steps,
              "hs_block_grads": 0}
    if not (steps == line_mod.CHUNK_STEPS
            and torch.equal(m.embedding_table, want.embedding_table)
            and torch.equal(m.context_emb, want.context_emb)):
        fail(f"LINE resumed: {steps} steps, want {line_mod.CHUNK_STEPS}, "
             f"or tables differ from the uninterrupted train")
    if launches != expect:
        fail(f"LINE resumed: launches {launches}, want {expect}")
    report("LINE order 'all' on Wiki cut in order 'second''s chunk 2 (a "
           "checkpoint every chunk)", d, times, steps, launches)

    sdne_restart_phase(dev, card, ds, tmp)

    # 21. metrics: one line a chunk, no bit of the train moved
    for hs, n_lines in ((0, 3), (1, 18)):
        path = os.path.join(tmp, f"metrics_hs{hs}.jsonl")
        want = walk_models[hs]
        m = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
        with StopAt(None, path) as logger:
            m.train(embed_size=128, window_size=5, iter=3, hs=hs,
                    metrics=logger)
        recs = [json.loads(x) for x in open(path).read().splitlines()]
        chunks = 64 * np.arange(1, n_lines + 1)
        expect = [("hs_chunk" if hs else "sgns_chunk",
                   int(c - 1) // (64 * n_lines // 3), int(c))
                  for c in chunks]
        got = [(r["kind"], r["epoch"], r["step"]) for r in recs]
        if got != expect or not all(np.isfinite(r["loss"]) for r in recs):
            fail(f"metrics hs={hs}: lines {got}, want {expect}")
        if not (torch.equal(m.w_in, want.w_in)
                and torch.equal(m.w_out, want.w_out)):
            fail(f"metrics hs={hs}: the tables differ from a train without "
                 f"metrics")
        print(f"metrics hs={hs}: {len(recs)} JSONL lines (kind, epoch, step "
              f"as the JAX package logs them), last {recs[-1]}; tables "
              f"bit-identical to the train without metrics", flush=True)


def blogcatalog_phase(dev, card):
    """Phase 22: LINE on BlogCatalog through the example entry point, and
    the DeepWalk example as a module in a process of its own."""
    import torch

    from graphembedding_tpu_torch.examples import line_blogcatalog

    def run():
        torch.cuda.synchronize()
        return line_blogcatalog.main([])

    (model, res, train_s), launches = counted(run)
    print(f"LINE BlogCatalog path launches: {launches}", flush=True)
    if launches["sgns_block_grads"] or launches["scatter_add_rows"]:
        fail(f"LINE on BlogCatalog launched K1 or K2: {launches}")
    if not (launches["gather_rows"] and launches["scatter_add_small"]):
        fail(f"LINE on BlogCatalog: K3 or K4 never launched: {launches}")
    g = model.graph
    table = model.embedding_table
    if (tuple(table.shape) != (g.num_nodes, 256)
            or not torch.isfinite(table).all()
            or not torch.isfinite(model.losses).all()):
        fail(f"LINE on BlogCatalog: embeddings {tuple(table.shape)} or "
             f"losses non-finite")
    steps = model.sampled_edges // 1024
    print(f"LINE order 'all' on BlogCatalog (V={g.num_nodes}, "
          f"E={g.num_edges}): train {train_s:.4f} s ({steps} steps of "
          f"1024 edges over both orders), sampled edges/s "
          f"{model.sampled_edges / train_s:.4e} [{card}]", flush=True)
    print(f"LINE BlogCatalog micro-F1: {res['micro']:.4f}, macro-F1: "
          f"{res['macro']:.4f} (gate {BC_MIN_MICRO_F1}) [{card}]",
          flush=True)
    if not res["micro"] >= BC_MIN_MICRO_F1:
        fail(f"LINE BlogCatalog micro-F1 {res['micro']:.4f} < "
             f"{BC_MIN_MICRO_F1}")
    blogcatalog = (model, res, train_s, launches)

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "graphembedding_tpu_torch.examples."
         "deepwalk_wiki", "--json"], cwd=HERE, capture_output=True,
        text=True, timeout=600)
    if out.returncode != 0:
        fail(f"python -m ...examples.deepwalk_wiki failed: "
             f"{out.stderr[-2000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"python -m graphembedding_tpu_torch.examples.deepwalk_wiki "
          f"--json: {line} ({time.perf_counter() - t0:.1f} s with the "
          f"interpreter's start) [{card}]", flush=True)
    if line["device"] != "cuda" or not line["micro"] >= MIN_MICRO_F1:
        fail(f"deepwalk_wiki example: {line}")
    return blogcatalog


@contextlib.contextmanager
def step_loop():
    """The single-device trainers' chunks launched step by step on the card
    (the plain version of their CUDA graphs): no device type captures."""
    from graphembedding_tpu_torch.train import chunk_graph

    cuda = chunk_graph.CAPTURES.pop("cuda")
    try:
        yield
    finally:
        chunk_graph.CAPTURES["cuda"] = cuda


def graphs_against_loop(what, ds, build, train, tables_of, gate, want,
                        dev):
    """`train(build())` through the chunk graphs and through the step loop
    (`step_loop`), in turns in this process, each from an empty graph
    cache: tables torch.equal, micro-F1 equal and >= gate, K1-K4 launches
    equal and `want(steps)` (none of K1-K5 where that is all zeros). For
    each way its capture s, cold and warm train s (the faster of two), the
    device time and busy share of one warm train (torch.profiler), and
    peak allocated and reserved memory. Returns (result lines, the graph
    way's cold s, micro-F1, steps and launches)."""
    import torch

    from graphembedding_tpu_torch.benchmarks.train_profile import (
        breakdown, device_events as profile_events)
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.train import chunk_graph

    lines, ways = [], {}
    for way in ("loop", "graph"):
        chunk_graph.release()
        with step_loop() if way == "loop" else contextlib.nullcontext():
            model = build()
            kernel_free = not any(want(1).values())
            (_, cold), launches = counted(
                lambda: no_kernel_launched(what, lambda: timed_walks(
                    lambda: train(model))) if kernel_free
                else timed_walks(lambda: train(model)))
            tables = [t.detach().clone() for t in tables_of(model)]
            steps = model.losses.shape[0]
            finite = bool(torch.isfinite(model.losses).all()) and all(
                bool(torch.isfinite(t).all()) for t in tables)
            f1 = Classifier(model.get_embeddings()).split_train_evaluate(
                ds.X, ds.Y, 0.8, seed=0)["micro"]
            graphs = chunk_graph.held(dev)
            torch.cuda.reset_peak_memory_stats()
            warm = min(timed_walks(lambda: train(model))[1]
                       for _ in range(2))
            peak = torch.cuda.max_memory_allocated()
            reserved = torch.cuda.memory_reserved()
            prof = breakdown(profile_events(lambda: train(model)), 3)
        ways[way] = (tables, f1, launches, cold, steps)
        capture = (f"capture {sum(g.seconds for g in graphs):.4f} s "
                   f"({len(graphs)} graphs)" if graphs else "no capture")
        lines.append(
            f"{what}, {way}: {capture}; train cold {cold:.4f} s, warm "
            f"{warm:.4f} s; one warm train under torch.profiler: device "
            f"{prof['device_ms']:.2f} ms, busy {prof['busy_ms']:.2f} ms in "
            f"{prof['device_events']} device events, busy share "
            f"{prof['busy_ms'] / 1e3 / warm:.4f}; peak allocated "
            f"{peak / 2**20:.1f} MiB, reserved {reserved / 2**20:.1f} MiB "
            f"with the graph pools held; micro-F1 {f1:.4f}; {steps} "
            f"losses, launches {launches}")
        if not finite:
            fail(f"{what}, {way}: non-finite tables or losses")
        if launches != want(steps):
            fail(f"{what}, {way}: launches {launches}, want {want(steps)} "
                 f"({steps} steps)")
        if way == "graph" and not graphs:
            fail(f"{what}: no chunk graph captured")
    (t_loop, f_loop, n_loop, *_), (t_graph, f_graph, n_graph, cold, steps) \
        = ways["loop"], ways["graph"]
    if not all(torch.equal(a, b) for a, b in zip(t_loop, t_graph)):
        fail(f"{what}: the graphs' tables differ from the loop's")
    if f_loop != f_graph or not f_graph >= gate:
        fail(f"{what}: micro-F1 {f_graph} (graphs) against {f_loop} "
             f"(loop), gate {gate}")
    if n_loop != n_graph:
        fail(f"{what}: launches {n_graph} (graphs), {n_loop} (loop)")
    lines.append(f"{what}: graphs against loop: tables torch.equal, "
                 f"micro-F1 {f_graph:.4f} both (gate {gate}), launches "
                 f"equal")
    return lines, (cold, f_graph, steps, n_graph)


def chunk_graph_phase(dev, card, blogcatalog):
    """Phase 29: each single-device trainer's path as a CUDA graph a chunk
    and as the step loop, in turns in this run: tables torch.equal,
    micro-F1 equal, launches equal (and those of phases 5, 10, 14, 15);
    capture s, cold and warm train s, device time and busy share of a warm
    train, peak memory with the graph pools held. LINE 'all' on
    BlogCatalog: phase 22's train (graphs) against the loop."""
    import tempfile

    import torch

    from graphembedding_tpu_torch import LINE, SDNE, DeepWalk, Struc2Vec
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.examples import line_blogcatalog
    from graphembedding_tpu_torch.train import chunk_graph

    t_phase = time.perf_counter()
    wiki, flight = load_dataset("wiki"), load_dataset("flight-brazil")
    dw = DeepWalk(wiki.graph, walk_length=10, num_walks=80, device=dev)
    walk_tables = lambda m: (m.w_in, m.w_out)  # noqa: E731
    sgns_n = {"sgns_block_grads": 192, "scatter_add_rows": 384,
              "gather_rows": 384, "scatter_add_small": 0, "hs_block_grads": 0}
    with tempfile.TemporaryDirectory() as tmp:
        s2v = Struc2Vec(flight.graph, walk_length=10, num_walks=80,
                        workers=4, temp_path=tmp, device=dev)
    paths = [
        ("DeepWalk on Wiki", wiki, lambda: dw, lambda m: m.train(
            embed_size=128, window_size=5, iter=3), walk_tables,
         MIN_MICRO_F1, sgns_n),
        ("DeepWalk hs=1 on Wiki", wiki, lambda: dw, lambda m: m.train(
            embed_size=128, window_size=5, iter=3, hs=1), walk_tables,
         HS_MIN_MICRO_F1, {"sgns_block_grads": 0, "scatter_add_rows": 0,
                           "gather_rows": 0, "scatter_add_small": 2304,
                           "hs_block_grads": 1152}),
        ("Struc2Vec on flight-brazil", flight, lambda: s2v,
         lambda m: m.train(embed_size=128, window_size=5, iter=5),
         walk_tables, S2V_MIN_MICRO_F1,
         {"sgns_block_grads": 0, "scatter_add_rows": 0, "gather_rows": 0,
          "scatter_add_small": 640, "hs_block_grads": 320}),
        ("LINE on Wiki", wiki, lambda: LINE(wiki.graph, embedding_size=128,
                                            order="second", device=dev),
         lambda m: m.train(batch_size=1024, epochs=50),
         lambda m: (m.second_emb, m.context_emb), LINE_MIN_MICRO_F1,
         {"sgns_block_grads": 0, "scatter_add_rows": 0, "gather_rows": 2048,
          "scatter_add_small": 2048, "hs_block_grads": 0}),
    ]
    # SDNE and the dense trainer: none of K1-K5 (want_n None)
    sdne_params = lambda m: list(m.net.parameters())  # noqa: E731
    for mode, train in (
            ("full batch", lambda m: m.train(batch_size=3000, epochs=40)),
            ("minibatch", lambda m: m.train(batch_size=1024, epochs=40)),
            ("train_sparse", lambda m: m.train_sparse(epochs=40,
                                                      row_chunk=512))):
        paths.append((f"SDNE {mode} on Wiki", wiki,
                      lambda: SDNE(wiki.graph, hidden_size=[256, 128],
                                   device=dev), train, sdne_params,
                      SDNE_MIN_MICRO_F1, None))
    paths += [
        ("DeepWalk trainer='dense' on Wiki", wiki, lambda: dw,
         lambda m: m.train(embed_size=128, window_size=5, trainer="dense"),
         walk_tables, DENSE_DW_MIN_MICRO_F1, None),
        ("LINE trainer='dense' on Wiki", wiki,
         lambda: LINE(wiki.graph, embedding_size=128, order="second",
                      device=dev), lambda m: m.train(trainer="dense"),
         lambda m: (m.second_emb, m.context_emb), DENSE_LINE_MIN_MICRO_F1,
         None),
    ]
    zeros = dict.fromkeys(kernel_counts(), 0)
    for name, ds, build, train, tables_of, gate, want_n in paths:
        lines, _ = graphs_against_loop(
            name, ds, build, train, tables_of, gate,
            lambda steps, want_n=want_n: want_n or zeros, dev)
        for line in lines:
            print(line, f"[{card}]", flush=True)

    model, res, train_s, launches = blogcatalog
    chunk_graph.release()
    with step_loop():
        (m_loop, r_loop, s_loop), n_loop = counted(
            lambda: line_blogcatalog.main([]))
    if not (torch.equal(m_loop.embedding_table, model.embedding_table)
            and torch.equal(m_loop.context_emb, model.context_emb)
            and r_loop["micro"] == res["micro"] and n_loop == launches):
        fail(f"LINE on BlogCatalog: the loop's tables, micro-F1 "
             f"{r_loop['micro']} or launches {n_loop} differ from the "
             f"graphs' ({res['micro']}, {launches})")
    print(f"LINE order 'all' on BlogCatalog: graphs (phase 22) train "
          f"{train_s:.4f} s, loop {s_loop:.4f} s; tables torch.equal, "
          f"micro-F1 {res['micro']:.4f} both, launches {launches} both "
          f"[{card}]", flush=True)
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s", flush=True)


LARGE_V = 1_000_000  # phase 30: DeepWalk at a million nodes
# phase 30's sparse chunk through K1-K3 against the plain versions: phase
# 4's tolerance (the plain scatter on the card sums with atomics)
LARGE_V_TOL = (1e-4, 1e-6)
# the sparse-cap train's table against the dense-cap train's, from the same
# seed (the same initial table and draws): the forms add in another order,
# about 1e-7 a step (tests/test_torch_large_v.py), over 192 steps
LARGE_V_FORMS_TOL = (1e-3, 1e-5)


def check_cache_bound(dev, what):
    """Fails unless the chunk graphs held on dev fit the cache's budget
    (or one graph, larger than the budget, is held alone); returns a text
    of what is held."""
    from graphembedding_tpu_torch.train import chunk_graph

    graphs = chunk_graph.held(dev)
    nbytes = chunk_graph.held_bytes(dev)
    if nbytes > chunk_graph.BUDGET_BYTES and len(graphs) > 1:
        fail(f"{what}: {len(graphs)} chunk graphs hold {nbytes} bytes, over "
             f"the budget of {chunk_graph.BUDGET_BYTES}")
    return (f"{len(graphs)} chunk graphs held, {nbytes / 2**20:.1f} MiB of "
            f"the {chunk_graph.BUDGET_BYTES / 2**20:.0f} MiB budget")


def reserved_text():
    import torch

    return f"reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB"


def hops_on_device(walks, graph, dev, what):
    """Fails unless every hop of walks follows an edge of graph (a sorted
    search on the card); returns the hops."""
    import torch

    dg = graph.to(dev)
    V = graph.num_nodes
    src = torch.repeat_interleave(torch.arange(V, device=dev),
                                  dg.degree.long())
    keys = src * V + dg.col_idx.long()  # sorted: the CSR's order
    u, v = walks[:, :-1].reshape(-1).long(), walks[:, 1:].reshape(-1).long()
    hop = v >= 0
    q = u[hop] * V + v[hop]
    at = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    if not bool((keys[at] == q).all()):
        fail(f"{what}: a hop follows no edge of the graph")
    return int(q.numel())


def large_v_phase(dev, card, records, record):
    """Phase 30: DeepWalk's SGNS at V = 1,000,000, D = 128 on
    `benchmarks.million.synthetic_graph(1M, 10)`, 5 walks of 10 a node, one
    epoch: cap_mode 'auto' (the sparse cap here) cold and warm, then
    'dense' cold and warm, each through its chunk graphs; K1-K3 launched;
    a chunk of sparse-cap steps through the kernels against the plain
    versions and through its graph against the loop; K2 at the sparse
    step's token call against the CPU plain version, `index_add_` and its
    bound; the cache within its budget after every train (and the graphs
    of the earlier phases); `table_scale --nodes 1000000` and
    `pq_crossover --degrees 512` once each."""
    import torch

    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.benchmarks import (
        million, pq_crossover, table_scale)
    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.ops.rows import (
        scatter_add_rows, scatter_add_rows_plain)
    from graphembedding_tpu_torch.ops.walk import (
        simulate_walks, uniform_draw_shapes, uniform_walks,
        uniform_walks_plain)
    from graphembedding_tpu_torch.train import chunk_graph
    from graphembedding_tpu_torch.train import skipgram as sg

    t_phase = time.perf_counter()
    V, D, L, W = LARGE_V, 128, 10, 5
    print(f"large V: before: {check_cache_bound(dev, 'phases 1-29')}, "
          f"{reserved_text()}", flush=True)
    g, build_s = timed_walks(lambda: million.synthetic_graph(V, 10, seed=0,
                                                             device=dev))
    want_edges = 2 * (V + million.random_edge_count(V, 10))
    if g.num_edges != want_edges or g.num_nodes != V:
        fail(f"large V: {g.num_nodes} nodes, {g.num_edges} edge entries; "
             f"want {V}, {want_edges}")
    print(f"large V: synthetic_graph({V}, 10) built in {build_s:.4f} s: "
          f"{g.num_edges} directed entries, max degree {g.max_degree} "
          f"[{card}]", flush=True)

    # the main path: counts from 0 before the model walks and trains
    kernels = kernel_counts()
    for k in kernels.values():
        k.launches = 0
    reset_walk_counts()
    with walks_through_kernels():
        model, walk_cold = timed_walks(
            lambda: DeepWalk(g, walk_length=L, num_walks=5, device=dev))
    check_walk_launches("large V constructor", {"uniform_walks": 1},
                        keep={"uniform_walks[V=1M]": "uniform_walks"})

    def walk():
        gen = torch.Generator(device=dev).manual_seed(model.seed)
        return simulate_walks(g, 5, L, generator=gen)
    walks, walk_warm = min((timed_walks(walk) for _ in range(2)),
                           key=lambda r: r[1])
    if not torch.equal(walks, model.walks):
        fail("large V: a walk from the model's seed differs from its own")
    del walks
    hops = hops_on_device(model.walks, g, dev, "large V corpus")
    print(f"large V walks [{model.walks.shape[0]}, {L}]: every hop an edge; "
          f"cold {walk_cold:.4f} s ({hops / walk_cold:.4e} walked edges/s), "
          f"warm {walk_warm:.4f} s ({hops / walk_warm:.4e} walked edges/s) "
          f"[{card}]", flush=True)
    # K6 at this corpus against its plain version (phase 33's checks)
    dg = g.to(dev)
    csr = (dg.row_ptr, dg.col_idx, dg.degree)
    starts = torch.arange(V, dtype=torch.int64, device=dev).repeat(5)
    chain_ms = (L - 1) * hop_latency_ms(dev, g)
    walk_kernel_case(
        "uniform_walks[V=1M]",
        functools.partial(uniform_walks, *csr, starts, length=L),
        functools.partial(uniform_walks_plain, *csr, starts, length=L),
        uniform_draw_shapes(5 * V, L),
        lambda w, what: (f"{hops_on_device(w, g, dev, what)} hops, every "
                         f"one an edge"),
        lambda a: (visited_rows_work(a, 12, 4, dg.degree)["bytes"]
                   + nbytes(starts), int(a[:, 1:].ge(0).sum())),
        dev, card, records, record, chain_ms, timing=(5, 3))
    del dg, csr, starts
    g.free_device()

    def train(mode):
        model.train(embed_size=D, window_size=W, iter=1, cap_mode=mode)

    results, tables = {}, {}
    for mode in ("auto", "dense"):
        _, cold = timed_walks(lambda: train(mode))
        after_cold = reserved_text()
        if mode == "auto":
            launches = {name: k.launches for name, k in kernels.items()}
            print(f"large V main path launches: {launches}", flush=True)
            for name in ("sgns_block_grads", "scatter_add_rows",
                         "gather_rows"):
                if launches[name] == 0:
                    fail(f"kernel {name} never launched on the large-V path")
        warm = min(timed_walks(lambda: train(mode))[1] for _ in range(2))
        losses, pairs = model.losses, model.trained_pairs
        table = model.embedding_table
        if (tuple(table.shape) != (V, D) or not torch.isfinite(table).all()
                or not torch.isfinite(losses).all()):
            fail(f"large V {mode}: embeddings {tuple(table.shape)} or "
                 f"losses not finite")
        head, tail = float(losses[:20].mean()), float(losses[-20:].mean())
        if not tail < head:
            fail(f"large V {mode}: the loss did not fall ({head} -> {tail})")
        results[mode] = (cold, warm, pairs)
        tables[mode] = (model.w_in, model.w_out)
        form = ("sparse" if sg.sparse_cap_for(mode, V) else "dense")
        print(f"large V train cap_mode={mode!r} ({form} cap), "
              f"{losses.shape[0]} steps: cold {cold:.4f} s "
              f"({pairs / cold:.4e} pairs/s, {after_cold} after it), warm "
              f"{warm:.4f} s ({pairs / warm:.4e} trained pairs/s, "
              f"{pairs:.0f} pairs), loss {head:.6f} -> {tail:.6f}; "
              f"{reserved_text()} after it; "
              f"{check_cache_bound(dev, f'large V {mode}')} [{card}]",
              flush=True)
        print(f"  {profiled_text(lambda: train(mode), warm)} [{card}]",
              flush=True)
    k2_launches = launches["scatter_add_rows"]
    rtol, atol = LARGE_V_FORMS_TOL
    errs = [max_err(a, b, rtol, atol, f"large V: the sparse-cap train's "
                    f"{half} against the dense-cap train's")
            for a, b, half in zip(tables["auto"], tables["dense"],
                                  ("w_in", "w_out"))]
    moved = float(tables["auto"][1].abs().max())
    print(f"large V: the sparse-cap train's tables against the dense-cap "
          f"train's from the same seed: max abs err w_in {errs[0]:.3e}, "
          f"w_out {errs[1]:.3e} (rtol {rtol}, atol {atol}); w_out moved "
          f"from 0 to max |w| {moved:.3e} [{card}]", flush=True)
    if not moved > 0:
        fail("large V: the train left w_out at zero")
    del tables

    # a chunk of sparse-cap steps at V = 1M from the trained table: the
    # kernels (through the chunk's graph) against the plain versions, and
    # the graph against the loop of the same steps
    NW = model.walks.shape[0]
    cfg = sg.SkipGramConfig()
    bw = sg.plan_block_walks(NW, L, V, cfg)
    geo = sg.block_geometry(NW, L, bw, cfg.neg_share_packs)
    S, K = 4, cfg.k_shared
    gen = torch.Generator(device=dev).manual_seed(3)
    eff = sg.window_draws(gen, (S, geo.G, geo.PL), W)
    negs = torch.randint(0, V, (S, geo.G2, K), generator=gen, device=dev,
                         dtype=torch.int32)
    w0 = torch.cat([model.w_in, model.w_out], 1)
    kw = dict(block_walks=bw, window=W, negative=5,
              neg_share_packs=cfg.neg_share_packs, sparse_cap=True)

    def chunk(ops=sg.KERNELS):
        w = w0.clone()
        _, losses, pairs = sg.sgns_block_chunk_cat(
            w, model.walks, eff, negs, 0.025, 1e-4, 0, 155.0, ops=ops, **kw)
        torch.cuda.synchronize()
        return w, losses, pairs

    (a, la, pa), n_graph = counted(chunk)
    b, lb, pb = chunk(sg.PLAIN)
    rtol, atol = LARGE_V_TOL
    err = max_err(a, b, rtol, atol, "large V sparse chunk: table")
    max_err(la, lb, rtol, atol, "large V sparse chunk: loss")
    if not torch.equal(pa, pb):
        fail("large V sparse chunk: pair counts differ")
    del b
    with step_loop():
        (c, lc, pc), n_loop = counted(chunk)
    if not (torch.equal(a, c) and torch.equal(la, lc) and torch.equal(pa, pc)
            and n_graph == n_loop):
        fail(f"large V sparse chunk: the graph differs from the loop "
             f"(launches {n_graph} against {n_loop})")
    del a, c
    print(f"large V sparse chunk, {S} steps of Bw = {geo.Bw} (G = {geo.G}, "
          f"PL = {geo.PL}, G2 = {geo.G2}, K = {K}): kernels against plain "
          f"max abs err {err:.3e} (rtol {rtol}, atol {atol}); the graph "
          f"torch.equal to the loop, launches {n_graph} both [{card}]",
          flush=True)

    # K2 at the sparse step's token call: [G*PL, 2D] pre-scaled rows into
    # the [V, 2D] table (pads -1)
    seen = []

    def keep_call(table, ids, grads):
        seen.append((tuple(table.shape), ids.clone(), grads.clone()))
        return scatter_add_rows_plain(table, ids, grads)
    window_ok, dm = sg.window_geometry(L, geo.PL, W, dev)
    tok = sg.chunk_blocks(model.walks, 0, 1, geo)[0]
    sg.sgns_step(w0.clone(), tok, eff[0], negs[0], 0.025,
                 window_ok=window_ok, dm=dm, nsp=geo.nsp,
                 neg_w=float(np.float32(5) / np.float32(K)),
                 update_cap=8.0, sparse_cap=True,
                 ops=sg.PLAIN._replace(scatter_add=keep_call))
    (_, n_ids, n_w), ((_, C), ids, grads), (_, g_ids, _) = seen
    tab = torch.zeros((V, C), device=dev)
    got = scatter_add_rows(tab.clone(), ids, grads)
    want = scatter_add_rows_plain(tab.cpu(), ids.cpu(), grads.cpu())
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        fail("large V: K2 at the token call differs from the CPU plain "
             "version's sequential sum")
    del got, want
    keep = ids >= 0
    ids_in, grads_in = ids[keep].long(), grads[keep].contiguous()
    ms, lib_ms = turns_ms(lambda: scatter_add_rows(tab, ids, grads),
                          lambda: tab.index_add_(0, ids_in, grads_in))
    plain_ms = median_ms(lambda: scatter_add_rows_plain(tab, ids, grads))
    bound = rows_bound_ms(ids, V, C, None)
    occ = torch.zeros((V, 1), device=dev)
    occ_ms, occ_lib = turns_ms(
        lambda: scatter_add_rows(occ, n_ids, n_w),
        lambda: occ.index_add_(0, n_ids.long(), n_w))
    print(f"  K2 at the sparse step's calls: tokens [{ids.numel()}, {C}] "
          f"into [{V}, {C}] ({int(keep.sum())} kept, "
          f"{int(ids_in.unique().numel())} rows): bit-equal to the CPU plain "
          f"version; {ms:.4f} ms vs index_add_ {lib_ms:.4f} ms in turns, "
          f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms; negatives' "
          f"occupancy [{n_ids.numel()}, 1] into [{V}, 1]: {occ_ms:.4f} ms vs "
          f"index_add_ {occ_lib:.4f} ms; {k2_launches} K2 launches in the "
          f"auto train [{card}]", flush=True)
    record("scatter_add_rows[1M sparse tokens]",
           "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:67", 0.0, ms, plain_ms,
           bound, lib_ms)
    records[-1]["launches"] = k2_launches
    del tab, occ, seen, ids, grads, ids_in, grads_in, w0

    cold, warm, pairs = results["dense"]
    s_cold, s_warm, _ = results["auto"]
    print(f"large V: warm train sparse {s_warm:.4f} s against dense "
          f"{warm:.4f} s ({warm / s_warm:.2f}x) [{card}]", flush=True)
    del model
    print(f"large V: after the trains: {check_cache_bound(dev, 'large V')}, "
          f"{reserved_text()}", flush=True)
    chunk_graph.release(dev)
    print(f"large V: after chunk_graph.release(): {reserved_text()}",
          flush=True)

    # the harness modules, once each on the card
    rows = table_scale.main(["--nodes", str(V)])
    print(f"  table_scale: {check_cache_bound(dev, 'table_scale')}",
          flush=True)
    if [r["cap_mode"] for r in rows] != ["dense", "sparse"] or not all(
            r["pairs_per_s"] > 0 for r in rows):
        fail(f"table_scale: {rows}")
    rows = pq_crossover.main(["--degrees", "512"])
    if len(rows) != 1 or rows[0]["winner"] not in (
            "exact", "rejection", "rejection_dense"):
        fail(f"pq_crossover: {rows}")
    chunk_graph.release(dev)
    print(f"phase 30: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return g


# phase 31: the sparse form's parity tolerance of 4 steps
# (tests/test_torch_hs_sparse.py), for a chunk of sparse-cap HS steps
# through the kernels against the plain versions, a sparse chunk against a
# dense one, and the V = 1M sparse-cap train against the dense-cap train
# from the same seed (1 walk a node: a row is touched a few times a train;
# measured 0.12 of the bound)
LARGE_V_HS_TOL = (1e-4, 1e-6)


def hs_rows_phase(call, V, C, ids, grads, dev, card, record):
    """Phase 31's check and times of one K2 call of the sparse HS step at
    V = 1M (the tokens' or the tree's pre-scaled rows, [N, C] into a zero
    [V, C] table): bit-equal to the CPU plain version, in turns with a bare
    `index_add_` on the kept ids, beside its bound; appends its record."""
    import torch

    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.ops.rows import (
        scatter_add_rows, scatter_add_rows_plain)

    keep = ids >= 0
    runs = torch.bincount(ids[keep].long(), minlength=V)
    tab = torch.zeros((V, C), device=dev)
    got = scatter_add_rows(tab.clone(), ids, grads)
    want = scatter_add_rows_plain(tab.cpu(), ids.cpu(), grads.cpu())
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        fail(f"large V hs=1: K2 at the {call} call differs from the CPU "
             f"plain version's sequential sum")
    del got, want
    ids_in, grads_in = ids[keep].long(), grads[keep].contiguous()
    ms, lib_ms = turns_ms(lambda: scatter_add_rows(tab, ids, grads),
                          lambda: tab.index_add_(0, ids_in, grads_in))
    plain_ms = median_ms(lambda: scatter_add_rows_plain(tab, ids, grads))
    bound = rows_bound_ms(ids, V, C, None)
    print(f"  K2 at the sparse HS step's {call} call [{ids.numel()}, {C}] "
          f"into [{V}, {C}]: {int(keep.sum())} kept ids, "
          f"{int((runs > 0).sum())} rows, the longest run {int(runs.max())}; "
          f"bit-equal to the CPU plain version; {ms:.4f} ms vs index_add_ "
          f"{lib_ms:.4f} ms in turns, plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms [{card}]", flush=True)
    record(f"scatter_add_rows[1M hs {call}]",
           "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:67", 0.0, ms, plain_ms,
           bound, lib_ms)


def large_v_hs_phase(dev, card, records, record, g):
    """Phase 31: DeepWalk hs=1 at V = 1,000,000, D = 128 on phase 30's
    graph, 1 walk of 10 a node, one epoch: `train(hs=1)` ('auto', the
    sparse cap here) cold and warm, then the dense form through
    `HSTrainer(cap_mode='dense')` from the same seed cold and warm, the
    graphs released between; K2 and K3 launched, K4 never (both tables
    above SMALL_V_ROWS); the two forms' tables within LARGE_V_HS_TOL; a
    chunk of 4 sparse steps through the kernels against the plain
    versions, and through its graph against the loop; K2 at the step's
    token and tree calls and K3 at its tree gather against the CPU plain
    versions, `index_add_` / `index_select` and their bounds; then on Wiki
    a sparse chunk through K4 (into the live tables) against a dense one,
    and `HSTrainer(cap_mode='sparse')` at the hs=1 gate."""
    import torch

    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.ops.rows import (
        SMALL_V_ROWS, gather_rows, gather_rows_plain, scatter_add_rows_plain)
    from graphembedding_tpu_torch.train import chunk_graph
    from graphembedding_tpu_torch.train import hsoftmax as hs
    from graphembedding_tpu_torch.train import skipgram as sg

    t_phase = time.perf_counter()
    V, D, L, W = LARGE_V, 128, 10, 5
    if not sg.sparse_cap_for("auto", V):
        fail(f"large V hs=1: cap_mode 'auto' takes the dense form at {V}")
    print(f"large V hs=1: before: {check_cache_bound(dev, 'phases 1-30')}, "
          f"{reserved_text()}", flush=True)
    # the main path: counts from 0 before the model walks and trains
    kernels = kernel_counts()
    for k in kernels.values():
        k.launches = 0
    model, walk_s = timed_walks(
        lambda: DeepWalk(g, walk_length=L, num_walks=1, device=dev))
    hops = hops_on_device(model.walks, g, dev, "large V hs=1 corpus")
    g.free_device()
    walks = model.walks
    NW = walks.shape[0]
    print(f"large V hs=1 walks [{NW}, {L}]: every hop an edge; "
          f"{walk_s:.4f} s ({hops / walk_s:.4e} walked edges/s) [{card}]",
          flush=True)
    # the tree as the fit builds it (the fit builds its own), on the host
    counts = sg.corpus_counts(walks, V)
    t0 = time.perf_counter()
    points, codes, T = hs.build_huffman(counts)
    huffman_s = time.perf_counter() - t0
    bw = sg.fit_block_walks(NW, L, 504)
    geo = sg.block_geometry(NW, L, bw, 1)
    chunks = -(-geo.n_blocks // 64)
    print(f"large V hs=1: build_huffman over {V} counts {huffman_s:.3f} s "
          f"on the host (depth T = {T}; points and codes {points.nbytes / 2**20:.1f} "
          f"MiB each); Bw = {geo.Bw}: G = {geo.G}, PL = {geo.PL}, N = PL*T "
          f"= {geo.PL * T}, {geo.n_blocks} blocks, {chunks} chunks of 64 "
          f"steps; a step gathers [{geo.G * geo.PL}, {D}] of w_in and "
          f"[{geo.G * geo.PL * T}, {D}] of w_tree", flush=True)
    points = torch.as_tensor(points, device=dev)
    codes = torch.as_tensor(codes, device=dev)

    def train_auto():
        model.train(embed_size=D, window_size=W, iter=1, hs=1)
        return (model.w_in, model.w_out, model.losses, model.trained_pairs)

    def train_dense():
        # the model's own fit (base.py: seed + 1 seeds it) in the dense form
        tr = hs.HSTrainer(embed_size=D, window=W, epochs=1, seed=model.seed,
                          cap_mode="dense")
        w_in, w_tree, losses = tr.fit(walks, V, seed=model.seed + 1)
        return w_in, w_tree, losses, tr.trained_pairs_

    tables = {}
    launches = None
    for form, train in (("sparse", train_auto), ("dense", train_dense)):
        chunk_graph.release(dev)
        out, cold = timed_walks(train)
        after_cold = reserved_text()
        if form == "sparse":
            launches = {name: k.launches for name, k in kernels.items()}
            print(f"large V hs=1 main path launches: {launches}", flush=True)
            if (launches["hs_block_grads"] == 0
                    or launches["scatter_add_rows"] == 0):
                fail(f"large V hs=1: K10 or K2 never launched ({launches})")
            if launches["scatter_add_small"] or launches["sgns_block_grads"]:
                fail(f"large V hs=1: K4 or K1 launched ({launches}); both "
                     f"tables are above SMALL_V_ROWS = {SMALL_V_ROWS}")
            if launches["gather_rows"]:
                fail(f"large V hs=1: K3 launched ({launches}); K10 reads "
                     f"the rows itself")
        out, warm = timed_walks(train)
        w_in, w_tree, losses, pairs = out
        if (tuple(w_in.shape) != (V, D) or tuple(w_tree.shape) != (V - 1, D)
                or not torch.isfinite(w_in).all()
                or not torch.isfinite(losses).all()):
            fail(f"large V hs=1 {form}: tables {tuple(w_in.shape)}, "
                 f"{tuple(w_tree.shape)} or losses not finite")
        head, tail = float(losses[:20].mean()), float(losses[-20:].mean())
        if not tail < head:
            fail(f"large V hs=1 {form}: the loss did not fall ({head} -> "
                 f"{tail})")
        tables[form] = (w_in.clone(), w_tree.clone())
        print(f"large V hs=1 train, the {form} cap"
              f"{' (auto)' if form == 'sparse' else ''}, {losses.shape[0]} "
              f"steps: cold {cold:.4f} s ({pairs / cold:.4e} pairs/s, "
              f"{after_cold} after it), warm {warm:.4f} s ({pairs / warm:.4e} "
              f"trained pairs/s, {pairs:.0f} pairs), loss {head:.6f} -> "
              f"{tail:.6f}; {reserved_text()} after it; "
              f"{check_cache_bound(dev, f'large V hs=1 {form}')} [{card}]",
              flush=True)
        print(f"  {profiled_text(train, warm)} [{card}]", flush=True)
    rtol, atol = LARGE_V_HS_TOL
    errs = [max_err(a, b, rtol, atol, f"large V hs=1: the sparse train's "
                    f"{name} against the dense train's")
            for a, b, name in zip(tables["sparse"], tables["dense"],
                                  ("w_in", "w_tree"))]
    print(f"large V hs=1: the sparse train's tables against the dense "
          f"train's from the same seed: max abs err w_in {errs[0]:.3e}, "
          f"w_tree {errs[1]:.3e} (rtol {rtol}, atol {atol}); w_tree moved "
          f"from 0 to max |w| {float(tables['sparse'][1].abs().max()):.3e} "
          f"[{card}]", flush=True)
    w_in0, w_tree0 = tables.pop("sparse")
    del tables
    chunk_graph.release(dev)

    # a chunk of sparse steps from the trained tables: the kernels (through
    # the chunk's graph) against the plain versions, and the graph against
    # the loop of the same steps
    gen = torch.Generator(device=dev).manual_seed(31)
    eff = sg.window_draws(gen, (4, geo.G, geo.PL), W)

    def chunk(ops=hs.KERNELS):
        a, b = w_in0.clone(), w_tree0.clone()
        _, _, losses, pairs = hs.hs_block_chunk(
            a, b, walks, points, codes, eff, 0.025, 1e-4, 0,
            float(chunks * 64), block_walks=bw, window=W, sparse_cap=True,
            ops=ops)
        torch.cuda.synchronize()
        return a, b, losses, pairs

    got, n_graph = counted(chunk)
    want = chunk(hs.PLAIN)
    errs = [max_err(x, y, rtol, atol, f"large V sparse HS chunk: {name}")
            for x, y, name in zip(got, want, ("w_in", "w_tree", "loss"))]
    if not torch.equal(got[3], want[3]):
        fail("large V sparse HS chunk: pair counts differ")
    del want
    with step_loop():
        again, n_loop = counted(chunk)
    if not (all(torch.equal(x, y) for x, y in zip(got, again))
            and n_graph == n_loop):
        fail(f"large V sparse HS chunk: the graph differs from the loop "
             f"(launches {n_graph} against {n_loop})")
    del got, again
    print(f"large V sparse HS chunk, 4 steps: kernels against plain max abs "
          f"err {max(errs):.3e} (rtol {rtol}, atol {atol}); the graph "
          f"torch.equal to the loop, launches {n_graph} both [{card}]",
          flush=True)

    # the first step's scatters, as the sparse step makes them, and the
    # tree gather of the plain version's products
    seen = {}

    def keep(name, fn):
        def wrapped(table, ids, *rest):
            seen.setdefault(name, []).append(
                (table.shape, ids.clone(), *(r.clone() for r in rest)))
            return fn(table, ids, *rest)
        return wrapped

    window_ok, dm = sg.window_geometry(L, geo.PL, W, dev)
    tok = sg.chunk_blocks(walks, 0, 1, geo)[0]
    hs.hs_step(w_in0.clone(), w_tree0.clone(), tok, eff[0], points, codes,
               0.025, window_ok=window_ok, dm=dm, update_cap=8.0,
               sparse_cap=True, ops=hs.PLAIN._replace(
                   scatter_add=keep("scatter", scatter_add_rows_plain)))
    for call, ((rows, C), ids, grads) in zip(("token", "tree"),
                                             seen["scatter"]):
        hs_rows_phase(call, rows, C, ids, grads, dev, card, record)
        records[-1]["launches"] = launches["scatter_add_rows"]
    g_ids = tree_gather_ids(tok, points)
    del seen
    got = gather_rows(w_tree0, g_ids)
    torch.cuda.synchronize()
    if not torch.equal(got, gather_rows_plain(w_tree0, g_ids)):
        fail("large V hs=1 tree gather: K3 differs from table[ids]")
    g_long = g_ids.long()
    k3_ms, sel_ms = turns_ms(lambda: gather_rows(w_tree0, g_ids),
                             lambda: torch.index_select(w_tree0, 0, g_long))
    g_bound = rows_bound_ms(g_ids, V - 1, D, g_ids.numel())
    record("gather_rows[1M hs tree]", "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:261", 0.0, k3_ms,
           median_ms(lambda: gather_rows_plain(w_tree0, g_ids)), g_bound,
           sel_ms)
    records[-1]["launches"] = launches["gather_rows"]
    print(f"  HS tree gather [{g_ids.numel()}, {D}] of [{V - 1}, {D}]: "
          f"{int(torch.unique(g_ids).numel())} distinct rows", flush=True)
    del w_in0, w_tree0, model, walks, points, codes, got
    chunk_graph.release(dev)

    # Wiki: the sparse form through K4 into the live tables (its scan plan
    # on tokens, its group plan on the tree): a chunk of 4 steps against
    # the dense form's from the same tables and draws, then whole fits
    ds = load_dataset("wiki")
    wiki = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
    Vw = ds.graph.num_nodes
    points, codes, _ = hs.build_huffman(sg.corpus_counts(wiki.walks, Vw))
    points = torch.as_tensor(points, device=dev)
    codes = torch.as_tensor(codes, device=dev)
    geo_w = sg.block_geometry(wiki.walks.shape[0], L, 504, 1)
    eff = sg.window_draws(gen, (4, geo_w.G, geo_w.PL), W)
    w_in0 = (torch.rand((Vw, D), generator=gen, device=dev) - 0.5) / D
    w_tree0 = torch.randn((Vw - 1, D), generator=gen, device=dev) * 0.05
    chunks_w = {}
    for sparse in (True, False):
        chunks_w[sparse], n_chunk = counted(lambda: hs.hs_block_chunk(
            w_in0.clone(), w_tree0.clone(), wiki.walks, points, codes, eff,
            0.025, 1e-4, 0, 1152.0, block_walks=504, window=W,
            sparse_cap=sparse))
        if (n_chunk["scatter_add_small"], n_chunk["scatter_add_rows"]) != (
                8, 0):
            fail(f"Wiki HS chunk (sparse {sparse}): launches {n_chunk}; K4 "
                 f"8 times, K2 never")
    errs = [max_err(x, y, rtol, atol, f"Wiki HS chunk, sparse against "
                    f"dense: {name}")
            for x, y, name in zip(chunks_w[True][:3], chunks_w[False][:3],
                                  ("w_in", "w_tree", "loss"))]
    del chunks_w
    print(f"Wiki HS chunk, 4 steps through K10 and K4: the sparse cap "
          f"against the dense cap from the same tables and draws, max abs "
          f"err {max(errs):.3e} (rtol {rtol}, atol {atol}) [{card}]",
          flush=True)
    kernels = kernel_counts()
    fits = {}
    for mode in ("sparse", "dense"):
        tr = hs.HSTrainer(embed_size=D, window=W, epochs=3, seed=wiki.seed,
                          cap_mode=mode)
        for k in kernels.values():
            k.launches = 0
        (w_in, w_tree, losses), fit_s = timed_walks(
            lambda: tr.fit(wiki.walks, Vw, seed=wiki.seed + 1))
        fits[mode] = (w_in, w_tree, fit_s)
        n_steps = losses.shape[0]
        if (kernels["scatter_add_small"].launches != 2 * n_steps
                or kernels["scatter_add_rows"].launches):
            fail(f"Wiki hs=1 {mode}: {n_steps} steps, K4 "
                 f"{kernels['scatter_add_small'].launches} and K2 "
                 f"{kernels['scatter_add_rows'].launches} launches; want "
                 f"2 K4 a step")
    # whole fits: the forms' last-bit differences grow over 1,152 steps
    # of a 2,405-node table (reported, not held to a tolerance)
    diffs = []
    for a, b, name in zip(fits["sparse"][:2], fits["dense"][:2],
                          ("w_in", "w_tree")):
        ratio = float(((a - b).abs() / (atol + rtol * b.abs())).max())
        diffs.append(f"{name} max abs err {float((a - b).abs().max()):.3e} "
                     f"({ratio:.3f} of the rtol {rtol}, atol {atol} bound; "
                     f"max |w| {float(b.abs().max()):.3e})")
    table = fits["sparse"][0].cpu().numpy()
    names = ds.graph.vocab.idx2node
    res = Classifier({names[i]: table[i] for i in range(Vw)}).\
        split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
    print(f"Wiki hs=1 cap_mode='sparse' ({n_steps} steps, K4 2 a step into "
          f"the live tables): cold fit {fits['sparse'][2]:.4f} s (dense "
          f"{fits['dense'][2]:.4f} s); against the dense fit from the same "
          f"seed: {', '.join(diffs)}; micro-F1 {res['micro']:.4f} [{card}]",
          flush=True)
    if not res["micro"] >= HS_MIN_MICRO_F1:
        fail(f"Wiki hs=1 sparse micro-F1 {res['micro']:.4f} < "
             f"{HS_MIN_MICRO_F1}")
    chunk_graph.release(dev)
    print(f"phase 31: {time.perf_counter() - t_phase:.1f} s", flush=True)


def scaling_phase(card):
    """Phase 32: `benchmarks/scaling.py` once at world 1 over NCCL (one
    spawned rank on the card), 2 chunks and 1 timed run a configuration:
    its four rows, rates positive, no walker lost."""
    from graphembedding_tpu_torch.benchmarks import scaling

    t0 = time.perf_counter()
    rows = scaling.main(["--world", "1", "--backend", "nccl", "--chunks",
                         "2", "--reps", "1"])
    modes = [r["mode"] for r in rows]
    if modes != ["train_dp_weak", "rowshard", "distributed_walks_weak",
                 "distributed_walks_a2a_weak"]:
        fail(f"scaling: rows {modes}")
    for r in rows:
        rate = r.get("pairs_per_s", r.get("walked_edges_per_s"))
        if not rate > 0 or r.get("overflow", 0) != 0:
            fail(f"scaling: {r}")
    print(f"phase 32: scaling.py at world 1 over NCCL, {len(rows)} rows "
          f"[{card}]; {time.perf_counter() - t0:.1f} s", flush=True)


def simquery_phase(dev, card):
    """Phase 23: most_similar on a 1,000,000 x 128 table on the card
    against the numpy path on the same table."""
    import torch

    from graphembedding_tpu_torch.utils import simquery

    V, D = 1_000_000, 128
    rng = np.random.default_rng(23)
    table = rng.standard_normal((V, D), dtype=np.float32)
    names = [f"v{i}" for i in range(V)]
    queries = [dict(node=f"v{i}") for i in (0, 4321, 999_999)] + [
        dict(vector=table[77] + rng.standard_normal(D, dtype=np.float32))]

    def query_all():
        return [simquery.most_similar((names, table), topn=10, **q)
                for q in queries]

    t0 = time.perf_counter()
    got = query_all()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    dev_s = min(timed_walks(query_all)[1] for _ in range(3))
    threshold = simquery._DEVICE_MIN_ROWS
    simquery._DEVICE_MIN_ROWS = V + 1
    try:
        want = query_all()
        np_s = min(timed_walks(query_all)[1] for _ in range(2))
    finally:
        simquery._DEVICE_MIN_ROWS = threshold
    err = 0.0
    for q, g, w in zip(queries, got, want):
        gs, ws = [s for _, s in g], [s for _, s in w]
        err = max(err, float(np.abs(np.subtract(gs, ws)).max()))
        cut = w[-1][1]
        differ = {n for n, _ in g} ^ {n for n, _ in w}
        ties = {n for n, s in g + w if abs(s - cut) <= 1e-5}
        if len(g) != 10 or err > 1e-5 or not differ <= ties:
            fail(f"most_similar {q}: card {g} against numpy {w}")
    n = len(queries)
    print(f"most_similar on [{V}, {D}] (pair form, {4 * V * D} bytes): "
          f"top-10 names equal the numpy path's apart from ties, scores "
          f"within {err:.2e}; card {1e3 * dev_s / n:.2f} ms a query warm "
          f"(the first {n} queries {cold_s:.3f} s with the upload), numpy "
          f"{1e3 * np_s / n:.2f} ms a query [{card}]", flush=True)


def mesh_train(what, gate, train, model, ds, per_step):
    """Phases 24-25: train(model) on the card in this rank, then its
    micro-F1, to be held to MESH_MIN_MICRO_F1[gate]. per_step: the K1-K4
    launches a step (K4 for V <= 16,384), checked against the steps the
    run's losses count. Returns the numbers."""
    import torch

    from graphembedding_tpu_torch.eval.classify import Classifier

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = counted(lambda: train(model))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    table = model.embedding_table
    if not torch.isfinite(table).all() or not torch.isfinite(
            model.losses).all():
        fail(f"{what}: non-finite embeddings or losses")
    steps = model.losses.shape[0]
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        fail(f"{what}: launches {launches}, want {want} ({steps} steps)")
    f1 = Classifier(model.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8, seed=0)["micro"]
    return dict(what=what, gate=gate, f1=f1, train_s=train_s, steps=steps,
                launches=launches)


SGNS_STEP = {"sgns_block_grads": 1, "scatter_add_rows": 2,
             "gather_rows": 1, "scatter_add_small": 0,
             "hs_block_grads": 0}  # rowshard
DP_STEP = dict(SGNS_STEP, gather_rows=2)
# HS with no model axis: K10 and two scatters
HS_STEP = dict(SGNS_STEP, sgns_block_grads=0, scatter_add_rows=0,
               gather_rows=0, scatter_add_small=2, hs_block_grads=1)
# LINE order 'second': emb and ctx, a gather and a scatter
LINE_STEP = dict(HS_STEP, gather_rows=2, hs_block_grads=0)
NO_KERNEL = dict.fromkeys(SGNS_STEP, 0)


def wiki_draws(geo, S, V, K, seed, dev):
    """Window draws in {1..5} and negative ids of S steps, from a CPU
    generator (so the card and the CPU get the same), on dev."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    eff = 5 - (torch.rand((S, geo.G, geo.PL), generator=gen) * 5).to(
        torch.int32).clamp(0, 4)
    negs = torch.randint(0, V, (S, geo.G2, K), generator=gen,
                         dtype=torch.int32)
    return eff.to(dev), negs.to(dev)


def mesh_ways(dev, ds, model, mesh):
    """Phase 24's mesh trainers at world 1 over NCCL, each through its
    chunk graphs and through the step loop (`graphs_against_loop`, the
    launches the steps times the per-step counts). Returns (result lines,
    the rowshard run through the graphs for `report_mesh_runs`)."""
    from graphembedding_tpu_torch import LINE, SDNE
    from graphembedding_tpu_torch.train import chunk_graph

    sgns_kw = dict(embed_size=128, window_size=5, iter=3, mesh=mesh)
    walk_tables = lambda m: (m.w_in, m.w_out)  # noqa: E731
    sdne_params = lambda m: list(m.net.parameters())  # noqa: E731
    trainers = [
        ("DeepWalk rowshard", "rowshard", lambda: model,
         lambda m: m.train(**sgns_kw), walk_tables, SGNS_STEP),
        ("DeepWalk rowshard prefetch", "rowshard_prefetch", lambda: model,
         lambda m: m.train(rowshard_prefetch=True, **sgns_kw), walk_tables,
         SGNS_STEP),
        ("DeepWalk dp", "dp", lambda: model,
         lambda m: m.train(parallel_mode="dp", **sgns_kw), walk_tables,
         DP_STEP),
        ("DeepWalk hs=1 dp", "hs", lambda: model,
         lambda m: m.train(hs=1, **sgns_kw), walk_tables, HS_STEP),
        ("LINE order 'second' dp", "line",
         lambda: LINE(ds.graph, embedding_size=128, order="second",
                      device=dev),
         lambda m: m.train(batch_size=1024, epochs=50, mesh=mesh),
         lambda m: (m.second_emb, m.context_emb), LINE_STEP),
        ("SDNE full batch", "sdne",
         lambda: SDNE(ds.graph, hidden_size=[256, 128], device=dev),
         lambda m: m.train(batch_size=3000, epochs=40, mesh=mesh),
         sdne_params, NO_KERNEL),
        ("SDNE train_sparse", "sdne",
         lambda: SDNE(ds.graph, hidden_size=[256, 128], device=dev),
         lambda m: m.train_sparse(epochs=40, row_chunk=512, mesh=mesh),
         sdne_params, NO_KERNEL),
    ]
    lines, rowshard_run = [], None
    for name, gate, build, train, tables_of, per_step in trainers:
        what = f"{name}, world 1 (NCCL)"
        got, (cold, f1, steps, launches) = graphs_against_loop(
            what, ds, build, train, tables_of, MESH_MIN_MICRO_F1[gate],
            lambda steps, per_step=per_step: {
                k: n * steps for k, n in per_step.items()}, dev)
        lines += got
        if rowshard_run is None:
            rowshard_run = dict(what=what, gate=gate, f1=f1, train_s=cold,
                                steps=steps, launches=launches,
                                rate=model.trained_pairs / cold)
    chunk_graph.release()
    return lines, rowshard_run


def mesh_world1_rank(info):
    """Phase 24, in a spawned NCCL rank of world size 1."""
    import torch

    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.parallel import make_mesh
    from graphembedding_tpu_torch.parallel.rowshard import (
        rank_geometry, rowsharded_sgns_chunk)
    from graphembedding_tpu_torch.train import skipgram as sg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = info.device
    mesh = make_mesh((1, 1), device=dev)
    ds = load_dataset("wiki")
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
    walks = model.walks
    NW, L = walks.shape
    V, D, K, S = ds.graph.num_nodes, 128, 64, 4
    geo = rank_geometry(NW, L, 4032, 1, 4)
    gen = torch.Generator().manual_seed(5)
    w0 = ((torch.rand((V, 2 * D), generator=gen) - 0.5) / D).to(dev)
    w0[:, D:] = (torch.randn((V, D), generator=gen) * 0.05).to(dev)
    eff, negs = wiki_draws(geo, S, V, K, 6, dev)
    kw = dict(block_walks=4032, window=5, negative=5, neg_share_packs=4)
    want = sg.sgns_block_chunk_cat(w0.clone(), walks, eff, negs, 0.025,
                                   1e-4, 0, 192.0, **kw)
    got, launches = counted(lambda: rowsharded_sgns_chunk(
        w0.clone(), walks, eff, negs, 0.025, 1e-4, 0, 192.0, mesh=mesh,
        **kw))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("rowshard chunk at world 1 (NCCL) differs from "
             "sgns_block_chunk_cat")
    if launches != {k: n * S for k, n in SGNS_STEP.items()}:
        fail(f"rowshard chunk at world 1: launches {launches} in {S} steps")
    moved = float((got[0] - w0).abs().max())
    chunk = (f"rowshard chunk, world 1 over NCCL: {S} steps at G={geo.G} "
             f"PL={geo.PL} G2={geo.G2} K={K} D={D}, through a chunk graph, "
             f"tables, losses and pairs torch.equal to "
             f"sgns_block_chunk_cat's (moved by {moved:.3e}); launches "
             f"{launches} = a step K3 1, K1 1, K2 2")
    lines, run = mesh_ways(dev, ds, model, mesh)
    return dict(chunk=chunk, runs=[run], lines=lines)


def card_and_cpu(fn, tensors, dev):
    """fn on copies of tensors on the card, then on the CPU (the same
    collectives in the same order on every rank)."""
    on_card = fn(*[t.to(dev, copy=True) if t is not None else None
                   for t in tensors])
    on_cpu = fn(*[t.clone() if t is not None else None for t in tensors])
    return on_card, on_cpu


def mesh_chunks(dev, ds, walks, mesh, mesh12, di):
    """Phase 25's chunks, card against CPU at world 2; result lines."""
    import torch

    from graphembedding_tpu_torch import LINE, SDNE
    from graphembedding_tpu_torch.models import line as line_mod
    from graphembedding_tpu_torch.parallel import hsoftmax, sgns
    from graphembedding_tpu_torch.parallel.line import sharded_line_chunk
    from graphembedding_tpu_torch.parallel.rowshard import (
        rank_geometry, rowsharded_sgns_chunk)
    from graphembedding_tpu_torch.train.hsoftmax import build_huffman
    from graphembedding_tpu_torch.train.skipgram import corpus_counts

    NW, L = walks.shape
    V, D, K, n = ds.graph.num_nodes, 128, 64, 2
    walks = walks.cpu()
    gen = torch.Generator().manual_seed(7)
    table = (torch.rand((V, 2 * D), generator=gen) - 0.5) / D
    table[:, D:] = torch.randn((V, D), generator=gen) * 0.05
    kw = dict(block_walks=4032, window=5, negative=5, neg_share_packs=4)
    lines = []

    def held(what, got, want, tol):
        err = max(max_err(a.cpu(), b, *tol, f"{what}, card against CPU")
                  for a, b in zip(got, want))
        lines.append(f"{what}: card against the CPU at world 2, max abs "
                     f"err {err:.3e} (rtol {tol[0]}, atol {tol[1]})")

    # rowshard: each rank's rows of the padded table, its own draws
    Vp, S = -(-V // n), 2
    geo = rank_geometry(NW, L, 4032, n, 4)
    w = torch.zeros((n * Vp, 2 * D))
    w[:V] = table
    eff, negs = wiki_draws(geo, S, V, K, 10 + di, "cpu")
    got, want = card_and_cpu(lambda w_, wk, e, ng: rowsharded_sgns_chunk(
        w_, wk, e, ng, 0.025, 1e-4, 0, 192.0, mesh=mesh, **kw),
        (w[di * Vp:(di + 1) * Vp], walks, eff, negs), dev)
    held(f"rowshard chunk ({S} steps, G={geo.G} PL={geo.PL} a rank)", got,
         want, MESH_SGNS_TOL)
    # dp at (2, 1) and (1, 2): eff shared, negatives by data rank
    for m_, shape in ((mesh, "(2, 1)"), (mesh12, "(1, 2)")):
        d = m_.get_local_rank("data")
        geo = sgns.dp_geometry(NW, L, 4032, m_.size("data"), 4)
        eff, _ = wiki_draws(geo, 4, V, K, 20, "cpu")
        _, negs = wiki_draws(geo, 4, V, K, 30 + d, "cpu")
        cols = slice(m_.get_local_rank("model") * D // m_.size("model"),
                     (m_.get_local_rank("model") + 1) * D
                     // m_.size("model"))
        w = torch.cat([table[:, :D][:, cols], table[:, D:][:, cols]], 1)
        got, want = card_and_cpu(lambda w_, wk, e, ng: sgns.sharded_sgns_chunk(
            w_, wk, e, ng, 0.025, 1e-4, 0, 192.0, mesh=m_, sync_every=2,
            **kw), (w, walks, eff, negs), dev)
        held(f"dp chunk at mesh {shape} (4 steps, sync every 2)", got, want,
             MESH_SGNS_TOL)
    # HS dp at (2, 1): the DeepWalk hs=1 block (504 walks) split in two
    points, codes, _ = build_huffman(corpus_counts(walks, V))
    points, codes = torch.as_tensor(points), torch.as_tensor(codes)
    geo = sgns.dp_geometry(NW, L, 504, n, 1)
    eff, _ = wiki_draws(geo, 4, V, K, 40 + di, "cpu")
    w_tree = torch.randn((V - 1, D), generator=gen) * 0.05
    got, want = card_and_cpu(
        lambda wi, wt, wk, p, c, e: hsoftmax.sharded_hs_chunk(
            wi, wt, wk, p, c, e, 0.025, 1e-4, 0, 1152.0, mesh=mesh,
            block_walks=504, window=5, sync_every=2),
        (table[:, :D].clone(), w_tree, walks, points, codes, eff), dev)
    held(f"HS dp chunk (4 steps, G={geo.G} PL={geo.PL} T={points.shape[1]} "
         f"a rank)", got, want, MESH_ROW_TOL)
    # LINE dp: 512 edges a rank a step, order 'second'
    lm = LINE(ds.graph, embedding_size=D, order="second", device="cpu")
    draws = line_mod.line_bulk_samples(
        lm._edge_src, lm._edge_dst, lm._edge_accept, lm._edge_alias,
        lm._neg_table, torch.Generator().manual_seed(50 + di), 0.025, 0,
        1000.0, chunk_steps=4, batch_size=512, negative=5, k_shared=0)
    got, want = card_and_cpu(
        lambda e, c, *dr: sharded_line_chunk(e, c, *dr, mesh=mesh,
                                             negative=5, sync_every=2),
        (table[:, :D].clone(), table[:, D:].clone(), *draws), dev)
    held("LINE dp chunk (4 steps, 512 edges a rank)", got, want,
         MESH_ROW_TOL)
    # SDNE's mesh trainers: three steps, from the same parameters
    for mode, train in (
            ("full batch", lambda m: m.train(batch_size=3000, epochs=3,
                                             mesh=mesh)),
            ("sparse", lambda m: m.train_sparse(epochs=3, row_chunk=512,
                                                mesh=mesh))):
        runs = []
        for device in (dev, "cpu"):
            m = SDNE(ds.graph, hidden_size=[256, 128], device=device)
            init = [p.detach().cpu().clone() for p in m.net.parameters()]
            no_kernel_launched(f"SDNE {mode} over the mesh",
                               lambda: train(m))
            runs.append(([p.detach().cpu() for p in m.net.parameters()],
                         m.losses.cpu()))
        (got, loss), (want, want_loss) = runs
        loss_err = max_err(loss, want_loss, SDNE_LOSS_RTOL, 0.0,
                           f"SDNE {mode} mesh losses, card against CPU")
        ratio = max(float((a - b).norm() / (b - p0).norm())
                    for a, b, p0 in zip(got, want, init))
        if not ratio <= SDNE_UPDATE_RTOL:
            fail(f"SDNE {mode} over the mesh: updates differ from the "
                 f"CPU's by {ratio} (L2, relative)")
        lines.append(f"SDNE {mode} mesh trainer (3 steps): card against the "
                     f"CPU at world 2, losses max abs err {loss_err:.3e} "
                     f"(rtol {SDNE_LOSS_RTOL}), updates' relative L2 error "
                     f"{ratio:.3e} (bound {SDNE_UPDATE_RTOL})")
    return lines


def mesh_world2_rank(info, tmp):
    """Phases 25-26, in each of two spawned gloo ranks on one card."""
    import torch

    from graphembedding_tpu_torch import LINE, SDNE, DeepWalk
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = info.device
    mesh = make_mesh((2, 1), device=dev)
    mesh12 = make_mesh((1, 2), device=dev)
    di = mesh.get_local_rank("data")
    ds = load_dataset("wiki")
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
    t0 = time.perf_counter()
    lines = mesh_chunks(dev, ds, model.walks, mesh, mesh12, di)
    lines.append(f"chunks' phase {time.perf_counter() - t0:.1f} s")

    sgns_kw = dict(embed_size=128, window_size=5, iter=3, mesh=mesh)
    runs = []
    run = mesh_train("DeepWalk rowshard, world 2 (gloo)", "rowshard",
                     lambda m: m.train(**sgns_kw), model, ds, SGNS_STEP)
    run["rate"] = model.trained_pairs / run["train_s"]
    reference = (model.w_in.clone(), model.w_out.clone())
    runs.append(run)
    run = mesh_train("DeepWalk dp, world 2 (gloo)", "dp", lambda m: m.train(
        parallel_mode="dp", **sgns_kw), model, ds, DP_STEP)
    run["rate"] = model.trained_pairs / run["train_s"]
    runs.append(run)
    run = mesh_train("DeepWalk hs=1, world 2 (gloo)", "hs", lambda m: m.train(
        hs=1, **sgns_kw), model, ds, HS_STEP)
    run["rate"] = model.trained_pairs / run["train_s"]
    runs.append(run)
    line = LINE(ds.graph, embedding_size=128, order="second", device=dev)
    run = mesh_train("LINE order 'second', world 2 (gloo)", "line",
                     lambda m: m.train(batch_size=1024, epochs=50, mesh=mesh),
                     line, ds, LINE_STEP)
    run["rate"] = line.sampled_edges / run["train_s"]
    runs.append(run)
    sdne = SDNE(ds.graph, hidden_size=[256, 128], device=dev)
    run = mesh_train("SDNE full batch, world 2 (gloo)", "sdne",
                     lambda m: m.train(batch_size=3000, epochs=40, mesh=mesh),
                     sdne, ds, NO_KERNEL)
    run["rate"] = ds.graph.num_nodes * 40 / run["train_s"]
    runs.append(run)

    # 26. the rowshard fit cut after its second chunk, then resumed
    class Cut(Exception):
        pass

    class CutAfter:
        def log(self, **kw):
            if kw["step"] > 128:
                raise Cut()

    try:
        model.train(checkpoint_dir=tmp, checkpoint_every=1,
                    metrics=CutAfter(), **sgns_kw)
        fail("the cut run was not cut")
    except Cut:
        pass
    _, launches = counted(lambda: model.train(checkpoint_dir=tmp, **sgns_kw))
    torch.cuda.synchronize()
    steps = model.losses.shape[0]
    if not (torch.equal(model.w_in, reference[0])
            and torch.equal(model.w_out, reference[1])):
        fail("the resumed rowshard fit differs from the uninterrupted one")
    if steps != 64 or launches != {k: n * steps for k, n in
                                   SGNS_STEP.items()}:
        fail(f"the resumed rowshard fit: {steps} steps, launches {launches}")
    lines.append(f"restart: the rowshard fit cut after chunk 2 and resumed "
                 f"from {sorted(os.listdir(tmp))}: tables torch.equal to the "
                 f"uninterrupted fit; the resumed run {steps} steps, "
                 f"launches {launches}")
    from graphembedding_tpu_torch.train import chunk_graph

    if chunk_graph.held():
        fail(f"{len(chunk_graph.held())} chunk graphs captured over gloo, "
             f"whose exchanges of CUDA tensors go through the host")
    lines.append("over gloo every mesh chunk ran its steps one by one (no "
                 "chunk graph captured: the backend rule)")
    return dict(lines=lines, runs=runs)


def report_mesh_runs(runs_by_rank, card):
    """Rank 0's runs, each with every rank's launches (and walk seconds
    where the run walked); the ranks' micro-F1 must agree (their tables
    are the same) and clear the run's gate."""
    for i, run in enumerate(runs_by_rank[0]):
        ranks = [rr[i] for rr in runs_by_rank]
        gate = MESH_MIN_MICRO_F1[run["gate"]]
        walk = (f"walks {run['walk_s']:.3f} s, " if "walk_s" in run
                else "")
        print(f"{run['what']}: {walk}train {run['train_s']:.3f} s, "
              f"{run['rate']:.4e} a s ({run['steps']} steps), launches "
              f"on each rank {[r['launches'] for r in ranks]}, micro-F1 "
              f"{run['f1']:.4f} (gate {gate}) [{card}]", flush=True)
        if any(r["f1"] != run["f1"] for r in ranks):
            fail(f"{run['what']}: ranks' micro-F1 differ: "
                 f"{[r['f1'] for r in ranks]}")
        if not run["f1"] >= gate:
            fail(f"{run['what']}: micro-F1 {run['f1']:.4f} < {gate}")


def mesh_phases(card):
    """Phases 24-26: the mesh trainers in spawned ranks on the card."""
    import tempfile

    import torch

    from graphembedding_tpu_torch.parallel.launch import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    [w1] = run_ranks(mesh_world1_rank, 1, backend="nccl", device="cuda:0",
                     threads=4, timeout_s=600)
    print(w1["chunk"], f"[{card}]", flush=True)
    for line in w1["lines"]:
        print(line, f"[{card}]", flush=True)
    report_mesh_runs([w1["runs"]], card)
    print(f"phase 24: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ge_mesh_") as tmp:
        w2 = run_ranks(mesh_world2_rank, 2, tmp, backend="gloo",
                       device="cuda:0", threads=4, timeout_s=500)
    for line in w2[0]["lines"]:
        print(line, f"[{card}]", flush=True)
    report_mesh_runs([w["runs"] for w in w2], card)
    print(f"phases 25-26: {time.perf_counter() - t0:.1f} s", flush=True)


# phases 27-28: the distributed walk engines (parallel/walks.py)
WALK_KINDS = (
    ("uniform", {}), ("weighted", dict(kind="weighted")),
    ("batched (hop_batch 4)", dict(hop_batch=4)),
    ("a2a uniform", dict(exchange="a2a")),
    ("a2a weighted", dict(kind="weighted", exchange="a2a")),
    ("node2vec exact", dict(kind="node2vec", p=0.25, q=4.0)),
    ("node2vec rejection", dict(kind="node2vec_rejection", p=0.25, q=4.0)),
    ("multilayer", dict(kind="multilayer")),
    ("multilayer a2a", dict(kind="multilayer", exchange="a2a")))


def one_card_walks(kw, graph, ly, dev):
    """fn() -> the one-card sampler's corpus of a walk kind (80 walks of 10
    a node, seed 0), for edges/s beside the engine's."""
    import torch

    from graphembedding_tpu_torch.models import struc2vec as s2v
    from graphembedding_tpu_torch.ops.walk import simulate_walks

    kind = kw.get("kind", "uniform")

    def run():
        gen = torch.Generator(device=dev).manual_seed(0)
        if kind == "multilayer":
            V = ly["gamma"].shape[1]
            return s2v.multilayer_walks(
                ly["row_ptr"], ly["col_idx"], ly["accept"], ly["alias"],
                ly["gamma"], torch.arange(V, dtype=torch.int32,
                                          device=dev).repeat(80),
                gen, 0.3, length=10)
        if kind == "weighted":
            return simulate_walks(graph, 80, 10, generator=gen,
                                  kind="weighted")
        if kind.startswith("node2vec"):
            return simulate_walks(
                graph, 80, 10, generator=gen, kind="node2vec", p=0.25, q=4.0,
                sampler="exact" if kind == "node2vec" else "rejection")
        return simulate_walks(graph, 80, 10, generator=gen)
    return run


def walk_kinds(mesh, graph, layers, one_card):
    """Every engine kind on the Wiki graph (multilayer: flight-brazil's
    layers), 80 walks of 10 a node, twice from seed 0: overflow 0, every
    hop an edge (a layer's, or a stay), the two runs torch.equal. Returns
    a line a kind with warm edges/s (and the one-card sampler's beside it
    when one_card)."""
    import torch

    from graphembedding_tpu_torch.models import struc2vec as s2v
    from graphembedding_tpu_torch.parallel.walks import DistributedWalker

    dev = mesh.device
    ly = s2v.layers_to(layers, dev)
    lines = []
    for name, kw in WALK_KINDS:
        kw = dict(kw)
        multilayer = kw.get("kind") == "multilayer"
        g = None if multilayer else graph
        if multilayer:
            kw.update(layers=layers, num_nodes=layers["gamma"].shape[1])
        walker = DistributedWalker(g, mesh, 10, num_walks=80, **kw)
        (w1, ov1), cold = timed_walks(lambda: walker.run_tensor(0))
        (w2, ov2), warm = timed_walks(lambda: walker.run_tensor(0))
        what = f"{name} walks over the mesh"
        if ov1 or ov2:
            fail(f"{what}: overflow {ov1}, {ov2}")
        if not torch.equal(w1, w2):
            fail(f"{what}: two runs from one seed differ")
        if multilayer:
            if not (w2 >= 0).all():
                fail(f"{what}: a walk ended early")
            check_layer_hops(w2, layers, what)
            edges = w2.shape[0] * 9
        else:
            edges = check_hops(w2, graph, what)
        line = (f"{name}: [{w2.shape[0]}, 10], overflow 0, warm "
                f"{warm:.4f} s (cold {cold:.4f}), {edges / warm:.4e} walked "
                f"edges/s")
        if walker.last_rounds is not None:
            line += f", rounds {walker.last_rounds}"
        if walker.last_crossed is not None:
            line += f", crossed {walker.last_crossed}"
        if one_card:
            run = one_card_walks(kw, graph, ly, dev)
            run()
            single, s1 = timed_walks(run)
            n1 = int((single[:, 1:] >= 0).sum())
            line += f"; one-card sampler {n1 / s1:.4e} edges/s ({s1:.4f} s)"
        lines.append(line)
    return lines


def flight_layers():
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.models import struc2vec as s2v

    fl = load_dataset("flight-brazil")
    edges, _ = s2v.build_context_graph(fl.graph, workers=4)
    return fl, s2v.build_layer_csr(edges, fl.graph.num_nodes)


def walk_model(what, gate, build, train, ds, per_step):
    """A walk model built with mesh= (its walks timed), then mesh_train."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build()
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    if model.walk_overflow:
        fail(f"{what}: walk overflow {model.walk_overflow}")
    run = mesh_train(what, gate, train, model, ds, per_step)
    run.update(walk_s=walk_s, rate=model.trained_pairs / run["train_s"])
    return run


def mesh_walks_world1_rank(info):
    """Phase 27, in a spawned NCCL rank of world size 1."""
    import torch

    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.data.datasets import synthetic_wiki
    from graphembedding_tpu_torch.graph import Graph
    from graphembedding_tpu_torch.ops.walk import (
        uniform_walks, uniform_walks_plain)
    from graphembedding_tpu_torch.parallel import make_mesh
    from graphembedding_tpu_torch.parallel.mesh import rank_seed
    from graphembedding_tpu_torch.parallel.walks import DistributedWalker

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = info.device
    mesh = make_mesh((1, 1), device=dev)
    ds = load_dataset("wiki")
    g = ds.graph
    lines = []
    # the oracle: at slack 1 the engine draws the lockstep walk's uniforms
    # (`uniform_walks_plain`; the one-card kernel K6 draws from Philox) in
    # its order as long as no walk stops (a stopped walker's slot is
    # compacted away, and the later walkers move to other slots and draws):
    # Wiki with a self-loop at each of its vertices without out-edges
    src, dst, _ = g.edges()
    dead = np.flatnonzero(g.degree == 0)
    loops = Graph(np.concatenate([src, dead]), np.concatenate([dst, dead]),
                  num_nodes=g.num_nodes)
    walks, ov = DistributedWalker(loops, mesh, 10, num_walks=80,
                                  slack=1).run_device(3)
    dl = loops.to(dev)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(3, 0))
    want = uniform_walks_plain(dl.row_ptr, dl.col_idx, dl.degree,
                               torch.arange(g.num_nodes, device=dev).repeat(
                                   80), length=10, generator=gen)
    if int(ov) or not torch.equal(walks, want):
        fail("the slack-1 world-1 corpus differs from uniform_walks_plain'")
    lines.append(f"oracle: the all-gather engine at slack 1, world 1 "
                 f"(NCCL), torch.equal to ops.walk.uniform_walks_plain from "
                 f"the same generator state ({walks.shape[0]} walks of 10 on "
                 f"Wiki with self-loops at its {dead.size} vertices without "
                 f"out-edges)")
    fl, layers = flight_layers()
    lines += walk_kinds(mesh, g, layers, one_card=True)

    run = walk_model("DeepWalk(mesh=) rowshard, world 1 (NCCL)", "rowshard",
                     lambda: DeepWalk(g, walk_length=10, num_walks=80,
                                      device=dev, mesh=mesh),
                     lambda m: m.train(embed_size=128, window_size=5,
                                       iter=3), ds, SGNS_STEP)

    # scale: one walk of 10 a node on phase 18's graph
    big = synthetic_wiki(num_nodes=100_000, avg_degree=10.0).graph
    bg = big.to(dev)
    scale = []
    for name, fn in (
            ("all-gather engine", DistributedWalker(big, mesh, 10).run_tensor),
            ("a2a engine", DistributedWalker(big, mesh, 10,
                                             exchange="a2a").run_tensor),
            ("uniform_walks", lambda seed: (uniform_walks(
                bg.row_ptr, bg.col_idx, bg.degree,
                torch.arange(big.num_nodes, device=dev), length=10,
                generator=torch.Generator(device=dev).manual_seed(seed)),
                0))):
        fn(0)
        (w, ov), warm = timed_walks(lambda: fn(0))
        if ov:
            fail(f"V = 100,000, {name}: overflow {ov}")
        edges = check_hops(w, big, f"V = 100,000, {name}")
        scale.append(f"{name} {edges / warm:.4e} edges/s ({warm:.4f} s)")
    lines.append(f"V = 100,000 (E = {big.num_edges}), one walk of 10 a "
                 f"node, warm: " + "; ".join(scale))
    return dict(lines=lines, runs=[run])


def a2a_frames(mesh, graph, bcap):
    """The a2a engine's corpus (one walk of 10 a node: a bucket cap of 64
    then takes some 100 rounds, not thousands) through the ragged exchange
    and through the dense frame (the JAX package's), from one seed; fails
    unless they are torch.equal. Returns a result line."""
    import torch

    from graphembedding_tpu_torch.parallel import walks as tw
    from graphembedding_tpu_torch.parallel.mesh import rank_seed

    n, me = mesh.size("data"), mesh.get_local_rank("data")
    vp = -(-graph.num_nodes // n)
    parts = tw.partition_csr(graph, n)
    starts, nw = tw._group_starts(graph.num_nodes, 1, n, vp)
    args = [torch.as_tensor(parts[k][me]).to(mesh.device)
            for k in ("row_ptr", "col_idx", "degree")]
    runs = []
    for ex in (tw.ragged_exchange, tw.dense_exchange):
        fn = tw.distributed_uniform_walks_a2a(
            mesh, length=10, vp=vp, n_walkers=nw, bucket_cap=bcap,
            exchange=ex)
        gen = torch.Generator(device=mesh.device).manual_seed(
            rank_seed(5, me))
        (walks, ov, rounds, crossed), s = timed_walks(lambda: fn(
            *args, torch.as_tensor(starts[me]).to(mesh.device), gen))
        runs.append((walks, int(ov), rounds, int(crossed), s))
    (a, *ra, sa), (b, *rb, sb) = runs
    if not torch.equal(a, b) or ra != rb or ra[0]:
        fail(f"a2a at bucket cap {bcap}: the ragged exchange's corpus "
             f"differs from the dense frame's ({ra} against {rb})")
    return (f"bucket cap {bcap or 'default'}: torch.equal, {ra[1]} rounds, "
            f"{ra[2]} rows crossed; ragged {sa:.4f} s, dense {sb:.4f} s")


def mesh_walks_world2_rank(info):
    """Phase 28, in each of two spawned gloo ranks on one card."""
    import tempfile

    import torch

    from graphembedding_tpu_torch import DeepWalk, Node2Vec, Struc2Vec
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = info.device
    mesh = make_mesh((2, 1), device=dev)
    ds = load_dataset("wiki")
    g = ds.graph
    fl, layers = flight_layers()
    t0 = time.perf_counter()
    lines = walk_kinds(mesh, g, layers, one_card=False)
    lines.append("a2a, the ragged exchange against the dense frame: "
                 + "; ".join(a2a_frames(mesh, g, b) for b in (None, 64)))
    lines.append(f"walk kinds and frames: {time.perf_counter() - t0:.1f} s")

    sgns = dict(embed_size=128, window_size=5, iter=3)
    runs = []
    model = None

    def deepwalk(**kw):
        nonlocal model
        model = DeepWalk(g, walk_length=10, num_walks=80, device=dev,
                         mesh=mesh, **kw)
        return model

    runs.append(walk_model("DeepWalk(mesh=) dp, world 2 (gloo)",
                           "walks_dp", deepwalk, lambda m: m.train(
                               parallel_mode="dp", **sgns), ds, DP_STEP))
    run = mesh_train("DeepWalk(mesh=) rowshard, world 2 (gloo)",
                     "walks_rowshard", lambda m: m.train(**sgns), model, ds,
                     SGNS_STEP)
    run.update(walk_s=runs[0]["walk_s"],
               rate=model.trained_pairs / run["train_s"])
    runs.append(run)
    runs.append(walk_model(
        "DeepWalk(mesh=, walk_exchange='a2a') dp, world 2 (gloo)",
        "walks_a2a", lambda: deepwalk(walk_exchange="a2a"),
        lambda m: m.train(parallel_mode="dp", **sgns), ds, DP_STEP))
    runs.append(walk_model(
        "Node2Vec(mesh=, p=0.25, q=4) dp, world 2 (gloo)", "walks_node2vec",
        lambda: Node2Vec(g, walk_length=10, num_walks=80, p=0.25, q=4.0,
                         device=dev, mesh=mesh),
        lambda m: m.train(parallel_mode="dp", **sgns), ds, DP_STEP))
    with tempfile.TemporaryDirectory(prefix="ge_s2v_") as tmp:
        runs.append(walk_model(
            "Struc2Vec(mesh=) hs=1, world 2 (gloo)", "walks_struc2vec",
            lambda: Struc2Vec(fl.graph, walk_length=10, num_walks=80,
                              workers=4, temp_path=tmp + "/", device=dev,
                              mesh=mesh),
            lambda m: m.train(embed_size=128, window_size=5, iter=5), fl,
            HS_STEP))
    return dict(lines=lines, runs=runs)


def multihost_phase(card):
    """Phase 28's end: the multi-host example as two processes on cuda:0
    over gloo; rank 0's JSON line."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    cmd = [sys.executable, "-m",
           "graphembedding_tpu_torch.examples.deepwalk_multihost",
           "--coordinator", f"localhost:{port}", "--num-processes", "2",
           "--device", "cuda:0", "--backend", "gloo", "--num-walks", "40",
           "--json"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=HERE,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail(f"deepwalk_multihost: exit codes {[p.returncode for p in procs]}"
             f"\n{outs[0][-2000:]}")
    res = json.loads([ln for ln in outs[0].splitlines()
                      if ln.startswith("{")][-1])
    if (res["processes"], res["walk_overflow"]) != (2, 0) or not \
            res["micro_f1"] >= 0.9:
        fail(f"deepwalk_multihost: {res}")
    print(f"deepwalk_multihost, two processes on cuda:0 over gloo "
          f"(dp, 40 walks a node): {json.dumps(res)}, "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def mesh_walk_phases(card):
    """Phases 27-28: the distributed walk engines in spawned ranks."""
    import torch

    from graphembedding_tpu_torch.parallel.launch import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    [w1] = run_ranks(mesh_walks_world1_rank, 1, backend="nccl",
                     device="cuda:0", threads=4, timeout_s=300)
    for line in w1["lines"]:
        print(f"world 1 (NCCL) {line} [{card}]", flush=True)
    report_mesh_runs([w1["runs"]], card)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    w2 = run_ranks(mesh_walks_world2_rank, 2, backend="gloo",
                   device="cuda:0", threads=4, timeout_s=500)
    for line in w2[0]["lines"]:
        print(f"world 2 (gloo) {line} [{card}]", flush=True)
    report_mesh_runs([w["runs"] for w in w2], card)
    multihost_phase(card)
    print(f"phase 28: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
