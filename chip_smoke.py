#!/usr/bin/env python3
"""Drive the port's main paths on one CUDA card and check them.

    python3 chip_smoke.py    # needs one card

The port's paths, each at the full width of its model on the two graphs of
``bench.py`` (262,144 nodes, about 4.2M edges), and an R-GCN on a graph of
ogbn-mag's full published shape:

* planned SpMM sum: a GCN [512, 512, 47] trains over ``build_spmm_graph``
  plans (K1 on the uniform graph; K2 and K2h on the power-law graph's
  dedup plans);
* exact max/min: a GraphSAGE max-pool [512, 512, 47] trains over chunked
  plans (K4), and ``spmm(reduce='max'/'min')`` runs forward and backward
  at F=512 on the power-law graph built ``minmax='auto'`` (K5) and on the
  uniform graph (K4);
* the CSR segment family: ``sage_forward`` [512, 512, 47] with
  ``aggr='mean'`` (K3) and ``aggr='max'`` (the planned K4) runs forward
  and backward on the uniform graph's CSR;
* the padded gather's backward, G1 (``gather_rows_backward``, the
  gradient of ``x[row.clamp(max=N-1)]``), runs wherever a gathered ``x``
  needs a gradient: ``sage_forward``'s second layer (F=512), GIN,
  PointNet++'s second level, the R-GCN mini-batches (B), paths A, P and
  Q, the distribution's T and E and the GCN and GraphSAGE examples, and
  each of them must launch it; it is held against its plain version (as
  are the paths, under :func:`plain_kernels`) and timed on a batch
  of the products bucket's shape (936,960 edge slots, 17.5% of them pads
  on one row) at F=256 and F=100;
* attention: a GAT [512, 512, 48] with 4 heads trains over chunked plans
  with edge maps on both graphs (K6 for the softmax, K1's ``msgs_padded``
  entry for the aggregation and the softmax backward's row sums);
* range-split plans: a GCN [512, 512, 47] trains over the uniform graph
  built ``range_split=4, range_fused=True, chunk='auto'`` (K7 forward and
  backward), and ``spmm`` runs forward and backward on a weighted fused
  graph (K7 with weights) and on a ``range_split=4`` graph (K1 per range);
* fused multi-aggregation: ``fused_scatter_reduce`` with ``['sum',
  'mean', 'min', 'max']`` and with ``['mean', 'min']`` runs forward and
  backward over the uniform graph's messages in destination order (F=512,
  the index a host array): K4s, the max pass that also sums, for max and
  sum, and for min in its negated form when the sums are still missing;
  the sum-less K4 for min beside a max+sum pass;
* the sorted-COO sums: ``segment_sum_coo`` and ``segment_mean_coo`` over
  the same messages (K3);
* the padded-batch GAT: a ``GATBatch`` [512, 128, 47] with 4 heads, as
  ``init_gat`` builds it, trains on the uniform graph as one padded batch
  of 4,128,768 edge slots (K3);
* the heterogeneous R-GCN [128, 128, 349] trains (Adam) on a graph of
  ogbn-mag's node and edge counts (4 node types, 4 relations, 21.1M
  edges; ``bench/bench_hetero.py``'s generator with Zipf(1.2) sources) in
  its three forms, each a path of its own: per-relation plans built
  ``dedup='auto'`` (K1 and/or K2/K2h, as each side's plan says), the
  stacked plans (``segment_matmul`` and K1m over the padded messages,
  5.1G elements at F=349) and the range-sliced plans (K7 with weights,
  forward and backward). It runs first, in a process of its own
  (``python3 chip_smoke.py --rgcn``, with growable allocator segments):
  the stacked form needs about 55 GB of the card;
* OGB's GIN (5 layers of 300, MLP hidden 600, a head to 47) trains
  (Adam) on the uniform graph's CSR (K3 at F=300); PyG's PointNet++
  (two set-abstraction levels, ``fps`` and ``radius`` each step, max
  pools by K4, F1 for ``fps``) and a DGCNN (k=20, one static ``knn``
  graph) train on 32 clouds of 1,024 points of ``make_cloud``'s shapes;
  GIN and PointNet++ are held against their plain computation, DGCNN
  against the same model on the CPU. The 14 sampled, ``index_sort``,
  spline and geometry ops then run on the card against the CPU (F1 also
  on one cloud of 100,000 points), and F1 is timed beside its plain
  version, a batched plain loop and its latency floor;
* the huge-graph step of ``bench/bench_sharded_huge.py`` at its full
  size (2,000,000 nodes, 30,009,772 edges, F=128, 8 row splits; the value
  and gradient of ``(spmm_sharded(x, g, 'mean', precision)**2).sum()``)
  over ``build_spmm_graph_sharded`` plans, in five variants, each a path
  of its own: uniform columns in bf16, f32 and int8 (K1), with
  ``range_split=4`` (K1 per range) and with max and min (K4); Zipf(1.2)
  columns built ``dedup='off'`` (K1, and K1's pieces over the
  transpose's hub rows of up to 5.6M slots) and ``dedup='auto',
  minmax='auto'`` (K2h and K2 as each split's plan says, K1 and its
  pieces on the chunked backward; K5 for max). It runs in a process of
  its own too (``python3 chip_smoke.py --sharded``); each variant's output
  and gradient are held against the plain versions and against ``spmm``
  over the unsharded graph;
* the host layer, its samples drawn by the C++ engine of
  ``pyg_lib_tpu_torch/csrc/host`` (``sampler._cpp.calls`` must show it
  in every phase): (A) GraphSAGE [602, 256, 41] with the mean aggregator
  trains (Adam) at Reddit's full shape (232,965 nodes, 114.5M edges of
  ``testing.uniform_graph``, 602 features) in batches of 1,024 seeds with
  fanouts [25, 10] from the port's ``NeighborLoader`` (K3 at F=602 and
  256), its loss and gradients held against the plain path on a batch;
  (B) the R-GCN [128, 128, 349] trains in mini-batches of 1,024 papers
  (``HeteroNeighborLoader``, 10 a hop and relation) on the ogbn-mag
  graph, in the R-GCN process after its full-graph forms, one batch's
  loss and gradients held against the CPU; (C)
  ``build_spmm_graph(reorder='on'/'auto')`` on the power-law graph and
  ``'on'`` on the uniform one, ``spmm`` sum, mean and max and their
  gradients held against the same graphs' plain versions and against the
  unreordered graphs (K1, K2/K2h, K4, K5);
  (D) node2vec's walks (p = q = 1 and q = 0.5) and 3 Adam steps of its
  loss on the uniform graph; (E) the port's ``entry()`` against the CPU;
  (P) SAGE [100, 256, 256, 47] (mean) trains (Adam) at ogbn-products'
  full shape (2,449,029 nodes, 123.7M edges of ``testing.uniform_graph``,
  100 features) in disjoint batches of 1,024 seeds with fanouts
  [15, 10, 5] biased by edge weights (K3 at F=100 and 256), is saved with
  ``save_checkpoint`` (model, Adam, loader) and resumed from it to the
  same parameters bit for bit, and its loss and gradients are held against
  the plain path on a batch; (Q) the same with node times and
  ``temporal_strategy='last'`` over time-sorted neighbourhoods; and the
  examples ``train_gcn`` (K3), ``train_gcn_fullgraph_spmm`` (K1),
  ``train_sage_weighted_disjoint`` and ``train_temporal_sage`` (K3) run
  a few steps each, their losses falling. A, C, D, E, P, Q and the
  examples run in a third process (``python3 chip_smoke.py --host``);
* distribution, in a fourth process (``python3 chip_smoke.py --dist``)
  that starts the ranks of the one card (``parallel.spawn``). NCCL's
  answer to four ranks on one card is printed first; then on gloo, with
  CUDA tensors staged through pinned host memory: (H) the GCN of
  ``train_dist_fullgraph.py`` at [128, 256, 172] (ogbn-papers100M's
  features and classes) trains over four ranks of the huge graph's 2M
  nodes and 30,009,772 edges, three Adam steps with
  ``halo_exchange_aggregate`` and three with ``ring_halo_aggregate`` (K3
  in every rank and layer), step 1's output and gradients held against
  one process on the whole graph; (T) GraphSAGE [602, 256, 41] at path
  A's Reddit shape trains data-parallel, each rank's batches from a
  ``DistNeighborLoader`` over its quarter of the seeds (K3 at 602 and
  256), step 1's all-reduced gradient held against the mean of the four
  local ones; (E) ``entry.dryrun_multichip(4)`` on a 2 x 2 mesh; (N) one
  rank over NCCL runs E's steps and H's all-gather aggregation against
  one process. Each rank's K3 launches, step ms, collectives' ms, peak
  memory and rank 0's profiled step are printed.

The script:

1. prints the card's name and power limit and builds every kernel from
   ``pyg_lib_tpu_torch/csrc`` with ``nvcc`` (one process per source);
2. holds each kernel against its plain PyTorch version on the card at
   small shapes (empty rows, partial tiles, -inf rows, ties and both
   zeros, rows far above and below the rest, empty ranges and empty
   tiles, a hub tile of hundreds of chunks, F=600 for K2, a hot_w
   replaced or changed after a K2h call, a K2 plan whose uc leaves room
   for one slab, a hub row of 120,000 edges and a source that is not
   16-byte aligned for K1, K1m, K3, K4 and K7 (K1's and K7's two
   branches must give the same bits); f32, bf16 and int8 where the
   kernel takes them);
3. builds the graphs and holds each kernel against its plain version at
   the main paths' shapes (F=512 and F=47; F=4, the head count, for K6);
4. drives each path with every launch count set to 0 just before it and
   read just after: each kernel of the path must have launched in it (and
   on the fused path, K4s in both its forms; on the range-sliced R-GCN,
   K7 in the forwards and in the backwards);
5. holds each path's result against the same computation through the
   plain versions (where a model's gradient jumps at a kink, a ReLU or
   leaky_relu, the plain computation takes the branch the kernel path
   took: the two paths' rounding would otherwise switch a few of the
   millions of branches at random), and the R-GCN's three forms' outputs
   against each other;
6. times each kernel at F=512 beside its plain version, one PyTorch call
   that computes the same function (timed here only, never used by the
   port; for K4 and K5, which gather x themselves, the gather and the
   reduce in one call) and its bound, times K3 and K4 (through
   ``edge_perm``) on the power-law transpose CSR's hub rows beside
   ``torch.segment_reduce``, and times ``spmm`` by ``bench.py``'s
   useful-bytes metric and the fused path against the composite (one
   scatter per reduction) forward and forward+backward. Each training
   path also gets one profiled step (device time by kernel, idle share;
   peak memory for GAT, the padded-batch GAT and the R-GCN forms). The
   R-GCN part also times ``segment_matmul`` beside one ``torch.mm`` over
   the same rows, and its kernels on its own plans at F=349 (K7 and its
   transpose beside ``torch.sparse.mm``); the huge-graph part times K1
   over the hub rows of the Zipf transpose's first split, cut and uncut,
   beside ``torch.sparse.mm``. The R-GCN's kernel checks hold K2, K2h
   and K7 against f64 sums of their terms (:func:`sums64`), as the
   huge-graph checks do.

It prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. It imports nothing of JAX or of ``pyg_lib_tpu``.
"""

import copy
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
# A kernel and its plain version sum the same f32 terms in another order:
# |kernel - plain| <= SUM_RTOL * Σ|terms| + SUM_ATOL, elementwise. A bf16
# result adds one bf16 step, 2**-8 of its size. K4 and K5 are exact.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
# K6 and its plain version: exponentials a few f32 ulps apart, and each
# row's sum of n terms in another order, at most n * 2**-24 of it apart in
# each: |kernel - plain| <= (1e-5 + n * 2**-23) |plain| + 1e-7 (a bf16
# result adds one bf16 step, 2**-7 |plain|), NaN where the plain has NaN.
K6_RTOL, K6_ATOL = 1e-5, 1e-7
# An f32 K6 row sums to 1 within this: its outputs' f32 rounding adds at
# most 2**-24, and the kernel's sum is a few dozen f32 additions deep (a
# stretch's groups, then its partials 32 lanes wide), a few 1e-6 at most. A hub row's stretch partial
# dropped or counted twice moves the whole row by that stretch's share of
# its sum (1/469 on the 810,552-edge row), which the per-element bound
# above, n * 2**-23 = 9.7% there, would let through.
K6_SUM_TOL = 1e-5
# A model's output and weight gradients pass several such sums and
# matmuls over 262,144 rows.
GCN_RTOL = 1e-4  # of max|plain output| (or of max|plain gradient|)
N_NODES, N_EDGES, F_BENCH = 262_144, 4_194_304, 512
DIMS = [512, 512, 47]
# GAT: ogbn-products' 47 classes rounded up to a multiple of the heads,
# which every width must be (init_gat_spmm).
GAT_DIMS, HEADS = [512, 512, 48], 4
# The padded-batch GAT as init_gat builds it: hidden layers concatenate 4
# heads of 128, the last averages 4 heads of 47 (ogbn-products' classes).
GAT_BATCH_DIMS = [512, 128, 47]
EDGE_BUDGET = 65536  # edge slots of a padded batch come in these steps
FUSED_LISTS = (['sum', 'mean', 'min', 'max'], ['mean', 'min'])
FUSED_CALLS = 2  # forward + backward calls of each list on the fused path
RANGES = 4  # range_split of the range paths (bench_range_split's "S=4f")
HOT_COLUMNS = 4096  # hot level of the power-law forward plan
STEPS = 3
# R-GCN on ogbn-mag's shape: 128 the paper features' width and
# bench/bench_hetero.py's hidden width, 349 the classes. Trained by Adam.
MAG_DIMS = [128, 128, 349]
MAG_CHUNK = 512  # the stacked form's chunk
# The stacked form's [E_pad, F] messages at F=349 must pass this many
# elements, so that the check covers 64-bit offsets.
INT32_ELEMENTS = 2**31
RGCN_LR = 0.01
# The R-GCN process's last line: this, then its launch counts as JSON.
RGCN_RESULT = 'R-GCN launches: '
BLOCK = 128  # feature columns per plain-version call at the bench shape
# The huge graph's step (bench/bench_sharded_huge.py: testing.huge_graph,
# 2,000,000 nodes, 30,009,772 edges): its width, row splits and S2's
# column ranges, and the plain versions' columns a call there (a
# [29.2M, 16] f64 slab for the power-law transpose's first split).
HUGE_F, HUGE_SPLITS, HUGE_RANGES, HUGE_BLOCK = 128, 8, 4, 16
# The sharded process's last line: this, then its results as JSON.
SHARDED_RESULT = 'sharded launches: '
# OGB's GIN (ogb examples/graphproppred/mol/main_pyg.py, --num_layer 5
# --emb_dim 300): 5 layers of 300, MLP hidden 600 (hidden_mult 2), here on
# the uniform graph's CSR with x at F=300 and a linear head to 47 classes.
GIN_DIMS, GIN_CLASSES = [300] * 6, 47
# With no batch norm (the JAX package's GIN has none), each layer's sum
# over about 15.5 neighbours grows the activations some 16-fold: unit
# features gave logits near 1e4 and a rising loss (16,023 to 47,801 in 3
# Adam steps on the H100), so the features are drawn at this scale.
GIN_X_SCALE = 1e-4
# Adam's first steps move every weight by about the learning rate, which
# 5 such layers compound: at 1e-3 the loss rose (4.3 to 32 in 5 steps on a
# 20,000-node uniform graph on the CPU), at 1e-4 it falls.
GIN_LR = 1e-4
# PyG's examples/pointnet2_classification.py without batch norm and
# dropout: SA levels (ratio, r, input features, MLP), the global MLP over
# [x, pos] and the head; radius(max_num_neighbors=64); 32 clouds of 1,024
# points of make_cloud's shapes (seed 0) in place of ModelNet; 10 classes.
CLOUDS, CLOUD_POINTS, POINT_CLASSES = 32, 1024, 10
SA_LEVELS = ((0.5, 0.2, 0, [64, 64, 128]), (0.25, 0.4, 128, [128, 128, 256]))
GLOBAL_MLP, PN_HEAD = [259, 256, 512, 1024], [1024, 512, 256, POINT_CLASSES]
RADIUS_CAP = 64
# PyG's examples/dgcnn_classification.py with one static knn graph per
# cloud: k=20, EdgeConv [3, 64, 128], a max over each cloud, a head.
DGCNN_K, DGCNN_DIMS = 20, [3, 64, 128]
DGCNN_HEAD = [128, 1024, 512, 256, POINT_CLASSES]
POINT_LR = 1e-3
# The device-op phase: F1 alone on one cloud of BIG_CLOUD points (ratio
# BIG_RATIO); spline_weighting at PyG examples/faust.py's SplineConv(., 32,
# dim=3, kernel_size=5) widths over the FAUST mesh's 41,328 directed edges
# (6,890 vertices, 13,776 faces), M_in 1 (conv1) and 32; graclus_cluster
# and edge_sample on a graph of GRACLUS_NODES nodes.
BIG_CLOUD, BIG_RATIO = 100_000, 0.1
# F1 is also timed on BIG_BATCH clouds of BIG_CLOUD points (a batch of
# LiDAR scans: SemanticKITTI's hold about 120,000 points) and on one cloud
# of HUGE_CLOUD points at HUGE_RATIO (RandLA-Net's scale).
BIG_BATCH = 8
HUGE_CLOUD, HUGE_RATIO = 1_000_000, 0.01
# DGCNN's dynamic EdgeConv layers run knn over 64 features a point: knn is
# timed there (cosine) with its dot products summed one feature at a time
# and with them from one GEMM a block.
KNN_FEATURES = 64
FAUST_EDGES, SPLINE_KERNEL, SPLINE_OUT = 41_328, 5, 32
GRACLUS_NODES = 20_000
# A knn, radius or nearest pair may differ between the card and the CPU
# only where its f64 distance lies within this of the k-th distance or r².
PAIR_RTOL = 1e-6
# The earlier designs' times of K5 (its [N, F] key table), K6 (a warp
# per row) and F1 (one block a cloud) on this script's shapes, printed
# beside the current ones (NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
EARLIER_MS = {'K5': 5.251, 'K6': 0.342, 'K6 hub rows': 60.877,
              'F1 32 clouds of 1024, ratio 0.5 (SA1)': 0.540,
              'F1 one cloud of 100000, ratio 0.1': 616.6}
# Path A, Reddit's mini-batch GraphSAGE (PyG examples/reddit.py;
# BASELINE.json config 2): the dataset's 232,965 nodes, 114,615,892 edges,
# 602 features, 41 classes and 153,431 training nodes, here a uniform
# graph of that size (testing.uniform_graph, seed 0) with random features;
# GraphSAGE [602, 256, 41] with the mean aggregator, Adam at 0.01,
# batches of 1,024 seeds with fanouts [25, 10] through NeighborLoader.
REDDIT_NODES, REDDIT_EDGES, REDDIT_TRAIN = 232_965, 114_615_892, 153_431
REDDIT_DIMS, REDDIT_LR = [602, 256, 41], 0.01
REDDIT_BATCH, REDDIT_FANOUTS = 1024, [25, 10]
REDDIT_WARMUP, REDDIT_STEPS = 2, 8
REDDIT_PROFILED = 4  # then a profiled window of this many steps
# Path B, ogbn-mag's R-GCN in mini-batches (PyG
# examples/hetero/to_hetero_mag.py): 1,024 paper seeds, two hops of 10 per
# relation, the padded batch through RGCNBatch [128, 128, 349] (MAG_DIMS).
MAG_BATCH, MAG_FANOUTS, MAG_BATCH_STEPS = 1024, [10, 10], 3
# Path D, node2vec (PyG examples/node2vec.py): walks of 20 steps, a
# context of 10 nodes, 10 walks a start node, one negative, embedding 128,
# 128 start nodes a batch; on the uniform bench graph, p = q = 1 and
# p = 1, q = 0.5, 3 Adam steps each.
WALK_LENGTH, CONTEXT, WALKS_PER_NODE, NEGATIVES = 20, 10, 10, 1
N2V_DIM, N2V_BATCH, N2V_STEPS, N2V_LR = 128, 128, 3, 0.01
# Path P, ogbn-products' GraphSAGE with weighted, disjoint sampling (PyG
# examples/ogbn_products_sage.py; BASELINE.json config 3;
# examples/train_sage_weighted_disjoint.py): the dataset's 2,449,029 nodes,
# 123,718,280 directed edges (OGB's 61,859,140 undirected ones, both ways),
# 100 features, 47 classes and 196,615 training nodes, here a uniform graph
# of that size (testing.uniform_graph, seed 0) with random features and
# edge weights uniform in [0.05, 1); SAGE [100, 256, 256, 47] with the
# mean aggregator, Adam at 0.003, batches of 1,024 seeds, fanouts
# [15, 10, 5], disjoint, biased by the weights. The epoch is cut to the
# warm-up, timed and profiled steps; a checkpoint at its end, then
# PRODUCTS_RESUME steps run twice: on, and from the restored checkpoint.
PRODUCTS_NODES, PRODUCTS_EDGES = 2_449_029, 123_718_280
PRODUCTS_TRAIN = 196_615
PRODUCTS_DIMS, PRODUCTS_LR = [100, 256, 256, 47], 0.003
PRODUCTS_BATCH, PRODUCTS_FANOUTS = 1024, [15, 10, 5]
PRODUCTS_WARMUP, PRODUCTS_STEPS, PRODUCTS_PROFILED = 2, 5, 3
PRODUCTS_RESUME = 2
# G1's row: a padded batch of the products bucket (the sage-products
# cell's, 1,024 seeds and fanouts [15, 10, 5]): its edge and node slots,
# G1_PAD_SHARE of the entries pads (row = the node slots, clamped onto the
# last row: the 17.3-17.7% the loader's batches carry), the others uniform
# over the first G1_REAL node slots; timed at the model's widths G1_WIDTHS.
G1_EDGE_SLOTS, G1_NODE_SLOTS, G1_REAL = 936_960, 937_984, 600_000
G1_PAD_SHARE, G1_WIDTHS = 0.175, (256, 100)
# Path Q, its temporal variant (examples/train_temporal_sage.py): the same
# graph and model, node times uniform in [0, 100) (seed 3), each
# neighbourhood time-sorted once, temporal_strategy='last'; one epoch of
# TEMPORAL_BATCHES batches, the last TEMPORAL_PROFILED of them profiled.
TEMPORAL_SPAN, TEMPORAL_BATCHES, TEMPORAL_PROFILED = 100, 4, 2
# The last four examples' main() on the card: this many epochs or steps.
EXAMPLE_STEPS = 20
# The host child's last line: this, then its results as JSON.
HOST_RESULT = 'host launches: '
# The distribution child (python3 chip_smoke.py --dist): four ranks on the
# one card, joined by gloo (NCCL refuses two ranks on one GPU; its answer
# is printed), CUDA tensors staged through pinned host memory by
# parallel._collectives. H: examples/train_dist_fullgraph.py's GCN at
# ogbn-papers100M's 128 features and 172 classes (BASELINE.json config 5),
# hidden 256, on the huge graph (testing.huge_graph, 2M nodes, 30,009,772
# edges) edge-partitioned over the four ranks; DIST_STEPS Adam steps with
# each halo aggregation. T: PyG examples/multi_gpu/distributed_sampling.py
# at path A's Reddit shape: SAGE [602, 256, 41] mean, 1,024 seeds a rank,
# fanouts [25, 10], DistNeighborLoader over 4 partitions, gradients
# averaged; DIST_T_WARMUP + DIST_T_STEPS steps.
DIST_RANKS, DIST_DIMS, DIST_LR, DIST_STEPS = 4, [128, 256, 172], 1e-2, 3
DIST_TRAIN_SHARE = 0.5  # H's training mask: about half the nodes
DIST_T_WARMUP, DIST_T_STEPS = 2, 4
DIST_RESULT = 'dist launches: '
# Launch counters of the kernel wrappers: id -> (wrapper in ops, counter).
COUNTERS = {'K1': ('spmm_chunked', 'launches'),
            'K2': ('dedup_sum', 'launches'),
            'K2h': ('dedup_sum', 'hot_launches'),
            'K3': ('segment_sum_csr_kernel', 'launches'),
            'K4': ('segment_max_kernel', 'launches'),
            'K4s': ('segment_max_kernel', 'sum_launches'),
            'K5': ('dedup_minmax', 'launches'),
            'K6': ('segment_softmax_planned', 'launches'),
            'K7': ('fused_range_sum', 'launches'),
            'K1m': ('segment_sum_chunked', 'launches'),
            'K1p': ('spmm_chunked', 'piece_launches'),
            'F1': ('fps_kernel', 'launches'),
            'G1': ('gather_rows_backward', 'launches')}
SOURCES = {
    'K1': ('spmm_chunked.cu', 'pyg_lib_tpu/ops/pallas/spmm_chunked.py:279'),
    'K2': ('spmm_dedup.cu', 'pyg_lib_tpu/ops/pallas/spmm_dedup.py:527'),
    'K2h': ('spmm_dedup.cu', 'pyg_lib_tpu/ops/pallas/spmm_dedup.py:542'),
    'K3': ('segment_csr.cu',
           'pyg_lib_tpu/ops/pallas/segment_csr_kernel.py:47'),
    'K4': ('segment_minmax.cu',
           'pyg_lib_tpu/ops/pallas/segment_minmax_kernel.py:59'),
    'K4s': ('segment_minmax.cu',
            'pyg_lib_tpu/ops/pallas/segment_minmax_kernel.py:59'),
    'K5': ('spmm_dedup_minmax.cu',
           'pyg_lib_tpu/ops/pallas/spmm_dedup_minmax.py:292'),
    'K6': ('segment_softmax.cu',
           'pyg_lib_tpu/ops/pallas/segment_softmax_kernel.py:47'),
    'K7': ('spmm_range_fused.cu',
           'pyg_lib_tpu/ops/pallas/spmm_range_fused.py:221'),
    'K1m': ('spmm_chunked.cu', 'pyg_lib_tpu/ops/pallas/spmm_chunked.py:279'),
    'K1p': ('spmm_chunked.cu', 'pyg_lib_tpu/ops/pallas/spmm_chunked.py:279'),
    'F1': ('fps.cu', 'pyg_lib_tpu/ops/geometry.py:59'),
    'G1': ('gather_rows.cu', 'pyg_lib_tpu/models/gnn.py:34'),
}


def range_graphs(rp, cl):
    """The range paths' graphs over the uniform graph ``(rp, cl)``: built
    ``range_split=RANGES, range_fused=True`` (K7), ``range_split=RANGES``
    (K1 per range) and weighted fused over RANGES equal bounds (K7 with
    weights), all ``chunk='auto'``; and the weights (seed 2)."""
    from pyg_lib_tpu_torch import ops

    g_uf = ops.build_spmm_graph(rp, cl, range_split=RANGES, range_fused=True,
                                chunk='auto')
    g_ur = ops.build_spmm_graph(rp, cl, range_split=RANGES, chunk='auto')
    quarter = -(-N_NODES // RANGES)
    bounds = [(i * quarter, min((i + 1) * quarter, N_NODES))
              for i in range(RANGES)]
    w = np.random.default_rng(2).normal(size=cl.shape[0]).astype(np.float32)
    g_w = ops.build_weighted_fused_graph(rp, cl, N_NODES, bounds, w,
                                         chunk='auto', bounds_t=bounds)
    return g_uf, g_ur, g_w, w


def ragged_graph(n, e):
    """Geometric row degrees (many empty rows, a few long ones) over ``n``
    rows, a partial last tile when ``n % 128``."""
    rng = np.random.default_rng(3)
    row = np.minimum(rng.geometric(0.01, e) - 1, n - 1)
    order = np.argsort(row, kind='stable')
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=rowptr[1:])
    return rowptr, rng.integers(0, n, e)[order].astype(np.int64)


class ByWidth:
    """A kernel's C entry point that also counts its calls by kernel id
    (``kid(args)``) and width (argument ``at``)."""

    def __init__(self, fn, at, kid):
        self.fn, self.at, self.kid = fn, at, kid
        self.argtypes, self.restype = fn.argtypes, fn.restype
        self.counts = {}

    def __call__(self, *args):
        key = (self.kid(args), args[self.at])
        self.counts[key] = self.counts.get(key, 0) + 1
        return self.fn(*args)


def one_element_in(t):
    """A copy of the contiguous ``t`` one element into a fresh storage: not
    16-byte aligned."""
    return t.new_empty(t.numel() + 1)[1:].view(t.shape).copy_(t)


def bits(t):
    """Tensor to compare bit for bit (-0.0 and +0.0 told apart)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def k6_row_sum_err(out, plan, idx=None):
    """The largest |sum - 1| over the rows of a K6 output, each row summed
    in f64 over its slots; rows of no slot and NaN columns are left out."""
    import torch

    from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import _padded_rows

    slot, row = _padded_rows(plan.tile_ptr)
    at = slot if idx is None else idx[slot].long()
    sums = torch.zeros((plan.num_rows, out.shape[1]), dtype=torch.float64,
                       device=out.device).index_add_(0, row, out[at].double())
    full = torch.bincount(row, minlength=plan.num_rows) > 0
    dev = (sums[full] - 1.0).abs().nan_to_num(0.0)
    return float(dev.max()) if dev.numel() else 0.0


def by_columns(fn, src, *args, block=BLOCK):
    """A plain version whose columns are independent, run on ``block``
    columns of ``src`` at a time and joined: keeps its ``[E, F]``
    temporaries to ``[E, block]`` at the bench shape."""
    import torch

    outs = [fn(src[:, f0:f0 + block].contiguous(), *args)
            for f0 in range(0, src.shape[1], block)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, 1) for parts in zip(*outs))
    return torch.cat(outs, 1)


def tie_values(n, f, gen, dev):
    """Values with many ties, both zeros and -inf (some rows all -inf)."""
    import torch

    choice = torch.tensor([-2.0, -0.0, 0.0, 1.0, float('-inf')], device=dev)
    v = choice[torch.randint(0, 5, (n, f), generator=gen, device=dev)]
    v[::7] = float('-inf')
    return v


def relu_signs(fn, replay=None):
    """Run ``fn()``; return its result and, for each ``leaky_relu`` and
    ``torch.relu`` call it made, in order, which inputs were > 0 (the
    branch taken). With ``replay``, such a list from another run, each
    call takes the recorded branch instead (``where(sign, x, slope·x)``,
    0 for relu): a plain path then takes the kernel path's branches."""
    import torch
    from torch.overrides import TorchFunctionMode

    leaky = torch.nn.functional.leaky_relu
    signs = [] if replay is None else list(replay)
    at = [0]

    class Record(TorchFunctionMode):

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is not leaky and func is not torch.relu:
                return func(*args, **kwargs)
            x = args[0]
            if replay is None:
                signs.append(x.detach() > 0)
                return func(*args, **kwargs)
            sign = signs[at[0]].to(x.device)
            at[0] += 1
            if func is torch.relu:
                return torch.where(sign, x, torch.zeros_like(x))
            slope = kwargs.get('negative_slope',
                               args[1] if len(args) > 1 else 0.01)
            return torch.where(sign, x, x * slope)

    with Record():
        result = fn()
    return result, signs


def plain_gat_batch(params, x, rowptr, row, col, signs=None):
    """``gat_forward`` through the plain versions: the plain K3
    (``segment_sum_csr_plain``) in place of K3. With ``signs``, from
    :func:`relu_signs` on the kernel path, each layer's leaky_relu
    takes the kernel path's branch: a logit within the two paths'
    rounding difference of 0 would otherwise switch slope (1 or 0.2) and
    move an attention-weight gradient by 0.8 |g·h|. Returns the output
    and the count of edge logits (pad edges left out) whose own branch
    differs from ``signs``."""
    import torch

    from pyg_lib_tpu_torch import ops

    heads, n = params['heads'], x.shape[0]
    switched = 0
    src, dst = row.clamp(max=n - 1), col.clamp(max=n - 1)
    pad = (col >= n)[:, None]
    layers = params['layers']
    for i, layer in enumerate(layers):
        d = layer['att_src'].shape[-1]
        h = (x @ layer['w']).view(n, heads, d)
        a_s = (h * layer['att_src']).sum(-1)
        a_d = (h * layer['att_dst']).sum(-1)
        pre = a_s[src] + a_d[dst]
        if signs is None:
            logits = torch.nn.functional.leaky_relu(pre, 0.2)
        else:
            switched += int(((signs[i] != (pre > 0)) & ~pad).sum())
            logits = torch.where(signs[i], pre, 0.2 * pre)
        del pre
        logits = logits.masked_fill(pad, float('-inf'))
        alpha = ops.scatter_softmax(logits, dst, 0, n).masked_fill(pad, 0.0)
        msgs = (h[src] * alpha[:, :, None]).reshape(src.shape[0], -1)
        agg = ops.segment_sum_csr_plain(msgs, rowptr).view(n, heads, d)
        del msgs
        if i < len(layers) - 1:
            x = torch.nn.functional.elu(agg.reshape(n, heads * d) +
                                        layer['b'])
        else:
            x = agg.mean(1) + layer['b']
    return x, switched


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyg_lib_tpu_torch import _build, ops
    from pyg_lib_tpu_torch.models import (GAT, GCN, SAGE, GATBatch,
                                          sage_forward)
    from pyg_lib_tpu_torch.ops.kernels.plan_cache import plan_for_ptr
    from pyg_lib_tpu_torch.ops.kernels.segment_minmax import POS_NONE
    from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import _padded_rows
    from pyg_lib_tpu_torch.ops.kernels.spmm_dedup_minmax import K5_SEG
    from pyg_lib_tpu_torch.ops.scatter_reduce import _fused as fused_closure
    from pyg_lib_tpu_torch.testing import powerlaw_graph, uniform_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    smi = card()
    print(smi, flush=True)

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        host_build = pool.submit(_build.build_host)
        _build.build()
        host_build.result()
    print(f'kernel build: {time.perf_counter() - t0:.1f} s '
          f'({", ".join(_build.sources())}; and the host sampling engine '
          f'{host_build.result().name} with g++)', flush=True)
    for name in _build.sources():
        log = (_build.BUILD_DIR / f'{name}.log').read_text()
        regs = [int(w) for w in re.findall(r'Used (\d+) registers', log)]
        spills = len(re.findall(r'[1-9]\d* bytes spill stores', log))
        print(f'  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} '
              f'registers, {spills} with spill stores', flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {k: 0.0 for k in COUNTERS}

    def plain(xm, plan, scale=None):
        if isinstance(plan, ops.DedupSpmmPlan):
            return ops.dedup_sum_plain(xm, plan, scale)
        if isinstance(plan, ops.FusedRangePlan):
            return ops.fused_range_plain(xm, plan, scale)
        if isinstance(plan, ops.RangeSpmmPlan):
            return sum(ops.spmm_chunked_plain(xm[lo:hi], p, scale)
                       for (lo, hi), p in zip(plan.bounds, plan.plans))
        return ops.spmm_chunked_plain(xm, plan, scale)

    def kernel(xm, plan, scale=None):
        if isinstance(plan, ops.DedupSpmmPlan):
            return ops.dedup_sum(xm, plan, scale)
        if isinstance(plan, ops.FusedRangePlan):
            return ops.fused_range_sum(xm, plan, scale)
        if isinstance(plan, ops.RangeSpmmPlan):
            return sum(ops.spmm_chunked(xm[lo:hi], p, scale)
                       for (lo, hi), p in zip(plan.bounds, plan.plans))
        return ops.spmm_chunked(xm, plan, scale)

    def abs_plan(plan):
        """The plan with |weights|: its plain sum of |x| is Σ|terms|."""
        if isinstance(plan, ops.FusedRangePlan):
            if plan.weights is None:
                return plan
            return plan._replace(weights=tuple(w.abs()
                                               for w in plan.weights))
        if not isinstance(plan, ops.DedupSpmmPlan) or not plan.weighted:
            return plan
        meta = plan.edge_meta.clone()
        meta[:, 2, :] = meta[:, 2, :].view(torch.float32).abs().view(
            torch.int32)
        hot_w = None if plan.hot_w is None else plan.hot_w.abs()
        return plan._replace(edge_meta=meta, hot_w=hot_w)

    def check_sum(label, kid, got, ref, mag, bf16=False):
        err = (got.float() - ref.float()).abs()
        tol = SUM_RTOL * mag + SUM_ATOL
        if bf16:
            tol = tol + 2.0**-8 * ref.float().abs()
        e = float(err.max()) if err.numel() else 0.0
        errs[kid] = max(errs[kid], e)
        print(f'  {kid} {label}: max_abs_err {e:.3g} (tolerance '
              f'{SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g}'
              f'{" + 2^-8 |plain|" if bf16 else ""})', flush=True)
        if not torch.isfinite(got).all() or bool((err > tol).any()):
            raise AssertionError(f'{kid} {label} disagrees with its plain '
                                 f'version: max_abs_err {e}')
        return e

    def check(label, kid, xm, plan, scale=None):
        got = kernel(xm, plan, scale)
        torch.cuda.synchronize()
        ref = plain(xm, plan, scale)
        xa = xm.abs() if xm.dtype != torch.int8 else xm.abs().to(torch.int8)
        mag = plain(xa, abs_plan(plan), None if scale is None else
                    scale.abs())
        return check_sum(label, kid, got, ref, mag)

    def check_exact(label, kid, got, ref):
        """Values and positions of K4/K5 against their plain version, bit
        for bit."""
        torch.cuda.synchronize()
        same = all(g.shape == r.shape and torch.equal(bits(g), bits(r))
                   for g, r in zip(got, ref))
        diff = torch.where(got[0] == ref[0], torch.zeros_like(got[0]),
                           (got[0] - ref[0]).abs())
        e = float(diff.max()) if diff.numel() else 0.0
        errs[kid] = max(errs[kid], e)
        print(f'  {kid} {label}: max_abs_err {e:.3g}, values and positions '
              f'{"equal bit for bit" if same else "DIFFER"}', flush=True)
        if not same:
            raise AssertionError(f'{kid} {label} disagrees with its plain '
                                 f'version')
        return e

    def check_k3(label, src, ptr):
        got = ops.segment_sum_csr_kernel(src, ptr)
        torch.cuda.synchronize()
        ref = by_columns(ops.segment_sum_csr_plain, src, ptr)
        mag = by_columns(ops.segment_sum_csr_plain, src.abs().float(), ptr)
        return check_sum(label, 'K3', got, ref, mag,
                         bf16=src.dtype == torch.bfloat16)

    def check_k4(label, src, plan, idx, negate=False):
        got = ops.segment_max_kernel(src, plan, idx, negate)
        ref = by_columns(ops.segment_max_plain, src, plan, idx, negate)
        return check_exact(label, 'K4', got, ref)

    def check_k4s(label, src, plan, idx, negate=False):
        """K4s: values and positions bit for bit those of the sum-less K4
        and of the plain version, sums within the sum tolerance (equal
        where the plain sum is infinite)."""
        got = ops.segment_max_kernel(src, plan, idx, negate, with_sum=True)
        sumless = ops.segment_max_kernel(src, plan, idx, negate)
        torch.cuda.synchronize()
        if not all(torch.equal(bits(g), bits(r))
                   for g, r in zip(got[:2], sumless)):
            raise AssertionError(f'K4s {label}: values or positions differ '
                                 f'from the sum-less K4')
        ref = by_columns(lambda s, *a: ops.segment_max_plain(
            s, *a, with_sum=True), src, plan, idx, negate)
        check_exact(f'{label} (values, positions)', 'K4s', got[:2], ref[:2])
        fin = torch.isfinite(ref[2])
        if not torch.equal(got[2][~fin], ref[2][~fin]):
            raise AssertionError(f'K4s {label}: infinite sums differ')
        mag = by_columns(lambda s, *a: ops.segment_max_plain(
            s, *a, with_sum=True)[2], src.abs().nan_to_num(posinf=0.0), plan,
            idx)
        return check_sum(f'{label} (sums of finite rows)', 'K4s',
                         torch.where(fin, got[2], 0.0),
                         torch.where(fin, ref[2], 0.0), mag)

    def check_k5(label, x, plan, negate=False):
        got = ops.dedup_minmax(x, plan, negate)
        ref = by_columns(ops.dedup_minmax_plain, x, plan, negate)
        return check_exact(label, 'K5', got, ref)

    def check_msgs(label, msgs, plan):
        """K1's msgs_padded entry against its plain version."""
        got = ops.segment_sum_chunked(msgs, plan)
        torch.cuda.synchronize()
        ref = by_columns(ops.segment_sum_chunked_plain, msgs, plan)
        mag = by_columns(ops.segment_sum_chunked_plain, msgs.abs(), plan)
        return check_sum(label, 'K1m', got, ref, mag)

    def check_k6(label, src, plan, idx=None):
        """K6 against its plain version, within the bound of K6_RTOL."""
        got = ops.segment_softmax_planned(src, plan, idx)
        torch.cuda.synchronize()
        ref = by_columns(ops.segment_softmax_plain, src, plan, idx).float()
        slot, row = _padded_rows(plan.tile_ptr)
        at = slot if idx is None else idx[slot].long()
        n = torch.zeros(ref.shape[0], device=dev)
        n[at] = torch.bincount(row, minlength=plan.num_rows)[row].float()
        del slot, row, at
        nan = torch.isnan(ref)
        mag = ref.abs().masked_fill(nan, 0.0)
        err = (got.float() - ref).abs().masked_fill(nan, 0.0)
        rtol = K6_RTOL + n[:, None] * 2.0**-23
        if src.dtype == torch.bfloat16:
            rtol = rtol + 2.0**-7
        e = float(err.max()) if err.numel() else 0.0
        errs['K6'] = max(errs['K6'], e)
        same_nan = torch.equal(torch.isnan(got.float()), nan)
        # The row sums only in f32: a bf16 output's rounding moves a row's
        # sum by up to 2^-9, and the f32 cases run the same merges.
        row_sum = (k6_row_sum_err(got, plan, idx)
                   if got.dtype == torch.float32 else 0.0)
        print(f'  K6 {label}: max_abs_err {e:.3g} (tolerance ({K6_RTOL:g} + '
              f'n * 2^-23{" + 2^-7" if src.dtype == torch.bfloat16 else ""})'
              f' |plain| + {K6_ATOL:g}); NaN '
              f'{"where" if same_nan else "NOT where"} the plain version has '
              f'NaN' + (f'; rows sum to 1 within {row_sum:.3g} (tolerance '
                        f'{K6_SUM_TOL:g})' if got.dtype == torch.float32
                        else ''), flush=True)
        if (got.dtype != src.dtype or not same_nan
                or bool((err > rtol * mag + K6_ATOL).any())
                or row_sum > K6_SUM_TOL):
            raise AssertionError(f'K6 {label} disagrees with its plain '
                                 f'version: max_abs_err {e}, row sum off '
                                 f'by {row_sum}')
        if idx is None and bool(got[~plan.valid_mask].float().abs().sum()):
            raise AssertionError(f'K6 {label} wrote a pad slot')
        return e

    def k6_values(rows, f, plan, idx, dtype):
        """Logits with rows far above (+200) and far below (-200) the rest,
        -inf at some rows' first slot and a row of -inf in column 0."""
        slot, row = _padded_rows(plan.tile_ptr)
        at = slot if idx is None else idx[slot].long()
        v = torch.randn((rows, f), generator=gen, device=dev) * 4
        shift = torch.zeros(plan.num_rows, device=dev)
        shift[0::13] = 200.0
        shift[5::17] = -200.0
        v[at] += shift[row][:, None]
        bounds = plan.tile_ptr[:, 0, :128].reshape(-1)[:plan.num_rows].long()
        first = bounds[3::11]
        hit = torch.isin(slot, first)
        v[at[hit], 0] = float('-inf')
        v[at[row == 23], 0] = float('-inf')
        return v.to(dtype)

    def modes(x):
        xq, scale = ops.quantize_columns(x)
        return [('f32', x, None), ('bf16', x.to(torch.bfloat16), None),
                ('int8', xq, scale)]

    # -- 2. kernel checks at small shapes -------------------------------
    print('kernel checks (small plans):', flush=True)
    rp_u, cl_u = uniform_graph(1000, 16000)
    rp_p, cl_p = powerlaw_graph(3000, 40000)
    rp_r, cl_r = ragged_graph(1000, 12000)
    rng = np.random.default_rng(1)
    w_p = rng.normal(size=cl_p.shape[0]).astype(np.float32)
    k1_plans = [('uniform', ops.build_spmm_plan(rp_u, cl_u, chunk=128)),
                ('powerlaw', ops.build_spmm_plan(rp_p, cl_p, chunk=256))]
    plain_dedup = ops.build_dedup_plan(rp_p, cl_p, ec=256, hot='off')
    hot_i8 = ops.build_dedup_plan(rp_p, cl_p, ec=256)
    if hot_i8.hot_w is None or hot_i8.hot_w.dtype != torch.int8:
        raise AssertionError('small power-law plan has no int8 hot level')
    # The transposed power-law graph: its hub rows give one tile hundreds
    # of chunks, which K2's chunk ranges split at many points.
    t_rp = np.zeros(3001, np.int64)
    np.cumsum(np.bincount(cl_p, minlength=3000), out=t_rp[1:])
    t_cl = np.repeat(np.arange(3000), np.diff(rp_p))[
        np.argsort(cl_p, kind='stable')]
    hub_dedup = ops.build_dedup_plan(t_rp, t_cl, ec=128, uc=64, hot='off')
    if np.bincount(hub_dedup.chunk_tile.cpu().numpy()).max() < 100:
        raise AssertionError('the hub-tile K2 plan has no tile of 100 '
                             'chunks')
    with torch.inference_mode():  # tables cached without version counters
        hot_inf = ops.build_dedup_plan(rp_p, cl_p, ec=256)
    k2_plans = [
        ('K2', 'plain', plain_dedup),
        # f32 x leaves room for one slab of 1024 unique rows, not two.
        ('K2', 'one slab', ops.build_dedup_plan(rp_p, cl_p, ec=1024, uc=1024,
                                                hot='off')),
        ('K2', 'weighted', ops.build_dedup_plan(rp_p, cl_p, ec=256,
                                                hot='off', edge_weight=w_p)),
        ('K2', 'hub tiles', hub_dedup),
        ('K2h', 'hot int8', hot_i8),
        ('K2h', 'hot bf16', hot_i8._replace(
            hot_w=hot_i8.hot_w.to(torch.bfloat16))),
        ('K2h', 'hot f32 weighted', ops.build_dedup_plan(
            rp_p, cl_p, ec=256, edge_weight=w_p)),
        ('K2h', 'hot int8, built under inference_mode', hot_inf),
    ]
    for f in (47, 128, 600):
        x = torch.randn((3000, f), generator=gen, device=dev)
        for mode, xm, scale in modes(x):
            if f != 600:
                for gname, plan in k1_plans:
                    check(f'{gname} F={f} {mode}', 'K1', xm[:1000] if
                          gname == 'uniform' else xm, plan, scale)
            for kid, pname, plan in k2_plans:
                check(f'{pname} F={f} {mode}', kid, xm, plan, scale)
        # K2h caches the row list of hot_w's non-zeros: it must follow a
        # hot_w given by _replace after a first call, and one changed in
        # place.
        plan = hot_i8._replace(hot_w=hot_i8.hot_w.clone())
        kernel(x, plan)
        plan = plan._replace(hot_w=plan.hot_w.roll(37, 0))
        check(f'hot int8, hot_w replaced after a call, F={f} f32', 'K2h', x,
              plan)
        plan.hot_w[plan.hot_w == 1] = 2
        plan.hot_w[:5] = 1
        check(f'hot int8, hot_w changed in place, F={f} f32', 'K2h', x, plan)

    # K3 over a ragged CSR with 5 leading and 9 trailing positions of no
    # row; K4 in its three index modes; K5 on a plain plan, on the
    # transposed power-law graph (hub tiles of many chunks, shared by
    # several blocks) and on a ragged graph (empty rows, a partial tile).
    ptr_r = torch.tensor(rp_r + 5, device=dev)
    k4_plan = ops.build_spmm_plan(rp_r, cl_r, chunk=128, with_edge_maps=True)
    k4_modes = [('padded', k4_plan.col_padded.shape[0], None),
                ('col_padded', 1000, k4_plan.col_padded),
                ('edge_perm', cl_r.shape[0], k4_plan.edge_perm)]
    k5_plans = [
        ('plain', 3000, ops.build_dedup_minmax_plan(rp_p, cl_p, ec=256,
                                                    uc=96)),
        ('hub tiles', 3000, ops.build_dedup_minmax_plan(t_rp, t_cl, ec=128,
                                                        uc=64)),
        ('ragged', 1000, ops.build_dedup_minmax_plan(rp_r, cl_r, ec=128,
                                                     uc=64)),
    ]
    if (np.bincount(k5_plans[1][2].chunk_tile.cpu().numpy()).max() <=
            K5_SEG):
        raise AssertionError('the hub-tile plan has no tile that K5 cuts')
    for f in (47, 128):
        for dtype in (torch.float32, torch.bfloat16):
            src = torch.randn((cl_r.shape[0] + 14, f), generator=gen,
                              device=dev).to(dtype)
            check_k3(f'ragged gap+pad F={f} {str(dtype)[6:]}', src, ptr_r)
        for values in ('normal', 'ties'):
            for mode, rows, idx in k4_modes:
                src = (tie_values(rows, f, gen, dev) if values == 'ties'
                       else torch.randn((rows, f), generator=gen,
                                        device=dev))
                for negate in (False, True):
                    check_k4(f'{mode} F={f} {values} negate={negate}', src,
                             k4_plan, idx, negate)
                    check_k4s(f'{mode} F={f} {values} negate={negate}', src,
                              k4_plan, idx, negate)
            for pname, rows, plan in k5_plans:
                x = (tie_values(rows, f, gen, dev) if values == 'ties'
                     else torch.randn((rows, f), generator=gen, device=dev))
                for negate in (False, True):
                    check_k5(f'{pname} F={f} {values} negate={negate}', x,
                             plan, negate)

    # K3 and K4 on a hub row of 120,000 edges among 2,000 short rows (a
    # third of them empty), from a src at the start of its storage and
    # from one a single element into it (not 16-byte aligned: the kernels'
    # scalar branch), at F = 1, 3, 47 and 600.
    rng_h = np.random.default_rng(5)
    deg_h = rng_h.geometric(0.1, 2000) - 1
    deg_h[rng_h.random(2000) < 0.33] = 0
    deg_h[700] = 120_000
    rp_h = np.zeros(2001, np.int64)
    np.cumsum(deg_h, out=rp_h[1:])
    cl_h = rng_h.integers(0, 2000, int(rp_h[-1]))
    ptr_h = torch.tensor(rp_h + 3, device=dev)  # a gap of 3, a pad of 5
    hub_plan = ops.build_spmm_plan(rp_h, cl_h, chunk=128, with_edge_maps=True)
    hub_modes = [('padded', hub_plan.col_padded.shape[0], None),
                 ('col_padded', 2000, hub_plan.col_padded),
                 ('edge_perm', cl_h.shape[0], hub_plan.edge_perm)]
    for f in (1, 3, 47, 600):
        e = int(rp_h[-1]) + 8
        for dtype in (torch.float32, torch.bfloat16):
            big = torch.randn(e * f + 1, generator=gen, device=dev).to(dtype)
            for where, src in (('aligned', big[:-1].view(e, f)),
                               ('unaligned', big[1:].view(e, f))):
                check_k3(f'hub row {where} F={f} {str(dtype)[6:]}', src,
                         ptr_h)
        for values in ('normal', 'ties'):
            for mode, rows, idx in hub_modes:
                big = (tie_values(rows + 1, f, gen, dev) if values == 'ties'
                       else torch.randn((rows + 1, f), generator=gen,
                                        device=dev)).reshape(-1)
                for where, src in (
                        ('aligned', big[:rows * f].view(rows, f)),
                        ('unaligned', big[1:rows * f + 1].view(rows, f))):
                    check_k4(f'hub row {mode} {where} F={f} {values}', src,
                             hub_plan, idx, negate=where == 'unaligned')
                    for negate in (False, True):
                        check_k4s(f'hub row {mode} {where} F={f} {values} '
                                  f'negate={negate}', src, hub_plan, idx,
                                  negate)
    del big, src

    # K1 (both entries) and K7 (S = 1, 2 and 4, with and without weights)
    # on the same hub row, from x at the start of its storage and from a
    # copy one element into another (the scalar branch; when aligned,
    # F=512 takes the vector branch in every type and F=600 in f32 and
    # bf16), f32, bf16 and int8 with its column scale where the kernel
    # takes it: each within the sum tolerance, and the two sources'
    # outputs equal bit for bit.
    w_h = rng_h.normal(size=cl_h.shape[0]).astype(np.float32)
    sum_plans = [('K1', 'K1', hub_plan), ('K1m', 'K1m', hub_plan)] + [
        ('K7', f'K7 S={s}{"" if w is None else " weighted"}',
         ops.build_fused_range_plan(rp_h, cl_h, 2000, s, chunk=128,
                                    edge_weight=w))
        for s in (1, 2, 4) for w in (None, w_h)]
    e_pad_h = hub_plan.col_padded.shape[0]
    for f in (1, 3, 47, 512, 600):
        x = torch.randn((e_pad_h, f), generator=gen, device=dev)
        for mode, xm, scale in modes(x):
            for kid, name, plan in sum_plans:
                weighted = getattr(plan, 'weights', None) is not None
                if mode == 'int8' and weighted:
                    continue  # refused on weighted plans
                rows = e_pad_h if kid == 'K1m' else 2000
                outs = []
                for where, src in (('aligned', xm[:rows]),
                                   ('unaligned', one_element_in(xm[:rows]))):
                    label = f'hub row {name} {where} F={f} {mode}'
                    if kid == 'K1m':
                        check_msgs(label, src, plan)
                        outs.append(ops.segment_sum_chunked(src, plan))
                    else:
                        check(label, kid, src, plan, scale)
                        outs.append(kernel(src, plan, scale))
                if not torch.equal(bits(outs[0]), bits(outs[1])):
                    raise AssertionError(f'{name} F={f} {mode}: the aligned '
                                         f'and the unaligned x give other '
                                         f'bits')
    del x, xm, outs

    # K6 over a ragged plan (empty rows, a partial tile), a uniform plan
    # and the transposed power-law graph (hub rows of many chunks), in the
    # padded mode and through edge_perm; K1's msgs_padded entry over the
    # same plans.
    k6_plans = [('ragged', k4_plan),
                ('uniform', ops.build_spmm_plan(rp_u, cl_u, chunk=128,
                                                with_edge_maps=True)),
                ('hub rows', ops.build_spmm_plan(t_rp, t_cl, chunk=128,
                                                 with_edge_maps=True))]
    for pname, plan in k6_plans:
        for f in (1, 4, 47, 512):
            for dtype in (torch.float32, torch.bfloat16):
                for mode, idx in (('padded', None),
                                  ('edge_perm', plan.edge_perm)):
                    rows = (plan.col_padded.shape[0] if idx is None else
                            max(plan.num_edges, 1))
                    check_k6(f'{pname} {mode} F={f} {str(dtype)[6:]}',
                             k6_values(rows, f, plan, idx, dtype), plan, idx)
        for f in (47, 128):
            msgs = torch.randn((plan.col_padded.shape[0], f), generator=gen,
                               device=dev)
            for mode, xm, _ in modes(msgs):
                check_msgs(f'{pname} F={f} {mode}', xm, plan)

    # K7 over S = 1, 2 and 4 equal ranges, explicit bounds, weights, and a
    # graph whose middle ranges hold no edge (dropped) and whose other two
    # each have no chunk in half the tiles.
    row_p = np.repeat(np.arange(3000), np.diff(rp_p))
    cl_skew = np.where(row_p < 1500, cl_p % 700, 2300 + cl_p % 700)
    three = [(0, 7), (7, 1500), (1500, 3000)]
    k7_plans = [
        ('S=1', ops.build_fused_range_plan(rp_p, cl_p, 3000, 1, chunk=128)),
        ('S=2', ops.build_fused_range_plan(rp_p, cl_p, 3000, 2, chunk=128)),
        ('S=4 auto', ops.build_fused_range_plan(rp_p, cl_p, 3000, 4,
                                                chunk='auto')),
        ('empty ranges and tiles', ops.build_fused_range_plan(
            rp_p, cl_skew, 3000, 4, chunk=128)),
        ('bounds', ops.build_fused_range_plan(rp_p, cl_p, 3000, 1, chunk=128,
                                              bounds=three)),
        ('weighted S=3', ops.build_fused_range_plan(rp_p, cl_p, 3000, 3,
                                                    chunk=128,
                                                    edge_weight=w_p)),
        ('weighted bounds', ops.build_fused_range_plan(
            rp_p, cl_p, 3000, 1, chunk=128, bounds=three, edge_weight=w_p)),
    ]
    skew = k7_plans[3][1]
    if len(skew.plans) != 2 or min(
            int(np.bincount(p.chunk_tile.cpu().numpy(),
                            minlength=p.tile_ptr.shape[0]).min())
            for p in skew.plans) != 0:
        raise AssertionError('the skewed K7 plan has no empty tile')
    for f in (47, 128):
        x = torch.randn((3000, f), generator=gen, device=dev)
        for mode, xm, scale in modes(x):
            for pname, plan in k7_plans:
                if plan.weights is not None and mode == 'int8':
                    continue  # refused on weighted plans
                check(f'{pname} F={f} {mode}', 'K7', xm, plan, scale)

    # -- 3. the R-GCN paths, in a process of their own -----------------
    # The stacked form needs about 55 GB of the card; a process of its own
    # gives it a fresh allocator with growable segments (PERF.md), and
    # leaves the other paths' allocator as it was.
    paths = Paths()
    launches, by_width, run_path = paths.launches, paths.by_width, paths.run
    torch.cuda.empty_cache()
    rgcn = child('--rgcn', RGCN_RESULT)
    # -- 3a. the huge-graph step over sharded plans, in a process of its
    # own too (its graphs and plans leave with it) ----------------------
    sharded = child('--sharded', SHARDED_RESULT)
    # -- 3b. the host layer's paths A, C, D and E, in a process of their
    # own too (Reddit's graph and features take some 2 GB of the host) ---
    host = child('--host', HOST_RESULT)
    # -- 3c. distribution: four ranks of the card (paths H, T, E, N), in
    # a process of its own too ----------------------------------------
    dist = child('--dist', DIST_RESULT)
    for res in (rgcn, sharded, host, dist):
        for k, n in res['launches'].items():
            launches[k] += n
        for kid, f, n in res['by_width']:
            by_width[kid, f] = by_width.get((kid, f), 0) + n

    def profile_step(label, model, graph, ms, top_n=8, call=None):
        """One profiled training step (:func:`profile`); ``call``
        replaces ``model(x, graph)``."""
        def step():
            model.zero_grad()
            out = model(x, graph) if call is None else call()
            torch.nn.functional.cross_entropy(out, labels).backward()

        profile(label, step, ms, top_n)

    # -- 3d. the graphs at bench scale ----------------------------------
    t0 = time.perf_counter()
    rp_u, cl_u = uniform_graph(N_NODES, N_EDGES)
    g_u = ops.build_spmm_graph(rp_u, cl_u, with_edge_maps=True,
                               minmax='auto')
    t_u = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp_p, cl_p = powerlaw_graph(N_NODES, N_EDGES)
    g_p = ops.build_spmm_graph(rp_p, cl_p, dedup='auto', minmax='auto')
    t_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_pp = ops.build_spmm_graph(rp_p, cl_p, with_edge_maps=True)
    t_pp = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_uf, g_ur, g_w, w_u = range_graphs(rp_u, cl_u)
    t_r = time.perf_counter() - t0
    e_u, e_p = int(rp_u[-1]), int(rp_p[-1])
    print(f'graphs: uniform E={e_u} E_pad={g_u.fwd.col_padded.numel()} '
          f'{type(g_u.fwd).__name__} mm={type(g_u.mm).__name__} '
          f'({t_u:.1f} s); powerlaw E={e_p} fwd '
          f'{type(g_p.fwd).__name__} chunks={g_p.fwd.num_chunks} '
          f'uc={g_p.fwd.uc} hot={g_p.fwd.num_hot} '
          f'hot_w={g_p.fwd.hot_w.dtype}, bwd {type(g_p.bwd).__name__} '
          f'chunks={g_p.bwd.num_chunks} uc={g_p.bwd.uc} '
          f'hot={g_p.bwd.num_hot}, mm {type(g_p.mm).__name__} '
          f'chunks={g_p.mm.num_chunks} ec={g_p.mm.ec} uc={g_p.mm.uc} '
          f'edges={int((g_p.mm.edge_meta[:, 0, :] < 128).sum())} '
          f'({t_p:.1f} s); powerlaw chunked '
          f'E_pad={g_pp.fwd.col_padded.numel()} ({t_pp:.1f} s); uniform '
          f'range-fused S={len(g_uf.fwd.plans)} chunk={g_uf.fwd.chunk} '
          f'slots={g_uf.fwd.cat_cols.numel()}, range-split chunk='
          f'{g_ur.fwd.plans[0].chunk}, weighted fused chunk={g_w.fwd.chunk} '
          f'({t_r:.1f} s for the three)', flush=True)
    if not (isinstance(g_u.fwd, ops.SpmmPlan)
            and isinstance(g_u.bwd, ops.SpmmPlan) and g_u.mm is None
            and g_u.fwd.edge_perm is not None
            and isinstance(g_p.fwd, ops.DedupSpmmPlan)
            and g_p.fwd.num_hot == HOT_COLUMNS
            and g_p.fwd.hot_w.dtype == torch.int8
            and isinstance(g_p.bwd, ops.DedupSpmmPlan)
            and g_p.bwd.num_hot == 0
            and isinstance(g_p.mm, ops.DedupMinmaxPlan)
            and isinstance(g_pp.fwd, ops.SpmmPlan)
            and g_pp.fwd.edge_perm is not None
            and isinstance(g_uf.fwd, ops.FusedRangePlan)
            and isinstance(g_uf.bwd, ops.FusedRangePlan)
            and len(g_uf.fwd.plans) == len(g_uf.bwd.plans) == RANGES
            and isinstance(g_ur.fwd, ops.RangeSpmmPlan)
            and g_w.fwd.weights is not None and g_w.bwd.weights is not None
            and len(g_w.bwd.plans) == RANGES):
        raise AssertionError('bench graphs did not get the expected plans')
    graphs = {'uniform': g_u, 'powerlaw': g_p}
    sage_graphs = {'uniform': g_u, 'powerlaw': g_pp}
    ptr_u = torch.tensor(rp_u, device=dev)
    row_u = torch.tensor(cl_u.astype(np.int64), device=dev)
    csr_plan = plan_for_ptr(ptr_u)  # the planned segment_max_csr's plan

    print('kernel checks (main-path shapes):', flush=True)
    main_errs = {k: 0.0 for k in COUNTERS}
    sides = [('K1', 'uniform fwd', g_u.fwd), ('K1', 'uniform bwd', g_u.bwd),
             ('K2h', 'powerlaw fwd', g_p.fwd),
             ('K2', 'powerlaw bwd', g_p.bwd),
             ('K7', 'uniform S=4f fwd', g_uf.fwd),
             ('K7', 'uniform S=4f bwd', g_uf.bwd),
             ('K7', 'uniform weighted fwd', g_w.fwd),
             ('K7', 'uniform weighted bwd', g_w.bwd)]
    for f in (F_BENCH, DIMS[-1]):
        x = torch.randn((N_NODES, f), generator=gen, device=dev)
        found = [(kid, check(f'{label} F={f} f32', kid, x, plan))
                 for kid, label, plan in sides]
        for negate in (False, True):
            found.append(('K4', check_k4(
                f'uniform fwd col_padded F={f} negate={negate}', x,
                g_u.fwd, g_u.fwd.col_padded, negate)))
            found.append(('K5', check_k5(
                f'powerlaw mm F={f} negate={negate}', x, g_p.mm, negate)))
        found.append(('K4', check_k4(f'powerlaw fwd col_padded F={f}', x,
                                     g_pp.fwd, g_pp.fwd.col_padded)))
        msgs = x[row_u]
        found.append(('K3', check_k3(f'uniform CSR F={f} f32', msgs, ptr_u)))
        found.append(('K4', check_k4(f'uniform CSR edge_perm F={f}', msgs,
                                     csr_plan, csr_plan.edge_perm)))
        for negate in (False, True):
            found.append(('K4s', check_k4s(
                f'uniform CSR edge_perm F={f} negate={negate}', msgs,
                csr_plan, csr_plan.edge_perm, negate)))
        for kid, e in found:
            main_errs[kid] = max(main_errs[kid], e)
        del x, msgs
        torch.cuda.empty_cache()

    # K6 at the head count's width: GAT's logits on the uniform forward
    # plan, and softmax_csr on the power-law graph's transpose CSR (hub
    # rows of about 0.8M edges) through edge_perm. K1's msgs_padded entry
    # on the uniform plan's padded messages at F=512 (pad slots 0, as
    # GAT's weighted messages).
    plan = g_u.fwd
    e_pad_u = plan.col_padded.numel()
    main_errs['K6'] = check_k6('uniform fwd padded F=4', k6_values(
        e_pad_u, HEADS, plan, None, torch.float32), plan)
    t_ptr_p = np.zeros(N_NODES + 1, np.int64)
    np.cumsum(np.bincount(cl_p, minlength=N_NODES), out=t_ptr_p[1:])
    ptr_tp = torch.tensor(t_ptr_p, device=dev)
    plan_tp = plan_for_ptr(ptr_tp)
    src_tp = torch.randn((e_p, HEADS), generator=gen, device=dev)
    main_errs['K6'] = max(main_errs['K6'], check_k6(
        'powerlaw transpose CSR edge_perm F=4', src_tp, plan_tp,
        plan_tp.edge_perm))
    via_op = ops.softmax_csr(src_tp, ptr_tp)
    if not torch.equal(via_op, ops.segment_softmax_planned(
            src_tp, plan_tp, plan_tp.edge_perm)):
        raise AssertionError('softmax_csr did not take the planned K6 path')
    print(f'  softmax_csr on the power-law transpose CSR (longest row '
          f'{int(np.diff(t_ptr_p).max())} edges) is K6 through edge_perm',
          flush=True)
    del via_op
    msgs_u = torch.randn((e_pad_u, F_BENCH), generator=gen, device=dev)
    msgs_u.mul_(plan.valid_mask[:, None])
    main_errs['K1m'] = check_msgs(f'uniform fwd F={F_BENCH}', msgs_u, plan)
    del msgs_u
    torch.cuda.empty_cache()
    for kid, e in [*rgcn['errs'].items(), *sharded['errs'].items()]:
        main_errs[kid] = max(main_errs[kid], e)  # at those paths' shapes
        errs[kid] = max(errs[kid], e)

    # -- 4. the main paths, each counted on its own ----------------------
    x = torch.randn((N_NODES, DIMS[0]), generator=gen, device=dev)
    labels = torch.randint(0, DIMS[-1], (N_NODES, ), generator=gen,
                           device=dev)

    def train(models, gdict, split=None, call=False):
        """``STEPS`` SGD steps per graph; ms per step after the first.
        ``split`` (a dict with a ``'kid'``) also counts that kernel's
        launches in the forwards and in the backwards apart. With
        ``call``, each ``gdict`` value is the tuple of batch tensors the
        model takes after ``x``."""
        def count():
            return 0 if split is None else getattr(
                getattr(ops, COUNTERS[split['kid']][0]),
                COUNTERS[split['kid']][1])

        step_ms = {}
        for gname, graph in gdict.items():
            model = models[gname]
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            for step in range(STEPS):
                if step == 1:  # the first step pays cuBLAS set-up
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                opt.zero_grad()
                c0 = count()
                out = model(x, *graph) if call else model(x, graph)
                loss = torch.nn.functional.cross_entropy(out, labels)
                c1 = count()
                loss.backward()
                if split is not None:
                    split['forward'] = split.get('forward', 0) + c1 - c0
                    split['backward'] = (split.get('backward', 0) + count()
                                         - c1)
                opt.step()
                if not torch.isfinite(loss):
                    raise AssertionError(f'loss on {gname} is not finite')
            torch.cuda.synchronize()
            step_ms[gname] = (time.perf_counter() - t0) * 1e3 / (STEPS - 1)
        return step_ms

    cpu_gen = torch.Generator().manual_seed(0)
    gcn = {k: GCN(DIMS, generator=cpu_gen, device=dev) for k in graphs}
    gcn_ms = run_path('GCN', ('K1', 'K2', 'K2h'), lambda: train(gcn, graphs))
    print(f'  {STEPS} GCN {DIMS} training steps per graph; ms per step '
          f'after the first {gcn_ms}', flush=True)
    sage = {k: SAGE(DIMS, generator=cpu_gen, device=dev)
            for k in sage_graphs}
    sage_ms = run_path('SAGE max-pool', ('K4', ),
                       lambda: train(sage, sage_graphs))
    print(f'  {STEPS} SAGE max-pool {DIMS} training steps per graph; ms per '
          f'step after the first {sage_ms}', flush=True)

    for mname, models, gdict, ms in (('GCN', gcn, graphs, gcn_ms),
                                     ('SAGE max-pool', sage, sage_graphs,
                                      sage_ms)):
        for gname, graph in gdict.items():
            profile_step(f'{mname} {gname}', models[gname], graph,
                         ms[gname])

    xs = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev,
                     requires_grad=True)
    cot = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev)

    def minmax_path():
        res = {}
        for gname, graph in (('powerlaw', g_p), ('uniform', g_u)):
            for reduce in ('max', 'min'):
                out = ops.spmm(xs, graph, reduce)
                (grad, ) = torch.autograd.grad((out * cot).sum(), xs)
                res[gname, reduce] = (out.detach(), grad)
        return res

    mm_res = run_path('spmm max/min', ('K4', 'K5'), minmax_path)

    sage_params = SAGE(DIMS, generator=cpu_gen, device=dev).params()
    cot47 = torch.randn((N_NODES, DIMS[-1]), generator=gen, device=dev)
    leaves = [p for layer in sage_params['layers'] for p in layer.values()]

    def sage_forward_path():
        res = {}
        for aggr in ('mean', 'max'):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sage_forward(sage_params, x, ptr_u, row_u, aggr)
            grads = torch.autograd.grad((out * cot47).sum(), leaves)
            torch.cuda.synchronize()
            res[aggr] = (out.detach(), grads,
                         (time.perf_counter() - t0) * 1e3)
        return res

    sf_res = run_path('sage_forward mean/max', ('K3', 'K4', 'G1'),
                      sage_forward_path)
    print('  sage_forward forward + backward ms: ' + ', '.join(
        f'{a} {r[2]:.3f}' for a, r in sf_res.items()), flush=True)

    # -- 5. each path against the plain versions ------------------------
    def plain_gcn(params, x, graph):
        inv = torch.rsqrt(graph.deg.clamp(min=1.0))[:, None]
        layers = params['layers']
        for i, layer in enumerate(layers):
            h = x @ layer['w']
            x = plain(h * inv, graph.fwd) * inv + h * inv**2 + layer['b']
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x

    def plain_maxpool(params, x, graph):
        plan = graph.fwd
        empty = (graph.deg < 0.5)[:, None]
        layers = params['layers']
        for i, layer in enumerate(layers):
            h = torch.relu(x @ layer['w_nbr'])
            agg = by_columns(ops.segment_max_plain, h, plan,
                             plan.col_padded)[0]
            agg = torch.where(empty, torch.zeros_like(agg), agg)
            x = x @ layer['w_self'] + agg + layer['b']
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x

    fwd_ms = {}
    with torch.no_grad():
        for mname, models, gdict, ref_fn in (
                ('GCN', gcn, graphs, plain_gcn),
                ('SAGE max-pool', sage, sage_graphs, plain_maxpool)):
            for gname, graph in gdict.items():
                params = models[gname].params()
                out = models[gname](x, graph)
                close(f'{mname} forward {gname}', out,
                      ref_fn(params, x, graph))
                if mname == 'GCN':
                    fwd_ms[gname] = {
                        'kernel': cuda_ms(lambda: models[gname](x, graph)),
                        'plain': cuda_ms(lambda: plain_gcn(params, x,
                                                           graph)),
                    }
                del out
    print(f'GCN forward ms: {fwd_ms}', flush=True)
    torch.cuda.empty_cache()

    for gname, graph in graphs.items():
        xg = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev,
                         requires_grad=True)
        cg = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev)
        (gk, ) = torch.autograd.grad((ops.spmm(xg, graph) * cg).sum(), xg)
        (gp, ) = torch.autograd.grad((plain(xg, graph.fwd) * cg).sum(), xg)
        bound = plain(cg.abs(), abs_plan(graph.bwd))
        err = (gk - gp).abs()
        e = float(err.max())
        print(f'spmm grad {gname}: max_abs_err {e:.3g} (tolerance '
              f'{SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g})', flush=True)
        if float((err - SUM_RTOL * bound - SUM_ATOL).max()) > 0:
            raise AssertionError(f'spmm gradient on {gname} disagrees')
        del xg, cg, gk, gp, bound, err
        torch.cuda.empty_cache()

    # spmm max/min: values bit for bit, the gradient as the winners' sums.
    xd = xs.detach()
    for (gname, reduce), (out, grad) in mm_res.items():
        graph = g_p if gname == 'powerlaw' else g_u
        plan = graph.mm if graph.mm is not None else graph.fwd
        is_min = reduce == 'min'
        if isinstance(plan, ops.DedupMinmaxPlan):
            vals, pos = by_columns(ops.dedup_minmax_plain, xd, plan, is_min)
            idx = plan.uniq_cols
        else:
            vals, pos = by_columns(ops.segment_max_plain, xd, plan,
                                   plan.col_padded, is_min)
            idx = plan.col_padded
        empty = (graph.deg < 0.5)[:, None]
        vals = torch.where(empty, torch.zeros_like(vals),
                           -vals if is_min else vals)
        hit = ~empty & (pos < POS_NONE)
        tgt = torch.where(hit, idx[torch.where(hit, pos, 0).long()],
                          N_NODES).long()
        grads = [torch.zeros((N_NODES + 1, F_BENCH), device=dev)
                 .scatter_add_(0, tgt, c)[:N_NODES] for c in (cot, cot.abs())]
        same = torch.equal(bits(out), bits(vals))
        e = float((grad - grads[0]).abs().max())
        print(f'spmm {reduce} {gname}: values '
              f'{"equal bit for bit" if same else "DIFFER"}; grad '
              f'max_abs_err {e:.3g} (tolerance {SUM_RTOL:g} * sum|terms| + '
              f'{SUM_ATOL:g})', flush=True)
        if not same or bool(((grad - grads[0]).abs() > SUM_RTOL * grads[1] +
                             SUM_ATOL).any()):
            raise AssertionError(f'spmm {reduce} on {gname} disagrees')
        del vals, pos, grads, tgt
    del mm_res, xs, xd, cot
    torch.cuda.empty_cache()

    # sage_forward through the plain versions, with its own gradients.
    counts = (ptr_u[1:] - ptr_u[:-1]).clamp(min=1)[:, None]
    empty_u = (ptr_u[1:] == ptr_u[:-1])[:, None]

    def plain_sage(aggr, mask):
        """sage_forward through the plain versions, with the kernel
        path's ReLU pattern ``mask``: a unit whose pre-activation lies
        within the two paths' rounding difference of 0 would otherwise
        switch, and move a weight gradient by |x·g|, about 1."""
        xi = x
        layers = sage_params['layers']
        for i, layer in enumerate(layers):
            msgs = xi[row_u]
            if aggr == 'mean':
                agg = ops.segment_sum_csr_plain(msgs, ptr_u) / counts
            else:
                agg = ops.segment_max_plain(msgs, csr_plan,
                                            csr_plan.edge_perm)[0]
                agg = torch.where(empty_u, torch.zeros_like(agg), agg)
            del msgs
            xi = xi @ layer['w_self'] + agg @ layer['w_nbr'] + layer['b']
            if i < len(layers) - 1:
                xi = torch.where(mask, xi, torch.zeros_like(xi))
        return xi

    for aggr, (out, grads, _) in sf_res.items():
        with torch.no_grad():  # layer 1 alone: its pre-activation
            mask = sage_forward({'layers': sage_params['layers'][:1]}, x,
                                ptr_u, row_u, aggr) > 0
        ref = plain_sage(aggr, mask)
        del mask
        close(f'sage_forward {aggr} forward', out, ref.detach())
        refs = torch.autograd.grad((ref * cot47).sum(), leaves)
        for name, g, r in zip(('w_self', 'w_nbr', 'b') * len(DIMS), grads,
                              refs):
            close(f'  sage_forward {aggr} grad {name}', g, r)
        del ref, refs
        torch.cuda.empty_cache()
    del sf_res

    # -- 5b. attention and range-split paths, each checked -------------
    # GAT [512, 512, 48], 4 heads, on chunked plans with edge maps: each
    # graph is a path of its own, so each must launch K6 and K1m.
    gat = {}
    gat_ms = {}
    for gname, graph in (('uniform', g_u), ('powerlaw', g_pp)):
        gat[gname] = GAT(GAT_DIMS, heads=HEADS, generator=cpu_gen,
                         device=dev)
        gat_ms.update(run_path(f'GAT {gname}', ('K6', 'K1m'),
                               lambda: train({gname: gat[gname]},
                                             {gname: graph})))
        torch.cuda.empty_cache()
    print(f'  {STEPS} GAT {GAT_DIMS} ({HEADS} heads) training steps per '
          f'graph; ms per step after the first {gat_ms}', flush=True)

    def plain_gat(params, x, graph):
        """The GAT forward through the plain versions, ``BLOCK`` feature
        columns of the weighted messages at a time."""
        plan = graph.fwd
        layers = params['layers']
        for i, layer in enumerate(layers):
            heads, out_h = layer['a_src'].shape
            h = x @ layer['w']
            hh = h.view(h.shape[0], heads, out_h)
            s_src = (hh * layer['a_src']).sum(-1)
            s_dst = (hh * layer['a_dst']).sum(-1)
            logits = torch.nn.functional.leaky_relu(
                s_src[plan.col_padded.long()] +
                s_dst[plan.row_padded.long()], 0.2)
            alpha = ops.segment_softmax_plain(logits, plan)
            parts = []
            for f0 in range(0, h.shape[1], BLOCK):
                cols = torch.arange(f0, min(f0 + BLOCK, h.shape[1]),
                                    device=dev)
                msgs = (h[:, cols].contiguous().index_select(
                    0, plan.col_padded) * alpha[:, cols // out_h])
                parts.append(ops.segment_sum_chunked_plain(msgs, plan))
                del msgs
            x = torch.cat(parts, 1)
            if i < len(layers) - 1:
                x = torch.nn.functional.elu(x)
        return x

    with torch.no_grad():
        for gname, graph in (('uniform', g_u), ('powerlaw', g_pp)):
            out = gat[gname](x, graph)
            close(f'GAT forward {gname}', out,
                  plain_gat(gat[gname].params(), x, graph))
            del out
            torch.cuda.empty_cache()
    for gname, graph in (('uniform', g_u), ('powerlaw', g_pp)):
        profile_step(f'GAT {gname}', gat[gname], graph, gat_ms[gname],
                     top_n=16)
        torch.cuda.empty_cache()
    del gat
    torch.cuda.empty_cache()

    # A GCN [512, 512, 47] over the range-fused uniform graph: K7 in the
    # forward and over the transpose in the backward.
    gcn_r = GCN(DIMS, generator=cpu_gen, device=dev)
    k7_split = {'kid': 'K7'}
    gcn_r_ms = run_path('GCN range-fused', ('K7', ), lambda: train(
        {'uniform': gcn_r}, {'uniform': g_uf}, split=k7_split))
    print(f'  {STEPS} GCN {DIMS} training steps on the uniform graph '
          f'(range_split={RANGES}, range_fused, chunk=auto); ms per step '
          f'after the first {gcn_r_ms}; K7 launches forward '
          f'{k7_split["forward"]}, backward {k7_split["backward"]}',
          flush=True)
    if k7_split['forward'] <= 0 or k7_split['backward'] <= 0:
        raise AssertionError('K7 did not launch in both the forward and the '
                             'backward of the range-fused GCN')
    with torch.no_grad():
        close('GCN range-fused forward uniform', gcn_r(x, g_uf),
              plain_gcn(gcn_r.params(), x, g_uf))
    profile_step('GCN range-fused uniform', gcn_r, g_uf, gcn_r_ms['uniform'])
    del gcn_r
    torch.cuda.empty_cache()

    # spmm forward and backward over the weighted fused graph (K7 with
    # weights) and the range_split=4 graph (K1 per range).
    xr = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev,
                     requires_grad=True)
    cr = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev)

    def range_spmm_path():
        res = {}
        for gname, graph in (('weighted fused', g_w), ('range-split', g_ur)):
            out = ops.spmm(xr, graph)
            (grad, ) = torch.autograd.grad((out * cr).sum(), xr)
            res[gname] = (out.detach(), grad)
        return res

    rs_res = run_path('spmm weighted fused / range-split', ('K7', 'K1'),
                      range_spmm_path)
    xd = xr.detach()
    for gname, graph in (('weighted fused', g_w), ('range-split', g_ur)):
        out, grad = rs_res.pop(gname)
        for what, got, ref, mag in (
                ('forward', out, plain(xd, graph.fwd),
                 plain(xd.abs(), abs_plan(graph.fwd))),
                ('grad', grad, plain(cr, graph.bwd),
                 plain(cr.abs(), abs_plan(graph.bwd)))):
            err = (got - ref).abs()
            e = float(err.max())
            print(f'spmm {gname} {what}: max_abs_err {e:.3g} (tolerance '
                  f'{SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g})', flush=True)
            if bool((err > SUM_RTOL * mag + SUM_ATOL).any()):
                raise AssertionError(f'spmm {gname} {what} disagrees')
            del err, ref, mag
        del out, grad
    del xr, xd, cr, rs_res
    torch.cuda.empty_cache()

    # -- 5c. fused multi-aggregation, COO sums, padded-batch GAT ---------
    # The uniform graph's messages x[src] in destination order (F=512);
    # its destinations as a host array (the fused path's index) and on
    # the card (the COO index).
    dst_np = np.repeat(np.arange(N_NODES), np.diff(rp_u))
    dst_u = torch.tensor(dst_np, device=dev)
    msgs_f = x[row_u].requires_grad_(True)
    f_msg = msgs_f.shape[1]
    fused_cot = {len(rl): torch.randn((N_NODES, f_msg * len(rl)),
                                      generator=gen, device=dev)
                 for rl in FUSED_LISTS}
    fused_split = {}

    def fused_path():
        res = {}
        for rl in FUSED_LISTS:
            c0 = (ops.segment_max_kernel.launches,
                  ops.segment_max_kernel.sum_launches)
            for _ in range(FUSED_CALLS):
                out = ops.fused_scatter_reduce(msgs_f, dst_np, N_NODES, rl)
                (grad, ) = torch.autograd.grad(
                    (out * fused_cot[len(rl)]).sum(), msgs_f)
            torch.cuda.synchronize()
            fused_split[tuple(rl)] = (
                ops.segment_max_kernel.launches - c0[0],
                ops.segment_max_kernel.sum_launches - c0[1])
            res[tuple(rl)] = (out.detach(), grad)
        return res

    fused_res = run_path('fused_scatter_reduce', ('K4s', 'K4'), fused_path)
    print(f'  {FUSED_CALLS} forward + backward calls per list; (K4, K4s) '
          f'launches by list: {fused_split}', flush=True)
    # [sum, mean, min, max]: one K4s max+sum pass and one sum-less negated
    # K4 a call; [mean, min]: one negated K4s pass and no K4.
    if (fused_split[tuple(FUSED_LISTS[0])] != (FUSED_CALLS, FUSED_CALLS)
            or fused_split[tuple(FUSED_LISTS[1])] != (0, FUSED_CALLS)):
        raise AssertionError('the fused path did not launch K4s in its '
                             'max+sum and negated forms and K4 as expected')

    # Against the composite through the plain versions (one scatter per
    # reduction and BLOCK columns at a time): sum and mean within the sum
    # tolerance, min and max bit for bit, the input gradient within
    # GCN_RTOL.
    msgs_d = msgs_f.detach()
    counts_u = (ptr_u[1:] - ptr_u[:-1]).clamp(min=1)[:, None].float()
    mag_u = by_columns(ops.segment_sum_csr_plain, msgs_d.abs(), ptr_u)
    for rl in FUSED_LISTS:
        out, grad = fused_res.pop(tuple(rl))
        cot = fused_cot[len(rl)]
        grad_ref = torch.zeros_like(msgs_d)
        for bi, r in enumerate(rl):
            got = out[:, bi * f_msg:(bi + 1) * f_msg]
            parts = []
            for f0 in range(0, f_msg, BLOCK):
                blk = slice(f0, f0 + BLOCK)
                src = msgs_d[:, blk].contiguous().requires_grad_(True)
                o = ops.fused_scatter_reduce(src, dst_u, N_NODES, [r])
                cb = cot[:, bi * f_msg + f0:bi * f_msg + f0 + BLOCK]
                (g, ) = torch.autograd.grad((o * cb).sum(), src)
                grad_ref[:, blk] += g
                parts.append(o.detach())
                del src, o, g
            ref = torch.cat(parts, 1)
            if r in ('min', 'max'):
                check_exact(f'fused {"+".join(rl)}: {r}', 'K4s', (got, ),
                            (ref, ))
            else:
                mag = mag_u / counts_u if r == 'mean' else mag_u
                check_sum(f'fused {"+".join(rl)}: {r}', 'K4s', got, ref, mag)
            del ref, parts
        close(f'fused {"+".join(rl)} input gradient', grad, grad_ref)
        del out, grad, grad_ref
        torch.cuda.empty_cache()
    del mag_u

    def coo_path():
        return (ops.segment_sum_coo(msgs_d, dst_u, dim_size=N_NODES),
                ops.segment_mean_coo(msgs_d, dst_u, dim_size=N_NODES))

    coo_sum, coo_mean = run_path('segment_sum_coo/segment_mean_coo', ('K3', ),
                                 coo_path)
    ref = by_columns(ops.segment_sum_csr_plain, msgs_d, ptr_u)
    mag = by_columns(ops.segment_sum_csr_plain, msgs_d.abs(), ptr_u)
    check_sum('segment_sum_coo', 'K3', coo_sum, ref, mag)
    check_sum('segment_mean_coo', 'K3', coo_mean, ref / counts_u,
              mag / counts_u)
    del coo_sum, coo_mean, ref, mag

    # The fused path against the composite, forward and forward+backward.
    fused_ms = {}
    for rl in FUSED_LISTS:
        cot = fused_cot[len(rl)]
        key = '+'.join(rl)

        def fwd_bwd(index):
            out = ops.fused_scatter_reduce(msgs_f, index, N_NODES, rl)
            torch.autograd.grad((out * cot).sum(), msgs_f)

        closure = fused_closure(dst_np, N_NODES, tuple(rl))
        with torch.no_grad():
            fused_ms[key] = {
                'fused fwd': cuda_ms(lambda: ops.fused_scatter_reduce(
                    msgs_d, dst_np, N_NODES, rl), iters=5),
                'fused fwd, cached closure': cuda_ms(lambda: closure(msgs_d),
                                                     iters=5),
                'composite fwd': cuda_ms(lambda: ops.fused_scatter_reduce(
                    msgs_d, dst_u, N_NODES, rl), iters=2, warmup=1)}
        torch.cuda.empty_cache()
        fused_ms[key]['fused fwd+bwd'] = cuda_ms(lambda: fwd_bwd(dst_np),
                                                 iters=5)
        fused_ms[key]['composite fwd+bwd'] = cuda_ms(
            lambda: fwd_bwd(dst_u), iters=2, warmup=1)
        torch.cuda.empty_cache()
    print(f'fused_scatter_reduce F={f_msg} over {e_u} messages into '
          f'{N_NODES} rows, ms: {fused_ms}', flush=True)
    del msgs_f, msgs_d, fused_cot, fused_res, dst_u
    torch.cuda.empty_cache()

    # The padded-batch GAT: the uniform graph as one batch of
    # EDGE_BUDGET-sized edge slots; pad slots carry row == col == N.
    e_slots = -(-e_u // EDGE_BUDGET) * EDGE_BUDGET
    row_b = torch.full((e_slots, ), N_NODES, dtype=torch.int64, device=dev)
    col_b = torch.full((e_slots, ), N_NODES, dtype=torch.int64, device=dev)
    row_b[:e_u] = row_u
    col_b[:e_u] = torch.tensor(dst_np, device=dev)
    batch_b = (ptr_u, row_b, col_b)
    gat_b = GATBatch(GAT_BATCH_DIMS, heads=HEADS, generator=cpu_gen,
                     device=dev)
    gat_b_ms = run_path('GATBatch padded', ('K3', ), lambda: train(
        {'uniform': gat_b}, {'uniform': batch_b}, call=True))['uniform']
    print(f'  {STEPS} GATBatch {GAT_BATCH_DIMS} ({HEADS} heads) training '
          f'steps on the uniform graph as one padded batch of {e_slots} '
          f'edge slots; ms per step after the first {gat_b_ms:.3f}',
          flush=True)

    gat_leaves = list(gat_b.parameters())
    out, signs = relu_signs(lambda: gat_b(x, *batch_b))
    if len(signs) != len(gat_b.w):
        raise AssertionError(f'GATBatch made {len(signs)} leaky_relu calls '
                             f'for {len(gat_b.w)} layers')
    grads = torch.autograd.grad((out * cot47).sum(), gat_leaves)
    out = out.detach()
    torch.cuda.empty_cache()
    ref, switched = plain_gat_batch(gat_b.params(), x, *batch_b, signs)
    del signs
    print(f'GATBatch: {switched} of {len(gat_b.w) * e_u * HEADS} edge '
          f'logits would take the other leaky_relu branch on the plain path',
          flush=True)
    refs = torch.autograd.grad((ref * cot47).sum(), gat_leaves)
    close('GATBatch forward uniform', out, ref.detach())
    names = [n for n, _ in gat_b.named_parameters()]
    for name, g, r in zip(names, grads, refs):
        close(f'  GATBatch grad {name}', g, r)
    del out, grads, ref, refs
    torch.cuda.empty_cache()
    profile_step('GATBatch uniform', gat_b, None, gat_b_ms, top_n=16,
                 call=lambda: gat_b(x, *batch_b))
    del gat_b, row_b, col_b, batch_b
    torch.cuda.empty_cache()

    # -- 4a. GIN, PointNet++ and DGCNN, and the geometry ops --------------
    f1_row = geometry_paths(dev, run_path, rp_u, cl_u)
    torch.cuda.empty_cache()

    paths.restore()
    print('K1, K1m, K3, K7 and G1 launches on the main paths by width: '
          + ', '.join(f'{kid} F={f} {n}'
                      for (kid, f), n in sorted(by_width.items())),
          flush=True)

    # -- 6. timing ------------------------------------------------------
    csr = {}
    for gname, (rp, cl) in {'uniform': (rp_u, cl_u),
                            'powerlaw': (rp_p, cl_p)}.items():
        a = torch.sparse_csr_tensor(
            torch.from_numpy(rp), torch.from_numpy(cl.astype(np.int64)),
            torch.ones(cl.shape[0]), (N_NODES, N_NODES)).to(dev)
        csr[gname] = (a, a.t().to_sparse_csr())
    xb = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev)
    print('spmm (bench.py useful bytes: E*F*4 + E*4 + N*F*4):', flush=True)
    for gname, graph in graphs.items():
        e = e_u if gname == 'uniform' else e_p
        useful = e * F_BENCH * 4 + e * 4 + N_NODES * F_BENCH * 4
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr[gname][0], xb))
        for prec in (None, 'bf16'):
            ms = cuda_ms(lambda: ops.spmm(xb, graph, precision=prec))
            print(f'  {gname} precision={prec}: {ms:.3f} ms, '
                  f'{useful / ms / 1e6:.1f} GB/s, bound '
                  f'{useful / HBM_BYTES_PER_S * 1e3:.3f} ms; '
                  f'torch.sparse.mm f32 {lib_ms:.3f} ms', flush=True)

    rows = []

    def row(kid, label, run, run_plain, run_lib, nbytes, flops, lib_name,
            f=F_BENCH):
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        r = {
            'name': kid, 'route': 'cuda',
            'source': f'pyg_lib_tpu_torch/csrc/{SOURCES[kid][0]}',
            'replaces': SOURCES[kid][1], 'launches': launches[kid],
            'max_abs_err': main_errs[kid], 'ms': cuda_ms(run),
            'plain_ms': cuda_ms(run_plain, iters=3), 'bound_ms': bound_ms,
            'bound_by': ('bytes' if nbytes / HBM_BYTES_PER_S >=
                         flops / F32_FLOPS else 'operations'),
            'library_ms': cuda_ms(run_lib),
        }
        was = (f' (earlier design: {EARLIER_MS[kid]:.3f} ms)'
               if kid in EARLIER_MS else '')
        print(f'  {kid} {label} F={f} f32: {r["ms"]:.3f} ms{was}, plain '
              f'{r["plain_ms"]:.3f} ms, {lib_name} {r["library_ms"]:.3f} '
              f'ms, bound {bound_ms:.3f} ms ({r["bound_by"]}: '
              f'{nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP)', flush=True)
        rows.append(r)

    for kid, label, plan, lib in (
            ('K1', 'uniform fwd', g_u.fwd, csr['uniform'][0]),
            ('K2h', 'powerlaw fwd', g_p.fwd, csr['powerlaw'][0]),
            ('K2', 'powerlaw bwd', g_p.bwd, csr['powerlaw'][1])):
        nbytes, flops = work(plan, F_BENCH)
        row(kid, label, lambda: kernel(xb, plan), lambda: plain(xb, plan),
            lambda: torch.sparse.mm(lib, xb), nbytes, flops,
            'torch.sparse.mm')
    for kid, label, plan in (('K2h', 'powerlaw fwd', g_p.fwd),
                             ('K2', 'powerlaw bwd', g_p.bwd)):
        _, _, top = device_time_by_kernel(lambda: kernel(xb, plan))
        print(f'  {kid} {label} F={F_BENCH}: one call by kernel (ms): '
              + '; '.join(f'{name} {t:.3f}' for name, t in top), flush=True)

    # K7 on the uniform graph's S=4f plan; beside it the weighted fused
    # plan (against torch.sparse.mm over the weighted CSR) and the
    # range_split=4 plan (K1 per range, partial sums added).
    plan = g_uf.fwd
    nbytes = (N_NODES * F_BENCH * 4 + plan.cat_cols.numel() * 4 +
              plan.tile_ptrs.shape[0] * len(plan.plans) * 129 * 4 +
              plan.num_rows * F_BENCH * 4)
    row('K7', f'uniform S={RANGES}f', lambda: ops.fused_range_sum(xb, plan),
        lambda: ops.fused_range_plain(xb, plan),
        lambda: torch.sparse.mm(csr['uniform'][0], xb), nbytes,
        e_u * F_BENCH, 'torch.sparse.mm')
    a_w = torch.sparse_csr_tensor(
        torch.from_numpy(rp_u), torch.from_numpy(cl_u.astype(np.int64)),
        torch.from_numpy(w_u), (N_NODES, N_NODES)).to(dev)
    print(f'  K7 uniform weighted fused (4 bounds) F={F_BENCH}: '
          f'{cuda_ms(lambda: ops.fused_range_sum(xb, g_w.fwd)):.3f} ms; '
          f'torch.sparse.mm weighted CSR '
          f'{cuda_ms(lambda: torch.sparse.mm(a_w, xb)):.3f} ms; K1 per '
          f'range (range_split={RANGES}, partials added) '
          f'{cuda_ms(lambda: kernel(xb, g_ur.fwd)):.3f} ms', flush=True)
    del csr, a_w
    torch.cuda.empty_cache()

    # K3 on the uniform graph's messages (its input is the messages). K4
    # on the uniform graph and K5 on the power-law min/max plan gather x
    # themselves, so their library call gathers and reduces in one timed
    # call; the reduce alone, over messages gathered beforehand, is
    # printed beside it.
    ptr_f = N_NODES * F_BENCH * 4
    msgs = xb[row_u]
    row('K3', 'uniform CSR', lambda: ops.segment_sum_csr_kernel(msgs, ptr_u),
        lambda: ops.segment_sum_csr_plain(msgs, ptr_u),
        lambda: torch.segment_reduce(msgs, 'sum', offsets=ptr_u, axis=0),
        e_u * F_BENCH * 4 + (N_NODES + 1) * 8 + ptr_f, e_u * F_BENCH,
        'torch.segment_reduce sum')
    busy_ms, wall_ms, top = device_time_by_kernel(
        lambda: ops.segment_sum_csr_kernel(msgs, ptr_u))
    print(f'  K3 uniform CSR F={F_BENCH}: one call by kernel (ms): '
          + '; '.join(f'{name} {t:.3f}' for name, t in top)
          + f'; device busy {busy_ms:.3f} of {wall_ms:.3f} ms', flush=True)
    k4_csr_ms = cuda_ms(lambda: ops.segment_max_kernel(
        msgs, csr_plan, csr_plan.edge_perm))
    print(f'  K4 uniform CSR edge_perm (sage_forward max) F={F_BENCH}: '
          f'{k4_csr_ms:.3f} ms', flush=True)
    # K4s on the same messages through the same plan (the fused path's
    # pass); its library call is torch.segment_reduce's sum and max, two
    # calls timed together.
    row('K4s', 'uniform CSR edge_perm', lambda: ops.segment_max_kernel(
        msgs, csr_plan, csr_plan.edge_perm, with_sum=True),
        lambda: ops.segment_max_plain(msgs, csr_plan, csr_plan.edge_perm,
                                      with_sum=True),
        lambda: (torch.segment_reduce(msgs, 'sum', offsets=ptr_u, axis=0),
                 torch.segment_reduce(msgs, 'max', offsets=ptr_u, axis=0)),
        e_u * F_BENCH * 4 + csr_plan.edge_perm.numel() * 4 +
        csr_plan.tile_ptr.shape[0] * 129 * 4 + 3 * ptr_f, 2 * e_u * F_BENCH,
        'torch.segment_reduce sum + max')
    torch.cuda.empty_cache()
    reduce_only = cuda_ms(lambda: torch.segment_reduce(
        msgs, 'max', offsets=ptr_u, axis=0))
    del msgs
    torch.cuda.empty_cache()
    # K3 and K4 through edge_perm (segment_max_csr) on the power-law
    # transpose CSR's [E, 512] messages (8.6 GB; hub rows up to 810,552
    # edges), each held against its plain version first; beside each,
    # torch.segment_reduce on the same messages.
    msgs = torch.randn((e_p, F_BENCH), generator=gen, device=dev)
    hub_k3_err = check_k3(f'powerlaw transpose CSR F={F_BENCH} f32', msgs,
                          ptr_tp)
    check_k4(f'powerlaw transpose CSR edge_perm F={F_BENCH}', msgs, plan_tp,
             plan_tp.edge_perm)
    torch.cuda.empty_cache()
    hub = {
        'K3': cuda_ms(lambda: ops.segment_sum_csr_kernel(msgs, ptr_tp)),
        'sum': cuda_ms(lambda: torch.segment_reduce(msgs, 'sum',
                                                    offsets=ptr_tp, axis=0)),
        'K4': cuda_ms(lambda: ops.segment_max_kernel(msgs, plan_tp,
                                                     plan_tp.edge_perm)),
        'max': cuda_ms(lambda: torch.segment_reduce(msgs, 'max',
                                                    offsets=ptr_tp, axis=0)),
    }
    del msgs
    torch.cuda.empty_cache()
    out_b = 2 * ptr_f  # K4 writes values and positions
    k3_b = e_p * F_BENCH * 4 + (N_NODES + 1) * 8 + ptr_f
    k4_b = (e_p * F_BENCH * 4 + plan_tp.edge_perm.numel() * 4 +
            plan_tp.tile_ptr.shape[0] * 129 * 4 + out_b)
    print(f'  K3 powerlaw transpose CSR (hub rows up to '
          f'{int(np.diff(t_ptr_p).max())} edges) F={F_BENCH} f32: '
          f'{hub["K3"]:.3f} ms, bound {k3_b / HBM_BYTES_PER_S * 1e3:.3f} '
          f'ms, max_abs_err {hub_k3_err:.3g}; torch.segment_reduce sum '
          f'{hub["sum"]:.3f} ms', flush=True)
    print(f'  K4 powerlaw transpose CSR edge_perm (segment_max_csr on hub '
          f'rows) F={F_BENCH} f32: {hub["K4"]:.3f} ms, bound '
          f'{k4_b / HBM_BYTES_PER_S * 1e3:.3f} ms; torch.segment_reduce max '
          f'{hub["max"]:.3f} ms', flush=True)
    plan = g_u.fwd
    row('K4', 'uniform fwd col_padded',
        lambda: ops.segment_max_kernel(xb, plan, plan.col_padded),
        lambda: ops.segment_max_plain(xb, plan, plan.col_padded),
        lambda: torch.segment_reduce(xb[row_u], 'max', offsets=ptr_u, axis=0),
        ptr_f + plan.col_padded.numel() * 4 + plan.tile_ptr.shape[0] * 129 * 4
        + 2 * ptr_f, e_u * F_BENCH, 'gather + torch.segment_reduce max')
    print(f'  K4 library without the gather (torch.segment_reduce max over '
          f'messages gathered beforehand): {reduce_only:.3f} ms', flush=True)
    torch.cuda.empty_cache()
    mm = g_p.mm
    rp_d, cl_d = ops.dedup_pairs(rp_p, cl_p)
    ptr_d = torch.tensor(rp_d, device=dev)
    idx_d = torch.tensor(cl_d, device=dev)
    msgs = xb[idx_d]
    reduce_only = cuda_ms(lambda: torch.segment_reduce(
        msgs, 'max', offsets=ptr_d, axis=0))
    del msgs
    torch.cuda.empty_cache()
    row('K5', 'powerlaw mm', lambda: ops.dedup_minmax(xb, mm),
        lambda: ops.dedup_minmax_plain(xb, mm),
        lambda: torch.segment_reduce(xb[idx_d], 'max', offsets=ptr_d,
                                     axis=0),
        ptr_f + mm.uniq_cols.numel() * 4 + mm.num_chunks * 2 * mm.ec * 4 +
        mm.num_chunks * 4 + 2 * ptr_f, cl_d.shape[0] * F_BENCH,
        'gather + torch.segment_reduce max')
    print(f'  K5 library without the gather (torch.segment_reduce max over '
          f'messages gathered beforehand): {reduce_only:.3f} ms', flush=True)
    _, _, top = device_time_by_kernel(lambda: ops.dedup_minmax(xb, mm))
    print(f'  K5 powerlaw mm F={F_BENCH}: one call by kernel (ms): '
          + '; '.join(f'{name} {t:.3f}' for name, t in top), flush=True)
    del idx_d
    torch.cuda.empty_cache()

    # K6 at the head count's width on the uniform forward plan (GAT's
    # logits). The library call is torch.sparse.softmax over a hybrid COO
    # tensor of the same rows: [row, place in the row] sparse, the heads
    # dense, so no two edges share an index.
    plan = g_u.fwd
    logits = torch.randn((e_pad_u, HEADS), generator=gen, device=dev)
    slot, row_of = _padded_rows(plan.tile_ptr)
    lo = plan.tile_ptr[:, 0, :128].reshape(-1).long()[row_of]
    place = slot - lo
    coo = torch.sparse_coo_tensor(
        torch.stack([row_of, place]), logits[slot],
        (plan.num_rows, int(place.max()) + 1, HEADS)).coalesce()
    del slot, row_of, lo, place
    ptr_bytes = plan.tile_ptr.shape[0] * 129 * 4
    row('K6', 'uniform fwd padded', lambda: ops.segment_softmax_planned(
        logits, plan), lambda: ops.segment_softmax_plain(logits, plan),
        lambda: torch.sparse.softmax(coo, 1),
        2 * e_pad_u * HEADS * 4 + ptr_bytes, 6 * e_u * HEADS,
        'torch.sparse.softmax (hybrid COO)', f=HEADS)
    del coo
    _, _, top = device_time_by_kernel(lambda: ops.segment_softmax_planned(
        logits, plan))
    print(f'  K6 uniform fwd padded F={HEADS}: one call by kernel (ms): '
          + '; '.join(f'{name} {t:.3f}' for name, t in top), flush=True)
    del logits
    hub_ms = cuda_ms(lambda: ops.segment_softmax_planned(
        src_tp, plan_tp, plan_tp.edge_perm))
    hub_bound = (2 * e_p * HEADS * 4 + e_p * 4 +
                 plan_tp.tile_ptr.shape[0] * 129 * 4) / HBM_BYTES_PER_S * 1e3
    # Its library call: torch.sparse.softmax over a hybrid COO tensor of
    # the transpose CSR's rows, built as the uniform one above.
    row_of = torch.repeat_interleave(torch.arange(N_NODES, device=dev),
                                     ptr_tp[1:] - ptr_tp[:-1])
    place = torch.arange(e_p, device=dev) - ptr_tp[row_of]
    coo = torch.sparse_coo_tensor(
        torch.stack([row_of, place]), src_tp,
        (N_NODES, int(place.max()) + 1, HEADS)).coalesce()
    del row_of, place
    hub_lib_ms = cuda_ms(lambda: torch.sparse.softmax(coo, 1))
    del coo
    print(f'  K6 powerlaw transpose CSR through edge_perm (softmax_csr, '
          f'hub rows up to {int(np.diff(t_ptr_p).max())} edges) F={HEADS}: '
          f'{hub_ms:.3f} ms (earlier design: '
          f'{EARLIER_MS["K6 hub rows"]:.3f} ms), bound '
          f'{hub_bound:.3f} ms; '
          f'torch.sparse.softmax (hybrid COO) {hub_lib_ms:.3f} ms',
          flush=True)

    # K1's msgs_padded entry on the uniform forward plan's padded messages
    # (pad slots 0, as GAT's); the library call is index_add_ over
    # row_padded, which on these inputs computes the same sums.
    msgs = torch.randn((e_pad_u, F_BENCH), generator=gen, device=dev)
    msgs.mul_(plan.valid_mask[:, None])
    row('K1m', 'uniform fwd msgs_padded',
        lambda: ops.segment_sum_chunked(msgs, plan),
        lambda: ops.segment_sum_chunked_plain(msgs, plan),
        lambda: torch.zeros((N_NODES, F_BENCH), device=dev).index_add_(
            0, plan.row_padded, msgs),
        e_pad_u * F_BENCH * 4 + ptr_bytes + N_NODES * F_BENCH * 4,
        e_u * F_BENCH, 'index_add_')

    # K1, K7 and K1m at the main paths' other widths, on the same plans
    # (K1 and K7 at F=47 take the scalar branch).
    for kid, f in sorted(k for k in by_width if k[1] != F_BENCH
                         and k[0] in ('K1', 'K7', 'K1m')):
        if kid == 'K1m':
            src = msgs[:, :f].contiguous()
            ms = cuda_ms(lambda: ops.segment_sum_chunked(src, g_u.fwd))
        else:
            src = xb[:, :f].contiguous()
            ms = cuda_ms(lambda: kernel(src, g_u.fwd if kid == 'K1' else
                                        g_uf.fwd))
        print(f'  {kid} F={f} f32 ({by_width[kid, f]} launches on the main '
              f'paths): {ms:.3f} ms', flush=True)
    # G1 on a batch of the products bucket's shape (paths P and Q, and the
    # benchmark's sage-products cell), with its launches on the main paths;
    # its row is F=256's, F=100's beside it.
    del msgs, xb
    torch.cuda.empty_cache()
    g1, errs['G1'] = g1_rows(dev)
    rows.append(dict(
        g1[G1_WIDTHS[0]], name='G1', route='cuda',
        source=f'pyg_lib_tpu_torch/csrc/{SOURCES["G1"][0]}',
        replaces=SOURCES['G1'][1], launches=launches['G1'],
        **{f'f{f}': g1[f] for f in G1_WIDTHS[1:]}))
    # K1's pieces, timed by the sharded process over the huge power-law
    # graph's hub rows.
    rows.append(dict(sharded['row'], launches=launches['K1p']))
    rows.append(dict(f1_row, launches=launches['F1']))
    # K3 on path A's batches (Reddit's shape) and on path P's
    # (ogbn-products'), at each width it ran at there, with its launches
    # in that path.
    k3 = next(r for r in rows if r['name'] == 'K3')
    for key, name, got in (
            ('path_a', 'Reddit GraphSAGE mini-batch', host['k3']),
            ('path_p', 'ogbn-products GraphSAGE (weighted, disjoint)',
             host['k3_p'])):
        k3_path = {f: n for kid, f, n in host['by_path'][name]
                   if kid == 'K3'}
        k3[key] = {f: dict(r, launches=k3_path.get(int(f), 0))
                   for f, r in got.items()}
    # K3 on the distribution paths H and T, at each width they ran at,
    # with its launches in each rank (all widths).
    for key, label in (('path_h', 'H'), ('path_t', 'T')):
        p = dist['paths'][label]
        k3[key] = {f: dict(r, launches=p['widths'].get(f, 0),
                           launches_per_rank=p['per_rank'])
                   for f, r in dist['k3_' + label.lower()].items()}
    return smi, errs, rows


def child(flag, result):
    """Run ``python3 chip_smoke.py flag`` and echo its output; return the
    JSON of its last line, which starts with ``result``."""
    with subprocess.Popen([sys.executable, os.path.abspath(__file__), flag],
                          stdout=subprocess.PIPE, text=True) as proc:
        last = ''
        for line in proc.stdout:
            print(line, end='', flush=True)
            last = line
    if proc.returncode != 0 or not last.startswith(result):
        raise AssertionError(f'the {flag} paths failed (exit code '
                             f'{proc.returncode})')
    return json.loads(last[len(result):])


class Paths:
    """Runs the main paths, each with every launch count set to 0 just
    before it and read just after; sums the launches (``launches``) and
    K1's, K1m's, K3's, K7's and G1's launches by width (``by_width``; and
    path by path, ``by_path``), read off their C entry points while it is
    installed (the wrappers' counters are the launch counts)."""

    def __init__(self):
        from pyg_lib_tpu_torch import _build
        from pyg_lib_tpu_torch.ops.kernels import gather_rows as g1_mod
        from pyg_lib_tpu_torch.ops.kernels import segment_csr as k3_mod
        from pyg_lib_tpu_torch.ops.kernels import spmm_chunked as k1_mod
        from pyg_lib_tpu_torch.ops.kernels import spmm_range_fused as k7_mod

        self.launches = {k: 0 for k in COUNTERS}
        self.by_width = {}
        self.by_path = {}
        self.tallies = [ByWidth(k1_mod._k1_lib(), 8,
                                lambda a: 'K1' if a[2] else 'K1m'),
                        ByWidth(k7_mod._k7_lib(), 12, lambda a: 'K7'),
                        ByWidth(k3_mod._k3_lib(), 6, lambda a: 'K3'),
                        ByWidth(g1_mod._lib(), 7, lambda a: 'G1')]
        self.entries = [('spmm_chunked', 'pygt_spmm_chunked'),
                        ('spmm_range_fused', 'pygt_spmm_range_fused'),
                        ('segment_csr', 'pygt_segment_sum_csr'),
                        ('gather_rows', 'pygt_gather_rows_backward')]
        for (lib, fn), tally in zip(self.entries, self.tallies):
            setattr(_build.load(lib), fn, tally)

    def run(self, name, need, fn, engine=()):
        """``fn()`` as the main path ``name``; each kernel of ``need``
        must launch in it, and each entry point of the C++ sampling
        engine in ``engine`` (``sampler._cpp.calls``) must be called."""
        import torch

        from pyg_lib_tpu_torch import ops
        from pyg_lib_tpu_torch.sampler import _cpp

        for wrapper, attr in COUNTERS.values():
            setattr(getattr(ops, wrapper), attr, 0)
        for t in self.tallies:
            t.counts.clear()
        calls = dict(_cpp.calls)
        result = fn()
        torch.cuda.synchronize()
        got = {k: getattr(getattr(ops, w), a)
               for k, (w, a) in COUNTERS.items()}
        drawn = {k: n - calls[k] for k, n in _cpp.calls.items()
                 if n > calls[k]}
        print(f'main path {name}: launches {got}'
              + (f'; C++ engine calls {drawn}' if engine else ''),
              flush=True)
        for k in need:
            if got[k] <= 0:
                raise AssertionError(f'{k} never launched on the main path '
                                     f'{name}')
        for k in engine:
            if drawn.get(k, 0) <= 0:
                raise AssertionError(f'the C++ engine\'s {k} was never '
                                     f'called on the main path {name}')
        for k, n in got.items():
            self.launches[k] += n
        widths = self.by_path.setdefault(name, {})
        for t in self.tallies:
            for key, n in t.counts.items():
                self.by_width[key] = self.by_width.get(key, 0) + n
                widths[key] = widths.get(key, 0) + n
        return result

    def restore(self):
        """Put the C entry points back."""
        from pyg_lib_tpu_torch import _build

        for (lib, fn), tally in zip(self.entries, self.tallies):
            setattr(_build.load(lib), fn, tally.fn)


def close(label, out, ref, rtol=GCN_RTOL):
    """``out`` finite, of ``ref``'s shape and within ``rtol * max|ref|``
    of it."""
    import torch

    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f'{label} is malformed')
    e = float((out - ref).abs().max())
    tol = rtol * float(ref.abs().max())
    print(f'{label}: max_abs_err {e:.3g} (tolerance {rtol:g} * '
          f'max|plain| = {tol:.3g})', flush=True)
    if e > tol:
        raise AssertionError(f'{label} disagrees with the plain path')


def profile(label, step, ms, top_n=8):
    """Where a training step's time goes: device time by kernel over one
    profiled ``step()``, against that step's own wall time (the idle
    share) and the unprofiled step time ``ms``; peak device memory of the
    step."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    busy_ms, wall_ms, top = device_time_by_kernel(step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if busy_ms == 0.0:
        print(f'profile {label}: the profiler saw no device time (not '
              f'measured); peak memory {peak:.2f} GiB', flush=True)
        return
    # PyTorch's index_add_ runs indexFunc* kernels; index_select runs
    # vectorized_gather_kernel or indexSelect* kernels.
    add_ms = sum(t for name, t in top if 'indexFunc' in name)
    gather_ms = sum(t for name, t in top
                    if re.search('vectorized_gather|indexSelect', name))
    print(f'profile {label} step: device busy {busy_ms:.3f} ms of '
          f'{wall_ms:.3f} ms (unprofiled step {ms:.3f} ms), idle share '
          f'{1 - busy_ms / wall_ms:.3f}; peak memory '
          f'{peak:.2f} GiB; index_select gathers {gather_ms:.3f} ms, '
          f'index_add_ {add_ms:.3f} ms; by kernel (ms): '
          + '; '.join(f'{name} {t:.3f}' for name, t in top[:top_n]),
          flush=True)


def rgcn_kid(plan):
    """The kernel that applies a per-relation plan: K1, K2 or K2h."""
    from pyg_lib_tpu_torch import ops

    if isinstance(plan, ops.DedupSpmmPlan):
        return 'K2h' if plan.num_hot else 'K2'
    return 'K1'


def plain_sum(x, plan):
    """The plain version of the kernel that applies ``plan`` (chunked,
    dedup or fused-range) to ``x``, ``BLOCK`` columns at a time."""
    from pyg_lib_tpu_torch import ops

    if isinstance(plan, ops.DedupSpmmPlan):
        return by_columns(ops.dedup_sum_plain, x, plan)
    if isinstance(plan, ops.FusedRangePlan):
        return by_columns(ops.fused_range_plain, x, plan)
    return by_columns(ops.spmm_chunked_plain, x, plan)


def describe(plan):
    """One plan's kernel and size, for the plans line."""
    from pyg_lib_tpu_torch import ops

    if isinstance(plan, ops.DedupSpmmPlan):
        return (f'{rgcn_kid(plan)} dedup chunks={plan.num_chunks} '
                f'ec={plan.ec} uc={plan.uc} hot={plan.num_hot}')
    if isinstance(plan, ops.FusedRangePlan):
        return (f'K7 fused S={len(plan.plans)} chunk={plan.chunk} '
                f'slots={plan.cat_cols.numel()} '
                f'weighted={plan.weights is not None}')
    return (f'K1 chunked chunk={plan.chunk} '
            f'E_pad={plan.col_padded.numel()}')


def _terms(plan):
    """The terms of the kernel that applies ``plan``: a list of ``(src,
    dst, w)``, each term ``w * x[src]`` added into row ``dst`` (``w`` None
    for 1), and the rows of the result before it is cut to
    ``plan.num_rows``. K1 (``SpmmPlan``) reads each real slot's column;
    K1 per range (``RangeSpmmPlan``) and K7 (``FusedRangePlan``) each
    range's slots at ``lo_s + col``, K7 times the range's weights; K2
    (``DedupSpmmPlan``) each real edge's unique row times its weight, and
    K2h its hot list's entries times their counts or weight sums."""
    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import TR, _padded_rows

    def slots(p, lo=0, w=None):
        slot, row = _padded_rows(p.tile_ptr)
        return (p.col_padded[slot].long() + lo, row,
                None if w is None else w[slot])

    if isinstance(plan, ops.SpmmPlan):
        return [slots(plan)], plan.num_rows
    if isinstance(plan, (ops.RangeSpmmPlan, ops.FusedRangePlan)):
        ws = getattr(plan, 'weights', None) or [None] * len(plan.plans)
        return [slots(p, lo, w) for (lo, _), p, w in
                zip(plan.bounds, plan.plans, ws)], plan.num_rows
    meta = plan.edge_meta
    c, e = torch.nonzero(meta[:, 0, :] >= 0, as_tuple=True)
    terms = [(plan.uniq_cols[c * plan.uc + meta[c, 1, e].long()].long(),
              plan.chunk_tile[c].long() * TR + meta[c, 0, e].long(),
              meta[c, 2, e].view(torch.float32) if plan.weighted else None)]
    rows = max(-(-plan.num_rows // TR), 1) * TR
    if plan.num_hot:
        # From the plan's dense hot_w, not the hot list K2h reads, which
        # is derived from it: a fault there must not reach the reference.
        row, h = torch.nonzero(plan.hot_w, as_tuple=True)
        terms.append((plan.hot_cols[h].long(), row, plan.hot_w[row, h]))
    return terms, rows


def sums64(xm, plan, absolute=False, block=HUGE_BLOCK):
    """What the kernel that applies ``plan`` to ``xm`` computes (K1, K1 per
    range, K2, K2h or K7, weighted or not: :func:`_terms`), summed in f64,
    ``block`` columns at a time; with ``absolute``, the sums of the terms'
    magnitudes, Σ|terms|. An f32 sum of the same terms is off by its own
    rounding, up to its addition depth times 2**-24 of Σ|terms|, which on
    rows of thousands of terms is more than the kernels' bound allows."""
    import torch

    terms, rows = _terms(plan)
    outs = []
    for lo in range(0, xm.shape[1], block):
        xb = xm[:, lo:lo + block]
        out = torch.zeros((rows, xb.shape[1]), dtype=torch.float64,
                          device=xm.device)
        for src, dst, w in terms:
            msgs = xb[src].double()
            if w is not None:
                msgs *= w.double()[:, None]
            out.index_add_(0, dst, msgs.abs() if absolute else msgs)
        outs.append(out[:plan.num_rows])
    return torch.cat(outs, 1)


def depth(plan, f):
    """Per row of ``plan``, the most f32 roundings a term passes through in
    the kernel that applies it at width ``f``, which keep the kernel within
    depth * 2**-24 of the terms' magnitude from the exact sum: K1's walk
    adds a row's slots in order, a cut row's pieces of at most K1_LONG in
    8 runs a warp then across the warps and onto the row
    (csrc/row_pieces.cuh); K1 per range adds the ranges' results; K7's
    walk adds a row's slots of every range in order, its runs of more than
    K7_LONG slots in a range cut into pieces as K1's, and a weight is
    fused into its term's addition; K2 adds a warp's run of at most ec/16
    edges, then at most 16 runs a chunk of the tile's chunks in a block's
    range into shared memory, then the blocks sharing the tile by
    atomics, the ranges being 8 per block the card holds at once (1 to 4
    an SM) over the F-blocks of 32 or 64 features (csrc/spmm_dedup.cu),
    and one more for a weight; K2h adds the row's hot entries onto that. Two
    more for a column scale and the mean's division."""
    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.ops.kernels import spmm_chunked as k1_mod
    from pyg_lib_tpu_torch.ops.kernels import spmm_range_fused as k7_mod
    from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import TR

    def runs(p):  # each row's slot count in plan p
        bounds = p.tile_ptr[:, 0, :TR + 1].long()
        return (bounds[:, 1:] - bounds[:, :-1]).reshape(-1)[:plan.num_rows]

    def cut(k, long_len):  # depth of runs k, cut above long_len
        pieces = -(-k // long_len)
        return torch.where(k > long_len,
                           long_len + -(-pieces // 8) + 8, k)

    if isinstance(plan, ops.RangeSpmmPlan):
        return (torch.stack([depth(p, f) for p in plan.plans]).amax(0)
                + len(plan.plans))
    if isinstance(plan, ops.SpmmPlan):
        return cut(runs(plan), k1_mod.K1_LONG) + 2
    if isinstance(plan, ops.FusedRangePlan):
        long_len = k7_mod.K7_LONG
        k = torch.stack([runs(p) for p in plan.plans])
        walked = torch.where(k > long_len, 0, k).sum(0)
        pieces = torch.where(k > long_len, -(-k // long_len), 0).sum(0)
        return (walked + torch.where(pieces > 0,
                                     long_len + -(-pieces // 8) + 9, 0) + 2)
    c = plan.num_chunks
    sms = torch.cuda.get_device_properties(
        plan.chunk_tile.device).multi_processor_count
    r_lo = max(min(c, -(-8 * sms // -(-f // 32))), 1)
    r_hi = max(min(c, -(-32 * sms // -(-f // 64))), 1)
    tiles = max(-(-plan.num_rows // TR), 1)
    ct = torch.bincount(plan.chunk_tile.long(), minlength=tiles)
    in_range = ct.clamp(max=-(-c // r_lo))
    blocks = torch.minimum(ct, -(-ct // max(c // r_hi, 1)) + 1)
    d = (-(-plan.ec // 16) + 16 * in_range + blocks).repeat_interleave(
        TR)[:plan.num_rows] + int(plan.weighted)
    if plan.num_hot:
        d = d + (plan.hot_w != 0).sum(1)[:plan.num_rows] + 1
    return d + 2


def rgcn_paths(dev, run_path):
    """The R-GCN [128, 128, 349] on a graph of ogbn-mag's published shape
    (``testing.mag_graph``: 1,939,743 nodes of 4 types, 21,111,007 edges of
    4 relations, Zipf(1.2) sources, seed 0), trained ``STEPS`` Adam steps
    (cross-entropy on the papers) in each of its three forms, each a path
    of its own: per-relation plans built ``dedup='auto'`` (K1 and/or
    K2/K2h, as each side's plan says), the stacked plans (K1m over the
    ``[E_pad, F]`` messages) and the range-sliced plans (K7 with weights,
    forward and backward). With the initial weights, each form's output
    and weight gradients are then held against the same computation
    through the plain versions (with the kernel path's ReLU branches) and
    the three forms' outputs against each other, all within ``GCN_RTOL``;
    and each kernel of the paths against its plain version at F=349 on
    the paths' plans (K2/K2h on every per-relation side, K7 on the
    range-sliced plan into paper and its transpose, K1m on the stacked
    paper plan's 5.1G-element messages), within the sum tolerance, and
    timed. Returns those kernels' largest errors, and the graph.
    """
    import copy

    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.models import (RGCN, HeteroSpmmPlan,
                                          build_rgcn_graphs,
                                          build_rgcn_planned,
                                          rgcn_forward_planned,
                                          rgcn_forward_spmm)
    from pyg_lib_tpu_torch.ops.kernels import spmm_range_fused as k7_mod
    from pyg_lib_tpu_torch.testing import mag_graph

    class PlainSpmm(torch.autograd.Function):
        """``spmm``'s sum through the plain versions: the forward plan's,
        and the transpose plan's in the backward."""

        @staticmethod
        def forward(ctx, x, graph):
            ctx.graph = graph
            return plain_sum(x, graph.fwd)

        @staticmethod
        def backward(ctx, g):
            return plain_sum(g.contiguous(), ctx.graph.bwd), None

    class PlainPadded(torch.autograd.Function):
        """``segment_sum_padded`` with K1m's plain version (its backward
        has no kernel: ``g[row_padded]``, pad slots 0)."""

        @staticmethod
        def forward(ctx, msgs, plan):
            ctx.plan = plan
            return by_columns(ops.segment_sum_chunked_plain, msgs, plan)

        @staticmethod
        def backward(ctx, g):
            grad = g.index_select(0, ctx.plan.row_padded)
            grad.mul_(ctx.plan.valid_mask[:, None])
            return grad, None

    def plain_forward(params, x_dict, plans, masks):
        """``rgcn_forward_spmm`` (a dict of graphs) or
        ``rgcn_forward_planned`` through the plain versions; the hidden
        ReLUs take the branches ``masks`` gives."""
        layers = params['layers']
        for i, layer in enumerate(layers):
            out = {t: h @ layer['w_self'] + layer['b']
                   for t, h in x_dict.items()}
            if isinstance(plans, dict):
                for ri, k in enumerate(sorted(plans)):
                    g = plans[k]
                    agg = PlainSpmm.apply(x_dict[k[0]] @ layer['w'][ri], g)
                    out[k[2]] = out[k[2]] + agg / g.deg.clamp(
                        min=1.0)[:, None]
            else:
                h_cat = ops.segment_matmul(
                    torch.cat([x_dict[k[0]] for k in plans.rel_order]),
                    plans.src_ptr, layer['w'])
                for t, g in plans.graphs.items():
                    if isinstance(g.fwd, ops.FusedRangePlan):
                        agg = PlainSpmm.apply(h_cat, g)
                    else:
                        msgs = h_cat.index_select(0, g.fwd.col_padded)
                        msgs.mul_(plans.deginv[t][:, None])
                        agg = PlainPadded.apply(msgs, g.fwd)
                        del msgs
                    out[t] = out[t] + agg[:out[t].shape[0]]
                del h_cat
            x_dict = out
            if i < len(layers) - 1:
                x_dict = {t: torch.where(masks[t], v, torch.zeros_like(v))
                          for t, v in x_dict.items()}
        return x_dict

    # -- the graph and the three forms' plans ----------------------------
    t0 = time.perf_counter()
    num_nodes, rowptr_d, col_d = mag_graph()
    t_gen = time.perf_counter() - t0
    rels = sorted(rowptr_d)
    builds = {}
    t0 = time.perf_counter()
    graphs = build_rgcn_graphs(rowptr_d, col_d, num_nodes, chunk=MAG_CHUNK,
                               dedup='auto', device=dev)
    builds['per-relation'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stacked = build_rgcn_planned(rowptr_d, col_d, num_nodes,
                                 chunk=MAG_CHUNK, device=dev)
    builds['stacked'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sliced = build_rgcn_planned(rowptr_d, col_d, num_nodes, chunk='auto',
                                range_sliced=True, device=dev)
    builds['range-sliced'] = time.perf_counter() - t0
    edges = {k[1]: int(col_d[k].shape[0]) for k in rels}
    longest = {k[1]: (int(np.diff(rowptr_d[k]).max()),
                      int(np.bincount(col_d[k]).max())) for k in rels}
    # The stacked CSR into paper with its 1/deg weights, for
    # torch.sparse.mm beside K7 below.
    into_paper = [(i, k) for i, k in enumerate(rels) if k[2] == 'paper']
    deg = {k: np.diff(rowptr_d[k]) for _, k in into_paper}
    paper_coo = (
        np.concatenate([np.repeat(np.arange(num_nodes['paper']), deg[k])
                        for _, k in into_paper]),
        np.concatenate([col_d[k] + stacked.src_ptr[i]
                        for i, k in into_paper]),
        np.concatenate([np.repeat(1.0 / np.maximum(deg[k], 1), deg[k])
                        for _, k in into_paper]).astype(np.float32))
    del deg  # rowptr_d and col_d stay for the mini-batch path (rgcn_main)
    print(f'R-GCN graph (ogbn-mag shape, Zipf(1.2) sources, seed 0): nodes '
          f'{num_nodes}, edges {edges}, longest row and column '
          f'{longest} ({t_gen:.1f} s); plan builds (s) {builds}',
          flush=True)
    for k in rels:
        print(f'  per-relation {k[1]} ({k[0]} -> {k[2]}): fwd '
              f'{describe(graphs[k].fwd)}; bwd {describe(graphs[k].bwd)}',
              flush=True)
    for t in stacked.graphs:
        print(f'  stacked into {t}: {describe(stacked.graphs[t].fwd)}; '
              f'range-sliced: {describe(sliced.graphs[t].fwd)}', flush=True)
    paper_pad = stacked.graphs['paper'].fwd.col_padded.numel()
    if not (all(isinstance(g.fwd, ops.SpmmPlan) and g.fwd.row_padded
                is not None for g in stacked.graphs.values())
            and all(isinstance(g.fwd, ops.FusedRangePlan)
                    and g.fwd.weights is not None and g.bwd.weights
                    is not None for g in sliced.graphs.values())
            and stacked.src_ptr[-1] == sum(num_nodes[k[0]] for k in rels)
            and paper_pad * MAG_DIMS[-1] >= INT32_ELEMENTS):
        raise AssertionError('the R-GCN plans are not the expected ones')

    # -- training, each form a path of its own ----------------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    x_dict = {t: torch.randn((n, MAG_DIMS[0]), generator=gen, device=dev)
              for t, n in num_nodes.items()}
    target = torch.randint(0, MAG_DIMS[-1], (num_nodes['paper'], ),
                           generator=gen, device=dev)
    model0 = RGCN(MAG_DIMS, len(rels),
                  generator=torch.Generator().manual_seed(3), device=dev)
    forms = {'per-relation': graphs, 'stacked': stacked,
             'range-sliced': sliced}
    need = {'per-relation': sorted(
        {rgcn_kid(g.fwd) for g in graphs.values()} |
        {rgcn_kid(graphs[k].bwd) for k in rels if k[2] == 'paper'}),
        'stacked': ('K1m', ), 'range-sliced': ('K7', )}

    def train_rgcn(model, plans, split):
        """``STEPS`` Adam steps; ms per step after the first. ``split``
        gets K7's launches in the forwards and in the backwards."""
        opt = torch.optim.Adam(model.parameters(), lr=RGCN_LR)
        losses = []
        for step in range(STEPS):
            if step == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            opt.zero_grad()
            c0 = ops.fused_range_sum.launches
            loss = torch.nn.functional.cross_entropy(
                model(x_dict, plans)['paper'], target)
            c1 = ops.fused_range_sum.launches
            loss.backward()
            split['forward'] = split.get('forward', 0) + c1 - c0
            split['backward'] = (split.get('backward', 0) +
                                 ops.fused_range_sum.launches - c1)
            opt.step()
            losses.append(loss.detach())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (STEPS - 1)
        losses = [float(v) for v in losses]
        if not np.isfinite(losses).all():
            raise AssertionError(f'R-GCN losses {losses} are not finite')
        return ms, losses

    for form, plans in forms.items():
        model = copy.deepcopy(model0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        split = {}
        ms, losses = run_path(f'R-GCN {form}', need[form],
                              lambda: train_rgcn(model, plans, split))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'  {STEPS} R-GCN {MAG_DIMS} {form} training steps (Adam): '
              f'{ms:.3f} ms per step after the first, peak memory '
              f'{peak:.2f} GiB, plan build {builds[form]:.1f} s, losses '
              f'{[round(v, 4) for v in losses]}; K7 launches forward '
              f'{split["forward"]}, backward {split["backward"]}',
              flush=True)
        if form == 'range-sliced' and min(split.values()) <= 0:
            raise AssertionError('K7 did not launch in both the forward and '
                                 'the backward of the range-sliced R-GCN')
        def step():
            model.zero_grad()
            torch.nn.functional.cross_entropy(model(x_dict, plans)['paper'],
                                              target).backward()

        profile(f'R-GCN {form}', step, ms, top_n=12)
        del model
    torch.cuda.empty_cache()

    # -- each form against its plain computation and the others ----------
    params = model0.params()
    names = [n for n, _ in model0.named_parameters()]
    leaves = list(model0.parameters())
    cots = {t: torch.randn((n, MAG_DIMS[-1]), generator=gen, device=dev)
            for t, n in num_nodes.items()}
    first = None
    for form, plans in forms.items():
        fwd = (rgcn_forward_planned if isinstance(plans, HeteroSpmmPlan)
               else rgcn_forward_spmm)
        with torch.no_grad():  # layer 1 alone: its pre-activations
            masks = {t: v > 0 for t, v in fwd(
                {'layers': params['layers'][:1]}, x_dict, plans).items()}
        out = model0(x_dict, plans)
        grads = torch.autograd.grad(
            sum((out[t] * cots[t]).sum() for t in out), leaves)
        out = {t: v.detach() for t, v in out.items()}
        torch.cuda.empty_cache()
        ref = plain_forward(params, x_dict, plans, masks)
        refs = torch.autograd.grad(
            sum((ref[t] * cots[t]).sum() for t in ref), leaves)
        del masks
        for t in out:
            close(f'R-GCN {form} forward {t}', out[t], ref[t].detach())
        for name, g, r in zip(names, grads, refs):
            close(f'  R-GCN {form} grad {name}', g, r)
        del ref, refs, grads
        out = {t: v.cpu() for t, v in out.items()}
        if first is None:
            first = out
        else:
            for t in out:
                close(f'R-GCN {form} forward {t} against per-relation',
                      out[t], first[t])
        del out
        torch.cuda.empty_cache()
    del first, cots

    # -- segment_matmul beside one torch.mm, and the kernels on their own
    # plans at F=349 ------------------------------------------------------
    with torch.no_grad():
        x_cat = torch.cat([x_dict[k[0]] for k in stacked.rel_order])
        rows = x_cat.shape[0]
        for f_out in sorted(set(MAG_DIMS[1:])):
            w = torch.randn((len(rels), MAG_DIMS[0], f_out), generator=gen,
                            device=dev)
            seg = cuda_ms(lambda: ops.segment_matmul(x_cat, stacked.src_ptr,
                                                     w))
            one = cuda_ms(lambda: x_cat @ w[0])
            tflops = 2 * rows * MAG_DIMS[0] * f_out / 1e9
            print(f'  segment_matmul [{rows}, {MAG_DIMS[0]}] by '
                  f'[{len(rels)}, {MAG_DIMS[0]}, {f_out}] f32: {seg:.3f} ms '
                  f'({tflops / seg:.1f} TFLOP/s); one torch.mm over the same '
                  f'rows {one:.3f} ms ({tflops / one:.1f} TFLOP/s)',
                  flush=True)
        del x_cat, w
        f = MAG_DIMS[-1]
        errs = {}

        def check(label, kid, got, ref, mag, against='its plain version',
                  note=''):
            """A kernel's output against ``ref``, within SUM_RTOL of the
            sum of the terms' magnitudes (``mag``)."""
            err = (got.double() - ref.double()).abs()
            e = float(err.max()) if err.numel() else 0.0
            errs[kid] = max(errs.get(kid, 0.0), e)
            print(f'  {kid} {label}: max_abs_err {e:.3g} against {against} '
                  f'(tolerance {SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g})'
                  f'{note}', flush=True)
            if (not torch.isfinite(got).all()
                    or bool((err > SUM_RTOL * mag + SUM_ATOL).any())):
                raise AssertionError(f'{kid} {label} disagrees with '
                                     f'{against}: max_abs_err {e}')

        def check64(label, kid, got, plan, src):
            """:func:`check` against the f64 sums of the kernel's terms
            (:func:`sums64`), with the error over Σ|terms| and the
            kernel's addition depth (:func:`depth`) printed beside it."""
            ref, mag = sums64(src, plan), sums64(src, plan, absolute=True)
            rel = float(((got.double() - ref).abs() / mag.clamp(min=1))
                        .max()) if got.numel() else 0.0
            check(label, kid, got, ref, mag, 'the f64 sums',
                  f'; largest error / max(sum|terms|, 1) {rel:.3g}; '
                  f'addition depth up to '
                  f'{int(depth(plan, got.shape[1]).max())}')

        for k in rels:
            for side, plan in (('fwd', graphs[k].fwd),
                               ('bwd', graphs[k].bwd)):
                n_in = num_nodes[k[0] if side == 'fwd' else k[2]]
                xs = torch.randn((n_in, f), generator=gen, device=dev)
                run = (ops.dedup_sum if isinstance(plan, ops.DedupSpmmPlan)
                       else ops.spmm_chunked)
                kid, label = rgcn_kid(plan), f'per-relation {k[1]} {side}'
                check64(f'{label} F={f}', kid, run(xs, plan), plan, xs)
                ms = cuda_ms(lambda: run(xs, plan))
                floor = edges[k[1]] * f * 4 / HBM_BYTES_PER_S * 1e3
                print(f'  {kid} {label} F={f} f32: {ms:.3f} ms, gather '
                      f'floor {floor:.3f} ms', flush=True)
                del xs
        # K7 into paper on the range-sliced plan, and over its transpose
        # (the backward; rows of up to 1.4M edges), each beside
        # torch.sparse.mm on the same weighted CSR (weights 1/deg > 0).
        n_src, n_paper = int(stacked.src_ptr[-1]), num_nodes['paper']
        e_paper = edges['cites'] + edges['writes']
        a = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack(paper_coo[:2])),
            torch.from_numpy(paper_coo[2]), (n_paper, n_src)).coalesce()
        a = (a.to_sparse_csr().to(dev), a.t().coalesce().to_sparse_csr()
             .to(dev))
        del paper_coo
        h_cat = torch.randn((n_src, f), generator=gen, device=dev)
        g_paper = torch.randn((n_paper, f), generator=gen, device=dev)
        floor = e_paper * f * 4 / HBM_BYTES_PER_S * 1e3
        for side, plan, src, lib in (
                ('forward', sliced.graphs['paper'].fwd, h_cat, a[0]),
                ('backward (transpose)', sliced.graphs['paper'].bwd,
                 g_paper, a[1])):
            label = f'range-sliced into paper {side}'
            check64(f'{label} F={f}', 'K7', ops.fused_range_sum(src, plan),
                    plan, src)
            ms = cuda_ms(lambda: ops.fused_range_sum(src, plan), iters=3,
                         warmup=1)
            lib_ms = cuda_ms(lambda: torch.sparse.mm(lib, src), iters=3,
                             warmup=1)
            # The same kernel with no run cut into pieces (a warp walks
            # each whole row, as before the cut), on the same inputs.
            k7_mod.K7_LONG, long_len = 1 << 30, k7_mod.K7_LONG
            try:
                whole_ms = cuda_ms(lambda: ops.fused_range_sum(src, plan),
                                   iters=3, warmup=1)
            finally:
                k7_mod.K7_LONG = long_len
            print(f'  K7 {label} F={f} f32: {ms:.3f} ms ({whole_ms:.3f} ms '
                  f'with no run cut), gather floor {floor:.3f} ms; '
                  f'torch.sparse.mm on the weighted CSR {lib_ms:.3f} ms',
                  flush=True)
        del a, g_paper
        # K1m over the stacked paper plan's [E_pad, 349] messages: more
        # than 2**31 elements, so its offsets must be 64-bit.
        plan = stacked.graphs['paper'].fwd
        msgs = h_cat.index_select(0, plan.col_padded)
        del h_cat
        check(f'stacked into paper F={f} over {msgs.numel()} elements',
              'K1m', ops.segment_sum_chunked(msgs, plan),
              by_columns(ops.segment_sum_chunked_plain, msgs, plan),
              by_columns(lambda m, p: ops.segment_sum_chunked_plain(
                  m.abs(), p), msgs, plan))
        ms = cuda_ms(lambda: ops.segment_sum_chunked(msgs, plan))
        nbytes = msgs.numel() * 4 + plan.num_rows * f * 4
        print(f'  K1m stacked into paper F={f} f32 over [{paper_pad}, {f}] '
              f'messages: {ms:.3f} ms, bound '
              f'{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms', flush=True)
        del msgs
    torch.cuda.empty_cache()
    return errs, (num_nodes, rowptr_d, col_d)


def mag_minibatch(dev, run_path, num_nodes, rowptr_d, col_d):
    """Path B: the R-GCN in mini-batches on the same graph. Its CSRs run
    over each relation's destination type, so the port's
    ``HeteroNeighborLoader`` samples with ``csc=True``: ``MAG_BATCH``
    paper seeds, ``MAG_FANOUTS`` a hop and relation, node budgets the
    worst case of those fanouts; ``pad_hetero_sample_output``'s batch goes
    through ``RGCNBatch`` ``MAG_DIMS`` (``segment_matmul`` per relation),
    Adam at ``RGCN_LR``, one warm-up step, ``MAG_BATCH_STEPS`` timed and
    one profiled. The losses must be finite, and one more batch's loss
    and weight gradients equal the same model's on the CPU within
    ``GCN_RTOL`` of their largest magnitude."""
    import torch

    from pyg_lib_tpu_torch.loader import HeteroNeighborLoader
    from pyg_lib_tpu_torch.models import RGCNBatch

    rels = sorted(rowptr_d)
    # The worst case: every sampled node new. A frontier node of type t
    # samples each relation into t (its CSR runs over t).
    frontier, total, max_edges = {'paper': MAG_BATCH}, {'paper': MAG_BATCH}, 0
    for f in MAG_FANOUTS:
        nxt = {}
        for t, n in frontier.items():
            for k in rels:
                if k[2] == t:
                    nxt[k[0]] = nxt.get(k[0], 0) + n * f
                    max_edges += n * f
        for t, n in nxt.items():
            total[t] = total.get(t, 0) + n
        frontier = nxt
    budgets = {t: max(total.get(t, 0), 8) for t in num_nodes}
    rng = np.random.default_rng(14)
    x_dict = {t: rng.standard_normal((n, MAG_DIMS[0]), dtype=np.float32)
              for t, n in num_nodes.items()}
    y_dict = {'paper': rng.integers(0, MAG_DIMS[-1], num_nodes['paper'])}
    seeds = rng.choice(num_nodes['paper'], MAG_BATCH * (MAG_BATCH_STEPS + 2),
                       replace=False)
    loader = HeteroNeighborLoader(
        {k: rowptr_d[k] for k in rels}, {k: col_d[k] for k in rels}, x_dict,
        y_dict, 'paper', seeds, MAG_BATCH, {k: MAG_FANOUTS for k in rels},
        budgets, max_edges, rng=15, device=dev, csc=True)
    model = RGCNBatch(MAG_DIMS, len(rels),
                      generator=torch.Generator().manual_seed(16), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=RGCN_LR)

    def loss_of(m, batch):
        out = m(batch['x'], batch['row'], batch['col'], batch['rel_ptr'])
        lo, n = batch['seed_offset'], batch['num_seeds']
        return torch.nn.functional.cross_entropy(out[lo:lo + n],
                                                 batch['y'][:n])

    def step(batch):
        opt.zero_grad()
        loss = loss_of(model, batch)
        loss.backward()
        opt.step()
        return float(loss.detach())

    def path():
        it = iter(loader)
        losses = [step(next(it))]  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(MAG_BATCH_STEPS):
            batch = next(it)
            t0 = time.perf_counter()
            losses.append(step(batch))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = device_time_by_kernel(lambda: losses.append(step(next(it))))
        return ms, losses, peak, prof

    ms, losses, peak, (busy, wall, top) = run_path(
        'R-GCN mini-batch (ogbn-mag)', ('G1', ), path,
        engine=('hetero_neighbor_sample', ))
    t = loader.timings
    mean = lambda v: sum(v) / len(v)
    print(f'  R-GCN mini-batch: budgets {budgets}, max_edges {max_edges}; '
          f'step ms (after a warm-up; from the batch in hand) '
          f'{[round(v, 3) for v in ms]}; host per batch: sample '
          f'{mean([v["sample_ms"] for v in t]):.3f} ms, pad '
          f'{mean([v["pad_ms"] for v in t]):.3f} ms, gather '
          f'{mean([v["gather_ms"] for v in t]):.3f} ms; nodes '
          f'{[v["num_nodes"] for v in t]}, edges '
          f'{[v["num_edges"] for v in t]}; peak memory {peak:.2f} GiB; '
          f'losses {[round(v, 4) for v in losses]}', flush=True)
    print(f'profile R-GCN mini-batch step (the next batch fetched): device '
          f'busy {busy:.3f} ms of {wall:.3f} ms, idle share '
          f'{1 - busy / wall:.3f}; by kernel (ms): '
          + '; '.join(f'{n} {v:.3f}' for n, v in top[:8]), flush=True)
    if len(losses) != MAG_BATCH_STEPS + 2 or not all(np.isfinite(losses)):
        raise AssertionError('the R-GCN mini-batch path did not train')

    # One more batch: its loss and weight gradients on the card against
    # the same model and batch on the CPU.
    it = iter(loader)
    batch = next(it)
    it.close()
    loss = loss_of(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    cpu = copy.deepcopy(model).cpu()
    ref = loss_of(cpu, {k: v.cpu() if torch.is_tensor(v) else v
                        for k, v in batch.items()})
    refs = torch.autograd.grad(ref, list(cpu.parameters()))
    close('R-GCN mini-batch loss against the CPU',
          loss.detach().cpu()[None], ref.detach()[None])
    for (name, _), g, r in zip(model.named_parameters(), grads, refs):
        close(f'  R-GCN mini-batch grad {name}', g.cpu(), r)


def rgcn_main():
    """``python3 chip_smoke.py --rgcn``: the R-GCN paths (:func:`rgcn_paths`)
    in a process of their own, as :func:`main` runs them; its last line is
    :data:`RGCN_RESULT` and, as JSON, the paths' launch counts (all, and
    K1's, K1m's and K7's by width) and the kernels' largest errors against
    their plain versions at the paths' shapes."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyg_lib_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()  # built by the calling process: loaded
    paths = Paths()
    t0 = time.perf_counter()
    dev = torch.device('cuda', 0)
    errs, graph = rgcn_paths(dev, paths.run)
    torch.cuda.empty_cache()  # the full-graph plans are gone
    t1 = time.perf_counter()
    mag_minibatch(dev, paths.run, *graph)
    print(f'R-GCN mini-batch path: {time.perf_counter() - t1:.1f} s',
          flush=True)
    paths.restore()
    print(f'R-GCN paths: {time.perf_counter() - t0:.1f} s', flush=True)
    print(RGCN_RESULT + json.dumps({
        'launches': paths.launches, 'errs': errs,
        'by_width': [[kid, f, n] for (kid, f), n in
                     sorted(paths.by_width.items())]}), flush=True)


def capture_cotangent(out):
    """A list that gets the cotangent autograd passes into the sum of
    ``spmm_sharded`` (its ``_ShardedSum`` node) when ``out`` is
    differentiated."""
    node = out.grad_fn
    while type(node).__name__ != '_ShardedSumBackward':
        node = node.next_functions[0][0]
    got = []
    node.register_prehook(lambda grads: got.append(grads[0].detach()))
    return got


def sharded_paths(dev, run_path):
    """The huge-graph step of ``bench/bench_sharded_huge.py`` at its full
    size (``testing.huge_graph``: 2,000,000 nodes, 30,009,772 edges, F=128
    f32, ``HUGE_SPLITS`` row splits): the value and gradient of
    ``(spmm_sharded(x, g, reduce, precision)**2).sum()``, ``STEPS`` steps
    a variant, each a path of its own:

    * S1: uniform columns, ``chunk=512``; mean in bf16, f32 and int8 (K1);
    * S2: uniform, ``chunk='auto', range_split=HUGE_RANGES`` (K1 a range);
    * S3: S1's plans, max and min (K4 with the gather fused);
    * S4: Zipf(1.2) columns, ``dedup='off'``; mean in bf16 (K1, and K1's
      pieces over the transpose's hub rows, up to 5.6M slots);
    * S5: Zipf(1.2), ``dedup='auto', minmax='auto'``; mean in bf16 (K2h or
      K2 as each split's plan says, K1 and its pieces where a side stays
      chunked) and max (K5).

    Each variant's output and gradient are held against the plain
    versions (sums in f64, ``HUGE_BLOCK`` columns at a time, within the
    sum tolerance plus the kernel's addition depth; max and min bit for
    bit, their gradient within the sum tolerance) and against ``spmm``
    over ``build_spmm_graph`` of the same CSR. The first backward split
    (the hub rows) goes through K1 and its pieces (S4) and K2 (S5) alone,
    on random terms and on small integers, whose sums must come out
    exact. Records build seconds, the unprofiled step, one profiled step,
    peak memory and the bench's ``traffic_gbps``; times K1 over S4's
    first backward split cut and uncut beside ``torch.sparse.mm`` on that
    CSR. Returns the kernels' largest errors and K1's piece row of the
    kernels line (without its launches)."""
    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.ops.kernels import spmm_chunked as k1_mod
    from pyg_lib_tpu_torch.ops.kernels.segment_minmax import POS_NONE
    from pyg_lib_tpu_torch.testing import HUGE_NODES, huge_graph

    tspmm = sys.modules['pyg_lib_tpu_torch.ops.spmm']
    n, f = HUGE_NODES, HUGE_F
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((n, f), generator=gen, device=dev)

    def kid_of(plan):
        if isinstance(plan, ops.DedupSpmmPlan):
            return 'K2h' if plan.num_hot else 'K2'
        if isinstance(plan, ops.DedupMinmaxPlan):
            return 'K5'
        return 'K1'

    def kids(plans):
        out = {kid_of(p) for p in plans}
        if any(isinstance(p, ops.SpmmPlan)
               and k1_mod.k1_pieces(p).rows.shape[0] for p in plans):
            out.add('K1p')
        return out

    def plain_split(xm, plan, scale=None):
        """The plain version of the split's kernel with its sums in f64
        (:func:`sums64`): the transpose's hub rows add up to 5.6M terms of
        one sign, each of which an f32 index_add_ rounds to its running
        sum's ulp (its result was 1% off on S4's first split)."""
        out = sums64(xm, plan)
        return out if scale is None else out * scale[None, :].double()

    def depths(plans, rows):
        return torch.cat([depth(p, f) for p in plans])[:rows]

    def plain_sharded(v, plans, rows, precision):
        """The sharded sum through the plain versions over the rows the
        kernels read under ``precision``, and its Σ|terms|, in f64."""
        if precision == 'int8':
            xm, scale = ops.quantize_columns(v)
        else:
            xm, scale = (v.to(torch.bfloat16) if precision == 'bf16'
                         else v), None
        ref = torch.cat([plain_split(xm, p, scale) for p in plans])[:rows]
        mag = torch.cat([plain_split(xm.abs(), p, scale)
                         for p in plans])[:rows]
        return ref, mag, scale

    def check(label, kid, got, ref, mag, extra=0.0, why='', deep=None):
        """Within SUM_RTOL * mag + SUM_ATOL, plus ``extra`` (``why``), and,
        where ``deep`` gives each row's addition depth d (:func:`depth`),
        plus d * 2**-24 * mag. The error counts as kernel ``kid``'s
        against its plain version unless ``kid`` is None."""
        err = (got.double() - ref.double()).abs()
        e = float(err.max())
        if kid is not None:
            errs[kid] = max(errs.get(kid, 0.0), e)
        same = ref.dtype == got.dtype and torch.equal(
            got.view(torch.int32), ref.view(torch.int32))
        tol = SUM_RTOL * mag + SUM_ATOL + extra
        if deep is not None:
            tol = tol + 2.0**-24 * deep[:, None] * mag
            why += (f' + d * 2^-24 * sum|terms| for addition depth d, up '
                    f'to {int(deep.max())}')
        print(f'  {label}: max_abs_err {e:.3g} (tolerance {SUM_RTOL:g} * '
              f'sum|terms| + {SUM_ATOL:g}{why}); largest error / '
              f'max(sum|terms|, 1) {float((err / mag.clamp(min=1)).max()):.3g}'
              f'{"; equal bit for bit" if same else ""}',
              flush=True)
        if (got.shape != ref.shape or not torch.isfinite(got).all()
                or bool((err > tol).any())):
            at = divmod(int((err - tol).argmax()), got.shape[1])
            print(f'  {label}: worst at {at}: got {float(got[at]):.9g}, '
                  f'plain {float(ref[at]):.9g}, sum|terms| '
                  f'{float(mag[at]):.9g}, tolerance {float(tol[at]):.9g}',
                  flush=True)
            raise AssertionError(f'{label} disagrees: max_abs_err {e}')

    def check_exact(label, kid, call, plan, plain):
        """``call`` on ``plan`` over integers in [-1, 2] against ``plain``,
        bit for bit: every partial sum of a row of up to 5.6M such terms
        is an integer below 2**24, which f32 holds exactly, so a term
        dropped or added twice shows."""
        xi = torch.randint(-1, 3, (n, f), generator=gen, device=dev,
                           dtype=torch.int8).to(torch.bfloat16)
        got, ref = call(xi, plan), plain(xi, plan)
        bad = int((got.double() != ref).sum())
        print(f'  {kid} {label} over integers: '
              f'{"equal bit for bit to" if not bad else f"{bad} DIFFER from"}'
              f' the exact sums', flush=True)
        if bad:
            raise AssertionError(f'{kid} {label}: {bad} sums of integers '
                                 f'are not exact')

    def train(graph, reduce, precision):
        """``STEPS`` steps; ms per step after the first, the last step's
        output and gradient."""
        xs = x.detach().requires_grad_()
        for step in range(STEPS):
            if step == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = ops.spmm_sharded(xs, graph, reduce, precision)
            (grad, ) = torch.autograd.grad((out**2).sum(), xs)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / (STEPS - 1),
                out.detach(), grad)

    def variant(label, graph, reduce, precision, need, edges):
        """One variant as a main path: its steps, the unprofiled step,
        peak memory, traffic_gbps and one profiled step."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms, out, grad = run_path(f'sharded {label}', sorted(need),
                                 lambda: train(graph, reduce, precision))
        peak = torch.cuda.max_memory_allocated() / 2**30
        gbps = 2 * (edges * f * 4 + edges * 4 + n * f * 4) / ms / 1e6
        print(f'  {STEPS} {label} steps ({reduce}, precision={precision}): '
              f'{ms:.3f} ms per step after the first, peak memory '
              f'{peak:.2f} GiB, traffic_gbps {gbps:.1f}', flush=True)
        xs = x.detach().requires_grad_()

        def step():
            o = ops.spmm_sharded(xs, graph, reduce, precision)
            torch.autograd.grad((o**2).sum(), xs)

        profile(f'sharded {label}', step, ms, top_n=10)
        return out, grad

    def check_mean(label, graph, precision, single, deg_in):
        """A mean variant's output and gradient against the plain versions
        and against ``spmm`` over the unsharded graph ``single``."""
        fk = sorted({kid_of(p) for p in graph.fwd})[0]
        bk = 'K1p' if 'K1p' in kids(graph.bwd) else kid_of(graph.bwd[0])
        xs = x.detach().requires_grad_()
        out = ops.spmm_sharded(xs, graph, 'mean', precision)
        cap = capture_cotangent(out)
        (grad, ) = torch.autograd.grad((out**2).sum(), xs)
        out = out.detach()
        d = graph.deg.clamp(min=1.0)[:, None]
        ref, mag, _ = plain_sharded(x, graph.fwd, graph.num_rows, precision)
        fdeep = depths(graph.fwd, graph.num_rows)
        check(f'{fk} {label} forward against the plain versions', fk, out,
              ref / d, mag / d, deep=fdeep)
        ref, gmag, gscale = plain_sharded(cap[0], graph.bwd, graph.num_cols,
                                          precision)
        bdeep = depths(graph.bwd, graph.num_cols)
        check(f'{bk} {label} gradient against the plain versions', bk, grad,
              ref, gmag, deep=bdeep)
        del ref
        xu = x.detach().requires_grad_()
        out_u = ops.spmm(xu, single, 'mean', precision)
        (grad_u, ) = torch.autograd.grad((out_u**2).sum(), xu)
        # Each side within its own depth of the exact sum.
        check(f'{label} forward against the unsharded spmm', None, out,
              out_u.detach(), mag / d, deep=fdeep + depth(single.fwd, f))
        # The two cotangents may differ by rounding, and so their bf16
        # rows or int8 quanta: one step a term.
        extra, why = 0.0, ''
        if precision == 'bf16':
            extra, why = 2.0**-8 * gmag, ' + 2^-8 * sum|terms|'
        elif precision == 'int8':
            extra = deg_in[:, None] * 2.0 * gscale[None, :]
            why = ' + two quanta a term'
        check(f'{label} gradient against the unsharded spmm', None, grad,
              grad_u, gmag, extra, why, deep=bdeep + depth(single.bwd, f))

    def winners(plans, deg, is_min):
        """The plain versions' max/min values (0 on an empty row) and
        winning source rows (``n`` on an empty row) over ``plans``."""
        vals, tgts = [], []
        for p in plans:
            if isinstance(p, ops.DedupMinmaxPlan):
                v, q = by_columns(ops.dedup_minmax_plain, x, p, is_min,
                                  block=HUGE_BLOCK)
                idx = p.uniq_cols
            else:
                v, q = by_columns(ops.segment_max_plain, x, p, p.col_padded,
                                  is_min, block=HUGE_BLOCK)
                idx = p.col_padded
            hit = q < POS_NONE
            tgts.append(torch.where(hit, idx[torch.where(hit, q, 0).long()],
                                    n).long())
            vals.append(v)
            del q, hit
        rows = deg.shape[0]
        empty = (deg < 0.5)[:, None]
        vals = torch.cat(vals)[:rows]
        vals = torch.where(empty, 0.0, -vals if is_min else vals)
        return vals, torch.where(empty, n, torch.cat(tgts)[:rows])

    def check_winner_grad(label, out, grad, tgt):
        """The winner-only gradient against the cotangents of ``(out**2)
        .sum()`` added in f64 into the winners ``tgt``, within the sum
        tolerance: the backward adds them in f64 too, and a hub column's
        come from millions of rows."""
        cot = (2.0 * out).double()
        gref, gmag = (torch.zeros((n + 1, f), dtype=torch.float64,
                                  device=dev).scatter_add_(0, tgt, c)[:n]
                      for c in (cot, cot.abs()))
        del cot
        check(label, None, grad, gref, gmag)

    def check_minmax(label, graph, reduce, single, out, grad):
        """Max/min values bit for bit against the plain versions and the
        unsharded ``spmm``, and each path's winner-only gradient against
        its own winners. A dedup min/max plan's tie goes to the least
        column, the chunked plan's to the first edge (the JAX package's
        contract): the two paths' winners may differ only where their
        values tie."""
        is_min = reduce == 'min'
        plans = graph.mm if graph.mm is not None else graph.fwd
        kid = kid_of(plans[0]) if isinstance(plans[0],
                                             ops.DedupMinmaxPlan) else 'K4'
        vals, tgt = winners(plans, graph.deg, is_min)
        same = torch.equal(bits(out), bits(vals))
        print(f'  {kid} {label}: values '
              f'{"equal bit for bit" if same else "DIFFER"} from the plain '
              f'versions', flush=True)
        if not same:
            raise AssertionError(f'{label} values disagree')
        errs[kid] = errs.get(kid, 0.0)
        del vals
        check_winner_grad(f'{label} gradient against the plain versions',
                          out, grad, tgt)
        xu = x.detach().requires_grad_()
        out_u = ops.spmm(xu, single, reduce)
        (grad_u, ) = torch.autograd.grad((out_u**2).sum(), xu)
        out_u = out_u.detach()
        same = torch.equal(bits(out), bits(out_u))
        print(f'  {label}: values {"equal bit for bit" if same else "DIFFER"}'
              f' from the unsharded spmm', flush=True)
        if not same:
            raise AssertionError(f'{label} disagrees with the unsharded spmm')
        _, tgt_u = winners([single.mm if single.mm is not None else
                            single.fwd], single.deg, is_min)
        moved = tgt_u != tgt
        pad = torch.cat([x, x.new_zeros((1, f))])
        tied = torch.equal(pad.gather(0, tgt)[moved],
                           pad.gather(0, tgt_u)[moved])
        print(f'  {label}: {int(moved.sum())} winners differ from the '
              f'unsharded path\'s, {"all" if tied else "NOT all"} at tied '
              f'values', flush=True)
        if not tied:
            raise AssertionError(f'{label}: winners differ from the '
                                 f'unsharded path\'s off a tie')
        del pad, moved, tgt
        check_winner_grad(f'{label} unsharded gradient against its plain '
                          f'versions', out_u, grad_u, tgt_u)

    def timed(build, *args, **kw):
        t0 = time.perf_counter()
        return build(*args, **kw), time.perf_counter() - t0

    def describe_sides(name, graph):
        for side in ('fwd', 'bwd', 'mm'):
            plans = getattr(graph, side)
            if plans is None:
                continue
            p = plans[0]
            extra = ''
            if isinstance(p, ops.DedupSpmmPlan):
                extra = (f' ec={p.ec} uc={p.uc} hot={p.num_hot} hot_w='
                         f'{None if p.hot_w is None else p.hot_w.dtype}')
            elif isinstance(p, ops.DedupMinmaxPlan):
                extra = f' ec={p.ec} uc={p.uc} scan_len={p.scan_len}'
            elif isinstance(p, ops.RangeSpmmPlan):
                extra = (f' ranges={len(p.plans)} chunk={p.plans[0].chunk} '
                         f'chunks={p.plans[0].num_chunks}')
            else:
                longest = int((p.tile_ptr[:, 0, 1:129] -
                               p.tile_ptr[:, 0, :128]).max())
                extra = f' chunk={p.chunk} longest row {longest}'
            chunks = getattr(p, 'num_chunks', None)
            print(f'  {name} {side}: {len(plans)} x {type(p).__name__}'
                  f'{"" if chunks is None else f" chunks={chunks}"}{extra}; '
                  f'kernels {sorted(kids(plans))}', flush=True)

    report = {}

    # -- uniform columns: S1, S3, S2 --------------------------------------
    t0 = time.perf_counter()
    rp, cl = huge_graph('uniform')
    edges = int(rp[-1])
    t_gen = time.perf_counter() - t0
    g1, report['S1 build s'] = timed(ops.build_spmm_graph_sharded, rp, cl,
                                     HUGE_SPLITS, chunk=512)
    u1, report['uniform unsharded build s'] = timed(ops.build_spmm_graph,
                                                    rp, cl, chunk=512)
    deg_in = torch.from_numpy(np.bincount(cl, minlength=n).astype(
        np.float32)).to(dev)
    print(f'huge graph (bench_sharded_huge.py, seed 0): {n} nodes, {edges} '
          f'edges, F={f}, {HUGE_SPLITS} splits ({t_gen:.1f} s); builds (s): '
          f'S1 {report["S1 build s"]:.1f}, unsharded '
          f'{report["uniform unsharded build s"]:.1f}', flush=True)
    describe_sides('S1', g1)
    if not all(isinstance(p, ops.SpmmPlan) for p in g1.fwd + g1.bwd):
        raise AssertionError('S1 did not get plain split plans')
    for precision in ('bf16', None, 'int8'):
        label = f'S1 {precision or "f32"}'
        variant(label, g1, 'mean', precision, ('K1', ), edges)
        check_mean(label, g1, precision, u1, deg_in)
    for reduce in ('max', 'min'):
        out, grad = variant(f'S3 {reduce}', g1, reduce, None, ('K4', ),
                            edges)
        check_minmax(f'S3 {reduce}', g1, reduce, u1, out, grad)
        del out, grad
    del g1
    g2, report['S2 build s'] = timed(ops.build_spmm_graph_sharded, rp, cl,
                                     HUGE_SPLITS, chunk='auto',
                                     range_split=HUGE_RANGES)
    print(f'  S2 build {report["S2 build s"]:.1f} s', flush=True)
    describe_sides('S2', g2)
    variant('S2 bf16', g2, 'mean', 'bf16', ('K1', ), edges)
    check_mean('S2 bf16', g2, 'bf16', u1, deg_in)
    del g2, u1, rp, cl, deg_in
    torch.cuda.empty_cache()

    # -- Zipf(1.2) columns: S4, S5 ----------------------------------------
    t0 = time.perf_counter()
    rp, cl = huge_graph('powerlaw')
    t_gen = time.perf_counter() - t0
    g4, report['S4 build s'] = timed(ops.build_spmm_graph_sharded, rp, cl,
                                     HUGE_SPLITS, chunk=512)
    u4, report['powerlaw unsharded build s'] = timed(ops.build_spmm_graph,
                                                     rp, cl, chunk=512)
    deg_in = torch.from_numpy(np.bincount(cl, minlength=n).astype(
        np.float32)).to(dev)
    print(f'huge power-law graph ({t_gen:.1f} s): longest column '
          f'{int(deg_in.max())} edges; builds (s): S4 '
          f'{report["S4 build s"]:.1f}, unsharded '
          f'{report["powerlaw unsharded build s"]:.1f}', flush=True)
    describe_sides('S4', g4)
    if 'K1p' not in kids(g4.bwd):
        raise AssertionError('S4 backward has no row that K1 cuts')
    variant('S4 bf16', g4, 'mean', 'bf16', kids(g4.fwd) | kids(g4.bwd),
            edges)
    check_mean('S4 bf16', g4, 'bf16', u4, deg_in)

    # K1 alone over S4's first backward split (the hub rows), on random
    # terms and on integers; then timed cut and uncut beside
    # torch.sparse.mm on that split's CSR.
    plan = g4.bwd[0]
    t_ptr, t_col = tspmm._transpose_csr(rp, cl, n)
    npd = plan.num_rows
    e0 = int(t_ptr[npd])
    cut = k1_mod.k1_pieces(plan)
    gb = torch.randn((n, f), generator=gen, device=dev)
    g16 = gb.to(torch.bfloat16)
    longest = int((plan.tile_ptr[:, 0, 1:129] - plan.tile_ptr[:, 0, :128])
                  .max())
    check(f'K1p S4 backward split 0 (rows up to {longest} slots, '
          f'{cut.pieces.shape[0]} pieces) bf16', 'K1p',
          ops.spmm_chunked(g16, plan), sums64(g16, plan),
          sums64(g16.abs(), plan))
    check_exact('S4 backward split 0', 'K1p', ops.spmm_chunked, plan,
                sums64)
    k1_ms = {'bf16': cuda_ms(lambda: ops.spmm_chunked(g16, plan), iters=5),
             'f32': cuda_ms(lambda: ops.spmm_chunked(gb, plan), iters=5)}
    plain_ms = cuda_ms(lambda: by_columns(ops.spmm_chunked_plain, g16, plan,
                                          block=HUGE_BLOCK), iters=1,
                       warmup=1)
    k1_mod.K1_LONG, long_len = 1 << 30, k1_mod.K1_LONG
    try:
        whole_ms = cuda_ms(lambda: ops.spmm_chunked(g16, plan), iters=1,
                           warmup=1)
    finally:
        k1_mod.K1_LONG = long_len
    a = torch.sparse_csr_tensor(
        torch.from_numpy(t_ptr[:npd + 1]), torch.from_numpy(t_col[:e0]),
        torch.ones(e0), (npd, n)).to(dev)
    lib = {'f32': (a, gb)}
    try:
        lib['bf16'] = (a.to(torch.bfloat16), g16)
        torch.sparse.mm(*lib['bf16'])
    except RuntimeError as err:  # no bf16 CSR product in this build
        print(f'  torch.sparse.mm bf16: {str(err)[:120]}', flush=True)
        del lib['bf16']
    lib_ms = {k: cuda_ms(lambda: torch.sparse.mm(*v), iters=5)
              for k, v in lib.items()}
    del a
    nbytes = (n * f * 2 + plan.col_padded.numel() * 4 +
              plan.tile_ptr.shape[0] * 129 * 4 + cut.pieces.numel() * 4 +
              cut.rows.numel() * 4 + npd * f * 4)
    floor = e0 * f * 2 / HBM_BYTES_PER_S * 1e3
    bound_ms = max(nbytes / HBM_BYTES_PER_S, e0 * f / F32_FLOPS) * 1e3
    print(f'  K1 S4 backward split 0 ({e0} edges) F={f}: bf16 '
          f'{k1_ms["bf16"]:.3f} ms ({whole_ms:.3f} ms with no row cut), f32 '
          f'{k1_ms["f32"]:.3f} ms; bound {bound_ms:.3f} ms, gather floor '
          f'{floor:.3f} ms (bf16); plain {plain_ms:.3f} ms; torch.sparse.mm '
          + ', '.join(f'{k} {v:.3f} ms' for k, v in lib_ms.items()),
          flush=True)
    row = {'name': 'K1p', 'route': 'cuda',
           'source': f'pyg_lib_tpu_torch/csrc/{SOURCES["K1p"][0]}',
           'replaces': SOURCES['K1p'][1], 'max_abs_err': errs['K1p'],
           'ms': k1_ms['bf16'], 'plain_ms': plain_ms, 'bound_ms': bound_ms,
           'bound_by': ('bytes' if nbytes / HBM_BYTES_PER_S >=
                        e0 * f / F32_FLOPS else 'operations'),
           'library_ms': lib_ms.get('bf16', lib_ms['f32'])}
    del g4, t_ptr, t_col, cut, gb, g16, lib
    torch.cuda.empty_cache()

    g5, report['S5 build s'] = timed(ops.build_spmm_graph_sharded, rp, cl,
                                     HUGE_SPLITS, dedup='auto',
                                     minmax='auto')
    print(f'  S5 build {report["S5 build s"]:.1f} s', flush=True)
    describe_sides('S5', g5)
    if not isinstance(g5.fwd[0], ops.DedupSpmmPlan) or g5.mm is None:
        raise AssertionError('S5 did not get dedup and min/max split plans')
    variant('S5 bf16', g5, 'mean', 'bf16', kids(g5.fwd) | kids(g5.bwd),
            edges)
    check_mean('S5 bf16', g5, 'bf16', u4, deg_in)
    out, grad = variant('S5 max', g5, 'max', None, kids(g5.mm) if
                        isinstance(g5.mm[0], ops.DedupMinmaxPlan) else
                        ('K4', ), edges)
    check_minmax('S5 max', g5, 'max', u4, out, grad)
    del out, grad
    # The same hub rows as S5's backward plan has them, through its kernel
    # alone, as K1's above.
    plan = g5.bwd[0]
    kid = kid_of(plan)
    call = (ops.dedup_sum if isinstance(plan, ops.DedupSpmmPlan) else
            ops.spmm_chunked)
    g16 = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
    check(f'{kid} S5 backward split 0 bf16', kid, call(g16, plan),
          sums64(g16, plan), sums64(g16.abs(), plan))
    check_exact('S5 backward split 0', kid, call, plan, sums64)
    print(f'sharded build seconds: {report}', flush=True)
    return errs, row


def sharded_main():
    """``python3 chip_smoke.py --sharded``: the huge-graph paths
    (:func:`sharded_paths`) in a process of their own, as :func:`main`
    runs them; its last line is :data:`SHARDED_RESULT` and, as JSON, the
    paths' launch counts (all, and K1's by width), the kernels' largest
    errors against their plain versions and K1's piece row of the
    kernels line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyg_lib_tpu_torch import _build

    _build.build()  # built by the calling process: loaded
    paths = Paths()
    t0 = time.perf_counter()
    errs, row = sharded_paths(torch.device('cuda', 0), paths.run)
    paths.restore()
    print(f'sharded paths: {time.perf_counter() - t0:.1f} s', flush=True)
    print(SHARDED_RESULT + json.dumps({
        'launches': paths.launches, 'errs': errs, 'row': row,
        'by_width': [[kid, f, n] for (kid, f), n in
                     sorted(paths.by_width.items())]}), flush=True)


def plain_kernels():
    """A context in which the port's ops run F1, K3, K4, G1 and, under
    ``spmm``, K1, K2/K2h and K5 through their plain versions on the card
    (K3, K4, K1, K2/K2h and K5 ``BLOCK`` columns at a time): the models'
    and ``spmm``'s plain computation, permutations and autograd as they
    are."""
    import contextlib
    from unittest import mock

    from pyg_lib_tpu_torch import ops

    def plain_sum_of(plain):
        def run(x, plan, scale=None):
            if scale is not None:
                raise ValueError('plain_kernels takes no int8 scale')
            return by_columns(plain, x, plan)
        return run

    def plain_max(src, plan, idx, negate=False):
        return by_columns(ops.segment_max_plain, src, plan, idx, negate)

    # The modules, not the ops of their names that the package exports.
    mods = {m: sys.modules[f'pyg_lib_tpu_torch.ops.{m}'] for m in (
        'geometry', 'segment_csr', 'spmm', 'kernels.spmm_chunked',
        'kernels.spmm_dedup', 'kernels.gather_rows')}
    stack = contextlib.ExitStack()
    for mod, name, plain in (
            ('geometry', 'fps_kernel', ops.fps_plain),
            ('segment_csr', 'segment_sum_csr_kernel',
             lambda src, ptr: by_columns(ops.segment_sum_csr_plain, src,
                                         ptr)),
            ('segment_csr', 'segment_max_kernel', plain_max),
            ('spmm', 'segment_max_kernel', plain_max),
            ('spmm', 'dedup_minmax',
             lambda x, plan, negate=False: by_columns(
                 ops.dedup_minmax_plain, x, plan, negate)),
            ('kernels.spmm_chunked', 'spmm_chunked',
             plain_sum_of(ops.spmm_chunked_plain)),
            ('kernels.spmm_dedup', 'dedup_sum',
             plain_sum_of(ops.dedup_sum_plain)),
            ('kernels.gather_rows', 'gather_rows_backward',
             ops.gather_rows_backward_plain)):
        stack.enter_context(mock.patch.object(mods[mod], name, plain))
    return stack


def cloud_batch(dev):
    """``CLOUDS`` clouds of ``CLOUD_POINTS`` points of ``make_cloud``'s
    shapes (seed 0): the points on ``dev``, their host ptr, the labels."""
    import torch

    from pyg_lib_tpu_torch.examples.train_pointcloud import make_cloud

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, CLOUDS)
    pts = np.concatenate([make_cloud(rng, int(y), CLOUD_POINTS)
                          for y in labels])
    ptr = np.arange(CLOUDS + 1, dtype=np.int64) * CLOUD_POINTS
    return (torch.from_numpy(pts).to(dev), ptr,
            torch.from_numpy(labels).to(dev))


def grouping(pos, ptr, ratio, r):
    """One set-abstraction level's grouping, as PyG's SAModule builds it:
    ``fps`` centroids of each cloud of the host ``ptr``, their host ptr,
    and the centroids' ``radius`` groups (at most ``RADIUS_CAP``) as a CSR
    over the centroids with no trailing pad (``E == rowptr[-1]``)."""
    import torch

    from pyg_lib_tpu_torch import ops

    idx = ops.fps(pos, ptr, ratio)
    n = np.diff(ptr)
    m = np.where(n > 0, np.maximum(1, np.ceil(ratio * n)), 0)
    cptr = np.concatenate([[0], np.cumsum(m)]).astype(np.int64)
    pairs = ops.radius(pos, pos[idx.long()], r, ptr, cptr, RADIUS_CAP)
    counts = torch.bincount(pairs[0], minlength=idx.shape[0])
    rowptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return idx, cptr, rowptr, pairs[1]


def pointnet2(p, pos, ptr):
    """PointNet++ classification logits of the clouds ``pos`` (host
    ``ptr``): the SA levels over ``grouping``, the global MLP over ``[x,
    pos]``, a max over each cloud and the head; and each level's edge
    count."""
    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.models import pointnet_sa_forward
    from pyg_lib_tpu_torch.models.extra import _mlp

    feat, edges = None, []
    for (ratio, r, _, _), sa in zip(SA_LEVELS, p['sa']):
        idx, ptr, rowptr, col = grouping(pos, ptr, ratio, r)
        edges.append(int(col.shape[0]))
        pos, feat = pointnet_sa_forward(sa, pos, feat, idx, rowptr, col)
    h = _mlp(p['glob'], torch.cat([feat, pos], 1))
    pooled = ops.segment_max_csr(h, torch.from_numpy(ptr).to(h.device))[0]
    return _mlp(p['head'], pooled), edges


def fps_batched_loop(pos, clouds):
    """The nearest thing to a library call for F1: one plain PyTorch loop
    over all clouds at once (clouds padded to the longest, pad distances
    -inf), each step a handful of batched launches."""
    import torch

    lo, n, m, start = (torch.from_numpy(c).to(pos.device)
                       for c in np.asarray(clouds).T)
    nmax, b = int(n.max()), lo.shape[0]
    at = torch.arange(nmax, device=pos.device)
    real = at[None, :] < n[:, None]
    pts = pos[(lo[:, None] + at[None, :]).clamp(max=pos.shape[0] - 1)]
    dist = torch.where(real, float('inf'), float('-inf'))
    picks = torch.zeros((b, int(m.max())), dtype=torch.int64,
                        device=pos.device)
    picks[:, 0] = start
    rows = torch.arange(b, device=pos.device)
    for i in range(1, picks.shape[1]):
        sq = pts - pts[rows, picks[:, i - 1]][:, None, :]
        sq = sq * sq
        d = sq[..., 0]
        for j in range(1, pos.shape[1]):
            d = d + sq[..., j]
        dist = torch.minimum(dist, d)
        picks[:, i] = dist.argmax(1)
    keep = torch.arange(picks.shape[1], device=pos.device)[None, :] < m[:,
                                                                        None]
    return (picks + lo[:, None])[keep].to(torch.int32)


def check_pairs(label, got, ref, d64, bound):
    """``got`` (the card's) equal to ``ref`` (the CPU's), except pairs in
    one and not the other whose f64 distance ``d64(q, c)`` lies within
    ``PAIR_RTOL`` relative of ``bound(q)`` (the query's k-th distance, or
    r²); the pairs both hold come in the same order."""
    if torch_equal(got, ref):
        print(f'  {label}: {ref.shape[-1]} pairs, equal', flush=True)
        return
    g = list(map(tuple, got.cpu().reshape(2, -1).T.tolist()))
    r = list(map(tuple, ref.reshape(2, -1).T.tolist()))
    gs, rs = set(g), set(r)
    odd = gs ^ rs
    far = [(q, c) for q, c in odd
           if abs(d64(q, c) - bound(q)) > PAIR_RTOL * bound(q)]
    same_order = [t for t in g if t in rs] == [t for t in r if t in gs]
    print(f'  {label}: {len(odd)} of {len(r)} pairs differ, {len(far)} of '
          f'them beyond {PAIR_RTOL:g} of the bound; common pairs in the '
          f'same order: {same_order}', flush=True)
    if far or not same_order:
        raise AssertionError(f'{label} differs between the card and the CPU')


def torch_equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def device_ops(dev, rp, cl, pos, ptr):
    """Each of the 14 ops of ``ops.sampled``, ``ops.index_sort``,
    ``ops.spline`` and ``ops.geometry`` on the card against the same call
    on CPU copies of its inputs: floats within 1e-5 of max|CPU|; fps,
    graclus_cluster, edge_sample, index_sort and grid_cluster equal;
    knn, radius and nearest as :func:`check_pairs` says. Returns F1's
    largest error (0 when equal) and the big cloud. Also times knn at
    ``KNN_FEATURES`` with its dot products summed and from a GEMM."""
    from unittest import mock

    import torch

    from pyg_lib_tpu_torch import ops

    geo_mod = sys.modules['pyg_lib_tpu_torch.ops.geometry']

    gen = torch.Generator().manual_seed(13)
    n = rp.shape[0] - 1
    dst = torch.from_numpy(np.repeat(np.arange(n), np.diff(rp)))
    src = torch.from_numpy(cl.astype(np.int64))
    left = torch.randn((n, 64), generator=gen)
    right = torch.randn((n, 64), generator=gen) + 3.0
    for op in (ops.sampled_add, ops.sampled_sub, ops.sampled_mul,
               ops.sampled_div):
        got = op(left.to(dev), right.to(dev), dst.to(dev), src.to(dev))
        close(f'  {op.__name__} [{n}, 64] at {src.shape[0]} edges', got.cpu(),
              op(left, right, dst, src), rtol=1e-5)
    got = ops.index_sort(src.to(dev), max_value=n)
    ref = ops.index_sort(src)
    if not (torch_equal(got[0], ref[0]) and torch_equal(got[1], ref[1])):
        raise AssertionError('index_sort differs between the card and CPU')
    print(f'  index_sort over {src.shape[0]} column ids: equal', flush=True)
    del left, right, dst, src

    pseudo = torch.rand((FAUST_EDGES, 3), generator=gen)
    ks = torch.full((3, ), SPLINE_KERNEL, dtype=torch.int64)
    for degree in (1, 2, 3):
        for is_open in (1, 0):
            op_ = torch.full((3, ), is_open, dtype=torch.int64)
            got = ops.spline_basis(pseudo.to(dev), ks.to(dev), op_.to(dev),
                                   degree)
            ref = ops.spline_basis(pseudo, ks, op_, degree)
            close(f'  spline_basis degree {degree} open {is_open} basis',
                  got[0].cpu(), ref[0], rtol=1e-5)
            if not torch_equal(got[1], ref[1]):
                raise AssertionError('spline_basis weight_index differs')
    basis, wi = ops.spline_basis(pseudo, ks, torch.ones(3, dtype=torch.int64))
    for m_in in (1, 32):
        x = torch.randn((FAUST_EDGES, m_in), generator=gen)
        w = torch.randn((SPLINE_KERNEL**3, m_in, SPLINE_OUT), generator=gen)
        got = ops.spline_weighting(x.to(dev), w.to(dev), basis.to(dev),
                                   wi.to(dev))
        close(f'  spline_weighting [{FAUST_EDGES}, {m_in}] by '
              f'[{SPLINE_KERNEL**3}, {m_in}, {SPLINE_OUT}]', got.cpu(),
              ops.spline_weighting(x, w, basis, wi), rtol=1e-5)

    pos_c = pos.cpu()
    big = torch.randn((BIG_CLOUD, 3), generator=gen)
    err = 0
    for label, pts, p, ratio in (
            (f'{CLOUDS} clouds of {CLOUD_POINTS}', pos_c, ptr, 0.5),
            (f'one cloud of {BIG_CLOUD}', big, [0, BIG_CLOUD], BIG_RATIO)):
        got = ops.fps(pts.to(dev), p, ratio)
        ref = ops.fps(pts, p, ratio)
        err = max(err, int((got.cpu().long() - ref.long()).abs().max()))
        print(f'  fps {label} ratio {ratio}: {ref.shape[0]} picks, '
              f'{"equal" if torch_equal(got, ref) else "DIFFER"}',
              flush=True)
        if not torch_equal(got, ref):
            raise AssertionError('F1 differs from its plain version')
    p64 = pos_c.double()

    def dist(a, b):
        return lambda q, c: float(((a[q] - b[c])**2).sum())

    knn_ref = ops.knn(pos_c, pos_c, DGCNN_K, ptr, ptr)
    kth = dist(p64, p64)
    check_pairs(f'knn k={DGCNN_K} over {CLOUDS} clouds',
                ops.knn(pos, pos, DGCNN_K, ptr, ptr), knn_ref, kth,
                lambda q: kth(q, int(knn_ref[1, q * DGCNN_K + DGCNN_K - 1])))
    feat = torch.randn((pos.shape[0], KNN_FEATURES), generator=gen).to(dev)
    knn_ms = {}
    for how, dots in (('summed', geo_mod._dots),
                      ('GEMM', lambda x, y: x @ y.T)):
        with mock.patch.object(geo_mod, '_dots', dots):  # TF32 is off here
            knn_ms[how] = cuda_ms(lambda: ops.knn(
                feat, feat, DGCNN_K, ptr, ptr, cosine=True), iters=3)
    print(f'  knn k={DGCNN_K} cosine over {CLOUDS} clouds at '
          f'F={KNN_FEATURES}: {knn_ms["summed"]:.3f} ms with the dot '
          f'products summed one feature at a time, {knn_ms["GEMM"]:.3f} ms '
          f'from a GEMM', flush=True)
    del feat
    idx, cptr, _, _ = grouping(pos_c, ptr, *SA_LEVELS[0][:2])
    cen = pos_c[idx.long()]
    r = SA_LEVELS[0][1]
    ref = ops.radius(pos_c, cen, r, ptr, cptr, RADIUS_CAP)
    check_pairs(f'radius r={r} cap {RADIUS_CAP} (SA1)',
                ops.radius(pos, cen.to(dev), r, ptr, cptr, RADIUS_CAP), ref,
                dist(cen.double(), p64), lambda q: r * r)
    ref = ops.nearest(pos_c, cen, ptr, cptr)
    got = ops.nearest(pos, cen.to(dev), ptr, cptr)
    near = dist(p64, cen.double())
    check_pairs('nearest (points to SA1 centroids)',
                torch.stack([torch.arange(got.shape[0]), got.cpu()]),
                torch.stack([torch.arange(ref.shape[0]), ref]), near,
                lambda q: near(q, int(ref[q])))
    size = torch.tensor([0.1, 0.1, 0.1])
    if not torch_equal(ops.grid_cluster(pos, size.to(dev)),
                       ops.grid_cluster(pos_c, size)):
        raise AssertionError('grid_cluster differs between the card and CPU')
    print('  grid_cluster size 0.1: equal', flush=True)

    g_rng = np.random.default_rng(17)
    deg = g_rng.integers(1, 10, GRACLUS_NODES)
    g_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    g_col = g_rng.integers(0, GRACLUS_NODES, int(g_ptr[-1]))
    g_w = g_rng.random(g_col.shape[0]).astype(np.float32)
    args = [torch.from_numpy(a) for a in (g_ptr, g_col, g_w)]
    for name, call in (
            ('graclus_cluster', lambda a: ops.graclus_cluster(*a, seed=3)),
            ('edge_sample', lambda a: ops.edge_sample(
                torch.arange(GRACLUS_NODES, device=a[0].device), a[0],
                count=5, seed=3))):
        got, ref = call([a.to(dev) for a in args]), call(args)
        if got.device.type != dev.type or not torch_equal(got, ref):
            raise AssertionError(f'{name} differs between the card and CPU')
        print(f'  {name} on {GRACLUS_NODES} nodes: equal', flush=True)
    return err, big


def geometry_paths(dev, run_path, rp, cl):
    """The GIN, PointNet++ and EdgeConv (DGCNN) paths, each trained
    ``STEPS`` Adam steps as a path of its own, and the device-op phase.

    * GIN ``GIN_DIMS`` (K3, 5 launches a forward) on the CSR ``(rp, cl)``
      with x at F=300 (seed 19) and a linear head to ``GIN_CLASSES``;
    * PointNet++ (F1 and K4) on ``CLOUDS`` clouds: ``fps`` and ``radius``
      each step, both SA levels pooled by K4 through ``edge_perm``;
    * DGCNN (no kernel of the repo) over one static ``knn`` graph.

    With the initial weights, GIN's and PointNet++'s loss and weight
    gradients are held against the same model through the plain versions
    (:func:`plain_kernels`), DGCNN's against the same model on the CPU,
    each with the kernel path's ReLU branches, within ``GCN_RTOL``. Each
    path gets one profiled step. Then :func:`device_ops`, and F1 on each
    of :func:`f1_shapes` (:func:`f1_shape`). Returns F1's row of the
    kernels line (SA1's shape; without its launches)."""
    import copy

    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.models import (gin_forward, init_edgeconv,
                                          init_gin, init_pointnet_sa,
                                          edgeconv_forward)
    from pyg_lib_tpu_torch.models.extra import _init_mlp, _mlp, _Module

    t_all = time.perf_counter()
    gen = torch.Generator().manual_seed(19)
    n = rp.shape[0] - 1
    rowptr = torch.from_numpy(rp).to(dev)
    row = torch.from_numpy(cl.astype(np.int64)).to(dev)
    x = (torch.randn((n, GIN_DIMS[0]), generator=gen) * GIN_X_SCALE).to(dev)
    y = torch.randint(0, GIN_CLASSES, (n, ), generator=gen).to(dev)
    pos, ptr, labels = cloud_batch(dev)

    def gin_loss(p):
        out = _mlp(p['head'], gin_forward(p['gin'], x, rowptr, row))
        return torch.nn.functional.cross_entropy(out, y)

    def pn_loss(p):
        logits, edges = pointnet2(p, pos, ptr)
        pn_edges[:] = edges
        return torch.nn.functional.cross_entropy(logits, labels)

    knn_idx = ops.knn(pos, pos, DGCNN_K, ptr, ptr)

    def dg_loss(p, pts=pos, idx=knn_idx, tgt=labels):
        h = edgeconv_forward(p['conv'], pts, idx, DGCNN_K)
        pooled = h.view(CLOUDS, CLOUD_POINTS, -1).amax(1)
        return torch.nn.functional.cross_entropy(_mlp(p['head'], pooled),
                                                 tgt)

    pn_edges = []
    models = {
        'GIN': (_Module({'gin': init_gin(GIN_DIMS, 2, gen, dev),
                         'head': _init_mlp([GIN_DIMS[-1], GIN_CLASSES], gen,
                                           dev)}), gin_loss, ('K3', 'G1'),
                GIN_LR),
        'PointNet++': (_Module({
            'sa': [init_pointnet_sa(fin, dims, gen, dev)
                   for _, _, fin, dims in SA_LEVELS],
            'glob': _init_mlp(GLOBAL_MLP, gen, dev),
            'head': _init_mlp(PN_HEAD, gen, dev)}), pn_loss,
            ('F1', 'K4', 'G1'), POINT_LR),
        'DGCNN': (_Module({'conv': init_edgeconv(DGCNN_DIMS, 1, gen, dev),
                           'head': _init_mlp(DGCNN_HEAD, gen, dev)}),
                  dg_loss, (), POINT_LR)}

    def train(model, loss_fn, lr):
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        losses = []
        for step in range(STEPS):
            if step == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            opt.zero_grad()
            loss = loss_fn(model.params())
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (STEPS - 1)
        losses = [float(v) for v in losses]
        if not np.isfinite(losses).all():
            raise AssertionError(f'losses {losses} are not finite')
        return ms, losses

    for name, (model0, loss_fn, need, lr) in models.items():
        model = copy.deepcopy(model0)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ms, losses = run_path(name, need,
                              lambda: train(model, loss_fn, lr))
        peak = torch.cuda.max_memory_allocated() / 2**30
        extra = (f'; SA1 and SA2 groupings {pn_edges[0]} and {pn_edges[1]} '
                 f'edges' if name == 'PointNet++' else '')
        print(f'  {STEPS} {name} training steps (Adam): {ms:.3f} ms per '
              f'step after the first, peak memory {peak:.2f} GiB '
              f'({peak - base:.2f} above the {base:.2f} held before the '
              f'path), losses {[round(v, 4) for v in losses]}{extra}',
              flush=True)

        def step():
            model.zero_grad()
            loss_fn(model.params()).backward()

        profile(name, step, ms, top_n=10)
        del model
        torch.cuda.empty_cache()

        leaves = list(model0.parameters())
        names = [k for k, _ in model0.named_parameters()]
        loss, signs = relu_signs(lambda: loss_fn(model0.params()))
        grads = torch.autograd.grad(loss, leaves)
        if name == 'DGCNN':
            cpu = copy.deepcopy(model0).cpu()
            leaves_ref = list(cpu.parameters())
            ref, _ = relu_signs(lambda: dg_loss(
                cpu.params(), pos.cpu(), knn_idx.cpu(), labels.cpu()),
                                signs)
            refs = torch.autograd.grad(ref, leaves_ref)
        else:
            leaves_ref = leaves
            with plain_kernels():  # G1's plain version runs in backward
                ref, _ = relu_signs(lambda: loss_fn(model0.params()), signs)
                refs = torch.autograd.grad(ref, leaves_ref)
        del signs
        against = 'the CPU' if name == 'DGCNN' else 'the plain path'
        close(f'{name} loss against {against}', loss.detach().cpu(),
              ref.detach().cpu())
        for k, g, r in zip(names, grads, refs):
            close(f'  {name} grad {k}', g.cpu(), r.cpu())
        del grads, refs, loss, ref
        torch.cuda.empty_cache()
    del x, y, rowptr, row
    torch.cuda.empty_cache()

    print('device ops on the card against the CPU:', flush=True)
    t0 = time.perf_counter()
    err, big = device_ops(dev, rp, cl, pos, ptr)
    print(f'  device-op phase: {time.perf_counter() - t0:.1f} s', flush=True)

    rows = [f1_shape(dev, label, pts, clouds, cheap)
            for label, pts, clouds, cheap in f1_shapes(dev, pos, ptr, big)]
    print(f'geometry paths: {time.perf_counter() - t_all:.1f} s', flush=True)
    row = rows[0]  # SA1's clouds, the main path's shape
    return {
        'name': 'F1', 'route': 'cuda',
        'source': f'pyg_lib_tpu_torch/csrc/{SOURCES["F1"][0]}',
        'replaces': SOURCES['F1'][1],
        'max_abs_err': float(max([err] + [r['err'] for r in rows])),
        'ms': row['ms'], 'plain_ms': row['plain_ms'],
        'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
        'library_ms': row['library_ms']}


def f1_shapes(dev, pos, ptr, big):
    """F1's timed shapes, ``(label, points on dev, clouds, cheap)``:
    PointNet++'s SA1 clouds (``ptr``, ratio 0.5, starts from seed 0) and
    SA2's (SA1's centroids, 32 of 512, ratio 0.25), tier S; one cloud of
    ``BIG_CLOUD`` (``big``, ratio ``BIG_RATIO``, start 0) and
    ``BIG_BATCH`` such clouds (seed 5), tier C; one of ``HUGE_CLOUD``
    (seed 6, ratio ``HUGE_RATIO``), tier G. ``cheap``: F1 and the batched
    plain loop take well under a second and are timed over several
    calls."""
    import torch

    from pyg_lib_tpu_torch import ops

    rng = np.random.default_rng(0)

    def clouds_of(sizes, ratio, start=None):
        n = np.asarray(sizes, np.int64)
        lo = np.concatenate([[0], np.cumsum(n)[:-1]])
        m = np.maximum(1, np.ceil(ratio * n)).astype(np.int64)
        first = rng.integers(n) if start is None else np.full_like(n, start)
        return np.stack([lo, n, m, first], 1)

    def randn(n, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        return torch.randn((n, 3), generator=gen, device=dev)

    sa1 = clouds_of(np.diff(ptr), SA_LEVELS[0][0])
    sa2_pos = pos[ops.fps_kernel(pos, sa1).long()]
    sa2 = clouds_of(sa1[:, 2], SA_LEVELS[1][0])
    return [
        (f'{CLOUDS} clouds of {CLOUD_POINTS}, ratio {SA_LEVELS[0][0]} '
         f'(SA1)', pos, sa1, True),
        (f'{CLOUDS} clouds of {int(sa1[0, 2])}, ratio {SA_LEVELS[1][0]} '
         f'(SA2)', sa2_pos, sa2, True),
        (f'one cloud of {BIG_CLOUD}, ratio {BIG_RATIO}', big.to(dev),
         clouds_of([BIG_CLOUD], BIG_RATIO, 0), False),
        (f'{BIG_BATCH} clouds of {BIG_CLOUD}, ratio {BIG_RATIO}',
         randn(BIG_BATCH * BIG_CLOUD, 5),
         clouds_of([BIG_CLOUD] * BIG_BATCH, BIG_RATIO), False),
        (f'one cloud of {HUGE_CLOUD}, ratio {HUGE_RATIO}',
         randn(HUGE_CLOUD, 6), clouds_of([HUGE_CLOUD], HUGE_RATIO), False)]


def f1_shape(dev, label, pts, clouds, cheap):
    """F1 on one shape: equal to its plain version (one cloud after the
    other) and to the batched plain loop, or it raises; timed beside them,
    its latency floor in its tier's form (:func:`fps_floor`) and its
    bound. Prints one line; returns the numbers."""
    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.ops.kernels.fps import (_batch_plan,
                                                   active_clusters,
                                                   fps_floor)

    d = pts.shape[1]
    plan = _batch_plan(clouds, d)
    clusters = (f', {active_clusters(plan, d, dev)} such clusters at once'
                if plan.tier != 'S' else '')
    got = ops.fps_kernel(pts, clouds)
    ref, plain_ms = timed_once(lambda: ops.fps_plain(pts, clouds))
    lib, lib_ms = timed_once(lambda: fps_batched_loop(pts, clouds))
    err = int((got.long() - ref.long()).abs().max())
    if not (torch_equal(got, ref) and torch_equal(lib, ref)):
        raise AssertionError(f'F1 on {label} differs from its plain version '
                             f'or the batched plain loop')
    if cheap:  # the loop's first call also makes its allocator's blocks
        lib_ms = cuda_ms(lambda: fps_batched_loop(pts, clouds), iters=3)
    iters = 10 if cheap else 3
    ms = cuda_ms(lambda: ops.fps_kernel(pts, clouds), iters=iters, warmup=1)
    floor_ms = cuda_ms(lambda: fps_floor(clouds, dev, d), iters=iters,
                       warmup=1)
    n, m = clouds[:, 1], clouds[:, 2]
    nbytes = int(n.sum()) * d * 4 + clouds.size * 8 + int(m.sum()) * 4
    flops = int(((m - 1) * n).sum()) * (3 * d + 2)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bound_by = ('bytes' if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
                else 'operations')
    earlier = EARLIER_MS.get(f'F1 {label}')
    print(f'  F1 {label}: {ms:.3f} ms (tier {plan.tier}, {plan.cluster} '
          f'block(s) of {plan.threads} a cloud, {plan.smem_bytes} B shared '
          f'memory a block{clusters}), bound {bound_ms:.5f} ms by '
          f'{bound_by} ({nbytes / 1e9:.6f} GB, {flops / 1e9:.3f} GFLOP), '
          f'latency floor {floor_ms:.3f} ms ({int(m.max()) - 1} dependent '
          f'argmaxes, no distance work), plain (cloud after cloud) '
          f'{plain_ms:.3f} ms, batched plain loop {lib_ms:.3f} ms'
          + (f'; the one-block design took {earlier} ms' if earlier else ''),
          flush=True)
    del got, ref, lib
    torch.cuda.empty_cache()
    return {'ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'err': err}


def timed_once(fn):
    """``fn()``'s result and its ms on the card by CUDA events, one call
    (for the plain versions on the large clouds, which take seconds)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def reddit_data():
    """Path A's graph and data: ``testing.uniform_graph`` at Reddit's node
    and edge counts (seed 0; ``col`` as int64 for the sampler), features
    ``[N, 602]`` f32 and 41-class labels (seed 1) and ``REDDIT_TRAIN``
    random training nodes."""
    from pyg_lib_tpu_torch.testing import uniform_graph

    rowptr, col = uniform_graph(REDDIT_NODES, REDDIT_EDGES)
    col = col.astype(np.int64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((REDDIT_NODES, REDDIT_DIMS[0]), dtype=np.float32)
    y = rng.integers(0, REDDIT_DIMS[-1], REDDIT_NODES)
    train = rng.permutation(REDDIT_NODES)[:REDDIT_TRAIN]
    return rowptr, col, x, y, train


def k3_row(label, msgs, ptr, f):
    """K3 at width ``f`` on a padded batch's messages ``[E_pad, f]`` and
    its ``rowptr`` (pad edges past ``rowptr[-1]``): checked against its
    plain version within the sum bound, and timed beside it,
    ``torch.segment_reduce`` over the real messages and its bound. Returns
    the timings and the error."""
    import torch

    from pyg_lib_tpu_torch import ops

    got = ops.segment_sum_csr_kernel(msgs, ptr)
    torch.cuda.synchronize()
    ref = ops.segment_sum_csr_plain(msgs, ptr)
    mag = ops.segment_sum_csr_plain(msgs.abs(), ptr)
    err = (got - ref).abs()
    e = float(err.max())
    print(f'  K3 {label} F={f}: max_abs_err {e:.3g} (tolerance '
          f'{SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g})', flush=True)
    if not torch.isfinite(got).all() or bool(
            (err > SUM_RTOL * mag + SUM_ATOL).any()):
        raise AssertionError(f'K3 {label} F={f} disagrees with its plain '
                             f'version')
    rows, e_real = ptr.shape[0] - 1, int(ptr[-1])
    real, ptr64 = msgs[:e_real], ptr.long()
    nbytes = e_real * f * 4 + (rows + 1) * ptr.element_size() + rows * f * 4
    flops = e_real * f
    r = {'max_abs_err': e,
         'ms': cuda_ms(lambda: ops.segment_sum_csr_kernel(msgs, ptr)),
         'plain_ms': cuda_ms(lambda: ops.segment_sum_csr_plain(msgs, ptr),
                             iters=3),
         'bound_ms': max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
         'bound_by': ('bytes' if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
                      else 'operations'),
         'library_ms': cuda_ms(lambda: torch.segment_reduce(
             real, 'sum', offsets=ptr64, axis=0))}
    print(f'  K3 {label} F={f} f32: {r["ms"]:.3f} ms, plain '
          f'{r["plain_ms"]:.3f} ms, torch.segment_reduce sum '
          f'{r["library_ms"]:.3f} ms, bound {r["bound_ms"]:.3f} ms '
          f'({r["bound_by"]}: {nbytes / 1e9:.3f} GB; {e_real} edges, '
          f'{rows} rows)', flush=True)
    return r


def g1_rows(dev):
    """G1 (``gather_rows_backward``) on a batch of the products bucket's
    shape (``G1_*``): at each of ``G1_WIDTHS`` in f32, and at the first
    in bf16, held against its plain version within the sum bound and
    against itself bit for bit (two calls); at each f32 width timed beside
    its plain version, ``index_add_`` (atomics) and its bound. At the pad
    row, read by some 164,000 entries, the bound is about 1.3 a column, so
    one term dropped or added twice exceeds it in about a fifth of the
    columns; at a real row, of one to a few terms, in nearly every one.
    Returns ``{f: row}`` and the largest error."""
    import torch

    from pyg_lib_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(0)
    row = torch.randint(0, G1_REAL, (G1_EDGE_SLOTS, ), generator=gen,
                        device=dev)
    pad = torch.rand(G1_EDGE_SLOTS, generator=gen, device=dev) < G1_PAD_SHARE
    idx = row.masked_fill_(pad, G1_NODE_SLOTS).clamp_(max=G1_NODE_SLOTS - 1)
    n, rows, worst = G1_NODE_SLOTS, {}, 0.0
    for f, dtype in [*((f, torch.float32) for f in G1_WIDTHS),
                     (G1_WIDTHS[0], torch.bfloat16)]:
        label = f'G1 products bucket F={f} {str(dtype)[6:]}'
        g = torch.randn((G1_EDGE_SLOTS, f), generator=gen,
                        device=dev).to(dtype)
        got = ops.gather_rows_backward(g, idx, n)
        same = torch.equal(got, ops.gather_rows_backward(g, idx, n))
        ref = ops.gather_rows_backward_plain(g.float(), idx, n)
        mag = ops.gather_rows_backward_plain(g.float().abs(), idx, n)
        err = (got.float() - ref).abs()
        tol = SUM_RTOL * mag + SUM_ATOL
        if dtype == torch.bfloat16:
            tol += 2.0**-8 * ref.abs()
        e = float(err.max())
        worst = max(worst, e)
        print(f'  {label}: max_abs_err {e:.3g} (tolerance {SUM_RTOL:g} * '
              f'sum|terms| + {SUM_ATOL:g}'
              f'{" + 2^-8 |plain|" if dtype == torch.bfloat16 else ""}); '
              f'two calls {"equal" if same else "DIFFER"} bit for bit',
              flush=True)
        if not torch.isfinite(got).all() or bool((err > tol).any()):
            raise AssertionError(f'{label} disagrees with its plain version')
        if not same:
            raise AssertionError(f'{label}: two calls differ')
        del got, ref, mag, err, tol
        if dtype != torch.float32:
            continue
        nbytes = (G1_EDGE_SLOTS * (f * 4 + 8) + n * f * 4 + (n + 1) * 8)
        flops = G1_EDGE_SLOTS * f
        r = rows[f] = {
            'max_abs_err': e,
            'ms': cuda_ms(lambda: ops.gather_rows_backward(g, idx, n)),
            'plain_ms': cuda_ms(
                lambda: ops.gather_rows_backward_plain(g, idx, n), iters=3),
            'bound_ms': max(nbytes / HBM_BYTES_PER_S,
                            flops / F32_FLOPS) * 1e3,
            'bound_by': ('bytes' if nbytes / HBM_BYTES_PER_S >=
                         flops / F32_FLOPS else 'operations'),
            'library_ms': cuda_ms(lambda: torch.zeros(
                (n, f), device=dev).index_add_(0, idx, g))}
        _, _, top = device_time_by_kernel(
            lambda: ops.gather_rows_backward(g, idx, n))
        print(f'  {label}: {r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} '
              f'ms, index_add_ {r["library_ms"]:.3f} ms, bound '
              f'{r["bound_ms"]:.3f} ms ({r["bound_by"]}: '
              f'{nbytes / 1e9:.3f} GB; {G1_EDGE_SLOTS} entries, '
              f'{int(pad.sum())} pads, {n} rows); one call by kernel (ms): '
              + '; '.join(f'{name} {t:.3f}' for name, t in top), flush=True)
        del g
        torch.cuda.empty_cache()
    return rows, worst


def reddit_path(dev, run_path):
    """Path A: GraphSAGE [602, 256, 41] (mean) trains with Adam on Reddit's
    shape in batches of 1,024 seeds, fanouts [25, 10], from the port's
    ``NeighborLoader`` (the C++ engine, buckets probed; pinned batches
    copied on a side stream one batch ahead): ``REDDIT_WARMUP`` steps,
    ``REDDIT_STEPS`` timed ones and a profiled window of
    ``REDDIT_PROFILED`` (its idle share: the loader's pace, once the
    look-ahead's first batches are spent). Then, on one more batch,
    a step's loss and weight gradients against the plain path (K3's plain
    version, with the kernel path's ReLU branches) within ``GCN_RTOL``,
    and K3 at F=602 and F=256 on that batch against its plain version,
    timed. Returns K3's rows by width."""
    import torch

    from pyg_lib_tpu_torch.examples.train_sage_weighted_disjoint import \
        seed_loss
    from pyg_lib_tpu_torch.loader import NeighborLoader

    t0 = time.perf_counter()
    rowptr, col, x, y, train = reddit_data()
    seeds = train[:REDDIT_BATCH * (REDDIT_WARMUP + REDDIT_STEPS +
                                   REDDIT_PROFILED)]
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader = NeighborLoader(rowptr, col, x, y, seeds, REDDIT_BATCH,
                            REDDIT_FANOUTS, device=dev)
    t_probe = time.perf_counter() - t0
    print(f'Reddit shape: {REDDIT_NODES} nodes, {int(rowptr[-1])} edges '
          f'(col int64 {col.nbytes / 1e9:.2f} GB, x {tuple(x.shape)} f32 '
          f'{x.nbytes / 1e9:.2f} GB) in {t_data:.1f} s; NeighborLoader '
          f'buckets {loader.buckets} probed in {t_probe:.2f} s', flush=True)
    model, _, step = sage_trainer(REDDIT_DIMS, REDDIT_LR, 5, dev)

    def path():
        it = iter(loader)
        ms, losses = [], []
        for i in range(REDDIT_WARMUP + REDDIT_STEPS):
            if i == REDDIT_WARMUP:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses.append(step(next(it)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, wall, top = device_time_by_kernel(
            lambda: [step(next(it)) for _ in range(REDDIT_PROFILED)])
        for _ in it:  # the epoch's end: the loader closes its pool
            pass
        return ms, [float(v) for v in losses], peak, busy, wall, top

    ms, losses, peak, busy, wall, top = run_path(
        'Reddit GraphSAGE mini-batch', ('K3', 'G1'), path,
        engine=('neighbor_sample', ))
    timed = ms[REDDIT_WARMUP:]
    print(f'  Reddit step (mean of {len(timed)} after {REDDIT_WARMUP}): '
          f'{sum(timed) / len(timed):.3f} ms (each: '
          f'{", ".join(f"{v:.1f}" for v in timed)}); losses '
          f'{[round(v, 4) for v in losses]}', flush=True)
    loader_report('Reddit', loader)
    print(f'profile Reddit GraphSAGE mini-batch, {REDDIT_PROFILED} steps: '
          f'device busy {busy:.3f} ms of {wall:.3f} ms '
          f'({wall / REDDIT_PROFILED:.3f} ms a step), idle share '
          f'{1 - busy / wall:.3f}; peak memory '
          f'{peak:.2f} GiB; by kernel (ms, the window): '
          + '; '.join(f'{n} {v:.3f}' for n, v in top[:8]), flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError('the Reddit losses are not finite')

    # One more batch: the step against the plain path, and K3's rows.
    it = iter(loader)
    batch = next(it)
    it.close()
    params, leaves = model.params(), list(model.parameters())
    loss, signs = relu_signs(lambda: seed_loss(params, batch))
    grads = torch.autograd.grad(loss, leaves)
    with plain_kernels():  # G1's plain version runs in backward
        ref, _ = relu_signs(lambda: seed_loss(params, batch), replay=signs)
        refs = torch.autograd.grad(ref, leaves)
    close('Reddit GraphSAGE loss', loss.detach()[None], ref.detach()[None])
    for (name, _), g, r in zip(model.named_parameters(), grads, refs):
        close(f'  Reddit GraphSAGE grad {name}', g, r)
    ptr, row = batch['rowptr'], batch['row']
    rows = {}
    for f in REDDIT_DIMS[:2]:
        src = batch['x'] if f == REDDIT_DIMS[0] else torch.randn(
            (batch['x'].shape[0], f), device=dev)
        msgs = src[row.clamp(max=src.shape[0] - 1)]
        rows[f] = k3_row('Reddit batch', msgs, ptr, f)
        del msgs
    torch.cuda.empty_cache()
    return rows


def reorder_path(dev, run_path, rp_u, cl_u):
    """Path C: ``build_spmm_graph(reorder=...)`` on the bench graphs: the
    power-law graph built ``dedup='auto', minmax='auto'`` with ``reorder=
    'on'`` and ``'auto'``, the uniform one (chunked) with ``'on'``. Each
    reordered graph's ``spmm`` sum, mean and max at F=512, and their
    gradients, against the same graph's under :func:`plain_kernels`
    within the sum bound, then against the unreordered graph's within
    twice it (each side within one of the exact sum); max values bit for
    bit. Then the sum kernels timed on the reordered plans beside the
    unreordered ones, and ``spmm`` sum and max with the permutations.
    Returns the build seconds."""
    import torch

    from pyg_lib_tpu_torch import ops, partition
    from pyg_lib_tpu_torch.testing import powerlaw_graph

    rp_p, cl_p = powerlaw_graph(N_NODES, N_EDGES)
    t0 = time.perf_counter()
    part = partition.metis(rp_p, cl_p, 256)
    t_metis = time.perf_counter() - t0
    cut = partition.edge_cut(rp_p, cl_p, part)
    builds = {}

    def build(name, rp, cl, **kw):
        t0 = time.perf_counter()
        g = ops.build_spmm_graph(rp, cl, device=dev, **kw)
        builds[name] = time.perf_counter() - t0
        return g

    graphs = {
        'powerlaw': build('powerlaw off', rp_p, cl_p, dedup='auto',
                          minmax='auto'),
        'uniform': build('uniform off', rp_u, cl_u),
    }

    def build_reordered():
        # metis runs on the C++ engine inside each build.
        graphs['powerlaw on'] = build('powerlaw on', rp_p, cl_p,
                                      dedup='auto', minmax='auto',
                                      reorder='on')
        graphs['powerlaw auto'] = build('powerlaw auto', rp_p, cl_p,
                                        dedup='auto', minmax='auto',
                                        reorder='auto')
        graphs['uniform on'] = build('uniform on', rp_u, cl_u, reorder='on')

    run_path('reordered plans: builds', (), build_reordered,
             engine=('part_grow', 'part_refine'))
    chose = graphs['powerlaw auto'].perm is not None
    print(f'reordered plans: metis (256 parts) on the power-law graph '
          f'{t_metis:.1f} s, edge cut {cut:.0f} of {N_EDGES}; build s '
          f'(metis, relabelling and plans) {builds}; reorder=\'auto\' on '
          f'the power-law graph {"adopted" if chose else "declined"} the '
          f'relabelling', flush=True)
    for name, g in graphs.items():
        mm = g.mm
        if isinstance(mm, ops.DedupMinmaxPlan):
            mm = f'K5 dedup min/max chunks={mm.num_chunks} ec={mm.ec}'
        elif mm is not None:
            mm = describe(mm)
        print(f'  {name}: fwd {describe(g.fwd)}; bwd {describe(g.bwd)}; mm '
              f'{mm}', flush=True)
    if graphs['powerlaw on'].perm is None or graphs['uniform on'].perm is None:
        raise AssertionError("reorder='on' did not relabel")
    pairs = [('powerlaw on', 'powerlaw'), ('uniform on', 'uniform')]
    if chose:
        pairs.append(('powerlaw auto', 'powerlaw'))
    need = set()
    for name, _ in pairs:
        g = graphs[name]
        plan_mm = g.mm if g.mm is not None else g.fwd
        need |= {rgcn_kid(g.fwd), rgcn_kid(g.bwd),
                 'K5' if isinstance(plan_mm, ops.DedupMinmaxPlan) else 'K4'}
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev,
                    requires_grad=True)
    cot = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev)

    def path():
        res = {}
        for name, _ in pairs:
            for reduce in ('sum', 'mean', 'max'):
                out = ops.spmm(x, graphs[name], reduce)
                (grad, ) = torch.autograd.grad((out * cot).sum(), x)
                res[name, reduce] = (out.detach(), grad)
        return res

    res = run_path('reordered plans', sorted(need), path)

    def hold(label, reduce, got, ref, mags, times):
        """``got``'s (value, gradient) against ``ref``'s within ``times``
        the sum bound of ``mags``, each Σ|terms| (max's values bit for bit
        too)."""
        (out, grad), (r, r_grad), (mag, mag_grad) = got, ref, mags
        same = torch.equal(bits(out), bits(r))
        e = float((out - r).abs().max())
        eg = float((grad - r_grad).abs().max())
        print(f'  spmm {reduce} {label}: max_abs_err {e:.3g}'
              + (f' (values {"equal bit for bit" if same else "DIFFER"})'
                 if reduce == 'max' else '')
              + f', grad {eg:.3g} (tolerance {times} * ({SUM_RTOL:g} * '
              f'sum|terms| + {SUM_ATOL:g}))', flush=True)
        bad = bool(((out - r).abs() > times * (SUM_RTOL * mag + SUM_ATOL))
                   .any()) or bool(((grad - r_grad).abs() > times * (
                       SUM_RTOL * mag_grad + SUM_ATOL)).any())
        if bad or (reduce == 'max' and not same) or not torch.isfinite(
                out).all():
            raise AssertionError(f'spmm {reduce} {label} disagrees')

    def spmm_and_sizes(g, reduce):
        """``spmm``'s value and gradient over ``g``, and their Σ|terms|."""
        out = ops.spmm(x, g, reduce)
        (grad, ) = torch.autograd.grad((out * cot).sum(), x)
        mag = ops.spmm(x.detach().abs(), g,
                       'sum' if reduce == 'max' else reduce)
        (mag_grad, ) = torch.autograd.grad(
            (ops.spmm(x, g, reduce) * cot.abs()).sum(), x)
        return (out.detach(), grad), (mag, mag_grad)

    base_of = dict(pairs)
    for (name, reduce), got in res.items():
        # The kernels against their plain versions on the inputs this path
        # gave them (the relabelled plans, x permuted), through the same
        # permutations and autograd, within the sum bound.
        with plain_kernels():
            ref, mags = spmm_and_sizes(graphs[name], reduce)
        hold(f'{name} against its plain version', reduce, got, ref, mags, 1)
        # Then against the unreordered graph's kernels, which checks the
        # permutations: each side is within one sum bound of the exact sum.
        ref, mags = spmm_and_sizes(graphs[base_of[name]], reduce)
        hold(f'{name} against the unreordered graph', reduce, got, ref,
             mags, 2)
    del res
    xb = x.detach()

    def run(plan):
        if isinstance(plan, ops.DedupSpmmPlan):
            return lambda: ops.dedup_sum(xb, plan)
        return lambda: ops.spmm_chunked(xb, plan)

    for name, base in pairs:
        for side in ('fwd', 'bwd'):
            a = getattr(graphs[name], side)
            b = getattr(graphs[base], side)
            print(f'  {rgcn_kid(a)} {name} {side} F={F_BENCH} f32: '
                  f'{cuda_ms(run(a)):.3f} ms reordered, {cuda_ms(run(b)):.3f}'
                  f' ms ({rgcn_kid(b)}) unreordered', flush=True)
        g_r, g_b = graphs[name], graphs[base]
        print(f'  spmm {name} F={F_BENCH} f32 forward (the two permutations '
              f'included): sum {cuda_ms(lambda: ops.spmm(xb, g_r)):.3f} ms '
              f'reordered, {cuda_ms(lambda: ops.spmm(xb, g_b)):.3f} ms '
              f'unreordered; max '
              f'{cuda_ms(lambda: ops.spmm(xb, g_r, "max")):.3f} against '
              f'{cuda_ms(lambda: ops.spmm(xb, g_b, "max")):.3f} ms',
              flush=True)
    del graphs, x, cot, xb
    torch.cuda.empty_cache()
    return dict(builds, metis=t_metis)


def node2vec_path(dev, run_path, rp_u, cl_u):
    """Path D: node2vec on the uniform bench graph: ``random_walk`` (the
    C++ engine) with p = q = 1 and with p = 1, q = 0.5, ``WALKS_PER_NODE``
    walks of ``WALK_LENGTH`` steps from each of ``N2V_BATCH`` start nodes,
    one uniform negative a walk, and ``N2V_STEPS`` Adam steps of
    ``node2vec_loss`` (a context of ``CONTEXT`` nodes) on a ``[N, 128]``
    table each. Every step of every walk must follow an edge (or stay on
    a node with none); the losses must be finite."""
    import torch

    from pyg_lib_tpu_torch.models import init_node2vec, node2vec_loss
    from pyg_lib_tpu_torch.sampler import random_walk

    n = rp_u.shape[0] - 1
    key = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp_u)) * n + cl_u
    key.sort()
    rng = np.random.default_rng(12)

    def path():
        res = {}
        for p, q in ((1.0, 1.0), (1.0, 0.5)):
            params = init_node2vec(n, N2V_DIM, torch.Generator().manual_seed(
                13), device=dev)
            params['emb'].requires_grad_()
            opt = torch.optim.Adam([params['emb']], lr=N2V_LR)
            walk_ms, step_ms, losses = [], [], []
            for step in range(N2V_STEPS):
                start = np.repeat(rng.integers(0, n, N2V_BATCH),
                                  WALKS_PER_NODE)
                t0 = time.perf_counter()
                walks = random_walk(rp_u, cl_u, start, WALK_LENGTH, p=p, q=q,
                                    rng=step)
                walk_ms.append((time.perf_counter() - t0) * 1e3)
                u, v = walks[:, :-1].reshape(-1), walks[:, 1:].reshape(-1)
                at = np.searchsorted(key, u * n + v).clip(max=len(key) - 1)
                dead = rp_u[u + 1] == rp_u[u]
                if not ((key[at] == u * n + v) | (dead & (u == v))).all():
                    raise AssertionError(f'a node2vec walk (p={p}, q={q}) '
                                         f'left the graph')
                neg = rng.integers(0, n, (len(start), NEGATIVES))
                t0 = time.perf_counter()
                opt.zero_grad()
                loss = node2vec_loss(params,
                                     torch.from_numpy(walks).to(dev),
                                     torch.from_numpy(neg).to(dev),
                                     window=CONTEXT - 1)
                loss.backward()
                opt.step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss.detach()))
            res[p, q] = (walk_ms, step_ms, losses)
        return res

    res = run_path('node2vec', (), path,
                   engine=('random_walk', 'random_walk_pq'))
    for (p, q), (walk_ms, step_ms, losses) in res.items():
        print(f'  node2vec p={p:g} q={q:g}: {N2V_BATCH * WALKS_PER_NODE} '
              f'walks of {WALK_LENGTH} steps, ms each step '
              f'{[round(v, 3) for v in walk_ms]} (the first p/q call sorts '
              f'the rows once); Adam step ms '
              f'{[round(v, 3) for v in step_ms]}; losses '
              f'{[round(v, 4) for v in losses]}', flush=True)
        if not all(np.isfinite(losses)):
            raise AssertionError('the node2vec losses are not finite')


def entry_path(dev, run_path):
    """Path E: the port's ``entry()`` on the card (``sage_forward``
    [32, 64, 7] over one padded batch from the port's sampler; K3)
    against the same function on the CPU, within ``GCN_RTOL``."""
    import torch

    from pyg_lib_tpu_torch.entry import entry

    def path():
        fn, args = entry(device=dev)  # samples its batch
        return args, fn(*args)

    args, out = run_path('entry()', ('K3', ), path,
                         engine=('neighbor_sample', ))
    fn_c, args_c = entry(device='cpu')
    for a, b in zip(args[1:], args_c[1:]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError('entry()\'s batch differs between the card '
                                 'and the CPU')
    close('entry() on the card against the CPU', out.cpu(), fn_c(*args_c))


def products_data():
    """Path P's graph and data: ``testing.uniform_graph`` at
    ogbn-products' node and edge counts (seed 0; ``col`` as int64 for the
    sampler), features ``[N, 100]`` f32, 47-class labels,
    ``PRODUCTS_TRAIN`` random training nodes and edge weights uniform in
    [0.05, 1) (seed 2)."""
    from pyg_lib_tpu_torch.testing import uniform_graph

    rowptr, col = uniform_graph(PRODUCTS_NODES, PRODUCTS_EDGES)
    col = col.astype(np.int64)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((PRODUCTS_NODES, PRODUCTS_DIMS[0]),
                            dtype=np.float32)
    y = rng.integers(0, PRODUCTS_DIMS[-1], PRODUCTS_NODES)
    train = rng.permutation(PRODUCTS_NODES)[:PRODUCTS_TRAIN]
    weight = rng.uniform(0.05, 1.0, len(col))
    return rowptr, col, x, y, train, weight


def sage_trainer(dims, lr, seed, dev):
    """A ``SAGE`` (weights from ``seed``), its Adam, and a step over a
    batch that returns the loss over the batch's seeds."""
    import torch

    from pyg_lib_tpu_torch.examples.train_sage_weighted_disjoint import \
        seed_loss
    from pyg_lib_tpu_torch.models import SAGE

    model = SAGE(dims, generator=torch.Generator().manual_seed(seed),
                 device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    params = model.params()

    def step(batch):
        opt.zero_grad()
        loss = seed_loss(params, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return model, opt, step


def loader_report(label, loader):
    """Print the loader's host timings of its last epoch (ms a batch, in
    its threads), its copies' times and its batches' sizes and buckets."""
    t = loader.timings
    h2d = []
    for tm in t:
        start, done = tm['h2d']
        done.synchronize()
        h2d.append(start.elapsed_time(done))
    mean = lambda v: sum(v) / len(v)

    def spread(key):
        v = sorted(tm[key] for tm in t)
        return (f'{mean(v):.3f} (median {v[len(v) // 2]:.3f}, first '
                f'{t[0][key]:.3f}, max {v[-1]:.3f})')

    print(f'  {label} host, ms a batch (mean of {len(t)}, in the loader\'s '
          f'threads): sample {spread("sample_ms")}, pad {spread("pad_ms")}, '
          f'feature gather into pinned memory {spread("gather_ms")}; H2D '
          f'{mean(h2d):.3f} (side stream; median '
          f'{sorted(h2d)[len(h2d) // 2]:.3f}); nodes a batch '
          f'{min(v["num_nodes"] for v in t)}-'
          f'{max(v["num_nodes"] for v in t)}, edges '
          f'{min(v["num_edges"] for v in t)}-'
          f'{max(v["num_edges"] for v in t)}; bucket counts '
          f'{loader.bucket_counts} of {loader.buckets}', flush=True)


def state_bits(state):
    """A nested state's tensors as one flat list of their bytes (on the
    host), to compare two states bit for bit."""
    import torch

    out = []
    if isinstance(state, torch.Tensor):
        out.append(state.detach().reshape(-1).view(torch.uint8).cpu())
    elif isinstance(state, dict):
        for k in sorted(state, key=str):
            out += state_bits(state[k])
    elif isinstance(state, (list, tuple)):
        for v in state:
            out += state_bits(v)
    return out


def products_path(dev, run_path):
    """Path P: SAGE [100, 256, 256, 47] (mean) trains with Adam on
    ogbn-products' shape, in disjoint batches of 1,024 seeds with fanouts
    [15, 10, 5] biased by the edge weights, from the port's
    ``NeighborLoader``: ``PRODUCTS_WARMUP`` steps, ``PRODUCTS_STEPS`` timed
    ones and a profiled window of ``PRODUCTS_PROFILED``, the epoch's end.
    Then the model, Adam and the loader go into a ``save_checkpoint``, the
    run goes on for ``PRODUCTS_RESUME`` steps, and a fresh model,
    optimizer and loader restored from the checkpoint take the same steps:
    their losses, parameters and Adam state must equal the first run's bit
    for bit. On one more batch, the step against the plain path within
    ``GCN_RTOL``, and K3 at F=100 and F=256 against its plain version,
    timed. Returns the data (for path Q) and K3's rows by width."""
    import tempfile

    import torch

    from pyg_lib_tpu_torch.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from pyg_lib_tpu_torch.examples.train_sage_weighted_disjoint import \
        seed_loss
    from pyg_lib_tpu_torch.loader import NeighborLoader

    t0 = time.perf_counter()
    data = products_data()
    rowptr, col, x, y, train, weight = data
    t_data = time.perf_counter() - t0
    epoch = PRODUCTS_WARMUP + PRODUCTS_STEPS + PRODUCTS_PROFILED
    seeds = train[:PRODUCTS_BATCH * epoch]

    def make_loader():
        return NeighborLoader(rowptr, col, x, y, seeds, PRODUCTS_BATCH,
                              PRODUCTS_FANOUTS, device=dev, disjoint=True,
                              edge_weight=weight)

    t0 = time.perf_counter()
    loader = make_loader()
    t_probe = time.perf_counter() - t0
    print(f'ogbn-products shape: {PRODUCTS_NODES} nodes, '
          f'{PRODUCTS_EDGES} edges asked, {int(rowptr[-1])} made (col '
          f'int64 {col.nbytes / 1e9:.2f} GB, weights f64 '
          f'{weight.nbytes / 1e9:.2f} GB, x {tuple(x.shape)} f32 '
          f'{x.nbytes / 1e9:.2f} GB) in {t_data:.1f} s; NeighborLoader '
          f'(disjoint, weighted) buckets {loader.buckets} probed in '
          f'{t_probe:.2f} s', flush=True)
    model, opt, step = sage_trainer(PRODUCTS_DIMS, PRODUCTS_LR, 7, dev)

    def path():
        it = iter(loader)
        ms, losses = [], []
        for i in range(PRODUCTS_WARMUP + PRODUCTS_STEPS):
            if i == PRODUCTS_WARMUP:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses.append(step(next(it)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, wall, top = device_time_by_kernel(
            lambda: [step(next(it)) for _ in range(PRODUCTS_PROFILED)])
        for _ in it:  # the epoch's end: the loader closes its pool
            pass
        loader_report('ogbn-products', loader)
        # The checkpoint at the epoch's end, then PRODUCTS_RESUME steps
        # twice: on, and from the restored checkpoint.
        with tempfile.TemporaryDirectory(prefix='pygt_ckpt_') as tmp:
            t0 = time.perf_counter()
            save_checkpoint(tmp, {'model': model.state_dict(),
                                  'opt': opt.state_dict()}, step=epoch,
                            loader=loader)
            t_save = time.perf_counter() - t0
            it = iter(loader)
            on = [step(next(it)) for _ in range(PRODUCTS_RESUME)]
            it.close()
            model2, opt2, step2 = sage_trainer(PRODUCTS_DIMS, PRODUCTS_LR,
                                               11, dev)
            loader2 = make_loader()
            t0 = time.perf_counter()
            state, meta = restore_checkpoint(
                tmp, {'model': model2.state_dict(),
                      'opt': opt2.state_dict()}, loader=loader2)
            model2.load_state_dict(state['model'])
            opt2.load_state_dict(state['opt'])
            t_restore = time.perf_counter() - t0
            it = iter(loader2)
            again = [step2(next(it)) for _ in range(PRODUCTS_RESUME)]
            it.close()
        resumed = {'save_s': t_save, 'restore_s': t_restore, 'meta': meta,
                   'on': [float(v) for v in on],
                   'again': [float(v) for v in again], 'equal': {}}
        for label, a, b in (
                ('losses', on, again),
                ('parameters', model.state_dict(), model2.state_dict()),
                ('Adam state', opt.state_dict(), opt2.state_dict())):
            pairs = list(zip(state_bits(a), state_bits(b)))
            resumed['equal'][label] = (len(pairs), all(
                torch.equal(u, v) for u, v in pairs))
        return ms, [float(v) for v in losses], peak, busy, wall, top, resumed

    ms, losses, peak, busy, wall, top, resumed = run_path(
        'ogbn-products GraphSAGE (weighted, disjoint)', ('K3', 'G1'), path,
        engine=('neighbor_sample', ))
    timed = ms[PRODUCTS_WARMUP:]
    mean = sum(timed) / len(timed)
    print(f'  ogbn-products step (mean of {len(timed)} after '
          f'{PRODUCTS_WARMUP}): {mean:.3f} ms (each: '
          f'{", ".join(f"{v:.1f}" for v in timed)}); losses '
          f'{[round(v, 4) for v in losses]}', flush=True)
    print(f'profile ogbn-products GraphSAGE, {PRODUCTS_PROFILED} steps: '
          f'device busy {busy:.3f} ms of {wall:.3f} ms '
          f'({wall / PRODUCTS_PROFILED:.3f} ms a step), idle share '
          f'{1 - busy / wall:.3f}; peak memory {peak:.2f} GiB; by kernel '
          f'(ms, the window): '
          + '; '.join(f'{n} {v:.3f}' for n, v in top[:8]), flush=True)
    print(f'  ogbn-products checkpoint at step {resumed["meta"]["step"]} '
          f'(loader {resumed["meta"]["loader_state"]}): saved in '
          f'{resumed["save_s"]:.3f} s, restored in '
          f'{resumed["restore_s"]:.3f} s; {PRODUCTS_RESUME} steps on '
          f'{resumed["on"]} and from the checkpoint {resumed["again"]}; '
          f'equal bit for bit: '
          + ', '.join(f'{k} {ok} ({n} tensors)'
                      for k, (n, ok) in resumed['equal'].items()),
          flush=True)
    if not all(np.isfinite(losses + resumed['on'])):
        raise AssertionError('the ogbn-products losses are not finite')
    if resumed['meta']['loader_state'] != {'epoch': 1, 'rng': 0}:
        raise AssertionError('the checkpoint holds the wrong loader state')
    for k, (_, ok) in resumed['equal'].items():
        if not ok:
            raise AssertionError(f'the run resumed from the checkpoint '
                                 f'differs from the run that went on: {k}')

    # One more batch: the step against the plain path, and K3's rows.
    it = iter(loader)
    batch = next(it)
    it.close()
    params, leaves = model.params(), list(model.parameters())
    loss, signs = relu_signs(lambda: seed_loss(params, batch))
    grads = torch.autograd.grad(loss, leaves)
    with plain_kernels():  # G1's plain version runs in backward
        ref, _ = relu_signs(lambda: seed_loss(params, batch), replay=signs)
        refs = torch.autograd.grad(ref, leaves)
    close('ogbn-products GraphSAGE loss', loss.detach()[None],
          ref.detach()[None])
    for (name, _), g, r in zip(model.named_parameters(), grads, refs):
        close(f'  ogbn-products GraphSAGE grad {name}', g, r)
    ptr, row = batch['rowptr'], batch['row']
    rows = {}
    for f in PRODUCTS_DIMS[:2]:
        src = batch['x'] if f == PRODUCTS_DIMS[0] else torch.randn(
            (batch['x'].shape[0], f), device=dev)
        msgs = src[row.clamp(max=src.shape[0] - 1)]
        rows[f] = k3_row('ogbn-products batch', msgs, ptr, f)
        del msgs
    del batch, loader
    torch.cuda.empty_cache()
    return data, rows


def temporal_path(dev, run_path, data):
    """Path Q: path P's graph and model with node times uniform in
    [0, ``TEMPORAL_SPAN``) (seed 3), each neighbourhood time-sorted once
    on the card (``time_sort_neighborhoods``), and ``NeighborLoader`` with
    ``node_time`` and ``temporal_strategy='last'`` (disjoint): one epoch of
    ``TEMPORAL_BATCHES`` Adam steps, the last ``TEMPORAL_PROFILED`` of them
    profiled. A sample of the same seeds holds no node later than its
    seed."""
    import torch

    from pyg_lib_tpu_torch import sampler
    from pyg_lib_tpu_torch.examples.train_temporal_sage import \
        time_sort_neighborhoods
    from pyg_lib_tpu_torch.loader import NeighborLoader

    rowptr, col, x, y, train, _ = data
    node_time = np.random.default_rng(3).integers(0, TEMPORAL_SPAN,
                                                  PRODUCTS_NODES)
    t0 = time.perf_counter()
    col_t = time_sort_neighborhoods(rowptr, col, node_time, dev)
    t_sort = time.perf_counter() - t0
    seeds = train[:PRODUCTS_BATCH * TEMPORAL_BATCHES]
    kw = dict(disjoint=True, node_time=node_time, temporal_strategy='last')
    t0 = time.perf_counter()
    loader = NeighborLoader(rowptr, col_t, x, y, seeds, PRODUCTS_BATCH,
                            PRODUCTS_FANOUTS, device=dev, **kw)
    t_probe = time.perf_counter() - t0
    _, _, step = sage_trainer(PRODUCTS_DIMS, PRODUCTS_LR, 13, dev)

    def path():
        it = iter(loader)
        ms, losses = [], []
        for i in range(TEMPORAL_BATCHES - TEMPORAL_PROFILED):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses.append(step(next(it)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        busy, wall, top = device_time_by_kernel(
            lambda: losses.extend(step(next(it))
                                  for _ in range(TEMPORAL_PROFILED)))
        peak = torch.cuda.max_memory_allocated() / 2**30
        for _ in it:  # the epoch's end
            pass
        return ms, [float(v) for v in losses], busy, wall, top, peak

    ms, losses, busy, wall, top, peak = run_path(
        'ogbn-products temporal GraphSAGE', ('K3', 'G1'), path,
        engine=('neighbor_sample', ))
    print(f'  ogbn-products temporal: neighbourhoods time-sorted on the '
          f'card in {t_sort:.2f} s; buckets {loader.buckets} probed in '
          f'{t_probe:.2f} s; step ms {[round(v, 1) for v in ms]} (the '
          f'first waits for the loader\'s first batch); losses '
          f'{[round(v, 4) for v in losses]}', flush=True)
    print(f'profile ogbn-products temporal GraphSAGE, {TEMPORAL_PROFILED} '
          f'steps: device busy {busy:.3f} ms of {wall:.3f} ms '
          f'({wall / TEMPORAL_PROFILED:.3f} ms a step), idle share '
          f'{1 - busy / wall:.3f}; peak memory {peak:.2f} GiB; by kernel '
          f'(ms, the window): '
          + '; '.join(f'{n} {v:.3f}' for n, v in top[:6]), flush=True)
    loader_report('ogbn-products temporal', loader)
    if len(losses) != TEMPORAL_BATCHES or not all(np.isfinite(losses)):
        raise AssertionError('the temporal losses are not finite')
    out = sampler.neighbor_sample(rowptr, col_t, seeds[:PRODUCTS_BATCH],
                                  PRODUCTS_FANOUTS, rng=0, **kw)
    batch_of, nodes = out[2][:, 0], out[2][:, 1]  # disjoint: (batch, node)
    late = int((node_time[nodes] >
                node_time[seeds[:PRODUCTS_BATCH]][batch_of]).sum())
    print(f'  ogbn-products temporal sample: {len(nodes)} nodes, {late} '
          f'later than their seed', flush=True)
    if late:
        raise AssertionError('the temporal sample holds nodes later than '
                             'their seeds')


def examples_path(dev, run_path):
    """The last four examples' ``main`` on the card, ``EXAMPLE_STEPS``
    epochs or steps each: full-batch GCN (K3, G1), the planned GCN (K1),
    weighted-disjoint and temporal GraphSAGE (K3, G1, the C++ engine).
    Each loss must fall."""
    from pyg_lib_tpu_torch.examples import (train_gcn,
                                            train_gcn_fullgraph_spmm,
                                            train_sage_weighted_disjoint,
                                            train_temporal_sage)

    for name, need, engine, call in (
            ('train_gcn', ('K3', 'G1'), (), lambda: train_gcn.main(
                epochs=EXAMPLE_STEPS, verbose=False, device=dev)),
            ('train_gcn_fullgraph_spmm', ('K1', ), (),
             lambda: train_gcn_fullgraph_spmm.main(
                 epochs=EXAMPLE_STEPS, verbose=False, device=dev)),
            ('train_sage_weighted_disjoint', ('K3', 'G1'),
             ('neighbor_sample', ),
             lambda: train_sage_weighted_disjoint.main(
                 steps=EXAMPLE_STEPS, verbose=False, device=dev)),
            ('train_temporal_sage', ('K3', 'G1'), ('neighbor_sample', ),
             lambda: train_temporal_sage.main(
                 steps=EXAMPLE_STEPS, verbose=False, device=dev))):
        t0 = time.perf_counter()
        acc, losses = run_path(f'example {name}', need, call,
                               engine=engine)
        print(f'  example {name}: {len(losses)} steps, loss {losses[0]:.4f}'
              f' -> {losses[-1]:.4f}, test accuracy {acc:.3f} '
              f'({time.perf_counter() - t0:.1f} s)', flush=True)
        if not losses[-1] < losses[0]:
            raise AssertionError(f'the example {name}\'s loss did not fall')


def host_paths(dev, run_path):
    """Paths A, C, D and E (the host layer on the card), P and Q
    (ogbn-products) and the last four examples; returns K3's rows at path
    A's and path P's widths and path C's build seconds."""
    from pyg_lib_tpu_torch.testing import uniform_graph

    t0 = time.perf_counter()
    k3_rows = reddit_path(dev, run_path)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp_u, cl_u = uniform_graph(N_NODES, N_EDGES)
    cl_u = cl_u.astype(np.int64)
    builds = reorder_path(dev, run_path, rp_u, cl_u)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    node2vec_path(dev, run_path, rp_u, cl_u)
    t_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    entry_path(dev, run_path)
    t_e = time.perf_counter() - t0
    t0 = time.perf_counter()
    data, k3_p = products_path(dev, run_path)
    t_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    temporal_path(dev, run_path, data)
    del data
    t_q = time.perf_counter() - t0
    t0 = time.perf_counter()
    examples_path(dev, run_path)
    print(f'host paths (s): A {t_a:.1f}, C {t_c:.1f}, D {t_d:.1f}, E '
          f'{t_e:.1f}, P {t_p:.1f}, Q {t_q:.1f}, examples '
          f'{time.perf_counter() - t0:.1f}', flush=True)
    return k3_rows, k3_p, builds


def host_main():
    """``python3 chip_smoke.py --host``: paths A, C, D, E, P, Q and the
    examples (:func:`host_paths`) in a process of their own, as
    :func:`main` runs them; its last line is :data:`HOST_RESULT` and, as
    JSON, the paths' launch counts (by width too, in all and path by
    path), K3's rows at path A's and path P's widths and path C's build
    seconds."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyg_lib_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()  # built by the calling process: loaded
    t0 = time.perf_counter()
    _build.build_host()
    print(f'host engine build: {time.perf_counter() - t0:.1f} s', flush=True)
    paths = Paths()
    t0 = time.perf_counter()
    k3_rows, k3_p, builds = host_paths(torch.device('cuda', 0), paths.run)
    paths.restore()
    print(f'host paths: {time.perf_counter() - t0:.1f} s', flush=True)
    print(HOST_RESULT + json.dumps({
        'launches': paths.launches, 'k3': k3_rows, 'k3_p': k3_p,
        'builds': builds,
        'by_width': [[kid, f, n] for (kid, f), n in
                     sorted(paths.by_width.items())],
        'by_path': {name: [[kid, f, n] for (kid, f), n in sorted(w.items())]
                    for name, w in paths.by_path.items()}}), flush=True)


# -- the distribution child (python3 chip_smoke.py --dist) -------------------


def sync(dev):
    import torch

    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def rank_setup(cfg):
    """A rank's start: TF32 off, and on the card K3's and G1's C entry
    points replaced by :class:`ByWidth` tallies (their calls by width).
    Returns the rank's device and the tallies by kernel (``None`` on the
    CPU)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(cfg['device'])
    tally = None
    if dev.type == 'cuda':
        from pyg_lib_tpu_torch import _build
        from pyg_lib_tpu_torch.ops.kernels import gather_rows as g1_mod
        from pyg_lib_tpu_torch.ops.kernels import segment_csr as k3_mod

        tally = {'K3': ByWidth(k3_mod._k3_lib(), 6, lambda a: 'K3'),
                 'G1': ByWidth(g1_mod._lib(), 7, lambda a: 'G1')}
        setattr(_build.load('segment_csr'), 'pygt_segment_sum_csr',
                tally['K3'])
        setattr(_build.load('gather_rows'), 'pygt_gather_rows_backward',
                tally['G1'])
    return dev, tally


def k3_start(dev, tally):
    """Set the rank's K3 and G1 counts and its peak memory to 0 (just
    before a main path)."""
    import torch

    from pyg_lib_tpu_torch import ops

    if dev.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ops.segment_sum_csr_kernel.launches = 0
    ops.gather_rows_backward.launches = 0
    for t in (tally or {}).values():
        t.counts.clear()


def k3_read(dev, tally):
    """The rank's K3 and G1 launches since :func:`k3_start`, by width too,
    and its peak memory in GiB."""
    import torch

    from pyg_lib_tpu_torch import ops

    def widths(kid):
        return [] if tally is None else [
            [f, n] for (_, f), n in sorted(tally[kid].counts.items())]

    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == 'cuda' else 0.0)
    return {'k3': ops.segment_sum_csr_kernel.launches,
            'widths': widths('K3'), 'g1': ops.gather_rows_backward.launches,
            'g1_widths': widths('G1'), 'peak': peak}


def digest(params):
    """SHA-1 of the parameters' bytes: equal across ranks, bit for bit."""
    import hashlib

    from torch.utils import _pytree

    h = hashlib.sha1()
    for t in _pytree.tree_leaves(params):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run_steps(rank, dev, step, params, n, next_batch, on_step=None):
    """``n`` steps of ``step`` in a rank, each timed by the host clock to a
    synchronise. The last one also times each collective (synchronised,
    ``parallel._collectives.stats``) and, in rank 0 on the card, runs
    under the profiler (device time by kernel, idle share). ``on_step(i)``
    runs after step ``i``. Returns the parameters and the record."""
    from pyg_lib_tpu_torch.parallel import _collectives as C

    opt, ms, losses, digests, prof = None, [], [], [], None
    for i in range(n):
        batch = next_batch()
        last = i == n - 1
        if last:
            C.reset_stats()
            C.set_timing(True)
        sync(dev)
        t0 = time.perf_counter()
        if last and rank == 0 and dev.type == 'cuda':
            out = []
            busy, wall, top = device_time_by_kernel(
                lambda: out.append(step(params, opt, batch)))
            (params, opt, loss), = out
            prof = {'busy': busy, 'wall': wall,
                    'k3_ms': sum(t for name, t in top if 'k3_' in name),
                    'top': [[name, t] for name, t in top[:6]]}
        else:
            params, opt, loss = step(params, opt, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        digests.append(digest(params))
        if on_step is not None:
            on_step(i)
    C.set_timing(False)
    return params, {'ms': ms, 'losses': losses, 'digests': digests,
                    'profile': prof,
                    'coll_ms': {k: v[0] for k, v in C.stats.items()},
                    'coll_calls': {k: v[1] for k, v in C.stats.items()}}


def dist_load(cfg, name):
    """An array the child wrote for the ranks, memory-mapped (copy on
    write: writable for ``torch.from_numpy``, shared until written)."""
    return np.load(os.path.join(cfg['tmp'], name + '.npy'), mmap_mode='c')


def dist_gcn(rank, world, cfg, dev, tally, form):
    """Path H in one rank: ``cfg['h_steps']`` Adam steps of the GCN over
    this rank's node range with ``form``'s aggregation ('halo' or
    'ring'); step 1's output rows and all-reduced weight gradients are
    held against the one-process reference (errors returned)."""
    import functools

    import torch

    from pyg_lib_tpu_torch import parallel
    from pyg_lib_tpu_torch.examples.train_dist_fullgraph import gcn_forward

    mesh = parallel.make_mesh((world, ), ('data', ), device=dev.type)
    npd = cfg['npd']
    mine = slice(rank * npd, (rank + 1) * npd)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k3_start(dev, tally)
    x = card(dist_load(cfg, 'h_x')[mine])
    y = card(dist_load(cfg, 'h_y')[mine])
    train = card(dist_load(cfg, 'h_train')[mine])
    inv_sqrt = card(dist_load(cfg, 'h_inv_sqrt')[mine])[:, None]
    if form == 'halo':
        tables = [card(dist_load(cfg, 'h_src')[rank]),
                  card(dist_load(cfg, 'h_ptr')[rank])]
        agg_fn = parallel.halo_exchange_aggregate
    else:
        tables = [card(dist_load(cfg, 'h_rb')[rank]),
                  card(dist_load(cfg, 'h_sb')[rank])]
        agg_fn = parallel.ring_halo_aggregate
    saved = np.load(os.path.join(cfg['tmp'], 'h_params.npz'))
    names = ('w1', 'b1', 'w2', 'b2')
    seen, check = {}, {}

    def loss_fn(p, _):
        logits = gcn_forward(p, x, inv_sqrt,
                             lambda h: agg_fn(mesh, h, *tables))
        seen['out'] = logits.detach()
        nll = torch.nn.functional.cross_entropy(logits, y, reduction='none')
        return torch.where(train, nll, 0.0).sum(), train.sum()

    step = parallel.make_train_step(
        loss_fn, functools.partial(torch.optim.Adam, lr=DIST_LR), mesh)

    def on_step(i):
        if i == 0:
            ref = card(dist_load(cfg, 'h_ref_out')[mine])
            check['out'] = float((seen['out'] - ref).abs().max())
            check['grads'] = [float((g - card(saved['g_' + k])).abs().max())
                              for g, k in zip(step.grads, names)]
        seen.clear()

    _, rec = run_steps(rank, dev, step, {k: card(saved[k]) for k in names},
                       cfg['h_steps'], lambda: None, on_step)
    return dict(rec, check=check, **k3_read(dev, tally))


def dist_sage(rank, world, cfg, dev, tally):
    """Path T in one rank: GraphSAGE over this rank's quarter of the
    training seeds, batches from a ``DistNeighborLoader`` over the
    partitioned graph (opened from ``.npy`` files, memory-mapped), the
    gradient averaged over the ranks by ``make_train_step``; returns step
    1's all-reduced gradient for the check."""
    import functools

    import torch

    from pyg_lib_tpu_torch import parallel
    from pyg_lib_tpu_torch.loader import DistNeighborLoader
    from pyg_lib_tpu_torch.models import SAGE, sage_forward
    from pyg_lib_tpu_torch.sampler.dist_service import partition_graph

    mesh = parallel.make_mesh((world, ), ('data', ), device=dev.type)
    graph = partition_graph(dist_load(cfg, 't_rowptr'),
                            dist_load(cfg, 't_col'), world)
    seeds = np.array_split(np.asarray(dist_load(cfg, 't_train')),
                           world)[rank]
    loader = DistNeighborLoader(graph, dist_load(cfg, 't_x'),
                                dist_load(cfg, 't_y'), seeds,
                                cfg['t_batch'], cfg['t_fanouts'],
                                device=dev, rng=rank)
    model = SAGE(cfg['t_dims'], generator=torch.Generator().manual_seed(5),
                 device=dev)
    params = {'layers': [{k: v.detach() for k, v in layer.items()}
                         for layer in model.params()['layers']]}

    def loss_fn(p, batch):
        out = sage_forward(p, batch['x'], batch['rowptr'], batch['row'])
        n = batch['num_seeds']
        return torch.nn.functional.cross_entropy(out[:n], batch['y'][:n])

    step = parallel.make_train_step(
        loss_fn, functools.partial(torch.optim.Adam, lr=cfg['t_lr']), mesh)
    grads0 = []

    def on_step(i):
        if i == 0:
            grads0.extend(g.cpu().numpy() for g in step.grads)

    it = iter(loader)
    k3_start(dev, tally)
    _, rec = run_steps(rank, dev, step, params,
                       cfg['t_warmup'] + cfg['t_steps'] + 1,
                       lambda: next(it), on_step)
    rec.update(k3_read(dev, tally))
    it.close()
    t = loader.timings
    h2d = []
    for tm in t:
        if 'h2d' in tm:
            tm['h2d'][1].synchronize()
            h2d.append(tm['h2d'][0].elapsed_time(tm['h2d'][1]))
    med = lambda v: sorted(v)[len(v) // 2] if v else 0.0
    host = {k: med([tm[k] for tm in t])
            for k in ('sample_ms', 'pad_ms', 'gather_ms')}
    host['h2d_ms'] = med(h2d)
    host['nodes'] = [min(tm['num_nodes'] for tm in t),
                     max(tm['num_nodes'] for tm in t)]
    return dict(rec, grads0=grads0, host=host)


def dist_rank(rank, world, cfg):
    """One rank of the child's four: paths H (the halo form, then the
    ring form), T and E in turn, each with the rank's K3 counts set to 0
    just before it and read just after (E then runs again under the plain
    versions, :func:`dryrun_against_plain`)."""
    dev, tally = rank_setup(cfg)
    out = {f'H {form}': dist_gcn(rank, world, cfg, dev, tally, form)
           for form in ('halo', 'ring')}
    out['T'] = dist_sage(rank, world, cfg, dev, tally)
    out['E'] = dryrun_against_plain(world, dev, tally)
    return out


def report_ranks(label, ranks):
    """The ranks' step ms, peaks, K3 and G1 launches, the collectives of
    the last step and rank 0's profile of it, printed; checks that the
    ranks' losses and parameters agree after every step."""
    for i, r in enumerate(ranks):
        c = r['coll_ms']
        print(f'  {label} rank {i}: step ms '
              f'{[round(v, 1) for v in r["ms"]]} (the last with the '
              f'collectives timed{", profiled" if i == 0 else ""}); peak '
              f'{r["peak"]:.2f} GiB; K3 launches {r["k3"]} (by width '
              f'{r["widths"]}), G1 {r["g1"]} (by width {r["g1_widths"]}); '
              f'last step\'s collectives ms: all-gather '
              f'{c["all_gather"]:.1f}, reduce-scatter '
              f'{c["reduce_scatter"]:.1f}, ring send/recv {c["ring"]:.1f}, '
              f'gradient all-reduce {c["all_reduce"]:.1f}, host staging '
              f'{c["staging"]:.1f} (calls {r["coll_calls"]})', flush=True)
    prof = ranks[0]['profile']
    if prof is not None:
        print(f'profile {label}, rank 0, its last step: device busy '
              f'{prof["busy"]:.3f} ms of {prof["wall"]:.3f} ms, idle share '
              f'{1 - prof["busy"] / prof["wall"]:.3f}; K3 '
              f'{prof["k3_ms"]:.3f} ms; by kernel (ms): '
              + '; '.join(f'{n} {t:.3f}' for n, t in prof['top']),
              flush=True)
    for i, r in enumerate(ranks):
        if r['digests'] != ranks[0]['digests']:
            raise AssertionError(f'{label}: rank {i}\'s parameters differ '
                                 f'from rank 0\'s after a step')
        if not np.isfinite(r['losses']).all():
            raise AssertionError(f'{label}: rank {i} loss is not finite')
        if r['losses'] != ranks[0]['losses']:
            raise AssertionError(f'{label}: the ranks\' losses differ')


def need_k3(label, ranks, cfg, g1=False):
    """K3, and G1 too with ``g1``, must launch in every rank on the
    card."""
    for kid in ('k3', 'g1') if g1 else ('k3', ):
        if cfg['device'] == 'cuda' and any(r[kid] <= 0 for r in ranks):
            raise AssertionError(f'{kid.upper()} never launched in a rank '
                                 f'of {label}')


def gcn_dist_data(dev, cfg):
    """Path H's graph, features, partitions and weights, written for the
    ranks, and the one-process reference on the card: the same GCN over
    the global CSR (``segment_sum_csr`` under :func:`plain_kernels`, so
    no K3), its loss the masked mean over every training node. Returns the tolerances of step 1's output and
    weight gradients (``GCN_RTOL`` of the reference's largest) and the
    partition (for K3's rows)."""
    import torch

    from pyg_lib_tpu_torch import ops, partition
    from pyg_lib_tpu_torch.examples.train_dist_fullgraph import gcn_forward
    from pyg_lib_tpu_torch.models.gnn import _glorot
    from pyg_lib_tpu_torch.testing import huge_graph

    d = DIST_RANKS
    t0 = time.perf_counter()
    rowptr, col = huge_graph('uniform', *cfg.get('huge', ()))
    n, e = len(rowptr) - 1, int(rowptr[-1])
    if n % d:
        raise ValueError(f'{n} nodes do not split over {d} ranks')
    cfg['npd'] = n // d
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, DIST_DIMS[0]), dtype=np.float32)
    y = rng.integers(0, DIST_DIMS[-1], n)
    train = rng.random(n) < DIST_TRAIN_SHARE
    inv_sqrt = (1.0 / np.sqrt(np.maximum(np.diff(rowptr), 1))).astype(
        np.float32)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = partition.mesh_edge_partition(rowptr, col, d)
    bpart = partition.mesh_edge_partition_blocked(rowptr, col, d)
    t_part = time.perf_counter() - t0
    for name, a in (('h_x', x), ('h_y', y), ('h_train', train),
                    ('h_inv_sqrt', inv_sqrt), ('h_rowptr', rowptr),
                    ('h_col', col), ('h_src', part.src_ids),
                    ('h_ptr', part.rowptr), ('h_rb', bpart.rowptr_blk),
                    ('h_sb', bpart.src_blk)):
        np.save(os.path.join(cfg['tmp'], name + '.npy'), a)
    gen = torch.Generator().manual_seed(7)
    f0, f1, f2 = DIST_DIMS
    params = {'w1': _glorot(f0, f1, gen, 'cpu'), 'b1': torch.zeros(f1),
              'w2': _glorot(f1, f2, gen, 'cpu'), 'b2': torch.zeros(f2)}
    print(f'H: huge graph {n} nodes, {e} edges, x [{n}, {f0}] in '
          f'{t_data:.1f} s; partitions for {d} ranks in {t_part:.1f} s '
          f'(E_max {part.src_ids.shape[1]} a rank, ring blocks '
          f'{bpart.src_blk.shape[2]})', flush=True)

    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    ptr_t = torch.from_numpy(rowptr).to(dev)
    col_t = torch.from_numpy(col).to(dev)
    p = {k: v.to(dev, copy=True).requires_grad_() for k, v in params.items()}
    with plain_kernels():
        logits = gcn_forward(p, torch.from_numpy(x).to(dev),
                             torch.from_numpy(inv_sqrt).to(dev)[:, None],
                             lambda h: ops.segment_sum_csr(
                                 h.index_select(0, col_t), ptr_t))
    tr = torch.from_numpy(train).to(dev)
    nll = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(y).to(dev), reduction='none')
    loss = torch.where(tr, nll, 0.0).sum() / tr.sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    sync(dev)
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_out = logits.detach().cpu().numpy()
    np.save(os.path.join(cfg['tmp'], 'h_ref_out.npy'), ref_out)
    tol = {'out': GCN_RTOL * float(np.abs(ref_out).max()),
           'grads': [GCN_RTOL * float(g.abs().max()) for g in grads]}
    np.savez(os.path.join(cfg['tmp'], 'h_params.npz'),
             **{k: v.numpy() for k, v in params.items()},
             **{'g_' + k: g.cpu().numpy() for k, g in zip(p, grads)})
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == 'cuda' else 0.0)
    print(f'H reference (one process, whole graph, plain versions, value '
          f'and gradient): '
          f'{ref_ms:.1f} ms, loss {loss.item():.6f}, peak {peak:.2f} GiB',
          flush=True)
    return tol, part


def sage_dist_data(cfg):
    """Path T's data (path A's Reddit shape), written for the ranks."""
    t0 = time.perf_counter()
    rowptr, col, x, y, train = reddit_data()
    for name, a in (('t_rowptr', rowptr), ('t_col', col), ('t_x', x),
                    ('t_y', y), ('t_train', train)):
        np.save(os.path.join(cfg['tmp'], name + '.npy'), a)
    print(f'T: Reddit shape {REDDIT_NODES} nodes, {int(rowptr[-1])} edges, '
          f'x {tuple(x.shape)}, written for the ranks in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)


def check_gcn_dist(form, ranks, tol):
    """Path H's step 1 in every rank against the reference."""
    for i, r in enumerate(ranks):
        c = r['check']
        print(f'  H {form} rank {i} step 1 against the reference: output '
              f'max_abs_err {c["out"]:.3g} (tolerance {tol["out"]:.3g}); '
              f'weight gradients {[float(f"{v:.3g}") for v in c["grads"]]} '
              f'(tolerances {[float(f"{v:.3g}") for v in tol["grads"]]})',
              flush=True)
        if c['out'] > tol['out'] or any(
                g > t for g, t in zip(c['grads'], tol['grads'])):
            raise AssertionError(f'H {form}: rank {i} disagrees with the '
                                 f'one-process GCN')


def check_sage_dist(dev, cfg, ranks):
    """Path T's step 1: the all-reduced gradient (equal in every rank, bit
    for bit) against the mean of the four ranks' local gradients,
    recomputed here from the same four first batches (each rank's loader
    rebuilt with its seeds and rng) and the same weights, within 1e-5 of
    its largest. Returns rank 0's first batch."""
    import torch

    from pyg_lib_tpu_torch.loader import DistNeighborLoader
    from pyg_lib_tpu_torch.models import SAGE, sage_forward
    from pyg_lib_tpu_torch.sampler.dist_service import partition_graph

    d = len(ranks)
    for r in ranks:
        if not all(np.array_equal(a, b) for a, b in zip(
                r['grads0'], ranks[0]['grads0'])):
            raise AssertionError('T: the ranks\' all-reduced gradients '
                                 'differ')
    graph = partition_graph(dist_load(cfg, 't_rowptr'),
                            dist_load(cfg, 't_col'), d)
    model = SAGE(cfg['t_dims'], generator=torch.Generator().manual_seed(5),
                 device=dev)
    params = model.params()
    leaves = [v for layer in params['layers'] for v in layer.values()]
    local, first = [], None
    for r in range(d):
        seeds = np.array_split(np.asarray(dist_load(cfg, 't_train')), d)[r]
        loader = DistNeighborLoader(graph, dist_load(cfg, 't_x'),
                                    dist_load(cfg, 't_y'), seeds,
                                    cfg['t_batch'], cfg['t_fanouts'],
                                    device=dev, rng=r, num_workers=1,
                                    lookahead=1)
        it = iter(loader)
        batch = next(it)
        it.close()
        out = sage_forward(params, batch['x'], batch['rowptr'], batch['row'])
        n = batch['num_seeds']
        loss = torch.nn.functional.cross_entropy(out[:n], batch['y'][:n])
        local.append([g.detach() for g in torch.autograd.grad(loss, leaves)])
        first = batch if r == 0 else first
    mean = [sum(gs) / d for gs in zip(*local)]
    errs, tols = [], []
    for g, ref in zip(ranks[0]['grads0'], mean):
        errs.append(float((torch.from_numpy(g).to(dev) - ref).abs().max()))
        tols.append(1e-5 * float(ref.abs().max()))
    print(f'  T step 1: the all-reduced gradients against the mean of the '
          f'ranks\' local ones, max_abs_err {[f"{v:.3g}" for v in errs]} '
          f'(tolerances {[f"{v:.3g}" for v in tols]})', flush=True)
    if any(e > t for e, t in zip(errs, tols)):
        raise AssertionError('T: the all-reduced gradient is not the mean '
                             'of the local gradients')
    return first


def dryrun_against_plain(world, dev, tally):
    """``dryrun_multichip(world)`` in this rank with its K3 counts set to
    0 just before it and read just after, then again under
    :func:`plain_kernels`: the errors of its train step's loss, its
    protocol batch's loss and the step's gradients against the plain
    run's, with their tolerances (``GCN_RTOL`` of the plain run's
    largest). The plain run must launch no K3 and no G1."""
    from pyg_lib_tpu_torch.entry import dryrun_multichip

    k3_start(dev, tally)
    got = dryrun_multichip(world, device=dev)
    out = dict(k3_read(dev, tally), line=got['line'])
    k3_start(dev, tally)
    with plain_kernels():
        ref = dryrun_multichip(world, device=dev)
    plain = k3_read(dev, tally)
    if plain['k3'] or plain['g1']:
        raise AssertionError('K3 or G1 launched under plain_kernels')
    keys = ('loss', 'dist_loss')
    out['loss_err'] = max(abs(got[k] - ref[k]) for k in keys)
    out['loss_tol'] = GCN_RTOL * max(abs(ref[k]) for k in keys)
    out['grad_err'] = [float(np.abs(a - b).max())
                       for a, b in zip(got['grads'], ref['grads'])]
    out['grad_tol'] = [GCN_RTOL * float(np.abs(b).max())
                       for b in ref['grads']]
    return out


def check_dryrun(label, ranks):
    """Every rank's dry run against its run under the plain versions."""
    for i, r in enumerate(ranks):
        print(f'  {label} rank {i} dry run against the plain versions: '
              f'losses max_abs_err {r["loss_err"]:.3g} (tolerance '
              f'{r["loss_tol"]:.3g}); gradients '
              f'{[float(f"{v:.3g}") for v in r["grad_err"]]} (tolerances '
              f'{[float(f"{v:.3g}") for v in r["grad_tol"]]})', flush=True)
        if r['loss_err'] > r['loss_tol'] or any(
                e > t for e, t in zip(r['grad_err'], r['grad_tol'])):
            raise AssertionError(f'{label}: rank {i}\'s dry run disagrees '
                                 f'with the plain versions')


def dist_nccl_rank(rank, world, cfg):
    """Path N, one rank over NCCL: ``dryrun_multichip(1)`` (against its
    run under the plain versions), then one forward and backward of
    ``halo_exchange_aggregate`` on H's graph at F=128 against the same
    sums and gradient in one process, under :func:`plain_kernels`."""
    import torch

    from pyg_lib_tpu_torch import ops, parallel, partition
    from pyg_lib_tpu_torch.parallel import _collectives as C

    dev, tally = rank_setup(cfg)
    C.reset_stats()
    C.set_timing(True)  # counts each kind's calls
    dry = dryrun_against_plain(1, dev, tally)
    k3_start(dev, tally)
    rowptr, col = dist_load(cfg, 'h_rowptr'), dist_load(cfg, 'h_col')
    part = partition.mesh_edge_partition(rowptr, col, 1)
    mesh = parallel.make_mesh((1, ), ('data', ), device=dev.type)
    x = torch.from_numpy(dist_load(cfg, 'h_x')).to(dev).requires_grad_()
    cot = torch.randn(x.shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    staged = C.staged(x, mesh.get_group('data'))
    sync(dev)
    t0 = time.perf_counter()
    agg = parallel.halo_exchange_aggregate(
        mesh, x, torch.from_numpy(part.src_ids[0]).to(dev),
        torch.from_numpy(part.rowptr[0]).to(dev))
    (agg * cot).sum().backward()
    sync(dev)
    halo_ms = (time.perf_counter() - t0) * 1e3
    counts = k3_read(dev, tally)
    C.set_timing(False)
    agg, grad = agg.detach(), x.grad
    del part
    x2 = x.detach().requires_grad_()
    with plain_kernels():
        ref = ops.segment_sum_csr(x2.index_select(
            0, torch.from_numpy(col).to(dev)), torch.from_numpy(rowptr).to(
                dev))
    (ref * cot).sum().backward()
    ref = ref.detach()
    for kid, key in (('k3', 'widths'), ('g1', 'g1_widths')):
        counts[kid] += dry[kid]
        widths = dict(dry[key])
        for f, n in counts[key]:
            widths[f] = widths.get(f, 0) + n
        counts[key] = [[f, n] for f, n in sorted(widths.items())]
    return dict(counts, dry=dry, line=dry['line'], staged=staged,
                halo_ms=halo_ms,
                calls={k: v[1] for k, v in C.stats.items()},
                coll_ms={k: v[0] for k, v in C.stats.items()},
                out_err=float((agg - ref).abs().max()),
                out_tol=GCN_RTOL * float(ref.abs().max()),
                grad_err=float((grad - x2.grad).abs().max()),
                grad_tol=GCN_RTOL * float(x2.grad.abs().max()))


def nccl_probe_rank(rank, world, cfg):
    import torch
    import torch.distributed as dist

    t = torch.ones(1, device='cuda')
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t)


def nccl_four_ranks():
    """NCCL's answer to ``DIST_RANKS`` ranks on the one card: the probe is
    expected to fail (NCCL refuses two ranks on one GPU), and its message
    is what this returns."""
    from pyg_lib_tpu_torch.parallel import spawn
    from pyg_lib_tpu_torch.parallel.launch import RankError

    try:
        out = spawn(nccl_probe_rank, DIST_RANKS, 'nccl', {}, timeout=180)
    except RankError as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        return 'refused: ' + ' | '.join(lines[-4:])
    return f'ran {DIST_RANKS} ranks (all_reduce of ones gave {out})'


def dist_paths(dev, cfg):
    """NCCL's answer to four ranks, then paths H, T and E in four gloo
    ranks of the card (one start of the ranks), then N in one NCCL rank;
    returns the child's result: K3's and G1's launches (in total and by
    width, per path and rank) and K3's rows at H's and T's widths."""
    import torch

    from pyg_lib_tpu_torch import parallel

    if dev.type == 'cuda':
        t0 = time.perf_counter()
        print(f'N: NCCL with {DIST_RANKS} ranks on one card: '
              f'{nccl_four_ranks()} ({time.perf_counter() - t0:.1f} s)',
              flush=True)
    tol, part = gcn_dist_data(dev, cfg)
    sage_dist_data(cfg)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.spawn(dist_rank, DIST_RANKS, 'gloo', cfg, timeout=900)
    print(f'H, T and E in {DIST_RANKS} ranks on one card (gloo): '
          f'{time.perf_counter() - t0:.1f} s with the ranks\' start',
          flush=True)
    for form in ('halo', 'ring'):
        label = f'H {form}'
        rs = [r[label] for r in ranks]
        print(f'{label}: losses {[round(v, 5) for v in rs[0]["losses"]]}',
              flush=True)
        check_gcn_dist(form, rs, tol)
        report_ranks(label, rs)
        need_k3(label, rs, cfg)
    rs = [r['T'] for r in ranks]
    print(f'T: losses {[round(v, 5) for v in rs[0]["losses"]]}', flush=True)
    for i, r in enumerate(rs):
        h = r['host']
        print(f'  T rank {i} loader, medians a batch (ms): distributed '
              f'sampling {h["sample_ms"]:.1f}, pad {h["pad_ms"]:.1f}, '
              f'pinned gather {h["gather_ms"]:.1f}, H2D {h["h2d_ms"]:.2f}; '
              f'nodes {h["nodes"]}', flush=True)
    report_ranks('T', rs)
    need_k3('T', rs, cfg, g1=True)
    first = check_sage_dist(dev, cfg, rs)
    rs = [r['E'] for r in ranks]
    print(f'E: {rs[0]["line"]} ({DIST_RANKS} ranks, 2 x 2 mesh, gloo; K3 '
          f'launches per rank {[r["k3"] for r in rs]}, G1 '
          f'{[r["g1"] for r in rs]})', flush=True)
    need_k3('E', rs, cfg, g1=True)
    check_dryrun('E', rs)

    paths = {}
    for label, keys in (('H', ('H halo', 'H ring')), ('T', ('T', )),
                        ('E', ('E', ))):
        p = paths[label] = {'per_rank': [], 'widths': {},
                            'g1_per_rank': [], 'g1_widths': {}}
        for r in ranks:
            p['per_rank'].append(sum(r[k]['k3'] for k in keys))
            p['g1_per_rank'].append(sum(r[k]['g1'] for k in keys))
            for k in keys:
                for kid in ('widths', 'g1_widths'):
                    for f, n in r[k][kid]:
                        p[kid][f] = p[kid].get(f, 0) + n
    if dev.type == 'cuda':
        t0 = time.perf_counter()
        (r, ) = parallel.spawn(dist_nccl_rank, 1, 'nccl', cfg, timeout=600)
        print(f'N: {r["line"]} (one rank, NCCL); halo_exchange_aggregate on '
              f'H\'s graph at F={DIST_DIMS[0]}, forward and backward '
              f'{r["halo_ms"]:.1f} ms, against one process\'s plain sums: '
              f'output max_abs_err {r["out_err"]:.3g} '
              f'(tolerance {r["out_tol"]:.3g}), gradient {r["grad_err"]:.3g} '
              f'({r["grad_tol"]:.3g}); staged through the host: '
              f'{r["staged"]}; NCCL calls {r["calls"]}, ms '
              f'{ {k: round(v, 1) for k, v in r["coll_ms"].items()} }; '
              f'K3 launches {r["k3"]} ({time.perf_counter() - t0:.1f} s)',
              flush=True)
        if (r['out_err'] > r['out_tol'] or r['grad_err'] > r['grad_tol']
                or r['staged']):
            raise AssertionError('N: the NCCL rank disagrees with the '
                                 'one-process sums')
        for kind in ('all_gather', 'reduce_scatter', 'all_reduce'):
            if r['calls'][kind] <= 0:
                raise AssertionError(f'N: NCCL never ran {kind}')
        need_k3('N', [r], cfg)
        check_dryrun('N', [r['dry']])
        paths['N'] = {'per_rank': [r['k3']], 'widths': dict(r['widths']),
                      'g1_per_rank': [r['g1']],
                      'g1_widths': dict(r['g1_widths'])}

    # K3 at H's widths on rank 0's halo messages and at T's on rank 0's
    # first batch, each against its plain version and timed.
    rows_h, rows_t = {}, {}
    if dev.type == 'cuda':
        src = torch.from_numpy(part.src_ids[0]).to(dev).long()
        ptr = torch.from_numpy(part.rowptr[0]).to(dev)
        n = part.num_nodes_padded
        for f in DIST_DIMS[1:]:
            h = torch.randn((n, f), device=dev)
            msgs = h.index_select(0, src.clamp(max=n - 1))
            del h
            rows_h[f] = k3_row('H rank 0 halo messages', msgs, ptr, f)
            del msgs
            torch.cuda.empty_cache()
        ptr, row = first['rowptr'], first['row']
        for f in cfg['t_dims'][:2]:
            src = first['x'] if f == cfg['t_dims'][0] else torch.randn(
                (first['x'].shape[0], f), device=dev)
            msgs = src[row.clamp(max=src.shape[0] - 1)]
            rows_t[f] = k3_row('T batch', msgs, ptr, f)
            del msgs
    totals = {}
    for p in paths.values():
        for kid, key in (('K3', 'widths'), ('G1', 'g1_widths')):
            for f, n in p[key].items():
                totals[kid, f] = totals.get((kid, f), 0) + n
    print(f'dist K3 launches per path and rank: '
          f'{ {k: p["per_rank"] for k, p in paths.items()} }; G1 '
          f'{ {k: p["g1_per_rank"] for k, p in paths.items()} }', flush=True)
    return {'by_width': [[kid, f, n]
                         for (kid, f), n in sorted(totals.items())],
            'paths': paths, 'k3_h': rows_h, 'k3_t': rows_t}


def dist_cfg(tmp, device='cuda'):
    """What the ranks need of this script's settings (a spawned rank
    re-imports the script, so a rehearsal's changes reach it only here)."""
    return {'tmp': tmp, 'device': device, 'h_steps': DIST_STEPS,
            't_batch': REDDIT_BATCH,
            't_fanouts': REDDIT_FANOUTS, 't_dims': REDDIT_DIMS,
            't_lr': REDDIT_LR, 't_warmup': DIST_T_WARMUP,
            't_steps': DIST_T_STEPS}


def dist_main():
    """``python3 chip_smoke.py --dist``: paths H, T, E and N
    (:func:`dist_paths`) in a process of their own; its last line is
    :data:`DIST_RESULT` and, as JSON, K3's launches and rows."""
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyg_lib_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    _build.build()  # built by the calling process: loaded
    _build.build_host()
    tmp = tempfile.mkdtemp(prefix='pygt_dist_')
    t0 = time.perf_counter()
    try:
        res = dist_paths(torch.device('cuda', 0), dist_cfg(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f'dist paths: {time.perf_counter() - t0:.1f} s', flush=True)
    launches = {k: 0 for k in COUNTERS}
    for kid, _, n in res['by_width']:
        launches[kid] += n
    print(DIST_RESULT + json.dumps(dict(res, launches=launches)), flush=True)


def work(plan, f):
    """Bytes (each input read once, the output written once) and f32
    operations that one K1/K2 call on ``plan`` at width ``f`` needs. K2
    and K2h read, besides x and the unique-column lists, the tables their
    wrapper derives from a dedup plan once (the real edges sorted by row,
    the row list of ``hot_w``'s non-zeros), not its padded ``edge_meta``
    and dense ``hot_w``: those tables are what is counted."""
    from pyg_lib_tpu_torch.ops import DedupSpmmPlan
    from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import cold_edges, hot_list

    x_bytes = N_NODES * f * 4
    out_bytes = plan.num_rows * f * 4
    if not isinstance(plan, DedupSpmmPlan):
        # col_padded, and row 0 of tile_ptr (TR + 1 lanes of each tile)
        tables = plan.col_padded.numel() * 4 + plan.tile_ptr.shape[0] * 129 * 4
        return x_bytes + tables + out_bytes, plan.num_edges * f
    edges = cold_edges(plan)
    tables = plan.uniq_cols.numel() * 4 + plan.chunk_tile.numel() * 4
    tables += sum(t.numel() * 4 for t in edges if t is not None)
    flops = edges.code.numel() * f * (2 if plan.weighted else 1)
    if plan.num_hot:
        hot = hot_list(plan)
        tables += hot.ptr.numel() * 4 + hot.val.numel() * 8
        flops += hot.val.numel() * f * 2
    return x_bytes + tables + out_bytes, flops


# The trace's categories of work on the device.
DEVICE_WORK = ('kernel', 'gpu_memcpy', 'gpu_memset')


def device_events(prof):
    """``[(category, name, start us, duration us)]`` of the profile's
    device work (:data:`DEVICE_WORK`), by start, read from its exported
    trace: the trace names each event's category in every PyTorch
    version."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix='pygt_trace_') as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    return sorted(((ev['cat'], ev['name'], float(ev['ts']), float(ev['dur']))
                   for ev in trace['traceEvents']
                   if ev.get('ph') == 'X' and ev.get('cat') in DEVICE_WORK),
                  key=lambda ev: ev[2])


def device_time_by_kernel(fn):
    """Run ``fn`` once under ``torch.profiler``; return the device's busy
    ms (the union of its kernels', copies' and memsets' intervals: a copy
    on a side stream may overlap a kernel), the run's wall ms (host clock
    to a synchronize) and ``[(kernel name, ms)]`` summed by name, largest
    first. Ranges the trace puts on the device (``record_function``'s,
    such as ``Optimizer.step`` or ``gloo:recv``) are no device work, and
    are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        # A short spin kernel first: the trace was seen to lose the first
        # kernel of a window (a ctypes kernel's, with nothing before it).
        # No path of the port launches it, so it and whatever came before
        # it are dropped by name, and nothing is if the trace lost it.
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    spin = [i for i, ev in enumerate(events) if 'spin_kernel' in ev[1]]
    if spin:
        events = events[spin[0] + 1:]
    by_name = {}
    busy_us, end_us = 0.0, None
    for _, name, start, dur in events:
        name = re.sub(r'^void |\(anonymous namespace\)::', '', name)
        name = name.split('(')[0][:60]
        by_name[name] = by_name.get(name, 0.0) + dur
        end = start + dur
        if end_us is None or start >= end_us:
            busy_us += dur
            end_us = end
        elif end > end_us:
            busy_us += end - end_us
            end_us = end
    top = sorted(((k, v / 1e3) for k, v in by_name.items()),
                 key=lambda kv: -kv[1])
    return busy_us / 1e3, wall_ms, top


def cuda_ms(fn, iters=10, warmup=2, warm_s=0.1):
    """Mean ms per call of ``fn`` on the card, by CUDA events, after at
    least ``warmup`` calls and ``warm_s`` seconds of calls: a function
    timed first after a pause (host work, ``empty_cache``) read 3-7% slow
    over 20 calls on the H100 (PERF.md)."""
    import torch

    t0 = time.perf_counter()
    done = 0
    while done < warmup or time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
        done += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


if __name__ == '__main__':
    if sys.argv[1:] == ['--rgcn']:
        # Growable segments: the stacked R-GCN's [E_pad, 349] message
        # slabs (20.5 GB, two at once in its backward) and the smaller
        # tensors between them would otherwise fragment the cached
        # segments until a slab no longer fits on the card (PERF.md).
        os.environ.setdefault('PYTORCH_CUDA_ALLOC_CONF',
                              'expandable_segments:True')
        rgcn_main()
        sys.exit(0)
    if sys.argv[1:] == ['--sharded']:
        sharded_main()
        sys.exit(0)
    if sys.argv[1:] == ['--host']:
        host_main()
        sys.exit(0)
    if sys.argv[1:] == ['--dist']:
        dist_main()
        sys.exit(0)
    import torch

    t_start = time.perf_counter()
    smi, errs, rows = main()
    print(f'small-plan and main-shape max_abs_err: {errs}; total '
          f'{time.perf_counter() - t_start:.1f} s', flush=True)
    print(json.dumps({'kernels': rows}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
